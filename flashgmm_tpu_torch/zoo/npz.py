"""The JAX package's parameters as the port's state dict.

Keys of the JAX package are "/"-joined nnx paths (``g_a/layers/0/conv1/
kernel``), conv kernels are HWIO, transposed-conv kernels [kh, kw, in,
out], and ``weights/*.npz`` stores them as float16
(flashgmm_tpu/zoo/npz.py). The port's modules sit at the same paths with
"." and keep torch's layouts under ``weight``: OIHW for a conv, [in, out,
kh, kw] for a transposed conv (the inverse map of
flashgmm_tpu/zoo/torch_export.py:32-73 for the Conv2d, ConvTranspose2d,
GDN and EntropyBottleneck leaves these models have). The two kernel
layouts need different transposes, so the map asks the model which
modules are transposed convs.
"""

import numpy as np
import torch

from flashgmm_tpu_torch.layers import ConvTranspose2d


def load_jax_params(flat: dict, model) -> dict:
    """{nnx path: array} -> {port state-dict key: float32 tensor} for
    ``model``: the kernels of its ConvTranspose2d modules take [kh, kw, in,
    out] -> [in, out, kh, kw], every other kernel HWIO -> OIHW."""
    transposed = {
        "/".join(name.split(".") + ["kernel"]) if name else "kernel"
        for name, m in model.named_modules() if isinstance(m, ConvTranspose2d)}
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        arr = np.asarray(value, dtype=np.float32)
        if parts[-1] == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{key}: expected a 4-d conv kernel, got "
                                 f"shape {arr.shape}")
            parts[-1] = "weight"
            arr = arr.transpose((2, 3, 0, 1) if key in transposed
                                else (3, 2, 0, 1))
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_npz(model, path) -> int:
    """Load a JAX-package ``.npz`` weight file into ``model`` (strictly:
    every parameter present, no key left over). Returns the tensor count."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state = load_jax_params(flat, model)
    model.load_state_dict(state, strict=True)
    return len(state)

"""The JAX package's parameters as the port's state dict.

Keys of the JAX package are "/"-joined nnx paths (``g_a/layers/0/conv1/
kernel``), conv kernels are HWIO, and ``weights/*.npz`` stores them as
float16 (flashgmm_tpu/zoo/npz.py). The port's modules sit at the same paths
with "." and keep conv weights OIHW under ``weight`` (the inverse map of
flashgmm_tpu/zoo/torch_export.py:32-73 for the Conv2d, GDN and
EntropyBottleneck leaves this model has).
"""

import numpy as np
import torch


def load_jax_params(flat: dict) -> dict:
    """{nnx path: array} -> {port state-dict key: float32 tensor}."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        arr = np.asarray(value, dtype=np.float32)
        if parts[-1] == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{key}: expected an HWIO conv kernel, got "
                                 f"shape {arr.shape}")
            parts[-1] = "weight"
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_npz(model, path) -> int:
    """Load a JAX-package ``.npz`` weight file into ``model`` (strictly:
    every parameter present, no key left over). Returns the tensor count."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state = load_jax_params(flat)
    model.load_state_dict(state, strict=True)
    return len(state)

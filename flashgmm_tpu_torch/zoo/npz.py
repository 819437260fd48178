"""The JAX package's parameters as the port's state dict.

Keys of the JAX package are "/"-joined nnx paths (``g_a/layers/0/conv1/
kernel``), conv kernels are HWIO, transposed-conv kernels [kh, kw, in,
out], linear kernels [in, out], and ``weights/*.npz`` stores them as
float16 (flashgmm_tpu/zoo/npz.py). The port's modules sit at the same paths
with "." and keep torch's layouts under ``weight``: OIHW for a conv, [in,
out, kh, kw] for a transposed conv, [out, in] for an ``nn.Linear`` (the
inverse map of flashgmm_tpu/zoo/torch_export.py:32-73 for the Conv2d,
ConvTranspose2d, GDN and EntropyBottleneck leaves these models have; the
VBR models add the linear layers and top-level parameters such as
``Gain``, which keep their path). The kernel layouts need different
transposes, so the map asks the model which modules are transposed convs
and which are linear layers. A spectral conv's ``kernel_transformed``
(complex, [kh, kw//2+1, in, out]) takes its spatial kernel's transposes to
``weight_transformed``.

``save_npz_weights`` writes the same format from a port model, the inverse
map, so that weights the port trains reach the JAX package and the
repository's weight files.
"""

import numpy as np
import torch
from torch import nn

from flashgmm_tpu_torch.layers import ConvTranspose2d


def _kernel_paths(model, cls):
    return {"/".join(name.split(".") + ["kernel"]) if name else "kernel"
            for name, m in model.named_modules() if isinstance(m, cls)}


_KERNELS = {"kernel": "weight", "kernel_transformed": "weight_transformed"}


def load_jax_params(flat: dict, model) -> dict:
    """{nnx path: array} -> {port state-dict key: float32 tensor} for
    ``model``: the kernels of its ConvTranspose2d modules take [kh, kw, in,
    out] -> [in, out, kh, kw], those of its ``nn.Linear`` modules [in, out]
    -> [out, in], every other kernel HWIO -> OIHW."""
    transposed = _kernel_paths(model, ConvTranspose2d)
    linear = _kernel_paths(model, nn.Linear)
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        arr = np.asarray(value)
        arr = arr.astype(np.complex64 if np.iscomplexobj(arr) else np.float32)
        if parts[-1] in _KERNELS:
            kernel = "/".join(parts[:-1] + ["kernel"])
            parts[-1] = _KERNELS[parts[-1]]
            if kernel in linear:
                if arr.ndim != 2:
                    raise ValueError(f"{key}: expected a 2-d linear kernel, "
                                     f"got shape {arr.shape}")
                arr = arr.T
            elif arr.ndim != 4:
                raise ValueError(f"{key}: expected a 4-d conv kernel, got "
                                 f"shape {arr.shape}")
            else:
                arr = arr.transpose((2, 3, 0, 1) if kernel in transposed
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


def save_npz_weights(model, path) -> None:
    """Write ``model``'s parameters as the JAX package's ``.npz`` weight
    file (flashgmm_tpu/zoo/npz.py:36-46): "/"-joined nnx paths, kernels
    back to HWIO ([kh, kw, in, out] for a transposed conv, [in, out] for an
    ``nn.Linear``), every value float16, through ``np.savez_compressed``.
    The keys are the state dict's, which holds the parameters alone (the
    entropy models' tables are buffers outside it), so they are the keys
    the JAX package writes for the same model and those ``load_npz`` reads
    back. A complex parameter (a spectral conv's) is refused: float16 would
    keep its real part alone."""
    transposed = _kernel_paths(model, ConvTranspose2d)
    linear = _kernel_paths(model, nn.Linear)
    weights = {v: k for k, v in _KERNELS.items()}
    arrays = {}
    for name, value in model.state_dict().items():
        if value.is_complex():
            raise ValueError(
                f"{name}: a complex parameter cannot be stored in the "
                "float16 .npz format without losing its imaginary part")
        parts = name.split(".")
        arr = value.detach().float().cpu().numpy()
        if parts[-1] in weights:
            parts[-1] = weights[parts[-1]]
            kernel = "/".join(parts[:-1] + ["kernel"])
            if kernel in linear:
                arr = arr.T
            else:
                arr = arr.transpose((2, 3, 0, 1) if kernel in transposed
                                    else (2, 3, 1, 0))
        arrays["/".join(parts)] = np.ascontiguousarray(arr).astype(np.float16)
    np.savez_compressed(path, **arrays)

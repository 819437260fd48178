"""flashgmm_tpu_torch: the PyTorch/CUDA port of flashgmm_tpu for one NVIDIA
H100.

The JAX package ``flashgmm_tpu`` stays the reference; this package imports
torch and numpy only, never JAX or anything under ``flashgmm_tpu``. Tensors
are NHWC at its public functions, as in the JAX package. Entry points run on
the card unless the caller passes ``device="cpu"``.

The three Pallas TPU kernels of the reference are hand-written CUDA C++ here
(``csrc/``), built by ``_build.py`` at first use: the rANS encoder and
decoder (``ans/rans_kernels.py``; the y passes' encoder evaluates each
symbol's GMM bounds inside it, the decoder the rows' entries its search
probes), and the conv (``ops/conv_kernel.py``) by both of its routes, float32
for the rows chain and bf16 on the tensor cores for the transforms under
``kernel_transforms=True``. So are the GMM rows and bounds that the
reference leaves to XLA (``ans/rows_kernel.py``), off the main path, the
reference format's boundary rows and the coding softmax. On CPU tensors
each wrapper runs its plain PyTorch version instead.

The reference format (``model.compress`` / ``decompress``, CompressAI's
container) runs the host rANS coder ``csrc/rans.cpp``, which the port
builds itself at first use (``ans/cext.py``), or the numpy range coder
after ``set_entropy_coder("rangecoder")``. On it stand the file codec CLI
``python -m flashgmm_tpu_torch.examples.codec`` (.fgm files), the
standalone C++ codec's model card and bitstream (``standalone/``) and the
tiled synthesis of large images (``runtime/tiled.py``).

Training (``parallel.train_step``, the trainer
``python -m flashgmm_tpu_torch.examples.train``) runs the models' forward
and autograd in plain PyTorch: no hand kernel is on its path, as no Pallas
kernel is on the JAX package's.
"""

__version__ = "0.1.0"

# The entropy-coder registry (flashgmm_tpu/__init__.py:28-57; the
# reference's compressai/__init__.py:50-90): the backend an entropy model
# built without an ``entropy_coder`` argument codes with. "rans" is the host
# rANS coder (``ans/cext.py``), "rangecoder" the numpy range coder
# (``ans/range_coder.py``).
_entropy_coder = "rans"
_available_entropy_coders = ["rans", "rangecoder"]


def set_entropy_coder(entropy_coder: str) -> None:
    """Specifies the default entropy coder used to encode the bit-streams.

    Args:
        entropy_coder: name of the entropy coder
    """
    global _entropy_coder
    if not isinstance(entropy_coder, str):
        raise ValueError(f'Invalid entropy coder type "{type(entropy_coder)}"')
    if entropy_coder not in _available_entropy_coders:
        raise ValueError(
            f'Invalid entropy coder "{entropy_coder}", choose from '
            f"({', '.join(_available_entropy_coders)}).")
    _entropy_coder = entropy_coder


def get_entropy_coder() -> str:
    """Return the name of the default entropy coder used to encode the
    bit-streams."""
    return _entropy_coder


def available_entropy_coders():
    """Return the list of available entropy coders."""
    return _available_entropy_coders

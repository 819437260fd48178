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
builds itself at first use (``ans/cext.py``).
"""

__version__ = "0.1.0"

"""Standalone codec export (port of flashgmm_tpu/standalone/; the analog of
the reference's SADL codec pipeline, compressai/sadl_codec/).

Exports a factorized-prior model (``bmshj2018-factorized`` /
``bmshj2018-factorized-relu``) to a self-contained binary "model card"
consumed by the pure-C++ encoder/decoder in ``csrc/standalone/``: no
Python, PyTorch or card at their run time.

- :mod:`.export` writes the model card (g_a/g_s layer stacks, the
  EntropyBottleneck's quantized CDF tables, per-channel synthesis gains
  for the encoder's RDOQ, measured by running g_s on the model's device).
- :mod:`.format` is the byte-compatible Python twin of the C++ bitstream
  (encode/decode through the port's model on its device and the port's
  host coder).
- :mod:`.build` compiles ``fgsc_encode`` / ``fgsc_decode`` from
  ``csrc/standalone/`` and ``csrc/rans.cpp`` with the Makefile's flags into
  ``build/flashgmm_tpu_torch/`` (``python -m flashgmm_tpu_torch.standalone``
  builds them and prints their paths).
"""

from .build import build_binaries
from .export import export_model_card, synthesis_gains
from .format import decode_bitstream, encode_bitstream

__all__ = [
    "build_binaries",
    "export_model_card",
    "synthesis_gains",
    "encode_bitstream",
    "decode_bitstream",
]

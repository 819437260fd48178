"""The SenseTime model line (port of flashgmm_tpu/models/sensetime.py): the
single-Gaussian counterparts of the GMM models, each latent position coded
under one Gaussian (scale, mean) through ``GaussianConditionalLatentCodec``
with the checkerboard's two-pass training forward.

- ``Cheng2020AnchorCheckerboard`` (:35-81): the flagship's transforms and
  context with single-Gaussian parameters, 4N -> 10N/3 -> 8N/3 -> 2N
  (512 -> 426 -> 341 -> 256 at N=128, the local weights'
  ``weights/ckbd_gc_n128_*.npz``). Coded by
  ``runtime.FastCheckerboardGsmCodec``.
- ``Elic2022Official`` (:83-183): ELIC with a single Gaussian in each
  channel group. Its forward only: the JAX package has no device codec for
  it, and its reference-format coding waits for ROADMAP item 9.

Built on the CPU from a ``torch.Generator`` seeded with ``seed``, then moved
to ``device`` (the card unless the caller asks otherwise). Module paths
equal the JAX package's parameter paths (``zoo.load_npz``), and a
CompressAI state dict loads through ``zoo.torch_convert``.
"""

import torch

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.latent_codecs import (
    CheckerboardLatentCodec,
    GaussianConditionalLatentCodec,
    HyperLatentCodec,
    HyperpriorLatentCodec,
)
from flashgmm_tpu_torch.layers import (
    CheckerboardMaskedConv2d,
    Conv2d,
    LeakyReLU,
    Sequential,
)

from .base import SimpleVAECompressionModel
from .elic_gmm import _elic_groups, _elic_modules
from .waseda import _cheng_g_a, _cheng_g_s, _cheng_h_a, _cheng_h_s


class Cheng2020AnchorCheckerboard(SimpleVAECompressionModel):
    def __init__(self, N=192, *, seed: int = 0, device="cuda"):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        self.N = int(N)

        self.g_a = _cheng_g_a(N, g)
        self.g_s = _cheng_g_s(N, g)

        self.latent_codec = HyperpriorLatentCodec({
            "y": CheckerboardLatentCodec(
                latent_codec={
                    "y": GaussianConditionalLatentCodec(quantizer="ste"),
                },
                entropy_parameters=Sequential(
                    Conv2d(N * 12 // 3, N * 10 // 3, 1, generator=g),
                    LeakyReLU(),
                    Conv2d(N * 10 // 3, N * 8 // 3, 1, generator=g),
                    LeakyReLU(),
                    Conv2d(N * 8 // 3, N * 6 // 3, 1, generator=g),
                ),
                context_prediction=CheckerboardMaskedConv2d(
                    N, 2 * N, kernel_size=5, stride=1, padding=2, generator=g),
                forward_method="twopass",
            ),
            "hyper": HyperLatentCodec(
                entropy_bottleneck=EntropyBottleneck(N, generator=g),
                h_a=_cheng_h_a(N, g),
                h_s=_cheng_h_s(N, g),
                quantizer="ste",
            ),
        })
        self.to(device)


class Elic2022Official(SimpleVAECompressionModel):
    def __init__(self, N=192, M=320, groups=None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        self.N, self.M = int(N), int(M)
        self.groups = _elic_groups(M, groups)
        self.g_a, self.g_s, self.latent_codec = _elic_modules(
            N, M, self.groups, 2,
            lambda: GaussianConditionalLatentCodec(quantizer="ste"),
            "twopass", g)
        self.to(device)

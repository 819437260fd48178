"""Cheng2020 anchor + checkerboard + GMM, the flagship model (port of
flashgmm_tpu/models/ckbd_gmm.py).

Built on the CPU from an explicit ``torch.Generator`` seeded with ``seed``,
then moved to ``device`` (the card unless the caller asks otherwise). Module
paths equal the JAX package's parameter paths, so its weights load through
``flashgmm_tpu_torch.zoo.load_jax_params``, and a CompressAI/FlashGMM
PyTorch state dict through ``flashgmm_tpu_torch.zoo.torch_convert``.

``model(x, training=True, generator=g)`` is the training forward
(``SimpleVAECompressionModel.forward``); images are NHWC [B, H, W, 3], as
the codecs take them. ``quantizer`` is the GMM latent codec's.
"""

import torch

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.latent_codecs import (
    CheckerboardLatentCodec,
    GaussianMixtureConditionalLatentCodec,
    HyperLatentCodec,
    HyperpriorLatentCodec,
)
from flashgmm_tpu_torch.layers import (
    CheckerboardMaskedConv2d,
    Conv2d,
    LeakyReLU,
    Sequential,
)
from flashgmm_tpu_torch.registry import register_model

from .base import SimpleVAECompressionModel
from .waseda import _cheng_g_a, _cheng_g_s, _cheng_h_a, _cheng_h_s


@register_model("cheng2020-anchor-checkerboard-gmm")
class Cheng2020AnchorCheckerboardGMMv2(SimpleVAECompressionModel):
    def __init__(self, N=192, K=4, quantizer: str = "noise", *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        self.N = int(N)
        self.K = int(K)

        self.g_a = _cheng_g_a(N, g)
        self.g_s = _cheng_g_s(N, g)
        h_a = _cheng_h_a(N, g)
        h_s = _cheng_h_s(N, g)

        self.latent_codec = HyperpriorLatentCodec({
            "y": CheckerboardLatentCodec(
                latent_codec={
                    "y": GaussianMixtureConditionalLatentCodec(
                        K=self.K, quantizer=quantizer),
                },
                entropy_parameters=Sequential(
                    Conv2d(N * 12 // 3, N * 10 // 3, 1, generator=g),
                    LeakyReLU(),
                    Conv2d(N * 10 // 3, N * 10 // 3, 1, generator=g),
                    LeakyReLU(),
                    Conv2d(N * 10 // 3, 3 * self.K * N, 1, generator=g),
                ),
                context_prediction=CheckerboardMaskedConv2d(
                    N, 2 * N, kernel_size=5, stride=1, padding=2, generator=g),
                forward_method="onepass",
            ),
            "hyper": HyperLatentCodec(
                entropy_bottleneck=EntropyBottleneck(N, generator=g),
                h_a=h_a,
                h_s=h_s,
                quantizer="ste",
            ),
        })
        self.to(device)

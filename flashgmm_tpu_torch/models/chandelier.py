"""Elic2022Chandelier (port of flashgmm_tpu/models/chandelier.py;
CompressAI's models/sensetime.py:344-546): the community ELIC
reimplementation. Channel context from only the first and the latest
groups, (means, scales) parameter order, a single Gaussian a channel coded
over the scale table.

Built on the CPU from a ``torch.Generator`` seeded with ``seed``, then moved
to ``device`` (the card unless the caller asks otherwise); module paths
equal the JAX package's. In the reference format the channel contexts, the
spatial contexts, the parameter aggregation and h_s run on the rows chain,
as ELIC's do (``latent_codecs``).
"""

import torch

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.latent_codecs import (
    ChannelGroupsLatentCodec,
    CheckerboardLatentCodec,
    GaussianConditionalLatentCodec,
    HyperLatentCodec,
    HyperpriorLatentCodec,
)
from flashgmm_tpu_torch.layers import (
    AttentionBlock,
    CheckerboardMaskedConv2d,
    Conv2d,
    ReLU,
    ResidualBottleneckBlock,
    Sequential,
    conv,
    deconv,
)
from flashgmm_tpu_torch.registry import register_model

from .base import SimpleVAECompressionModel
from .elic_gmm import _elic_groups


@register_model("elic2022-chandelier")
class Elic2022Chandelier(SimpleVAECompressionModel):
    def __init__(self, N=192, M=320, groups=None, *, seed: int = 0,
                 device="cuda", **kwargs):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        self.N, self.M = int(N), int(M)
        self.groups = _elic_groups(M, groups)
        gs = self.groups

        def bottlenecks():
            return [ResidualBottleneckBlock(N, N, generator=g)
                    for _ in range(3)]

        self.g_a = Sequential(
            conv(3, N, kernel_size=5, stride=2, generator=g), *bottlenecks(),
            conv(N, N, kernel_size=5, stride=2, generator=g), *bottlenecks(),
            AttentionBlock(N, generator=g),
            conv(N, N, kernel_size=5, stride=2, generator=g), *bottlenecks(),
            conv(N, M, kernel_size=5, stride=2, generator=g),
            AttentionBlock(M, generator=g),
        )
        self.g_s = Sequential(
            AttentionBlock(M, generator=g),
            deconv(M, N, kernel_size=5, stride=2, generator=g),
            *bottlenecks(),
            deconv(N, N, kernel_size=5, stride=2, generator=g),
            AttentionBlock(N, generator=g), *bottlenecks(),
            deconv(N, N, kernel_size=5, stride=2, generator=g),
            *bottlenecks(),
            deconv(N, 3, kernel_size=5, stride=2, generator=g),
        )
        h_a = Sequential(
            conv(M, N, kernel_size=3, stride=1, generator=g), ReLU(),
            conv(N, N, kernel_size=5, stride=2, generator=g), ReLU(),
            conv(N, N, kernel_size=5, stride=2, generator=g),
        )
        h_s = Sequential(
            deconv(N, N, kernel_size=5, stride=2, generator=g), ReLU(),
            deconv(N, N * 3 // 2, kernel_size=5, stride=2, generator=g),
            ReLU(),
            conv(N * 3 // 2, M * 2, kernel_size=3, stride=1, generator=g),
        )
        channel_context = {
            f"y{k}": Sequential(
                conv(gs[0] + (k > 1) * gs[k - 1], 224, kernel_size=5,
                     stride=1, generator=g),
                ReLU(),
                conv(224, 128, kernel_size=5, stride=1, generator=g),
                ReLU(),
                conv(128, gs[k] * 2, kernel_size=5, stride=1, generator=g),
            )
            for k in range(1, len(gs))
        }
        spatial_context = [
            CheckerboardMaskedConv2d(gs[k], gs[k] * 2, kernel_size=5,
                                     stride=1, padding=2, generator=g)
            for k in range(len(gs))
        ]
        param_aggregation = [
            Sequential(
                Conv2d(gs[k] * 2 + (k > 0) * gs[k] * 2 + M * 2, M * 2, 1,
                       generator=g),
                ReLU(),
                Conv2d(M * 2, 512, 1, generator=g),
                ReLU(),
                Conv2d(512, gs[k] * 2, 1, generator=g),
            )
            for k in range(len(gs))
        ]
        scctx_latent_codec = {
            f"y{k}": CheckerboardLatentCodec(
                latent_codec={
                    "y": GaussianConditionalLatentCodec(
                        quantizer="ste", chunks=("means", "scales")),
                },
                context_prediction=spatial_context[k],
                entropy_parameters=param_aggregation[k],
                forward_method="twopass",
            )
            for k in range(len(gs))
        }
        self.latent_codec = HyperpriorLatentCodec({
            "y": ChannelGroupsLatentCodec(
                groups=gs, channel_context=channel_context,
                latent_codec=scctx_latent_codec,
                context_mode="first_and_last"),
            "hyper": HyperLatentCodec(
                entropy_bottleneck=EntropyBottleneck(N, generator=g),
                h_a=h_a, h_s=h_s, quantizer="ste"),
        })
        self.to(device)

"""ELIC 2022 with GMM entropy coding (port of
flashgmm_tpu/models/elic_gmm.py): uneven channel groups, each coded in
two checkerboard passes (SCCTX), K-mixture GMM conditionals, residual
bottleneck transforms with attention.

Built on the CPU from an explicit ``torch.Generator`` seeded with ``seed``,
then moved to ``device`` (the card unless the caller asks otherwise).
Module paths equal the JAX package's parameter paths (the channel groups'
``channel_context/y1..`` and ``latent_codec/y0..`` included), so its
weights load through ``flashgmm_tpu_torch.zoo.load_npz``, and a
CompressAI/FlashGMM PyTorch state dict through
``flashgmm_tpu_torch.zoo.torch_convert``.
"""

import torch

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.latent_codecs import (
    ChannelGroupsLatentCodec,
    CheckerboardLatentCodec,
    GaussianMixtureConditionalLatentCodec,
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
    sequential_channel_ramp,
)
from flashgmm_tpu_torch.registry import register_model

from .base import SimpleVAECompressionModel


def _conv_factory(ksize, pad):
    def make(in_ch, out_ch, *, generator):
        return Conv2d(in_ch, out_ch, ksize, stride=1, padding=pad,
                      generator=generator)
    return make


def _elic_modules(N, M, groups, params_per_channel, make_codec,
                  forward_method, g):
    """(g_a, g_s, latent codec) of an ELIC model (the reference's
    elic_gmm.py and sensetime.py:83-183 build the same networks): uneven
    channel groups, each coded by a checkerboard codec whose aggregation
    network makes ``params_per_channel`` parameters a channel of its
    group and whose conditional codec is ``make_codec()``. Weights are
    drawn from the ``torch.Generator`` ``g`` in module order."""
    def rbb():
        return ResidualBottleneckBlock(N, N, generator=g)

    g_a = Sequential(
        conv(3, N, kernel_size=5, stride=2, generator=g),
        rbb(), rbb(), rbb(),
        conv(N, N, kernel_size=5, stride=2, generator=g),
        rbb(), rbb(), rbb(),
        AttentionBlock(N, generator=g),
        conv(N, N, kernel_size=5, stride=2, generator=g),
        rbb(), rbb(), rbb(),
        conv(N, M, kernel_size=5, stride=2, generator=g),
        AttentionBlock(M, generator=g),
    )

    g_s = Sequential(
        AttentionBlock(M, generator=g),
        deconv(M, N, kernel_size=5, stride=2, generator=g),
        rbb(), rbb(), rbb(),
        deconv(N, N, kernel_size=5, stride=2, generator=g),
        AttentionBlock(N, generator=g),
        rbb(), rbb(), rbb(),
        deconv(N, N, kernel_size=5, stride=2, generator=g),
        rbb(), rbb(), rbb(),
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
        deconv(N * 3 // 2, N * 2, kernel_size=3, stride=1, generator=g),
    )

    gs = groups
    # g_ch^(t): channel context over the groups decoded before t
    channel_context = {
        f"y{t}": sequential_channel_ramp(
            sum(gs[:t]), gs[t] * 2, min_ch=N, num_layers=3,
            make_layer=_conv_factory(5, 2), make_act=ReLU, generator=g)
        for t in range(1, len(gs))
    }
    # g_sp^(t): checkerboard spatial context of each group
    spatial_context = [
        CheckerboardMaskedConv2d(gs[t], gs[t] * 2, kernel_size=5,
                                 stride=1, padding=2, generator=g)
        for t in range(len(gs))
    ]
    # parameter aggregation: spatial + channel context + side -> the
    # group's parameters
    param_aggregation = [
        sequential_channel_ramp(
            gs[t] * 2 + (t > 0) * gs[t] * 2 + N * 2,
            gs[t] * params_per_channel, min_ch=N * 2, num_layers=3,
            make_layer=_conv_factory(1, 0), make_act=ReLU, generator=g)
        for t in range(len(gs))
    ]
    scctx_latent_codec = {
        f"y{t}": CheckerboardLatentCodec(
            latent_codec={"y": make_codec()},
            context_prediction=spatial_context[t],
            entropy_parameters=param_aggregation[t],
            forward_method=forward_method,
        )
        for t in range(len(gs))
    }

    latent_codec = HyperpriorLatentCodec({
        "y": ChannelGroupsLatentCodec(
            groups=gs, channel_context=channel_context,
            latent_codec=scctx_latent_codec),
        "hyper": HyperLatentCodec(
            entropy_bottleneck=EntropyBottleneck(N, generator=g),
            h_a=h_a, h_s=h_s, quantizer="ste"),
    })
    return g_a, g_s, latent_codec


def _elic_groups(M, groups):
    groups = list(groups) if groups is not None else [16, 16, 32, 64, M - 128]
    if sum(groups) != M:
        raise ValueError(f"groups {groups} do not sum to M={M}")
    return groups


@register_model("elic2022-official")
class Elic2022GMM(SimpleVAECompressionModel):
    def __init__(self, N=192, M=320, K=4, quantizer: str = "noise",
                 groups=None, *, seed: int = 0, device="cuda"):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        self.N, self.M, self.K = int(N), int(M), int(K)
        self.groups = _elic_groups(M, groups)
        self.g_a, self.g_s, self.latent_codec = _elic_modules(
            N, M, self.groups, 3 * self.K,
            lambda: GaussianMixtureConditionalLatentCodec(
                K=self.K, quantizer=quantizer),
            "onepass", g)
        self.to(device)

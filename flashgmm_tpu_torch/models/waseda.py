"""The Cheng2020 models (port of flashgmm_tpu/models/waseda.py; CompressAI's
models/waseda.py:46-160): ``Cheng2020Anchor`` and ``Cheng2020Attention``,
the joint autoregressive prior (``google.JointAutoregressiveHierarchical
Priors``, M = N) with residual transforms, with attention in the second.
The transforms g_a, h_a, h_s and g_s are shared with the checkerboard
models (the GMM flagship and the single-Gaussian
``Cheng2020AnchorCheckerboard``); each is built from the
``torch.Generator`` ``g``, drawing its weights in module order."""

from flashgmm_tpu_torch.layers import (
    AttentionBlock,
    LeakyReLU,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    Sequential,
    conv3x3,
    subpel_conv3x3,
)
from flashgmm_tpu_torch.registry import register_model

from .google import JointAutoregressiveHierarchicalPriors, _generator


def _cheng_g_a(N, g):
    return Sequential(
        ResidualBlockWithStride(3, N, stride=2, generator=g),
        ResidualBlock(N, N, generator=g),
        ResidualBlockWithStride(N, N, stride=2, generator=g),
        ResidualBlock(N, N, generator=g),
        ResidualBlockWithStride(N, N, stride=2, generator=g),
        ResidualBlock(N, N, generator=g),
        conv3x3(N, N, stride=2, generator=g),
    )


def _cheng_h_a(N, g):
    return Sequential(
        conv3x3(N, N, generator=g), LeakyReLU(),
        conv3x3(N, N, generator=g), LeakyReLU(),
        conv3x3(N, N, stride=2, generator=g), LeakyReLU(),
        conv3x3(N, N, generator=g), LeakyReLU(),
        conv3x3(N, N, stride=2, generator=g),
    )


def _cheng_h_s(N, g):
    return Sequential(
        conv3x3(N, N, generator=g), LeakyReLU(),
        subpel_conv3x3(N, N, 2, generator=g), LeakyReLU(),
        conv3x3(N, N * 3 // 2, generator=g), LeakyReLU(),
        subpel_conv3x3(N * 3 // 2, N * 3 // 2, 2, generator=g), LeakyReLU(),
        conv3x3(N * 3 // 2, N * 2, generator=g),
    )


def _cheng_g_s(N, g):
    return Sequential(
        ResidualBlock(N, N, generator=g),
        ResidualBlockUpsample(N, N, 2, generator=g),
        ResidualBlock(N, N, generator=g),
        ResidualBlockUpsample(N, N, 2, generator=g),
        ResidualBlock(N, N, generator=g),
        ResidualBlockUpsample(N, N, 2, generator=g),
        ResidualBlock(N, N, generator=g),
        subpel_conv3x3(N, 3, 2, generator=g),
    )


@register_model("cheng2020-anchor")
class Cheng2020Anchor(JointAutoregressiveHierarchicalPriors):
    def __init__(self, N=192, *, seed: int = 0, device="cuda", generator=None,
                 **kwargs):
        g = _generator(seed, generator)
        super().__init__(N=N, M=N, device="cpu", generator=g, **kwargs)
        self.g_a = _cheng_g_a(N, g)
        self.h_a = _cheng_h_a(N, g)
        self.h_s = _cheng_h_s(N, g)
        self.g_s = _cheng_g_s(N, g)
        self.to(device)


@register_model("cheng2020-attn")
class Cheng2020Attention(Cheng2020Anchor):
    def __init__(self, N=192, *, seed: int = 0, device="cuda", generator=None,
                 **kwargs):
        g = _generator(seed, generator)
        super().__init__(N=N, device="cpu", generator=g, **kwargs)
        self.g_a = Sequential(
            ResidualBlockWithStride(3, N, stride=2, generator=g),
            ResidualBlock(N, N, generator=g),
            ResidualBlockWithStride(N, N, stride=2, generator=g),
            AttentionBlock(N, generator=g),
            ResidualBlock(N, N, generator=g),
            ResidualBlockWithStride(N, N, stride=2, generator=g),
            ResidualBlock(N, N, generator=g),
            conv3x3(N, N, stride=2, generator=g),
            AttentionBlock(N, generator=g),
        )
        self.g_s = Sequential(
            AttentionBlock(N, generator=g),
            ResidualBlock(N, N, generator=g),
            ResidualBlockUpsample(N, N, 2, generator=g),
            ResidualBlock(N, N, generator=g),
            ResidualBlockUpsample(N, N, 2, generator=g),
            AttentionBlock(N, generator=g),
            ResidualBlock(N, N, generator=g),
            ResidualBlockUpsample(N, N, 2, generator=g),
            ResidualBlock(N, N, generator=g),
            subpel_conv3x3(N, 3, 2, generator=g),
        )
        self.to(device)

"""The Cheng2020 transforms (port of flashgmm_tpu/models/waseda.py:24-54,
and the g_a that the reference writes out in each model): g_a, h_a, h_s
and g_s, shared by the checkerboard models (the GMM flagship and the
single-Gaussian ``Cheng2020AnchorCheckerboard``). Each is built from the
``torch.Generator`` ``g``, drawing its weights in module order."""

from flashgmm_tpu_torch.layers import (
    LeakyReLU,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    Sequential,
    conv3x3,
    subpel_conv3x3,
)


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

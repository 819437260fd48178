"""NN building blocks over NHWC tensors (port of
flashgmm_tpu/layers/layers.py).

Parameters use PyTorch's layouts (conv weights OIHW, named ``weight``) and
the JAX package's module paths, so ``zoo.npz.load_jax_params`` maps one onto
the other. Convolutions keep NHWC at their boundary: the input is viewed as
NCHW with channels-last strides (no copy) for ``F.conv2d``.

:func:`run_canonical` is the rows-chain forward: every stride-1 "same" conv
goes through the hand conv kernel in float32, so the encoder and the decoder
compute bitwise-identical entropy parameters.

:func:`route_bf16_kernel` marks a bf16 transform (the port's counterpart of
the reference's ``use_pallas_conv`` at trace time): its stride-1 "same"
convs of at least 64 channels then run the bf16 conv kernel (whatever the
input's float type: the kernel computes in bf16), and the blocks fuse their LeakyReLU and residual add into the
kernel's epilogue.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from flashgmm_tpu_torch.ops import conv_kernel
from flashgmm_tpu_torch.ops.conv_kernel import leaky_relu

from .gdn import GDN


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return leaky_relu(x, self.negative_slope)


class Sequential(nn.Module):
    """Ordered container; children live under ``layers.<i>`` as in the JAX
    package's parameter paths."""

    def __init__(self, *layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        layers = list(self.layers)
        i = 0
        while i < len(layers):
            layer = layers[i]
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            if (isinstance(layer, Conv2d) and layer.kernel_route
                    and isinstance(nxt, LeakyReLU)):
                x = layer.forward_fused(x, negative_slope=nxt.negative_slope)
                i += 2
            else:
                x = layer(x)
                i += 1
        return x

    def __iter__(self):
        return iter(self.layers)

    def __getitem__(self, i):
        return self.layers[i]


class Conv2d(nn.Module):
    """2D convolution over NHWC with explicit symmetric padding.

    Initialised as torch's Conv2d (Kaiming-uniform, a=sqrt(5)) from an
    explicit ``torch.Generator``.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, use_bias: bool = True, *, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.in_ch = in_ch
        self.out_ch = out_ch
        fan_in = kh * kw * in_ch
        self.weight = nn.Parameter(_uniform(
            (out_ch, in_ch, kh, kw), math.sqrt(3.0 / fan_in), generator))
        self.bias = (nn.Parameter(_uniform((out_ch,), 1.0 / math.sqrt(fan_in),
                                           generator))
                     if use_bias else None)

    kernel_route = False  # set by route_bf16_kernel

    def _weight(self):
        return self.weight

    def route_bf16_kernel(self):
        """Send this conv through the bf16 conv kernel from now on, if the
        kernel's rule takes it; the weights are frozen in its layout."""
        k = tuple(self.weight.shape[-2:])
        if not conv_kernel.bf16_route_takes(self.in_ch, self.out_ch, k,
                                            self.stride, self.padding):
            return
        self._kernel_w = conv_kernel.pack_bf16_weight(self.kernel_hwio())
        self._kernel_b = (None if self.bias is None
                          else self.bias.detach().float())
        self.kernel_route = True

    def forward_fused(self, x, negative_slope=None, residual=None):
        """conv -> LeakyReLU (if ``negative_slope``) -> + ``residual``: one
        kernel launch with a bf16 result on a routed conv, else the library
        conv and the elementwise ops."""
        if self.kernel_route:
            return conv_kernel.conv2d_nhwc_bf16(
                x, self._kernel_w, self._kernel_b,
                negative_slope=negative_slope, residual=residual)
        y = self(x)
        if negative_slope is not None:
            y = leaky_relu(y, negative_slope)
        return y if residual is None else y + residual

    def forward(self, x):
        if self.kernel_route:
            return self.forward_fused(x)
        w = self._weight()
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                     None if self.bias is None else self.bias.to(x.dtype),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)

    def kernel_hwio(self):
        """The (masked) weight as a contiguous float32 HWIO kernel."""
        return self._weight().detach().float().permute(2, 3, 1, 0).contiguous()

    def canonical(self, x, negative_slope=None):
        """Rows-chain forward through the hand conv kernel (float32)."""
        k = self.weight.shape[-1]
        if (self.stride != (1, 1) or self.weight.shape[-2] != k
                or self.padding != (k // 2, k // 2)):
            raise ValueError("the rows-chain conv kernel takes stride-1 "
                             "'same' square convs only")
        return conv_kernel.conv2d_nhwc(
            x.float().contiguous(), self.kernel_hwio(),
            None if self.bias is None else self.bias.float(),
            negative_slope=negative_slope)


def conv3x3(in_ch, out_ch, stride=1, *, generator=None):
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                  generator=generator)


def conv1x1(in_ch, out_ch, stride=1, *, generator=None):
    return Conv2d(in_ch, out_ch, 1, stride=stride, padding=0,
                  generator=generator)


def pixel_shuffle(x, r: int):
    """NHWC pixel shuffle: [N,H,W,C*r*r] -> [N,H*r,W*r,C], with
    torch.nn.PixelShuffle's channel order."""
    n, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # n, h, i, w, j, c
    return x.reshape(n, h * r, w * r, c)


class PixelShuffle(nn.Module):
    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_shuffle(x, self.r)


def subpel_conv3x3(in_ch, out_ch, r=1, *, generator=None):
    """3x3 sub-pixel convolution for up-sampling."""
    return Sequential(
        Conv2d(in_ch, out_ch * r * r, 3, padding=1, generator=generator),
        PixelShuffle(r))


class MaskedConv2d(Conv2d):
    """Masked conv for autoregressive context models: type 'A' masks the
    current pixel, 'B' keeps it. The mask multiplies the weight."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 mask_type: str = "A", *, generator=None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         generator=generator)
        if mask_type not in ("A", "B"):
            raise ValueError(f'Invalid "mask_type" value "{mask_type}"')
        kh, kw = self.weight.shape[-2:]
        mask = torch.ones(1, 1, kh, kw)
        mask[:, :, kh // 2, kw // 2 + (mask_type == "B"):] = 0
        mask[:, :, kh // 2 + 1:] = 0
        self.register_buffer("mask", mask, persistent=False)

    def _weight(self):
        return self.weight * self.mask


class CheckerboardMaskedConv2d(MaskedConv2d):
    """Checkerboard-masked conv (He2021): sees only anchor positions (and
    the center for type 'B')."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 mask_type: str = "A", *, generator=None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         mask_type=mask_type, generator=generator)
        kh, kw = self.weight.shape[-2:]
        mask = torch.ones(1, 1, kh, kw)
        mask[:, :, 0::2, 0::2] = 0
        mask[:, :, 1::2, 1::2] = 0
        mask[:, :, kh // 2, kw // 2] = 1.0 if mask_type == "B" else 0.0
        self.mask.copy_(mask)


class ResidualBlockWithStride(nn.Module):
    """conv3x3(s) -> lrelu -> conv3x3 -> GDN + skip."""

    def __init__(self, in_ch, out_ch, stride=2, *, generator=None):
        super().__init__()
        self.conv1 = conv3x3(in_ch, out_ch, stride=stride, generator=generator)
        self.conv2 = conv3x3(out_ch, out_ch, generator=generator)
        self.gdn = GDN(out_ch)
        self.skip = (conv1x1(in_ch, out_ch, stride=stride, generator=generator)
                     if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        identity = x if self.skip is None else self.skip(x)
        out = self.conv1.forward_fused(x, negative_slope=0.01)
        out = self.gdn(self.conv2(out))
        return out + identity


class ResidualBlockUpsample(nn.Module):
    """subpel conv -> lrelu -> conv3x3 -> IGDN + subpel skip.

    ``fuse=True`` (the default, as in the reference) runs the main and the
    skip subpel convs, which read the same input with the same geometry, as
    one conv with twice the output channels.
    """

    def __init__(self, in_ch, out_ch, upsample=2, *, fuse: bool = True,
                 generator=None):
        super().__init__()
        self.subpel_conv = subpel_conv3x3(in_ch, out_ch, upsample,
                                          generator=generator)
        self.conv = conv3x3(out_ch, out_ch, generator=generator)
        self.igdn = GDN(out_ch, inverse=True)
        self.upsample = subpel_conv3x3(in_ch, out_ch, upsample,
                                       generator=generator)
        self.fuse = bool(fuse)
        self.kernel_route = False  # set by route_bf16_kernel

    def route_bf16_kernel(self):
        """Send the fused subpel conv through the bf16 conv kernel from now
        on, if the kernel's rule takes it (the unfused convs route alone)."""
        c1, c2 = self.subpel_conv.layers[0], self.upsample.layers[0]
        if not (self.fuse and conv_kernel.bf16_route_takes(
                c1.in_ch, c1.out_ch + c2.out_ch, tuple(c1.weight.shape[-2:]),
                c1.stride, c1.padding)):
            return
        self._kernel_w = conv_kernel.pack_bf16_weight(
            torch.cat([c1.kernel_hwio(), c2.kernel_hwio()], dim=-1))
        self._kernel_b = torch.cat([c1.bias, c2.bias]).detach().float()
        self.kernel_route = True

    def forward(self, x):
        if self.fuse:
            c1, c2 = self.subpel_conv.layers[0], self.upsample.layers[0]
            r = self.subpel_conv.layers[1].r
            if self.kernel_route:
                y = conv_kernel.conv2d_nhwc_bf16(x, self._kernel_w,
                                                 self._kernel_b)
            else:
                w = torch.cat([c1.weight, c2.weight]).to(x.dtype)
                b = torch.cat([c1.bias, c2.bias]).to(x.dtype)
                y = F.conv2d(x.permute(0, 3, 1, 2), w, b, c1.stride,
                             c1.padding).permute(0, 2, 3, 1)
            n_out = c1.weight.shape[0]
            out = pixel_shuffle(y[..., :n_out], r)
            identity = pixel_shuffle(y[..., n_out:], r)
        else:
            identity = self.upsample(x)
            out = self.subpel_conv(x)
        out = leaky_relu(out)
        out = self.igdn(self.conv(out))
        return out + identity


class ResidualBlock(nn.Module):
    """Two 3x3 convs with leaky relu."""

    def __init__(self, in_ch, out_ch, *, generator=None):
        super().__init__()
        self.conv1 = conv3x3(in_ch, out_ch, generator=generator)
        self.conv2 = conv3x3(out_ch, out_ch, generator=generator)
        self.skip = (conv1x1(in_ch, out_ch, generator=generator)
                     if in_ch != out_ch else None)

    def forward(self, x):
        identity = x if self.skip is None else self.skip(x)
        out = self.conv1.forward_fused(x, negative_slope=0.01)
        return self.conv2.forward_fused(out, negative_slope=0.01,
                                        residual=identity)


def route_bf16_kernel(module):
    """Mark every conv of ``module`` that the bf16 conv kernel takes
    (``conv_kernel.bf16_route_takes``), and the fused subpel convs of its
    ResidualBlockUpsamples, to run through that kernel from now on. Call
    it on a transform whose parameters are final (the codec's bf16
    snapshots): the kernel's weights are frozen at this call."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ResidualBlockUpsample)):
            m.route_bf16_kernel()
    return module


def run_canonical(module, x):
    """Rows-chain forward of a conv, or of a Sequential of convs, pixel
    shuffles and LeakyReLUs: every conv goes through the hand conv kernel in
    float32, and a LeakyReLU right after a conv fuses into its epilogue."""
    if isinstance(module, Conv2d):
        return module.canonical(x)
    if not isinstance(module, Sequential):
        return module(x)
    layers = list(module.layers)
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if isinstance(layer, Conv2d) and isinstance(nxt, LeakyReLU):
            x = layer.canonical(x, negative_slope=nxt.negative_slope)
            i += 2
        else:
            x = run_canonical(layer, x)
            i += 1
    return x

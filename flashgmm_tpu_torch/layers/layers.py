"""NN building blocks over NHWC tensors (port of
flashgmm_tpu/layers/layers.py).

Parameters use PyTorch's layouts (conv weights OIHW, named ``weight``) and
the JAX package's module paths, so ``zoo.npz.load_jax_params`` maps one onto
the other. Convolutions keep NHWC at their boundary: the input is viewed as
NCHW with channels-last strides (no copy) for ``F.conv2d``.

:func:`run_canonical` is the rows-chain forward: every stride-1 "same" conv,
and every transposed conv as a zero-inserted "same" conv, goes through the
hand conv kernel in float32, so the encoder and the decoder compute
bitwise-identical entropy parameters.

:func:`route_bf16_kernel` marks a bf16 transform (the port's counterpart of
the reference's ``use_pallas_conv`` at trace time): its stride-1 "same"
convs of at least 64 channels then run the bf16 conv kernel (whatever the
input's float type: the kernel computes in bf16), and the blocks fuse their LeakyReLU and residual add into the
kernel's epilogue.
"""

import math
from contextlib import contextmanager

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


def _library_input(x, weight):
    """NHWC x as the NCHW input of a library conv: a channels-last view of
    x, except where autograd records a conv on the CPU. There it is a
    contiguous copy: PyTorch 2.13's oneDNN backward over the view corrupts
    the heap (a strided conv over few channels, such as g_a's first skip
    conv, 1x1 stride 2 over 3), and the process aborts a few backwards
    later. The card's convs and every conv without autograd keep the view:
    the memory format picks the library's algorithm, and with it the
    coded bytes."""
    v = x.permute(0, 3, 1, 2)
    if v.device.type == "cpu" and torch.is_grad_enabled() \
            and (v.requires_grad or weight.requires_grad):
        return v.contiguous()
    return v


def _activation(x, negative_slope):
    """LeakyReLU with ``negative_slope``; slope 0 is ``torch.relu``."""
    return torch.relu(x) if negative_slope == 0.0 else leaky_relu(
        x, negative_slope)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return _activation(x, self.negative_slope)


class ReLU(LeakyReLU):
    """ReLU, a LeakyReLU of slope 0: a conv's kernel epilogue applies it as
    such (``slope * v`` for v < 0, so -0.0 where ``torch.relu`` gives
    +0.0; the plain version rounds the same way)."""

    def __init__(self):
        super().__init__(0.0)


class Sequential(nn.Module):
    """Ordered container; children live under ``layers.<i>`` as in the JAX
    package's parameter paths."""

    def __init__(self, *layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        return _run_fused(list(self.layers), x, _kernel_route_fused,
                          nn.Module.__call__)

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
        w = self.kernel_hwio()
        if not conv_kernel.bf16_route_takes(self.in_ch, self.out_ch,
                                            tuple(w.shape[:2]), self.stride,
                                            self.padding):
            return
        self._kernel_w = conv_kernel.pack_bf16_weight(w)
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
            y = _activation(y, negative_slope)
        return y if residual is None else y + residual

    def forward(self, x):
        if self.kernel_route:
            return self.forward_fused(x)
        w = self._weight()
        y = F.conv2d(_library_input(x, w), w.to(x.dtype),
                     None if self.bias is None else self.bias.to(x.dtype),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)

    def kernel_hwio(self):
        """The (masked) weight as a contiguous float32 HWIO kernel."""
        return self._weight().detach().float().permute(2, 3, 1, 0).contiguous()

    def canonical(self, x, negative_slope=None):
        """Rows-chain forward through the hand conv kernel (float32)."""
        w = self.kernel_hwio()
        k = w.shape[1]
        if (self.stride != (1, 1) or w.shape[0] != k
                or self.padding != (k // 2, k // 2)):
            raise ValueError("the rows-chain conv kernel takes stride-1 "
                             "'same' square convs only")
        return conv_kernel.conv2d_nhwc(
            x.float().contiguous(), w,
            None if self.bias is None else self.bias.float(),
            negative_slope=negative_slope)


class ConvTranspose2d(nn.Module):
    """Transposed conv over NHWC with torch's ConvTranspose2d semantics
    (padding ``k - 1 - p``, ``output_padding`` on the bottom and right).
    The weight keeps torch's layout [in, out, kh, kw]; the JAX package
    stores it [kh, kw, in, out] (``zoo.npz.load_jax_params`` maps one onto
    the other). Initialised as the JAX package's (fan-in over the output
    channels, as torch counts it) from an explicit ``torch.Generator``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, output_padding=0, use_bias: bool = True, *,
                 generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.in_ch = in_ch
        self.out_ch = out_ch
        fan_in = kh * kw * out_ch
        self.weight = nn.Parameter(_uniform(
            (in_ch, out_ch, kh, kw), math.sqrt(3.0 / fan_in), generator))
        self.bias = (nn.Parameter(_uniform((out_ch,), 1.0 / math.sqrt(fan_in),
                                           generator))
                     if use_bias else None)

    def _weight(self):
        return self.weight

    def forward(self, x):
        w = self._weight()
        y = F.conv_transpose2d(
            _library_input(x, w), w.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype),
            self.stride, self.padding, self.output_padding)
        return y.permute(0, 2, 3, 1)

    def kernel_hwio(self):
        """The equivalent stride-1 conv's kernel: the weight flipped
        spatially, as a contiguous float32 HWIO [kh, kw, in, out]."""
        return self._weight().detach().float().permute(2, 3, 0, 1).flip(
            0, 1).contiguous()

    def canonical(self, x, negative_slope=None):
        """Rows-chain forward through the hand conv kernel (float32): the
        input zero-inserted to [B, sH, sW, C] (values at ``[:, ::s, ::s]``),
        then a stride-1 "same" conv with the flipped kernel. That pads the
        dilated input by k//2 before and k//2 + s - 1 after, which is
        torch's ``k - 1 - p`` and ``k - 1 - p + output_padding`` for a
        square odd k, p = k//2 and output_padding = s - 1 (CompressAI's
        ``deconv``). The inserted zeros leave each output's fmaf chain
        unchanged (fma(0, w, acc) == acc), so its bits depend only on the
        fixed (dy, dx, c_in) order, as in every rows-chain conv."""
        kernel = self.kernel_hwio()
        kh, kw = kernel.shape[:2]
        s = self.stride[0]
        if (kh != kw or kh % 2 == 0 or self.stride != (s, s)
                or self.padding != (kh // 2, kh // 2)
                or self.output_padding != (s - 1, s - 1)):
            raise ValueError("the rows-chain conv kernel takes transposed "
                             "convs with a square odd k, padding k//2 and "
                             "output_padding stride - 1 only")
        x = x.float()
        if s > 1:
            b, h, w, c = x.shape
            up = x.new_zeros((b, s * h, s * w, c))
            up[:, ::s, ::s] = x
            x = up
        return conv_kernel.conv2d_nhwc(
            x.contiguous(), kernel,
            None if self.bias is None else self.bias.float(),
            negative_slope=negative_slope)


class SpectralConv2d(Conv2d):
    """Conv with its weight stored in the real-FFT domain (Balle 2018
    "spectral Adam"; the reference's layers.py:59-106): the parameter
    ``weight_transformed`` is ``torch.fft.rfftn`` of the OIHW weight over
    (kh, kw) (``norm="ortho"``, complex [out, in, kh, kw//2+1]), rebuilt by
    ``irfftn`` at every call, so that an optimizer's steps reach every
    frequency alike."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 use_bias: bool = True, *, generator=None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         use_bias, generator=generator)
        w = self.weight.detach()
        del self.weight
        self.kernel_size_hw = tuple(w.shape[-2:])
        self.weight_transformed = nn.Parameter(torch.fft.rfftn(
            w, s=self.kernel_size_hw, dim=(-2, -1), norm="ortho"))

    def _weight(self):
        return torch.fft.irfftn(self.weight_transformed, s=self.kernel_size_hw,
                                dim=(-2, -1), norm="ortho")


class SpectralConvTranspose2d(ConvTranspose2d):
    """Transposed variant of :class:`SpectralConv2d`: the real FFT of the
    [in, out, kh, kw] weight over (kh, kw)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 output_padding=0, use_bias: bool = True, *, generator=None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         output_padding, use_bias, generator=generator)
        w = self.weight.detach()
        del self.weight
        self.kernel_size_hw = tuple(w.shape[-2:])
        self.weight_transformed = nn.Parameter(torch.fft.rfftn(
            w, s=self.kernel_size_hw, dim=(-2, -1), norm="ortho"))

    def _weight(self):
        return torch.fft.irfftn(self.weight_transformed, s=self.kernel_size_hw,
                                dim=(-2, -1), norm="ortho")


def conv(in_ch, out_ch, kernel_size=5, stride=2, *, generator=None):
    """CompressAI's default strided conv (models/utils.py ``conv``)."""
    return Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                  padding=kernel_size // 2, generator=generator)


def deconv(in_ch, out_ch, kernel_size=5, stride=2, *, generator=None):
    """CompressAI's default up-sampling deconv (models/utils.py
    ``deconv``)."""
    return ConvTranspose2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=kernel_size // 2,
                           output_padding=stride - 1, generator=generator)


def conv3x3(in_ch, out_ch, stride=1, *, generator=None):
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                  generator=generator)


def conv1x1(in_ch, out_ch, stride=1, *, generator=None):
    return Conv2d(in_ch, out_ch, 1, stride=stride, padding=0,
                  generator=generator)


def linear(in_f, out_f, generator=None):
    """``nn.Linear`` with a weight uniform in +-1/sqrt(in) from
    ``generator`` and a zero bias (nnx.Linear's default bias)."""
    lin = nn.Linear(in_f, out_f)
    with torch.no_grad():
        bound = 1.0 / in_f ** 0.5
        lin.weight.copy_((torch.rand((out_f, in_f), generator=generator)
                          * 2.0 - 1.0) * bound)
        lin.bias.zero_()
    return lin


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
                y = F.conv2d(_library_input(x, w), w, b, c1.stride,
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


def _run_fused(layers, x, fused, run):
    """A list of layers in order. Where ``fused(layer)`` gives a call
    ``f(x, negative_slope=None)`` and a LeakyReLU (or ReLU) follows the
    layer, the activation runs inside that call; every other layer runs as
    ``run(layer, x)``."""
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        f = fused(layer)
        if f is not None and isinstance(nxt, LeakyReLU):
            x = f(x, negative_slope=nxt.negative_slope)
            i += 2
        else:
            x = run(layer, x)
            i += 1
    return x


def _kernel_route_fused(layer):
    """A Conv2d on the kernel route fuses into its bf16 kernel's epilogue."""
    if isinstance(layer, Conv2d) and layer.kernel_route:
        return layer.forward_fused
    return None


def _canonical_fused(layer):
    """Every rows-chain conv fuses into the f32 kernel's epilogue."""
    if isinstance(layer, (Conv2d, ConvTranspose2d)):
        return layer.canonical
    return None


class ResidualBottleneckBlock(nn.Module):
    """1x1 -> relu -> 3x3 -> relu -> 1x1 + skip, ELIC's block
    (reference models/elic_gmm.py:238-274). On the kernel route the relus
    and the residual add fuse into the convs' epilogues."""

    def __init__(self, in_ch, out_ch, *, generator=None):
        super().__init__()
        mid_ch = min(in_ch, out_ch) // 2
        self.conv1 = conv1x1(in_ch, mid_ch, generator=generator)
        self.conv2 = conv3x3(mid_ch, mid_ch, generator=generator)
        self.conv3 = conv1x1(mid_ch, out_ch, generator=generator)
        self.skip = (conv1x1(in_ch, out_ch, generator=generator)
                     if in_ch != out_ch else None)

    def forward(self, x):
        identity = x if self.skip is None else self.skip(x)
        out = self.conv1.forward_fused(x, negative_slope=0.0)
        out = self.conv2.forward_fused(out, negative_slope=0.0)
        return self.conv3.forward_fused(out, residual=identity)


class _ResidualUnit(nn.Module):
    """relu(conv(x) + x) over conv = 1x1 -> relu -> 3x3 -> relu -> 1x1.
    The residual fuses into the last conv's epilogue; its relu comes after
    the residual, which the epilogue's order (bias, activation, residual)
    does not allow, so it stays a separate op."""

    def __init__(self, N, *, generator=None):
        super().__init__()
        self.conv = Sequential(
            conv1x1(N, N // 2, generator=generator), ReLU(),
            conv3x3(N // 2, N // 2, generator=generator), ReLU(),
            conv1x1(N // 2, N, generator=generator))

    def forward(self, x):
        layers = list(self.conv.layers)
        h = _run_fused(layers[:-1], x, _kernel_route_fused,
                       nn.Module.__call__)
        return torch.relu(layers[-1].forward_fused(h, residual=x))


class AttentionBlock(nn.Module):
    """Cheng2020's simplified attention block: x + a * sigmoid(b)
    (reference layers.py:285-336)."""

    def __init__(self, N, *, generator=None):
        super().__init__()
        self.conv_a = Sequential(*(_ResidualUnit(N, generator=generator)
                                   for _ in range(3)))
        self.conv_b = Sequential(*(_ResidualUnit(N, generator=generator)
                                   for _ in range(3)),
                                 conv1x1(N, N, generator=generator))

    def forward(self, x):
        a = self.conv_a(x)
        b = self.conv_b(x)
        return x + a * torch.sigmoid(b)


def sequential_channel_ramp(in_ch: int, out_ch: int, *, min_ch: int = 0,
                            num_layers: int = 3, make_layer=None,
                            make_act=None, generator=None):
    """Layers of linearly ramping channel counts (the inner ones at least
    ``min_ch``) with an activation between each two (reference
    layers.py:391-417)."""
    channels = [int(math.floor(in_ch + (out_ch - in_ch) * i / num_layers))
                for i in range(num_layers + 1)]
    channels[1:-1] = [max(c, min_ch) for c in channels[1:-1]]
    layers = []
    for ch_in, ch_out in zip(channels[:-1], channels[1:]):
        layers += [make_layer(ch_in, ch_out, generator=generator), make_act()]
    return Sequential(*layers[:-1])


class _QReLU(torch.autograd.Function):
    """Forward: ``clip(x, 0, 2**bit_depth - 1)``. Backward: the incoming
    gradient inside the range, and outside it the smooth surrogate
    ``exp(-alpha**beta * |2x / max - 1|**beta)`` times it (CompressAI's
    layers.py:339-388; the JAX package's ``jax.custom_vjp``)."""

    ALPHA = 0.9943258522851727

    @staticmethod
    def forward(ctx, x, bit_depth, beta):
        ctx.save_for_backward(x)
        ctx.bit_depth, ctx.beta = bit_depth, beta
        return torch.clamp(x, 0.0, float(2 ** bit_depth - 1))

    @staticmethod
    def _integer_pow(x, n):
        """x ** n by squaring, JAX's ``lax.integer_pow`` multiply for
        multiply (torch's float pow rounds otherwise, and the exponent
        magnifies it)."""
        acc = None
        while n > 0:
            if n & 1:
                acc = x if acc is None else acc * x
            n >>= 1
            if n > 0:
                x = x * x
        return acc

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        max_value = float(2 ** ctx.bit_depth - 1)
        grad_sub = torch.exp(
            -(_QReLU.ALPHA ** ctx.beta)
            * _QReLU._integer_pow(torch.abs(2.0 * x / max_value - 1),
                                  int(ctx.beta))) * grad
        outside = (x < 0) | (x > max_value)
        return torch.where(outside, grad_sub, grad), None, None


def qrelu(x, bit_depth: int = 8, beta: int = 100):
    """The integer network's clamp to [0, 2**bit_depth - 1] with a smooth
    surrogate gradient outside it (``_QReLU``)."""
    return _QReLU.apply(x, bit_depth, beta)


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
    """Rows-chain forward of a conv, a transposed conv, a module with a
    ``canonical`` forward of its own, or a Sequential of them, pixel
    shuffles, LeakyReLUs and ReLUs: every conv goes through the hand conv
    kernel in float32, and an activation right after a conv fuses into its
    epilogue (a ReLU as slope 0)."""
    if hasattr(module, "canonical"):
        return module.canonical(x)
    if not isinstance(module, Sequential):
        return module(x)
    return _run_fused(list(module.layers), x, _canonical_fused,
                      run_canonical)


@contextmanager
def pinned_library_settings():
    """The library settings the transforms run under, whatever the caller
    set: cuDNN on, no autotuning by timing, deterministic algorithms only,
    no TF32 in convs or matmuls (GDN's), so that no global setting of the
    caller changes the quantized latents, and so the bytes."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = prev


def run_transform(module, x, dtype=torch.float32):
    """A transform (g_a, h_a, g_s) on x in ``dtype``: x copied into a tensor
    of canonical strides first, the module run under
    :func:`pinned_library_settings`; float32 out. PyTorch picks cuDNN's
    memory format, and with it the algorithm and its roundings, from the
    strides, and a caller's batch-1 tensor may carry any stride on its
    size-1 batch dimension (0 from numpy's ``img[None]``, H*W*3 from a
    slice of a batch): the bytes differed between two such callers (ROADMAP
    C9)."""
    canonical = torch.empty(x.shape, dtype=dtype, device=x.device)
    with pinned_library_settings():
        return module(canonical.copy_(x)).float()

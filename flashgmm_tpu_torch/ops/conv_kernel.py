"""Hand-written CUDA convs: float32 for the rows chain, bf16 for the
transforms.

``conv2d_nhwc`` replaces flashgmm_tpu/ops/pallas_conv.py::_conv_kernel
(source: ``flashgmm_tpu_torch/csrc/conv_kernel.cu``): a stride-1 "same" KxK
conv over NHWC, K odd, float32 with float32 accumulation, with bias,
LeakyReLU and a residual add fused into the epilogue. It takes any width
and channel count (the TPU kernel's ``w % 8`` and ``C >= 64`` rules do not
apply).

On the rows chain its job is bitwise reproducibility: each output is one
float32 fmaf chain in the fixed order (dy, dx, c_in), in one thread, so its
bits depend only on its input neighbourhood and the weights, never on the
batch size, the tile shape, the shapes around it or a library's algorithm
choice. The encoder and the decoder therefore compute identical CDF rows.

Design: an implicit GEMM (M = output pixels, N = C_out, reduction over
(dy, dx, c_in)) with a 4-deep cp.async pipeline of shared-memory tiles and
8x8 (4x4 for the smaller tile shapes) register tiles per thread; the tile
shape follows the problem's shape so the small rows-chain layers still
fill the card. What bounds it: float32 FMA issue on the CUDA cores (no tensor
cores). ``conv2d_nhwc.launches`` counts launches. The wrapper takes the
plain version only for CPU tensors. ``conv2d_nhwc_plain`` is the kernel's
arithmetic, so the two are equal bit for bit and the port's CPU codec and
its card codec compute the same rows: the same fmaf chain per output (a
true FMA, emulated exactly by ``xla_math._fma``), then the same epilogue.

``conv2d_nhwc_bf16`` is the same kernel's bf16 route (its default
``compute_dtype``; source ``flashgmm_tpu_torch/csrc/conv_bf16.cu``): x and
w in bf16 on the tensor cores (wgmma, fed by TMA in a persistent,
warp-specialised kernel), an f32 accumulator, the epilogue in f32 and one
rounding to the output type. The transforms g_a, h_a and g_s take it when
the codec is built with ``kernel_transforms=True`` (``bf16_route_takes`` is
the rule); they hand it weights packed once in the kernel's layout
(``pack_bf16_weight``). No bit-equality is asked of it: its plain version
sums in another order and the two agree within a bf16 ulp.
"""

import ctypes
from contextlib import contextmanager
from typing import NamedTuple

import torch
import torch.nn.functional as F

from flashgmm_tpu_torch import _build
from flashgmm_tpu_torch.entropy_models.xla_math import _fma


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def conv2d_nhwc_plain(x, w, b=None, *, negative_slope=None, residual=None):
    """The plain version, the kernel's arithmetic (csrc/conv_kernel.cu):
    each output is one float32 FMA chain over k = (dy, dx, c_in) in that
    order from +0, taps outside the image included as zeros (fma(0, w,
    acc) == acc), then the epilogue rounded as the kernel rounds it: + bias,
    LeakyReLU (slope * v for v < 0), + residual. Vectorized over pixels and
    C_out, sequential over k."""
    n, h, wd, _ = x.shape
    k, c_in, c_out = w.shape[0], w.shape[2], w.shape[3]
    p = k // 2
    xp = F.pad(x.float(), (0, 0, p, p, p, p))  # the zero-filled taps
    w = w.float()
    acc = torch.zeros((n, h, wd, c_out), dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            win = xp[:, dy:dy + h, dx:dx + wd, :]
            for ci in range(c_in):
                acc = _fma(win[..., ci:ci + 1], w[dy, dx, ci], acc)
    if b is not None:
        acc = acc + b.float()
    if negative_slope is not None:
        acc = leaky_relu(acc, negative_slope)
    if residual is not None:
        acc = acc + residual.float()
    return acc.contiguous()


TILES = 3  # the kernel's tile shapes: 128x64, 64x64, 32x32 outputs a block


def conv2d_nhwc(x, w, b=None, *, negative_slope=None, residual=None,
                tile=None):
    """Stride-1 'same' KxK conv: x [N, H, W, C_in], w [K, K, C_in, C_out]
    (HWIO), b [C_out] or None; LeakyReLU with ``negative_slope`` and then
    ``residual`` [N, H, W, C_out] are applied in the epilogue. float32.

    ``tile`` None lets the kernel pick its tile shape by the problem's
    shape; 0..TILES-1 forces one (the output's bits must not change)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] \
            or w.shape[0] % 2 == 0 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_nhwc: x {tuple(x.shape)}, w {tuple(w.shape)}"
                         " (need NHWC input and an odd square HWIO kernel)")
    if tile is not None and not 0 <= tile < TILES:
        raise ValueError(f"conv2d_nhwc: tile {tile} not in 0..{TILES - 1}")
    if x.device.type == "cpu":
        return conv2d_nhwc_plain(x, w, b, negative_slope=negative_slope,
                                 residual=residual)
    n, h, wd, c_in = x.shape
    k, c_out = w.shape[0], w.shape[3]
    tensors = [t for t in (x, w, b, residual) if t is not None]
    _build.require_cuda("conv2d_nhwc", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("conv2d_nhwc: the kernel computes in float32 only")
    if b is not None and b.shape != (c_out,):
        raise ValueError(f"conv2d_nhwc: bias {tuple(b.shape)} for C_out={c_out}")
    if residual is not None and residual.shape != (n, h, wd, c_out):
        raise ValueError(f"conv2d_nhwc: residual {tuple(residual.shape)}")
    x = x.contiguous()
    w = w.contiguous()
    b = None if b is None else b.contiguous()
    residual = None if residual is None else residual.contiguous()
    y = torch.empty((n, h, wd, c_out), dtype=torch.float32, device=x.device)
    null = ctypes.c_void_p(None)
    lib = _build.load().lib
    with torch.cuda.device(x.device):
        rc = lib.fg_conv2d_nhwc(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            null if b is None else ctypes.c_void_p(b.data_ptr()),
            null if residual is None else ctypes.c_void_p(residual.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), n, h, wd, c_in, c_out, k,
            int(negative_slope is not None),
            0.0 if negative_slope is None else float(negative_slope),
            -1 if tile is None else int(tile), _build.stream_ptr(x))
    _build.check(rc, "conv2d_nhwc")
    conv2d_nhwc.launches += 1
    return y


conv2d_nhwc.launches = 0


def bf16_route_takes(c_in, c_out, kernel_size, stride, padding) -> bool:
    """Whether a conv of a marked transform goes through the bf16 kernel:
    stride 1, "same" padding, a square odd K up to 7 (the TPU kernel's
    rule, flashgmm_tpu/ops/pallas_conv.py:90-105), C_in and C_out at least
    64 (the reference's channel rule: narrower convs stay on the library)
    and multiples of 8 (rows of 16 bytes, as TMA reads and writes them).
    The reference's VMEM tile rule belongs to the TPU and does not carry
    over. ``kernel_size``, ``stride`` and ``padding`` are (height, width)
    pairs."""
    kh, kw = kernel_size
    return (tuple(stride) == (1, 1) and kh == kw and kh % 2 == 1 and kh <= 7
            and tuple(padding) == (kh // 2, kh // 2) and c_in >= 64
            and c_out >= 64 and c_in % 8 == 0 and c_out % 8 == 0)


@contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class PackedBf16Weight(NamedTuple):
    """HWIO conv weights packed once in the bf16 kernel's layout: ``kio``
    [K*K, C_out, C_in] bf16, contiguous (tap dy * K + dx, output channel,
    input channel), so that one tap's weights for 64 input channels are one
    TMA box with the input channels contiguous."""

    kio: torch.Tensor

    @property
    def k(self) -> int:
        return int(round(self.kio.shape[0] ** 0.5))

    @property
    def c_in(self) -> int:
        return self.kio.shape[2]

    @property
    def c_out(self) -> int:
        return self.kio.shape[1]

    @property
    def shape(self):
        """The HWIO shape (K, K, C_in, C_out) of the weights it holds."""
        return torch.Size((self.k, self.k, self.c_in, self.c_out))

    def hwio(self):
        """The HWIO weights [K, K, C_in, C_out] again (bf16)."""
        k = self.k
        return self.kio.reshape(k, k, self.c_out, self.c_in).permute(
            0, 1, 3, 2)


def pack_bf16_weight(w) -> PackedBf16Weight:
    """HWIO weights [K, K, C_in, C_out] (float32 is rounded to bf16, as the
    wrapper rounds it) in the kernel's layout; ``.hwio()`` gives them back
    exactly."""
    if w.dim() != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"pack_bf16_weight: w {tuple(w.shape)} is not a "
                         "square HWIO kernel")
    k, _, c_in, c_out = w.shape
    return PackedBf16Weight(w.to(torch.bfloat16).permute(0, 1, 3, 2)
                            .reshape(k * k, c_out, c_in).contiguous())


def _weight_geometry(w):
    """(K, C_in, C_out) of HWIO or packed weights; raises on anything else."""
    if isinstance(w, PackedBf16Weight):
        if w.kio.dim() != 3 or w.k * w.k != w.kio.shape[0]:
            raise ValueError(f"conv2d_nhwc_bf16: packed w "
                             f"{tuple(w.kio.shape)} is not [K*K, C_out, C_in]")
        if w.kio.dtype != torch.bfloat16:
            raise TypeError(f"conv2d_nhwc_bf16: packed w is {w.kio.dtype}")
        return w.k, w.c_in, w.c_out
    if not isinstance(w, torch.Tensor) or w.dim() != 4 \
            or w.shape[0] != w.shape[1]:
        raise ValueError(f"conv2d_nhwc_bf16: w {getattr(w, 'shape', w)} is "
                         "not a square HWIO kernel")
    return w.shape[0], w.shape[2], w.shape[3]


def conv2d_nhwc_bf16_plain(x, w, b=None, *, negative_slope=None,
                           residual=None, out_dtype=torch.bfloat16):
    """The plain version of the bf16 route: x and w rounded to bf16, the
    conv in float32 (TF32 off; the bf16 products are exact in float32, so
    only the order of the sums differs from the kernel's), the epilogue in
    float32 (+ bias, LeakyReLU, + residual read at its own type, as the TPU
    kernel reads it) and one rounding to ``out_dtype``. ``w`` is HWIO or
    packed (``pack_bf16_weight``)."""
    if isinstance(w, PackedBf16Weight):
        w = w.hwio()
    k = w.shape[0]
    xr = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wr = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    with _no_tf32():
        y = F.conv2d(xr, wr, padding=k // 2).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if negative_slope is not None:
        y = leaky_relu(y, negative_slope)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype).contiguous()


def _aligned(t, bytes_):
    """``t`` contiguous, its data on a ``bytes_`` boundary (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % bytes_ == 0 else t.clone()


def conv2d_nhwc_bf16(x, w, b=None, *, negative_slope=None, residual=None,
                     out_dtype=torch.bfloat16):
    """Stride-1 "same" KxK conv on the tensor cores: x [N, H, W, C_in] and
    w [K, K, C_in, C_out] (HWIO), or w packed once by ``pack_bf16_weight``,
    in bf16 (float32 is rounded to bf16 first, as the TPU kernel casts to
    its compute dtype), b [C_out] or None (f32), then LeakyReLU with
    ``negative_slope`` and + ``residual`` [N, H, W, C_out] (bf16 or f32) on
    the f32 accumulator, rounded once to ``out_dtype`` (bf16 or float32).
    K odd up to 7; C_in and C_out multiples of 8. Input that is not
    contiguous or not on a 16-byte boundary is copied first."""
    if x.dim() != 4:
        raise ValueError(f"conv2d_nhwc_bf16: x {tuple(x.shape)} is not NHWC")
    k, c_in, c_out = _weight_geometry(w)
    if k % 2 == 0 or k > 7 or c_in != x.shape[3]:
        raise ValueError(f"conv2d_nhwc_bf16: x {tuple(x.shape)}, w K={k} "
                         f"C_in={c_in} C_out={c_out} (need an odd K <= 7 "
                         "and C_in of x)")
    n, h, wd, _ = x.shape
    if c_in % 8 or c_out % 8 or min(n, h, wd, c_in, c_out) < 1:
        raise ValueError(f"conv2d_nhwc_bf16: C_in {c_in} and C_out {c_out} "
                         "must be multiples of 8")
    if b is not None and tuple(b.shape) != (c_out,):
        raise ValueError(f"conv2d_nhwc_bf16: bias {tuple(b.shape)} for "
                         f"C_out={c_out}")
    if residual is not None and tuple(residual.shape) != (n, h, wd, c_out):
        raise ValueError(f"conv2d_nhwc_bf16: residual {tuple(residual.shape)}")
    packed = isinstance(w, PackedBf16Weight)
    pairs = ((x, "x"), (None if packed else w, "w"), (residual, "residual"))
    for t, name in pairs:
        if t is not None and t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"conv2d_nhwc_bf16: {name} is {t.dtype}, not "
                            "bfloat16 or float32")
    if b is not None and not b.dtype.is_floating_point:
        raise TypeError(f"conv2d_nhwc_bf16: bias is {b.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv2d_nhwc_bf16: out_dtype {out_dtype}")
    if x.device.type == "cpu":
        return conv2d_nhwc_bf16_plain(x, w, b, negative_slope=negative_slope,
                                      residual=residual, out_dtype=out_dtype)
    wt = w.kio if packed else w
    tensors = [t for t in (x, wt, b, residual) if t is not None]
    _build.require_cuda("conv2d_nhwc_bf16", *tensors)
    x = _aligned(x.to(torch.bfloat16), 16)
    kio = _aligned(w.kio if packed else pack_bf16_weight(w).kio, 16)
    b = None if b is None else _aligned(b.float(), 8)
    # The kernel reads a residual of its result's type: a bf16 one is
    # widened for an f32 result (exact); an f32 one makes the kernel's
    # result f32, rounded to out_dtype once after (the same rounding).
    f32_res = residual is not None and residual.dtype == torch.float32
    y_dtype = torch.float32 if f32_res else out_dtype
    residual = None if residual is None else _aligned(residual.to(y_dtype), 16)
    y = torch.empty((n, h, wd, c_out), dtype=y_dtype, device=x.device)
    null = ctypes.c_void_p(None)
    lib = _build.load().lib
    with torch.cuda.device(x.device):
        rc = lib.fg_conv2d_nhwc_bf16(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(kio.data_ptr()),
            null if b is None else ctypes.c_void_p(b.data_ptr()),
            null if residual is None else ctypes.c_void_p(residual.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), int(y_dtype == torch.float32),
            n, h, wd, c_in, c_out, k, int(negative_slope is not None),
            0.0 if negative_slope is None else float(negative_slope),
            _build.stream_ptr(x))
    _build.check(rc, "conv2d_nhwc_bf16")
    conv2d_nhwc_bf16.launches += 1
    return y.to(out_dtype)


conv2d_nhwc_bf16.launches = 0

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
w in bf16 on the tensor cores, an f32 accumulator, the epilogue in f32 and
one rounding to the output type. The transforms g_a, h_a and g_s take it
when the codec is built with ``kernel_transforms=True``
(``bf16_route_takes`` is the rule). No bit-equality is asked of it: its
plain version sums in another order and the two agree within a bf16 ulp.
"""

import ctypes
from contextlib import contextmanager

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
    and multiples of 8 (the kernel's 16-byte copies). The reference's VMEM
    tile rule belongs to the TPU and does not carry over. ``kernel_size``,
    ``stride`` and ``padding`` are (height, width) pairs."""
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


def conv2d_nhwc_bf16_plain(x, w, b=None, *, negative_slope=None,
                           residual=None, out_dtype=torch.bfloat16):
    """The plain version of the bf16 route: x and w rounded to bf16, the
    conv in float32 (TF32 off; the bf16 products are exact in float32, so
    only the order of the sums differs from the kernel's), the epilogue in
    float32 (+ bias, LeakyReLU, + residual read at its own type, as the TPU
    kernel reads it) and one rounding to ``out_dtype``."""
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
    w [K, K, C_in, C_out] (HWIO) in bf16 (float32 is rounded to bf16 first,
    as the TPU kernel casts to its compute dtype), b [C_out] or None (f32),
    then LeakyReLU with ``negative_slope`` and + ``residual`` [N, H, W,
    C_out] (bf16 or f32) on the f32 accumulator, rounded once to
    ``out_dtype`` (bf16 or float32). K odd up to 7; C_in and C_out
    multiples of 8."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] \
            or w.shape[0] % 2 == 0 or w.shape[0] > 7 \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_nhwc_bf16: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (need NHWC input and an odd "
                         "square HWIO kernel, K <= 7)")
    n, h, wd, c_in = x.shape
    c_out = w.shape[3]
    if c_in % 8 or c_out % 8 or min(n, h, wd, c_in, c_out) < 1:
        raise ValueError(f"conv2d_nhwc_bf16: C_in {c_in} and C_out {c_out} "
                         "must be multiples of 8")
    if b is not None and tuple(b.shape) != (c_out,):
        raise ValueError(f"conv2d_nhwc_bf16: bias {tuple(b.shape)} for "
                         f"C_out={c_out}")
    if residual is not None and tuple(residual.shape) != (n, h, wd, c_out):
        raise ValueError(f"conv2d_nhwc_bf16: residual {tuple(residual.shape)}")
    pairs = ((x, "x"), (w, "w"), (residual, "residual"))
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
    tensors = [t for t in (x, w, b, residual) if t is not None]
    _build.require_cuda("conv2d_nhwc_bf16", *tensors)
    x = _aligned(x.to(torch.bfloat16), 16)
    w = _aligned(w.to(torch.bfloat16), 16)
    b = None if b is None else _aligned(b.float(), 4)
    residual = None if residual is None else _aligned(residual, 8)
    y = torch.empty((n, h, wd, c_out), dtype=out_dtype, device=x.device)
    null = ctypes.c_void_p(None)
    lib = _build.load().lib
    with torch.cuda.device(x.device):
        rc = lib.fg_conv2d_nhwc_bf16(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            null if b is None else ctypes.c_void_p(b.data_ptr()),
            null if residual is None else ctypes.c_void_p(residual.data_ptr()),
            int(residual is not None and residual.dtype == torch.float32),
            ctypes.c_void_p(y.data_ptr()), int(out_dtype == torch.float32),
            n, h, wd, c_in, c_out, w.shape[0],
            int(negative_slope is not None),
            0.0 if negative_slope is None else float(negative_slope),
            _build.stream_ptr(x))
    _build.check(rc, "conv2d_nhwc_bf16")
    conv2d_nhwc_bf16.launches += 1
    return y


conv2d_nhwc_bf16.launches = 0

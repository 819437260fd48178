"""Hand-written CUDA conv for the rows chain.

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
"""

import ctypes

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

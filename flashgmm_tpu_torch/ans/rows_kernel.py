"""The GMM CDF rows, bounds, boundary-rows and softmax kernels (source:
``flashgmm_tpu_torch/csrc/gmm_rows.cu``; each entry is ``csrc/gmm_entry.cuh``).

``gmm_rows`` replaces the plain-XLA fusion of
flashgmm_tpu/ans/gaussian_cdf.py:114 (``gmm_guarded_rows``; not a Pallas
kernel): one CUDA kernel computes the int32 [N, L] boundary rows from the
[N, K] mixture parameters, with the float32 operations and roundings of the
plain version in ``gaussian_cdf.py`` (which is XLA's CPU arithmetic), so its
rows equal the plain version's and the JAX package's bit for bit.

``gmm_bounds`` replaces ``gmm_guarded_bounds``
(flashgmm_tpu/ans/gaussian_cdf.py:150, plain XLA too): each symbol's
``(start, freq)``, the two row entries that bound its bin, without the
rest of the row. The batched codec no longer takes it: its encoder
evaluates the same two entries inside the rANS kernel
(``rans_kernels.encode_scan_gmm``).

``gmm_boundary_rows`` replaces the plain-XLA ``gmm_boundary_rows``
(flashgmm_tpu/ans/gaussian_cdf.py:71): the reference format's uint16 rows
[N, L], XLA's CPU roundings entry by entry (its mixture sum and its
saturating convert included), the device half of device-rows coding.
``gaussian_boundary_rows`` replaces the plain-XLA ``gaussian_boundary_rows``
(flashgmm_tpu/ans/gaussian_cdf.py:170, the single-Gaussian search coder's
rows): the same kernel at K = 1, each mean 0 and each weight 1, whose rows
equal JAX's single-Gaussian rows bit for bit (the weight's multiply is
exact, and x - 0 is x). ``gmm_softmax`` gives every coding path its
mixture weights: the softmax
over K of [.., K, M] in jax.nn.softmax's op order on XLA's CPU, so the
card's weights equal the CPU's (ROADMAP C11).

All take CUDA tensors only and raise on anything else; CPU tensors never
reach them (``gaussian_cdf`` runs the plain versions for them).
``<wrapper>.launches`` counts each one's launches.

What bounds it on the card: the float32 arithmetic. Each of the N*L
entries evaluates K CDF terms (an IEEE divide, XLA's exp, a square root or
a reciprocal each); the output is 4 bytes an entry, and the parameters
(12K bytes a symbol) are read once from device memory and from L1 by the
symbol's other L-1 threads. The bounds: also the arithmetic, two entries
a symbol (12K + 4 bytes read and 8 written a symbol). The boundary rows:
the arithmetic, as the rows (2 bytes an entry out). The softmax: the bytes
(8K a column, ~30K flops).
"""

import ctypes

import torch

from flashgmm_tpu_torch import _build

MAX_K = 8  # mixture components the kernel takes


def _check_params(name, scales, means, weights, lo, num_bins, mode):
    """Refuse what the kernels do not take; returns the parameters
    contiguous."""
    _build.require_cuda(name, scales, means, weights)
    if any(t.dtype != torch.float32 for t in (scales, means, weights)):
        raise TypeError(f"{name}: scales, means and weights must be float32")
    if scales.dim() != 2 or means.shape != scales.shape \
            or weights.shape != scales.shape:
        raise ValueError(f"{name}: shapes {tuple(scales.shape)}, "
                         f"{tuple(means.shape)}, {tuple(weights.shape)} "
                         "(need three equal [N, K])")
    if not 1 <= scales.shape[1] <= MAX_K:
        raise ValueError(f"{name}: K={scales.shape[1]}, the kernel takes "
                         f"1..{MAX_K}")
    if mode not in (0, 1, 2):
        raise ValueError(f"{name}: APPROX_MODE {mode}")
    if not 2 <= num_bins + 1 < 65536 or abs(int(lo)) >= 1 << 22:
        raise ValueError(f"{name}: lo={lo}, num_bins={num_bins}")
    return tuple(t.contiguous() for t in (scales, means, weights))


def gmm_rows(scales, means, weights, lo: int, num_bins: int, mode: int = 0):
    """int32 [N, num_bins+1] guarded rows from float32 [N, K] scales,
    means and weights on one CUDA device (see gaussian_cdf.gmm_guarded_rows)."""
    scales, means, weights = _check_params("gmm_rows", scales, means, weights,
                                           lo, num_bins, mode)
    n, k = scales.shape
    L = num_bins + 1
    rows = torch.empty((n, L), dtype=torch.int32, device=scales.device)
    if n == 0:
        return rows
    lib = _build.load().lib
    with torch.cuda.device(scales.device):
        rc = lib.fg_gmm_rows(
            ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(means.data_ptr()),
            ctypes.c_void_p(weights.data_ptr()), n, k, int(lo), L, int(mode),
            ctypes.c_void_p(rows.data_ptr()), _build.stream_ptr(scales))
    _build.check(rc, "gmm_rows")
    gmm_rows.launches += 1
    return rows


gmm_rows.launches = 0


def gmm_bounds(values, scales, means, weights, lo: int, num_bins: int,
               mode: int = 0):
    """(start, freq) int32 [N] of symbol values [N] (in [lo, lo + num_bins))
    under float32 [N, K] parameters on one CUDA device: rows[i, v - lo] and
    rows[i, v - lo + 1] - rows[i, v - lo] of the guarded rows (see
    gaussian_cdf.gmm_guarded_bounds)."""
    scales, means, weights = _check_params("gmm_bounds", scales, means,
                                           weights, lo, num_bins, mode)
    _build.require_cuda("gmm_bounds", values, scales)
    n, k = scales.shape
    if values.shape != (n,) or values.dtype.is_floating_point:
        raise ValueError(f"gmm_bounds: values {tuple(values.shape)} "
                         f"{values.dtype} for {n} symbols (need integer [N])")
    values = values.to(torch.int32).contiguous()
    start = torch.empty(n, dtype=torch.int32, device=scales.device)
    freq = torch.empty(n, dtype=torch.int32, device=scales.device)
    if n == 0:
        return start, freq
    lib = _build.load().lib
    with torch.cuda.device(scales.device):
        rc = lib.fg_gmm_bounds(
            ctypes.c_void_p(values.data_ptr()),
            ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(means.data_ptr()),
            ctypes.c_void_p(weights.data_ptr()), n, k, int(lo), num_bins + 1,
            int(mode), ctypes.c_void_p(start.data_ptr()),
            ctypes.c_void_p(freq.data_ptr()), _build.stream_ptr(scales))
    _build.check(rc, "gmm_bounds")
    gmm_bounds.launches += 1
    return start, freq


gmm_bounds.launches = 0


def gmm_boundary_rows(scales, means, weights, lo: int, num_bins: int,
                      mode: int = 0):
    """uint16 [N, num_bins+1] reference-format boundary rows from float32
    [N, K] scales, means and weights on one CUDA device (see
    gaussian_cdf.gmm_boundary_rows)."""
    scales, means, weights = _check_params("gmm_boundary_rows", scales,
                                           means, weights, lo, num_bins, mode)
    n, k = scales.shape
    L = num_bins + 1
    rows = torch.empty((n, L), dtype=torch.uint16, device=scales.device)
    if n == 0:
        return rows
    lib = _build.load().lib
    with torch.cuda.device(scales.device):
        rc = lib.fg_gmm_boundary_rows(
            ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(means.data_ptr()),
            ctypes.c_void_p(weights.data_ptr()), n, k, int(lo), L, int(mode),
            ctypes.c_void_p(rows.data_ptr()), _build.stream_ptr(scales))
    _build.check(rc, "gmm_boundary_rows")
    gmm_boundary_rows.launches += 1
    return rows


gmm_boundary_rows.launches = 0


def gaussian_boundary_rows(scales, lo: int, num_bins: int, mode: int = 0):
    """uint16 [N, num_bins+1] single-Gaussian boundary rows from float32
    [N] scales on one CUDA device (see gaussian_cdf.gaussian_boundary_rows):
    the boundary-rows kernel at K = 1, means 0 and weights 1."""
    _build.require_cuda("gaussian_boundary_rows", scales)
    if scales.dtype != torch.float32 or scales.dim() != 1:
        raise TypeError("gaussian_boundary_rows: float32 scales [N] needed, "
                        f"got {scales.dtype} {tuple(scales.shape)}")
    s = scales.reshape(-1, 1)
    s, m, w = _check_params("gaussian_boundary_rows", s, torch.zeros_like(s),
                            torch.ones_like(s), lo, num_bins, mode)
    n, L = s.shape[0], num_bins + 1
    rows = torch.empty((n, L), dtype=torch.uint16, device=s.device)
    if n == 0:
        return rows
    lib = _build.load().lib
    with torch.cuda.device(s.device):
        rc = lib.fg_gmm_boundary_rows(
            ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(m.data_ptr()),
            ctypes.c_void_p(w.data_ptr()), n, 1, int(lo), L, int(mode),
            ctypes.c_void_p(rows.data_ptr()), _build.stream_ptr(s))
    _build.check(rc, "gaussian_boundary_rows")
    gaussian_boundary_rows.launches += 1
    return rows


gaussian_boundary_rows.launches = 0


def gmm_softmax(logits):
    """Softmax over dim -2 (K) of float32 logits [..., K, M] on a CUDA
    device (see gaussian_cdf.gmm_softmax)."""
    _build.require_cuda("gmm_softmax", logits)
    if logits.dtype != torch.float32 or logits.dim() < 2:
        raise TypeError("gmm_softmax: float32 logits [..., K, M] needed, got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    k, m = logits.shape[-2:]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gmm_softmax: K={k}, the kernel takes 1..{MAX_K}")
    logits = logits.contiguous()
    out = torch.empty_like(logits)
    outer = logits.numel() // max(k * m, 1)
    if logits.numel() == 0:
        return out
    lib = _build.load().lib
    with torch.cuda.device(logits.device):
        rc = lib.fg_gmm_softmax(
            ctypes.c_void_p(logits.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            outer, k, m, _build.stream_ptr(logits))
    _build.check(rc, "gmm_softmax")
    gmm_softmax.launches += 1
    return out


gmm_softmax.launches = 0

"""The fused GMM CDF rows kernel (source: ``flashgmm_tpu_torch/csrc/gmm_rows.cu``).

``gmm_rows`` replaces the plain-XLA fusion of
flashgmm_tpu/ans/gaussian_cdf.py:114 (``gmm_guarded_rows``; not a Pallas
kernel): one CUDA kernel computes the int32 [N, L] boundary rows from the
[N, K] mixture parameters, with the float32 operations and roundings of the
plain version in ``gaussian_cdf.py`` (which is XLA's CPU arithmetic), so its
rows equal the plain version's and the JAX package's bit for bit.

It takes CUDA tensors only and raises on anything else; CPU tensors never
reach it (``gaussian_cdf.gmm_guarded_rows`` runs the plain version for
them). ``gmm_rows.launches`` counts its launches.

What bounds it on the card: the float32 arithmetic. Each of the N*L
entries evaluates K CDF terms (an IEEE divide, XLA's exp, a square root or
a reciprocal each); the output is 4 bytes an entry, and the parameters
(12K bytes a symbol) are read once from device memory and from L1 by the
symbol's other L-1 threads.
"""

import ctypes

import torch

from flashgmm_tpu_torch import _build

MAX_K = 8  # mixture components the kernel takes


def gmm_rows(scales, means, weights, lo: int, num_bins: int, mode: int = 0):
    """int32 [N, num_bins+1] guarded rows from float32 [N, K] scales,
    means and weights on one CUDA device (see gaussian_cdf.gmm_guarded_rows)."""
    _build.require_cuda("gmm_rows", scales, means, weights)
    if any(t.dtype != torch.float32 for t in (scales, means, weights)):
        raise TypeError("gmm_rows: scales, means and weights must be float32")
    if scales.dim() != 2 or means.shape != scales.shape \
            or weights.shape != scales.shape:
        raise ValueError(f"gmm_rows: shapes {tuple(scales.shape)}, "
                         f"{tuple(means.shape)}, {tuple(weights.shape)} "
                         "(need three equal [N, K])")
    n, k = scales.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gmm_rows: K={k}, the kernel takes 1..{MAX_K}")
    if mode not in (0, 1, 2):
        raise ValueError(f"gmm_rows: APPROX_MODE {mode}")
    L = num_bins + 1
    if not 2 <= L < 65536 or abs(int(lo)) >= 1 << 22:
        raise ValueError(f"gmm_rows: lo={lo}, num_bins={num_bins}")
    scales, means, weights = (t.contiguous() for t in (scales, means, weights))
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

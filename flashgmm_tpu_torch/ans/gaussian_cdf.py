"""GMM probability math for the interleaved coder: the plain version of the
rows kernel, bit for bit XLA's CPU arithmetic.

Port of flashgmm_tpu/ans/gaussian_cdf.py. :func:`gmm_guarded_rows` gives
the full rows, :func:`gmm_guarded_bounds` only the two entries that bound
each symbol's bin, :func:`gmm_boundary_rows` the reference format's uint16
rows (its device-rows mode) and :func:`gmm_softmax` the mixture weights
that every coding path computes its rows from (the fast codec evaluates those inside its encoder,
``rans_kernels.encode_scan_gmm``, and the entries its decoder's search
probes, ``rans_kernels.decode_scan_gmm``).
On CPU tensors they run the plain torch versions below, on CUDA tensors
the kernels of ``rows_kernel.py`` (``csrc/gmm_rows.cu``, every entry from
``csrc/gmm_entry.cuh``), which perform the same float32 operations with
the same roundings. All equal the JAX package's on the CPU bit for bit, in
all three modes.

The plain version follows XLA's CPU code for that function (its optimized
HLO and LLVM IR, jaxlib 0.9) op by op:

- every add, sub, mul, div and sqrt is one correctly rounded float32
  operation (the sqrt through float64: torch's float32 sqrt is not);
- XLA's own exp and logistic (``entropy_models/xla_math.py``), not torch's;
- XLA's algebraic simplifier turns the Pólya term ``w * 0.5 * (1 + c)``
  into ``(1 + c) * (w * 0.5)``;
- contraction: the x86 back end fuses each ``fmul`` whose only use is an
  ``fadd`` or ``fsub`` into an FMA, the left operand first when both are
  products. So the guarded rows' mixture is ``acc = fma(a0, b0, a1 * b1)``,
  then ``acc = fma(ak, bk, acc)`` for k >= 2; the boundary rows' (a
  ``jnp.sum`` over K, XLA's reduce) is ``acc = a0 * b0``, then
  ``acc = fma(ak, bk, acc)`` for k >= 1; and in A&S mode
  ``1 + p|z|``, the Horner steps and ``1 - z * poly`` are FMAs too
  (``xla_math._fma``, a true FMA emulated in float64);
- flush to zero: XLA's CPU code runs with subnormal inputs read as zero
  and subnormal results flushed (``xla_math._ftz``), so the parameters are
  flushed on entry and every result that can be subnormal on its way out;
- XLA's float -> uint16 convert saturates: NaN -> 0, below 0 -> 0, above
  65535 -> 65535, else truncated.

Each was pinned by comparing against the JAX functions on the CPU, entry by
entry (``tests/test_torch_port_rows.py``,
``tests/test_torch_port_reference_codec.py``).

``APPROX_MODE`` selects the CDF approximation as in the reference:
0 = Pólya (default), 1 = Abramowitz & Stegun, 2 = logistic.
"""

import os
import struct

import torch

from flashgmm_tpu_torch.ans import rows_kernel
from flashgmm_tpu_torch.entropy_models.xla_math import _fma, _ftz
from flashgmm_tpu_torch.entropy_models.xla_math import exp as _exp
from flashgmm_tpu_torch.entropy_models.xla_math import logistic as _logistic


def _f32(v: float) -> float:
    """A Python constant as the float32 XLA computes with."""
    return struct.unpack("f", struct.pack("f", v))[0]


MAX_CDF_VALUE = 65535.0
_PI = 3.14159265358979323846
_POLYA_C = _f32(-2.0 / _PI)
_INV_SQRT_2PI = _f32(0.3989422804014327)
_AS_P = _f32(0.2316419)
_AS_B = [_f32(b) for b in (0.319381530, -0.356563782, 1.781477937,
                           -1.821255978, 1.330274429)]
_LOGISTIC_K = _f32(1.702)


def get_approx_mode() -> int:
    try:
        mode = int(os.environ.get("APPROX_MODE", "0"))
    except ValueError:
        mode = 0
    return mode if mode in (0, 1, 2) else 0


def _sqrt(v):
    """Correctly rounded float32 sqrt. torch's float32 sqrt on the CPU is
    not (it misrounds near-ties); float64's, rounded to float32, is."""
    return torch.sqrt(v.double()).float()


def _polya(z):
    """1 + sign(z) sqrt(1 - exp(-2z^2/pi)): twice the Pólya CDF."""
    e = _exp(_ftz(_ftz(z * z) * _POLYA_C))
    s = _sqrt(torch.clamp_min(1.0 - e, 0.0))
    return 1.0 + torch.where(torch.signbit(z), -s, s)


def _abramowitz_stegun(z):
    """A&S 26.2.17 five-term polynomial."""
    t = 1.0 / _fma(torch.abs(z), _AS_P, 1.0)
    q = _fma(t, _AS_B[4], _AS_B[3])
    for b in _AS_B[2::-1]:
        q = _fma(t, q, b)
    pdf = _ftz(_exp(_ftz(_ftz(z * -0.5) * z)) * _INV_SQRT_2PI)
    res = _fma(-pdf, _ftz(t * q), 1.0)
    return torch.where(z >= 0, res, 1.0 - res)


def _logistic_1702(z):
    return _logistic(_ftz(z * _LOGISTIC_K))


def polya_cdf(x):
    """Phi(x) ~= 0.5*(1 + sign(x)*sqrt(1 - exp(-2x^2/pi)))."""
    return 0.5 * _polya(x.float())


def abramowitz_stegun_cdf(x):
    """A&S 26.2.17 five-term polynomial approximation."""
    return _abramowitz_stegun(x.float())


def logistic_cdf(x):
    """Phi(x) ~= sigmoid(1.702 x)."""
    return _logistic_1702(x.float())


_CDF_FNS = {0: polya_cdf, 1: abramowitz_stegun_cdf, 2: logistic_cdf}
# Each mixture term is a product a * b: the CDF part, and the weight (in
# Pólya mode the 0.5 moves onto the weight, as XLA rewrites it).
_TERM_A = {0: _polya, 1: _abramowitz_stegun, 2: _logistic_1702}
_TERM_B = {0: lambda w: _ftz(w * 0.5), 1: lambda w: w, 2: lambda w: w}


def gaussian_cdf(x, mode: int = None):
    """Phi(x) by the approximation ``mode`` (0 Pólya, 1 Abramowitz &
    Stegun, 2 logistic; None: ``APPROX_MODE``, as ``get_approx_mode``)."""
    if mode is None:
        mode = get_approx_mode()
    return _CDF_FNS[mode](x)


def _mixture_cdf(x, scales, means, weights, mode: int):
    """Sum_k w_k Phi((x - mu_k)/sigma_k) with the reference's FIXED
    sequential K-add chain (gaussian_cdf.py:94), contracted as XLA's x86
    code contracts it: fma(a0, b0, a1*b1), then fma(ak, bk, acc)."""
    terms = []
    for k in range(scales.shape[-1]):
        z = _ftz((x - means[..., k:k + 1]) / scales[..., k:k + 1])
        terms.append((_TERM_A[mode](z), _TERM_B[mode](weights[..., k:k + 1])))
    if len(terms) == 1:
        return _ftz(terms[0][0] * terms[0][1])
    acc = _ftz(_fma(*terms[0], _ftz(terms[1][0] * terms[1][1])))
    for a, b in terms[2:]:
        acc = _ftz(_fma(a, b, acc))
    return acc


def _quantize(cdf, L: int):
    """floor(clip(cdf, 0, 1) * (65536 - L)) as int32, NaN -> 0 (XLA's)."""
    raw = torch.floor(torch.clamp(cdf, 0.0, 1.0) * float(65536 - L))
    return torch.where(torch.isnan(raw), 0.0, raw).to(torch.int32)


def gmm_guarded_rows_plain(scales, means, weights, lo: int, num_bins: int,
                           mode: int = 0):
    """The plain version of the rows kernel, on any device (see
    :func:`gmm_guarded_rows`)."""
    L = num_bins + 1
    dev = scales.device
    scales, means, weights = (_ftz(t.float()) for t in (scales, means, weights))
    j = torch.arange(L, dtype=torch.float32, device=dev)
    x = (float(lo) - 0.5) + j  # [L]
    # boundaries [1, L, 1] against parameters [N, 1, K] -> [N, L]
    cdf = _mixture_cdf(x[None, :, None], scales[:, None, :],
                       means[:, None, :], weights[:, None, :], mode)[..., 0]
    rows = _quantize(cdf, L) + torch.arange(L, dtype=torch.int32,
                                            device=dev)[None, :]
    rows[:, -1] = 65536
    return rows


def gmm_guarded_bounds_plain(values, scales, means, weights, lo: int,
                             num_bins: int, mode: int = 0):
    """The plain version of the bounds kernel, on any device (see
    :func:`gmm_guarded_bounds`): the rows' entry math at each symbol's two
    boundaries only, x = (lo - 0.5) + j in float32 as the rows compute it."""
    L = num_bins + 1
    scales, means, weights = (_ftz(t.float()) for t in (scales, means, weights))
    j = (values.long() - lo).to(torch.int32)

    def entry(jj):
        x = (float(lo) - 0.5) + jj.float()  # [N]
        cdf = _mixture_cdf(x[:, None], scales, means, weights, mode)[:, 0]
        return torch.where(jj == L - 1, 65536, _quantize(cdf, L) + jj)

    start = entry(j)
    return start, entry(j + 1) - start


def gmm_boundary_rows_plain(scales, means, weights, lo: int, num_bins: int,
                            mode: int = 0):
    """The plain version of the boundary-rows kernel, on any device (see
    :func:`gmm_boundary_rows`)."""
    L = num_bins + 1
    scales, means, weights = (_ftz(t.float()) for t in (scales, means, weights))
    j = torch.arange(L, dtype=torch.float32, device=scales.device)
    x = ((float(lo) - 0.5) + j)[None, :]  # [1, L] against [N, 1] parameters
    acc = None
    for k in range(scales.shape[-1]):
        z = _ftz((x - means[:, k:k + 1]) / scales[:, k:k + 1])
        a, b = _TERM_A[mode](z), _TERM_B[mode](weights[:, k:k + 1])
        acc = _ftz(a * b) if acc is None else _ftz(_fma(a, b, acc))
    v = acc * 65535.0
    v = torch.where(torch.isnan(v), 0.0, torch.clamp(v, 0.0, 65535.0))
    return v.to(torch.int32).to(torch.uint16)


def gmm_boundary_rows(scales, means, weights, lo: int, num_bins: int,
                      mode: int = 0):
    """Quantized boundary CDFs of every symbol under a K-mixture, the
    reference format's device rows (JAX ``gmm_boundary_rows``).

    Args: scales/means/weights float32 [N, K]; lo the first bin's value;
    returns uint16 [N, num_bins + 1], ``rows[i, j] = u16(cdf_i(lo + j - 0.5)
    * 65535)``. CPU tensors take the plain version; CUDA tensors launch the
    boundary-rows kernel (``rows_kernel.gmm_boundary_rows``), which raises
    on what it cannot take.
    """
    if scales.device.type == "cpu":
        return gmm_boundary_rows_plain(scales, means, weights, lo, num_bins,
                                       mode)
    return rows_kernel.gmm_boundary_rows(scales, means, weights, lo,
                                         num_bins, mode)


def gaussian_boundary_rows_plain(scales, lo: int, num_bins: int,
                                 mode: int = 0):
    """The plain version of the single-Gaussian boundary-rows kernel, on any
    device (see :func:`gaussian_boundary_rows`): the mixture's boundary
    rows at K = 1 with mean 0 and weight 1. JAX computes
    ``u16(cdf(x / s) * 65535)``; the mixture's ``(x - 0) / s`` is ``x / s``
    and its multiply by the weight 1 (0.5 in Pólya mode, where XLA moves
    the 0.5 onto the weight) is exact, so the rows are JAX's bit for bit."""
    s = scales.float().reshape(-1, 1)
    return gmm_boundary_rows_plain(s, torch.zeros_like(s), torch.ones_like(s),
                                   lo, num_bins, mode)


def gaussian_boundary_rows(scales, lo: int, num_bins: int, mode: int = 0):
    """Quantized boundary CDFs of zero-mean Gaussians, the search coder's
    rows (JAX ``gaussian_boundary_rows``, flashgmm_tpu/ans/gaussian_cdf.py:
    170; the reference's rans_interface.cpp:401-456).

    Args: scales float32 [N]; lo the first bin's value; returns uint16
    [N, num_bins + 1], ``rows[i, j] = u16(cdf((lo + j - 0.5) / s_i) *
    65535)``. CPU tensors take the plain version; CUDA tensors launch the
    boundary-rows kernel at K = 1 (``rows_kernel.gaussian_boundary_rows``),
    which raises on what it cannot take.
    """
    if scales.device.type == "cpu":
        return gaussian_boundary_rows_plain(scales, lo, num_bins, mode)
    return rows_kernel.gaussian_boundary_rows(scales, lo, num_bins, mode)


def gmm_softmax_plain(logits):
    """The plain version of the softmax kernel, on any device (see
    :func:`gmm_softmax`)."""
    x = _ftz(logits.float())
    e = _exp(_ftz(x - x.amax(dim=-2, keepdim=True)))
    total = e[..., 0:1, :]
    for k in range(1, e.shape[-2]):
        total = _ftz(total + e[..., k:k + 1, :])
    return _ftz(e / total)


def gmm_softmax(logits):
    """Softmax over dim -2 (the K mixture components) of float32 logits
    [..., K, M], in jax.nn.softmax's op order on XLA's CPU: the max over K,
    subtracted; XLA's exp; the sum over k = 0, 1, ... in order; a divide.
    torch.softmax rounds differently on the CPU and on the card (ROADMAP
    C11); this equals JAX's on the CPU bit for bit, on either. CPU tensors
    take the plain version; CUDA tensors launch the softmax kernel
    (``rows_kernel.gmm_softmax``)."""
    if logits.device.type == "cpu":
        return gmm_softmax_plain(logits)
    return rows_kernel.gmm_softmax(logits)


def gmm_guarded_rows(scales, means, weights, lo: int, num_bins: int,
                     mode: int = 0):
    """Strictly-monotone int32 boundary rows for the interleaved coder.

    ``rows[i, j] = floor(cdf_i(lo + j - 0.5) * (2^16 - (num_bins+1))) + j``
    with the last boundary forced to 2^16: every bin has pmf >= 1, so no
    bypass escape is ever needed.

    Args: scales/means/weights float32 [N, K]; returns int32 [N, num_bins+1].
    CPU tensors take the plain version; CUDA tensors launch the fused rows
    kernel (``rows_kernel.gmm_rows``), which raises on what it cannot take.
    """
    if scales.device.type == "cpu":
        return gmm_guarded_rows_plain(scales, means, weights, lo, num_bins,
                                      mode)
    return rows_kernel.gmm_rows(scales, means, weights, lo, num_bins, mode)


def gmm_guarded_bounds(values, scales, means, weights, lo: int,
                       num_bins: int, mode: int = 0):
    """(start, freq) int32 [N] of each symbol's bin in its guarded row:
    ``rows[i, v - lo]`` and ``rows[i, v - lo + 1] - rows[i, v - lo]`` of
    :func:`gmm_guarded_rows`, computed without the rest of the row.

    Args: values int [N] in [lo, lo + num_bins); scales/means/weights
    float32 [N, K]. CPU tensors take the plain version; CUDA tensors launch
    the bounds kernel (``rows_kernel.gmm_bounds``), which raises on what it
    cannot take.
    """
    if scales.device.type == "cpu":
        return gmm_guarded_bounds_plain(values, scales, means, weights, lo,
                                        num_bins, mode)
    return rows_kernel.gmm_bounds(values, scales, means, weights, lo,
                                  num_bins, mode)

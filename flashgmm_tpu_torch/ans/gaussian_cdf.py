"""GMM probability math for the interleaved coder, as plain torch ops.

Port of flashgmm_tpu/ans/gaussian_cdf.py (there XLA, here eager torch, on
whatever device the parameters live). The encoder and the decoder of the fast
codec call :func:`gmm_guarded_rows` on the same tensors of the same shapes,
so both compute the same integer rows. The op order follows the reference
line by line, so the rows agree with JAX's up to the ulps in which the two
libraries' ``exp``/``sqrt``/``sigmoid`` differ (measured in
tests/test_torch_port_rows.py).

``APPROX_MODE`` selects the CDF approximation as in the reference:
0 = Pólya (default), 1 = Abramowitz & Stegun, 2 = logistic.
"""

import os

import torch

_INV_SQRT_2PI = 0.3989422804014327
_PI = 3.14159265358979323846


def get_approx_mode() -> int:
    try:
        mode = int(os.environ.get("APPROX_MODE", "0"))
    except ValueError:
        mode = 0
    return mode if mode in (0, 1, 2) else 0


def polya_cdf(x):
    """Phi(x) ~= 0.5*(1 + sign(x)*sqrt(1 - exp(-2x^2/pi)))."""
    x = x.float()
    e = torch.exp((-2.0 / _PI) * (x * x))
    s = torch.sqrt(torch.clamp_min(1.0 - e, 0.0))
    return 0.5 * (1.0 + torch.copysign(s, x))


def abramowitz_stegun_cdf(x):
    """A&S 26.2.17 five-term polynomial approximation."""
    x = x.float()
    p = 0.2316419
    b1, b2, b3, b4, b5 = (0.319381530, -0.356563782, 1.781477937,
                          -1.821255978, 1.330274429)
    abs_x = torch.abs(x)
    z = _INV_SQRT_2PI * torch.exp(-0.5 * x * x)
    t = 1.0 / (1.0 + p * abs_x)
    poly = t * (b1 + t * (b2 + t * (b3 + t * (b4 + t * b5))))
    res = 1.0 - z * poly
    return torch.where(x >= 0, res, 1.0 - res)


def logistic_cdf(x):
    """Phi(x) ~= sigmoid(1.702 x)."""
    return torch.sigmoid(1.702 * x.float())


_CDF_FNS = {0: polya_cdf, 1: abramowitz_stegun_cdf, 2: logistic_cdf}


def _mixture_cdf(x, scales, means, weights, mode: int):
    """Sum_k w_k Phi((x - mu_k)/sigma_k) with a FIXED sequential K-add
    chain, as in the reference (gaussian_cdf.py:94)."""
    cdf_fn = _CDF_FNS[mode]
    acc = None
    for k in range(scales.shape[-1]):
        term = weights[..., k:k + 1] * cdf_fn(
            (x - means[..., k:k + 1]) / scales[..., k:k + 1])
        acc = term if acc is None else acc + term
    return acc


def gmm_guarded_rows(scales, means, weights, lo: int, num_bins: int,
                     mode: int = 0):
    """Strictly-monotone int32 boundary rows for the interleaved coder.

    ``rows[i, j] = floor(cdf_i(lo + j - 0.5) * (2^16 - (num_bins+1))) + j``
    with the last boundary forced to 2^16: every bin has pmf >= 1, so no
    bypass escape is ever needed.

    Args: scales/means/weights float32 [N, K]; returns int32 [N, num_bins+1].
    """
    L = num_bins + 1
    dev = scales.device
    j = torch.arange(L, dtype=torch.float32, device=dev)
    x = (float(lo) - 0.5) + j  # [L]
    # boundaries [1, L, 1] against parameters [N, 1, K] -> [N, L]
    cdf = _mixture_cdf(x[None, :, None], scales[:, None, :],
                       means[:, None, :], weights[:, None, :], mode)[..., 0]
    raw = torch.floor(torch.clamp(cdf, 0.0, 1.0) * float(65536 - L))
    rows = raw.to(torch.int32) + torch.arange(L, dtype=torch.int32,
                                              device=dev)[None, :]
    rows[:, -1] = 65536
    return rows

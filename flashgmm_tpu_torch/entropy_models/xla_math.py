"""float32 exp, log1p, tanh, logistic and softplus as XLA's CPU backend
computes them, from single IEEE-rounded torch ops.

The EntropyBottleneck's integer CDF tables round a float PMF to 1/65536;
an ulp of difference in the density MLP moves entries across rounding
boundaries. XLA's CPU backend evaluates these functions with its own
polynomial and rational approximations (Cephes-style exp and log, an
Eigen-style rational tanh), not with libm, so torch's own functions differ
from it in the last ulp for a large share of inputs. Written out here op by
op (the op order and constants of XLA's emitted LLVM IR, jaxlib 0.9, and
the multiply-adds its x86 code generator contracts into FMAs), they give the
JAX package's tables bit for bit, and the same bits on the CPU and the GPU.
An FMA is emulated in float64: the product of two float32 values is exact
there, and the float64 sum is rounded to odd (its exact error, from
TwoSum, decides the last bit), so the one rounding to float32 that follows
is that of a true FMA, ties included.
"""

import struct

import torch


def _f(hex_double: str) -> float:
    """An LLVM float constant (printed as the hex of a double)."""
    return struct.unpack(">d", bytes.fromhex(hex_double))[0]


_EXP_LO, _EXP_HI = _f("C055F33340000000"), _f("4056333340000000")
_LOG2E = _f("3FF7154760000000")
_LN2_HI, _LN2_LO = _f("3FE6300000000000"), _f("BF2BD01060000000")
_EXP_P = [_f(h) for h in ("3F2A0D2CE0000000", "3F56E879C0000000",
                          "3F81112100000000", "3FA5553820000000",
                          "3FC5555540000000")]

_MIN_NORMAL = _f("3810000000000000")
_SQRT_HALF = _f("3FE6A09E60000000")
_LOG_P = [_f(h) for h in ("3FB2043760000000", "BFBD7A3700000000",
                          "BFBFCBA9E0000000", "3FC23D37E0000000",
                          "3FC999D580000000", "BFCFFFFF80000000",
                          "3FBDE4A340000000", "BFC555CA00000000",
                          "3FD5555540000000")]

_LOG1P_SMALL = _f("3FDA8279A0000000")
_LOG1P_Q = [_f(h) for h in ("402E2035A0000000", "4054C30B60000000",
                            "406BB865A0000000", "4073519460000000",
                            "406B0DB140000000", "404E0F3040000000")]
_LOG1P_P = [_f(h) for h in ("3F07BC0960000000", "3FDFE818A0000000",
                            "401A509F40000000", "403DE97380000000",
                            "404E798EC0000000", "404C8E75A0000000",
                            "40340A2020000000")]

_TANH_SMALL = _f("3F3A36E2E0000000")
_TANH_CLAMP = _f("401FFEC880000000")
_TANH_NUM = [_f(h) for h in ("BCB3E4B800000000", "3D4C266FC0000000",
                             "BDD7A6FFE0000000", "3E6B800820000000",
                             "3EEF286940000000", "3F44E1BDA0000000",
                             "3F740B3B80000000")]
_TANH_DEN = [_f(h) for h in ("3EB41A7B00000000", "3F1F12BAC0000000",
                             "3F629540A0000000", "3F740B3BA0000000")]


def _ftz(x):
    """XLA's CPU code runs with subnormals flushed to zero."""
    return torch.where(torch.abs(x) < _MIN_NORMAL, torch.zeros_like(x), x)


def _fma(a, b, c):
    """round_f32(a * b + c) with one rounding, as a hardware FMA computes it.

    ``a`` is a float32 tensor, ``b`` and ``c`` float32 values (tensors, or
    Python floats that are float32 constants). a * b is exact in float64;
    the float64 sum s is rounded to odd: if it was inexact and its last
    bit is even, it moves one ulp toward the exact sum. Rounding a
    round-to-odd value with 29 spare bits to float32 rounds the exact sum.
    """
    p = a.double() * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)  # TwoSum: s + err == p + c exactly
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def exp(x):
    x = torch.clamp(x.float(), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(-n, _LN2_LO, _fma(-n, _LN2_HI, x))
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + [0.5]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * scale)


def _log(u):
    """Natural log of u > 0 (XLA's Cephes-style log; u <= 0, inf and NaN
    take XLA's special values)."""
    m = torch.where(u > _MIN_NORMAL, u, torch.full_like(u, _MIN_NORMAL))
    bits = m.view(torch.int32)
    f = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    lt = f < _SQRT_HALF
    x = (f + -1.0) + torch.where(lt, f, torch.zeros_like(f))
    e = e - lt.to(torch.float32)
    z = x * x
    x3 = z * x
    p = _LOG_P
    y1 = _fma(_fma(x, p[0], p[1]), x, p[6])
    y2 = _fma(_fma(x, p[2], p[3]), x, p[7])
    y3 = _fma(_fma(x, p[4], p[5]), x, p[8])
    y = _fma(_fma(y1, x3, y2), x3, y3)
    y = _fma(y, x3, e * _LN2_LO)
    r = _fma(e, _LN2_HI, (x - z * 0.5) + y)
    r = torch.where((u <= 0) | torch.isnan(u), torch.full_like(r, float("nan")), r)
    r = torch.where(u == 0, torch.full_like(r, float("-inf")), r)
    return torch.where(u == float("inf"), u, r)


def log1p(x):
    x = x.float()
    big = _log(x + 1.0)
    x2 = x * x
    zero = x * 0.0
    q = zero + 1.0
    for c in _LOG1P_Q:
        q = _fma(q, x, c)
    p = zero + _LOG1P_P[0]
    for c in _LOG1P_P[1:]:
        p = _fma(p, x, c)
    small = x + (x2 * -0.5 + (x * x2) * (p / q))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, big)


def logistic(x):
    return _ftz(1.0 / (exp(-x) + 1.0))  # exp ends in a power-of-2 multiply


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    x = x.float()
    out = _ftz(torch.clamp_min(x, 0.0) + log1p(exp(-torch.abs(x))))
    return torch.where(x != x, x, out)


def tanh(x):
    x = x.float()
    ax = torch.abs(x)
    c = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    c2 = c * c
    num = _fma(c2, _TANH_NUM[0], _TANH_NUM[1])
    for k in _TANH_NUM[2:]:
        num = _fma(c2, num, k)
    num = c * num
    den = _fma(c2, _TANH_DEN[0], _TANH_DEN[1])
    for k in _TANH_DEN[2:]:
        den = _fma(c2, den, k)
    out = torch.where(ax < _TANH_SMALL, x, num / den)
    return torch.where(ax >= 20.0, torch.copysign(torch.ones_like(x), x), out)

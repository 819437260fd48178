"""float32 exp, log1p, tanh, logistic, softplus, erfc and ndtri as XLA's
CPU backend (and JAX's ndtri on top of it) computes them, from single
IEEE-rounded torch ops.

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

import numpy as np
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
    Python floats that are float32 constants). a * b is exact in float64, so
    the float64 sum s differs from the exact sum by less than half an ulp of
    float64, and rounding s to float32 rounds the exact sum unless s sits
    exactly on a float32 rounding tie (its low 29 bits 1 followed by zeros)
    or outside float32's normal range. On the CPU those rare elements alone
    take the exact path (:func:`_fma_round_to_odd`); on a GPU every element
    does, with no host synchronisation.
    """
    p = a.double() * b
    s = p + c
    if s.device.type != "cpu":
        return _fma_round_to_odd(p, c, s)
    bits = s.view(torch.int64)
    mag = torch.abs(s)
    risky = ((bits & 0x1FFFFFFF) == 0x10000000) | (mag >= 2.0 ** 127) \
        | ((mag < _MIN_NORMAL) & (s != 0))
    out = s.float()
    if bool(risky.any()):
        if isinstance(c, torch.Tensor):
            c = torch.broadcast_to(c, s.shape)[risky]
        out[risky] = _fma_round_to_odd(torch.broadcast_to(p, s.shape)[risky],
                                       c, s[risky])
    return out


def _fma_round_to_odd(p, c, s):
    """The FMA of the exact product p (float64) and c from their float64
    sum s: s rounded to odd (if it was inexact and its last bit is even, it
    moves one ulp toward the exact sum), then to float32. Rounding a
    round-to-odd value with 29 spare bits to float32 rounds the exact sum.
    """
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


def _f32(text: str) -> float:
    """A float32 constant as XLA's HLO text prints it (9 digits)."""
    return struct.unpack("f", struct.pack("f", float(text)))[0]


_ERFC_SMALL = [_f32(t) for t in (
    "7.85386146e-05", "-0.000801019371", "0.00518832775", "-0.0268538129",
    "0.112835854", "-0.37612626", "1.12837911")]
_ERFC_MID = [_f32(t) for t in (
    "0.0232682", "-0.138703942", "0.368742466", "-0.582473278",
    "0.621000469", "-0.494451523", "0.340488", "-0.274112701",
    "0.563825965")]
_ERFC_BIG = [_f32(t) for t in (
    "-10.477664", "12.9772", "-7.49551868", "2.92101908", "-1.01526523",
    "0.42184633", "-0.282076746", "0.564189494")]
_ERFC_UNDERFLOW = _f32("-88.7228394")


def erfc(x):
    """XLA's float32 erfc (its CHLO expansion): 1 - x * P(x^2) for |x| < 1,
    else exp(-x^2) / |x| * Q(1/x^2) (one of two polynomials, split at
    |x| = 2), reflected to 2 - erfc(-x) for x < 0; each multiply that
    feeds an add fused into an FMA."""
    x = _ftz(x.float())
    ax = torch.abs(x)
    x2 = _ftz(x * x)
    p = _fma(x2, _ERFC_SMALL[0], _ERFC_SMALL[1])
    for c in _ERFC_SMALL[2:]:
        p = _fma(p, x2, c)
    small = _fma(-x, p, 1.0)
    q = 1.0 / x2
    mid = _fma(q, _ERFC_MID[0], _ERFC_MID[1])
    for c in _ERFC_MID[2:]:
        mid = _fma(mid, q, c)
    big = _fma(q, _ERFC_BIG[0], _ERFC_BIG[1])
    for c in _ERFC_BIG[2:]:
        big = _fma(big, q, c)
    y = _ftz(exp(-x2) * (1.0 / ax))
    y = _ftz(y * torch.where(ax < 2.0, mid, big))
    y = torch.where(-x2 < _ERFC_UNDERFLOW, torch.zeros_like(y), y)
    y = torch.where(x < 0, 2.0 - y, y)
    return torch.where(ax < 1.0, small, y)


# Cephes' ndtri coefficients as jax.scipy.special.ndtri holds them (float32)
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
             -5.66762857469070293439E1, 1.39312609387279679503E1,
             -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
             8.63602421390890590575E1, -2.25462687854119370527E2,
             2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
             5.71628192246421288162E1, 4.40805073893200834700E1,
             1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
             -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
             4.13172038254672030440E1, 1.50425385692907503408E1,
             2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
             3.93881025292474443415E0, 1.33303460815807542389E0,
             2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6,
             6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
             1.37702099489081330271E0, 2.16236993594496635890E-1,
             1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval(coeffs, x):
    """jnp.polyval: y = 0, then y = y * x + c for each coefficient, each
    step one FMA (its jitted scan contracts them)."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = _fma(y, x, _f32(repr(c)))
    return y


def ndtri(p):
    """jax.scipy.special.ndtri in float32, called eagerly as the JAX
    package calls it: op by op (separate XLA computations, so nothing is
    contracted across ops), with ``jnp.polyval``'s FMAs and XLA's log."""
    p = p.float()
    big_p = _f32(repr(float(-np.expm1(-2.0))))
    mcp = torch.where(p > big_p, 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, torch.full_like(mcp, 0.5), mcp)
    w = mcp - 0.5
    ww = w * w
    sqrt_2pi = _f32(repr(float(np.sqrt(2.0 * np.pi))))
    x_big = w + (w * ww) * (_polyval(_NDTRI_P0, ww) / _polyval(_NDTRI_Q0, ww))
    x_big = x_big * -sqrt_2pi
    z = torch.sqrt((-2.0 * _log(mcp)).double()).float()
    first = z - _log(z) / z
    inv_z = 1.0 / z
    x_small = first - (_polyval(_NDTRI_P2, inv_z) / _polyval(_NDTRI_Q2, inv_z)
                       ) / z
    x_other = first - (_polyval(_NDTRI_P1, inv_z) / _polyval(_NDTRI_Q1, inv_z)
                       ) / z
    x = torch.where(mcp > _f32(repr(float(np.exp(-2.0)))), x_big,
                    torch.where(z >= 8.0, x_small, x_other))
    x = torch.where(p > _f32(repr(float(1.0 - np.exp(-2.0)))), x, -x)
    x = torch.where(p == 0.0, torch.full_like(x, -float("inf")), x)
    return torch.where(p == 1.0, torch.full_like(x, float("inf")), x)

"""Hand-written CUDA kernels for the interleaved rANS coder.

``encode_scan`` replaces flashgmm_tpu/ans/pallas_coder.py::_encode_kernel and
``decode_scan`` replaces ::_decode_kernel (sources:
``flashgmm_tpu_torch/csrc/rans_kernels.cu``). Each wrapper takes the plain
version in ``interleaved.py`` only for tensors on the CPU; for CUDA tensors
it launches its kernel or raises. ``<wrapper>.launches`` counts the kernel
launches. The decoders raise on a desynchronised stream at once, or, given
an error flag (``err``), set it on the device without waiting, so that a
CUDA graph can capture them (``runtime/latency_codec.py``).

``encode_scan_gmm`` is the same encoder with each symbol's (start, freq)
evaluated inside it from the symbol's [K] mixture parameters
(``gaussian_cdf.gmm_guarded_bounds``, which it replaces on the batched
codec's y passes), and ``decode_scan_gmm`` the same decoder with the rows'
entries evaluated at the probes of its search: both by the code the full
rows come from, ``csrc/gmm_entry.cuh``, so no bounds or rows tensor is
built. Both kernels have compile-time instances for K = 4 (the GMM codecs)
and K = 1 (the single-Gaussian codec, ``FastCheckerboardGsmCodec``: zero
means, unit weights) and a runtime-K loop for any other K; the bits do not
depend on the instance. ``<wrapper>.launches_k1`` counts the K = 1
instance's launches among ``launches``.

What bounds them on the card: encode spreads the lanes over the card in
slabs of 32, one CTA each; 16 producer warps a CTA stage the inputs of
chunks of 16 steps ahead (cp.async) and turn them into records (start,
freq and an exact reciprocal of freq), one warp runs the serial state chain
over them. The GMM encoder is bound by its producers, whose two GMM
entries a symbol are some thousands of cycles of latency and take most of
an SM's instruction issue at W=4096; a chunk takes about one record's time
whatever the number of active lanes, so at a small T the pass costs its
chunks, not its chain (``chip_profile.py --encode``). Decode spreads the W
lanes over one thread-block cluster of up to 16 CTAs (one SM each); its
steps are serial, each a dependent row search, a cluster-wide scan with
one cluster barrier and a dependent stream read: latency bound. The
cluster has min(MAX_CLUSTER, ceil(W / 256)) CTAs (8 where more do not fit
on the card); the tests and ``chip_profile.py --decode`` lower
``MAX_CLUSTER`` to reach the smaller sizes at a given W, whose symbols
must be equal.
"""

import ctypes

import torch

from flashgmm_tpu_torch import _build
from flashgmm_tpu_torch.ans import interleaved as il
from flashgmm_tpu_torch.ans.gaussian_cdf import (gmm_guarded_bounds_plain,
                                                 gmm_guarded_rows_plain)
from flashgmm_tpu_torch.ans.rows_kernel import MAX_K

MAX_CLUSTER = 16  # the decoder's cluster size cap (Hopper's non-portable max)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _u32_as_i32(states):
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    states = states.long() & il.MASK32
    return torch.where(states >= 2**31, states - 2**32, states).to(torch.int32)


def encode_scan(starts, freqs, active):
    """W lockstep rANS encoders over T steps in reverse time.

    Same contract as :func:`interleaved.encode_scan`: returns (states int64
    [W], words int32 [T, W], emits bool [T, W]).
    """
    if starts.device.type == "cpu":
        return il.encode_scan(starts, freqs, active)
    _build.require_cuda("rans encode", starts, freqs, active)
    if starts.dim() != 2 or freqs.shape != starts.shape \
            or active.shape != starts.shape:
        raise ValueError(f"rans encode: shapes {tuple(starts.shape)}, "
                         f"{tuple(freqs.shape)}, {tuple(active.shape)}")
    T, W = starts.shape
    starts = starts.to(torch.int32).contiguous()
    freqs = freqs.to(torch.int32).contiguous()
    active = active.to(torch.bool).contiguous()
    states = torch.empty(W, dtype=torch.int32, device=starts.device)
    words = torch.empty((T, W), dtype=torch.int32, device=starts.device)
    emits = torch.empty((T, W), dtype=torch.bool, device=starts.device)
    lib = _build.load().lib
    with torch.cuda.device(starts.device):
        rc = lib.fg_rans_encode(_ptr(starts), _ptr(freqs), _ptr(active), T, W,
                                _ptr(states), _ptr(words), _ptr(emits),
                                _build.stream_ptr(starts))
    _build.check(rc, "rans encode")
    encode_scan.launches += 1
    return states.long() & il.MASK32, words, emits


encode_scan.launches = 0


def _mulhi32(m, x):
    """(m * x) >> 32 of int64 tensors with values < 2^32, without int64
    overflow."""
    return (m * (x >> 16) + ((m * (x & il.MASK16)) >> 16)) >> 16


def encode_reciprocal(freq):
    """The encoder kernel's reciprocal of each divisor 1 <= freq <= 65536
    (csrc/rans_kernels.cu, ``encode_record``), as int64 tensors (m, shift1,
    shift2): Granlund and Montgomery's multiplier m = floor(2^32 (2^l -
    freq) / freq) + 1 with l = ceil(log2 freq), computed as the kernel does
    by two 32-bit divisions."""
    d = freq.long()
    l = torch.zeros_like(d)
    for b in range(17):  # bit length of d - 1
        l += ((d - 1) >> b) > 0
    a = (1 << l) - d
    hi = torch.div(a << 16, d, rounding_mode="floor")
    m = (hi << 16) + torch.div(((a << 16) - hi * d) << 16, d,
                               rounding_mode="floor") + 1
    return m, torch.clamp(l, max=1), torch.clamp(l - 1, min=0)


def divmod_reciprocal(x, freq):
    """(x // freq, x % freq) as the encoder kernel's chain computes them
    from ``encode_reciprocal(freq)``, for u32 x in int64: a multiply-high
    and two shifts, the remainder by a multiply-subtract. Equal to
    ``interleaved.divmod_rans`` (tests/test_torch_port_encode_gmm.py)."""
    x = x.long()
    m, s1, s2 = encode_reciprocal(freq)
    t = _mulhi32(m, x)
    q = (t + ((x - t) >> s1)) >> s2
    return q, x - q * freq.long()


def encode_scan_gmm_plain(values, scales, means, weights, lo: int,
                          num_bins: int, mode: int = 0, w: int = 128):
    """The plain version: each symbol's (start, freq) from the guarded
    rows' entries, laid over w lanes, then the plain encoder."""
    n = values.shape[0]
    t, _ = il.layout(n, w)
    start, freq = gmm_guarded_bounds_plain(values, scales, means, weights, lo,
                                           num_bins, mode)
    return il.encode_scan(il.to_lanes(start, w), il.to_lanes(freq, w),
                          il.active_mask(n, t, w, values.device))


def encode_scan_gmm(values, scales, means, weights, lo: int, num_bins: int,
                    mode: int = 0, w: int = 128):
    """Encode n symbols over w lanes (symbol i at step i // w, lane i % w;
    T = ceil(n / w) steps, lanes at or past n inactive), each under the
    guarded GMM row of its float32 [K] scales, means and weights, evaluated
    inside the kernel. values int [n] in [lo, lo + num_bins). Returns
    (states int64 [w], words int32 [T, w], emits bool [T, w]), equal to
    ``encode_scan`` over ``gmm_guarded_bounds`` laid over the lanes
    (:func:`encode_scan_gmm_plain`)."""
    if scales.device.type == "cpu":
        return encode_scan_gmm_plain(values, scales, means, weights, lo,
                                     num_bins, mode, w)
    name = "rans encode gmm"
    _build.require_cuda(name, values, scales, means, weights)
    if values.dim() != 1 or values.dtype.is_floating_point:
        raise ValueError(f"{name}: values {tuple(values.shape)} "
                         f"{values.dtype} (need integer [n])")
    w = int(w)
    if w < 1:
        raise ValueError(f"{name}: {w} lanes")
    n = values.shape[0]
    T, _ = il.layout(n, w)
    scales, means, weights, k = _gmm_params(name, scales, means, weights,
                                            n, lo, num_bins, mode)
    if scales.shape[0] != n:
        raise ValueError(f"{name}: {n} values, {scales.shape[0]} parameters")
    values = values.to(torch.int32).contiguous()
    dev = values.device
    states = torch.empty(w, dtype=torch.int64, device=dev)  # < 2^32
    words = torch.empty((T, w), dtype=torch.int32, device=dev)
    emits = torch.empty((T, w), dtype=torch.bool, device=dev)
    lib = _build.load().lib
    with torch.cuda.device(dev):
        rc = lib.fg_rans_encode_gmm(
            _ptr(values), _ptr(scales), _ptr(means), _ptr(weights), n, k,
            int(lo), num_bins + 1, int(mode), T, w, _ptr(states),
            _ptr(words), _ptr(emits), _build.stream_ptr(values))
    _build.check(rc, name)
    encode_scan_gmm.launches += 1
    if k == 1:
        encode_scan_gmm.launches_k1 += 1
    return states, words, emits


encode_scan_gmm.launches = 0
encode_scan_gmm.launches_k1 = 0  # of them the K = 1 instance's


def _gmm_params(name, scales, means, weights, lanes, lo, num_bins, mode):
    """Refuse GMM arguments the coder kernels do not take (at most ``lanes``
    symbols); returns the parameters contiguous, and K."""
    if any(t.dtype != torch.float32 for t in (scales, means, weights)):
        raise TypeError(f"{name}: scales, means and weights must be float32")
    if scales.dim() != 2 or means.shape != scales.shape \
            or weights.shape != scales.shape:
        raise ValueError(f"{name}: parameters {tuple(scales.shape)}, "
                         f"{tuple(means.shape)}, {tuple(weights.shape)} "
                         "(need three equal [n, K])")
    n, k = scales.shape
    if not 1 <= n <= lanes or not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: n={n}, K={k} for {lanes} lanes")
    if mode not in (0, 1, 2):
        raise ValueError(f"{name}: APPROX_MODE {mode}")
    if not 2 <= num_bins + 1 < 65536 or abs(int(lo)) >= 1 << 22:
        raise ValueError(f"{name}: lo={lo}, num_bins={num_bins}")
    return (*(t.contiguous() for t in (scales, means, weights)), k)


def _check_decode_args(name, states, stream, active):
    """(T, W) of a decode; refuses shapes the kernel does not take."""
    if active.dim() != 2:
        raise ValueError(f"{name}: active {tuple(active.shape)} (need [T, W])")
    T, W = active.shape
    if states.shape != (W,) or stream.dim() != 1:
        raise ValueError(f"{name}: shapes {tuple(states.shape)}, "
                         f"{tuple(stream.shape)}, {tuple(active.shape)}")
    return T, W


def _launch_decode(name, entry, states, stream, source, active, tail,
                   err=None):
    """Launch a decoder entry, whose arguments are (states, stream,
    n_stream, *source, active, *tail, MAX_CLUSTER, out, err, stream);
    returns int32 [T, W] symbols. Raises on a refused launch. Without
    ``err`` it waits for the kernel and raises on a desynchronised stream;
    with it the kernel ORs 1 into ``err`` and nothing waits (a CUDA graph
    can capture the call; the caller checks the flag)."""
    T, W = active.shape
    dev = active.device
    states32 = _u32_as_i32(states).contiguous()
    stream = stream.to(torch.int32).contiguous()
    active = active.to(torch.bool).contiguous()
    out = torch.empty((T, W), dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev) if err is None else err
    lib = _build.load().lib
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            _ptr(states32), _ptr(stream), stream.numel(), *source,
            _ptr(active), *tail, MAX_CLUSTER, _ptr(out), _ptr(flag),
            _build.stream_ptr(active))
    _build.check(rc, name)
    if err is None and int(flag.item()):
        raise RuntimeError(f"{name}: stream read past its end "
                           "(desynchronised or truncated stream)")
    return out


def _check_err(name, err, device):
    """Refuse an error flag the decoders do not take: int32 [1], on the
    decoder's device."""
    if err is not None and (err.dtype != torch.int32
                            or tuple(err.shape) != (1,)
                            or err.device != device):
        raise ValueError(f"{name}: err {err.dtype} {tuple(err.shape)} on "
                         f"{err.device} (need int32 [1] on {device})")


def decode_scan(states, stream, rows, active, lo: int, err=None):
    """T decode steps of W lanes over materialized rows int32 [T, W, L].

    Same contract as :func:`interleaved.decode_scan` for rows that never
    decrease along L, as every row of the codec does: returns int32 [T, W]
    symbols. The kernel finds each count by bisection and the plain version
    counts directly, so on a row that decreases the two may differ. Raises
    if the stream desynchronised and read past its end, or, given ``err``
    (int32 [1] on the device), sets it to 1 instead and does not wait for
    the kernel, so the call can be captured in a CUDA graph; one flag may
    serve several decodes, since the kernel only ever writes 1 to it. The
    plain version never reads past its stream's end and leaves ``err`` as
    it is.
    """
    _check_err("rans decode", err, rows.device)
    if rows.device.type == "cpu":
        return il.decode_scan(states, stream, rows, active, lo)
    _build.require_cuda("rans decode", states, stream, rows, active)
    T, W = _check_decode_args("rans decode", states, stream, active)
    if rows.dim() != 3 or rows.shape[:2] != (T, W) or rows.shape[2] < 2:
        raise ValueError(f"rans decode: rows {tuple(rows.shape)} for "
                         f"[T, W] = {[T, W]} (need [T, W, L >= 2])")
    rows = rows.to(torch.int32).contiguous()
    out = _launch_decode("rans decode", "fg_rans_decode", states, stream,
                         (_ptr(rows),), active, (int(lo), T, W, rows.shape[2]),
                         err)
    decode_scan.launches += 1
    return out


decode_scan.launches = 0


def decode_scan_gmm_plain(states, stream, scales, means, weights, active,
                          lo: int, num_bins: int, mode: int = 0):
    """The plain version: the full rows of the n symbols (padding lanes past
    n get zero rows; they are inactive), then the plain decoder."""
    T, W = active.shape
    rows = gmm_guarded_rows_plain(scales, means, weights, lo, num_bins, mode)
    pad = T * W - rows.shape[0]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
    return il.decode_scan(states, stream, rows.reshape(T, W, -1), active, lo)


def decode_scan_gmm(states, stream, scales, means, weights, active, lo: int,
                    num_bins: int, mode: int = 0, err=None):
    """T decode steps of W lanes whose rows are the guarded GMM rows of
    symbols 0..n-1 (symbol i at step i // W, lane i % W), evaluated on
    demand. scales/means/weights float32 [n, K] with n <= T * W; lanes at
    or past n must be inactive. Returns int32 [T, W] symbols, equal to
    ``il.decode_scan(states, stream, gmm_guarded_rows_plain(...), active,
    lo)`` on the rows padded to [T, W, L]. The guarded rows never decrease
    along L (CDF entries plus j, capped by 65536), as the kernel's bisection
    needs; see :func:`decode_scan`, also for ``err``."""
    _check_err("rans decode gmm", err, scales.device)
    if scales.device.type == "cpu":
        return decode_scan_gmm_plain(states, stream, scales, means, weights,
                                     active, lo, num_bins, mode)
    name = "rans decode gmm"
    _build.require_cuda(name, states, stream, scales, means, weights, active)
    T, W = _check_decode_args(name, states, stream, active)
    scales, means, weights, k = _gmm_params(name, scales, means, weights,
                                            T * W, lo, num_bins, mode)
    n = scales.shape[0]
    L = num_bins + 1
    out = _launch_decode(
        name, "fg_rans_decode_gmm", states, stream,
        (_ptr(scales), _ptr(means), _ptr(weights), n, k), active,
        (int(lo), T, W, L, int(mode)), err)
    decode_scan_gmm.launches += 1
    if k == 1:
        decode_scan_gmm.launches_k1 += 1
    return out


decode_scan_gmm.launches = 0
decode_scan_gmm.launches_k1 = 0  # of them the K = 1 instance's


"""Hand-written CUDA kernels for the interleaved rANS coder.

``encode_scan`` replaces flashgmm_tpu/ans/pallas_coder.py::_encode_kernel and
``decode_scan`` replaces ::_decode_kernel (sources:
``flashgmm_tpu_torch/csrc/rans_kernels.cu``). Each wrapper takes the plain
version in ``interleaved.py`` only for tensors on the CPU; for CUDA tensors
it launches its kernel or raises. ``<wrapper>.launches`` counts the kernel
launches.

What bounds them on the card: encode is one thread per lane, a serial walk
over T with a few bytes read and written per step (memory bound, and
latency bound at small T). Decode is one CTA per pass stream (one SM), a
serial walk over T whose every step ends in a CTA-wide scan and a dependent
stream read: latency bound, and using 1 of the 132 SMs is this version's
known limit.
"""

import ctypes

import torch

from flashgmm_tpu_torch import _build
from flashgmm_tpu_torch.ans import interleaved as il

MAX_DECODE_LANES = 4096  # 4 lanes for each of 1024 threads in one CTA


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


def decode_scan(states, stream, rows, active, lo: int):
    """T decode steps of W lanes, one CTA for the whole stream.

    Same contract as :func:`interleaved.decode_scan`: returns int32 [T, W]
    symbols. Raises if the stream desynchronised and read past its end.
    """
    if rows.device.type == "cpu":
        return il.decode_scan(states, stream, rows, active, lo)
    _build.require_cuda("rans decode", states, stream, rows, active)
    T, W, L = rows.shape
    if states.shape != (W,) or active.shape != (T, W) or stream.dim() != 1:
        raise ValueError(f"rans decode: shapes {tuple(states.shape)}, "
                         f"{tuple(stream.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(active.shape)}")
    if W > MAX_DECODE_LANES or L < 2:
        raise ValueError(f"rans decode: W={W} (max {MAX_DECODE_LANES}), "
                         f"L={L} (min 2)")
    states32 = _u32_as_i32(states).contiguous()
    stream = stream.to(torch.int32).contiguous()
    rows = rows.to(torch.int32).contiguous()
    active = active.to(torch.bool).contiguous()
    out = torch.empty((T, W), dtype=torch.int32, device=rows.device)
    err = torch.zeros(1, dtype=torch.int32, device=rows.device)
    lib = _build.load().lib
    with torch.cuda.device(rows.device):
        rc = lib.fg_rans_decode(_ptr(states32), _ptr(stream), stream.numel(),
                                _ptr(rows), _ptr(active), int(lo), T, W, L,
                                _ptr(out), _ptr(err), _build.stream_ptr(rows))
    _build.check(rc, "rans decode")
    decode_scan.launches += 1
    if int(err.item()):
        raise RuntimeError("rans decode: stream read past its end "
                           "(desynchronised or truncated stream)")
    return out


decode_scan.launches = 0

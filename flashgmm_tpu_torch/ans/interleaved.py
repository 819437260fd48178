"""Interleaved 32-bit rANS: layout helpers and the plain coder.

Port of flashgmm_tpu/ans/interleaved.py. Symbols are round-robined over W
lanes (symbol i -> step i // W, lane i % W); each lane runs its own 32-bit
rANS chain (state in [2^16, 2^32), 16-bit probabilities, 16-bit words), and
each step emits or consumes at most one word per lane, so the stream is laid
out in (t, lane) order. The byte format is docs/bitstream.md §2.

These are the PLAIN versions of the hand kernels in ``rans_kernels.py``:
integer math in int64, masked to 32 bits (torch has no full uint32
arithmetic). They are the CPU path and what the kernels are held against.

Tensor types at this boundary: states int64 [W] (values < 2^32), starts,
freqs, words, rows and streams int32 (u16 payloads), masks bool.
"""

import torch

RANS_L = 1 << 16
M_TOTAL = 1 << 16  # probability denominator
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF


def divmod_rans(a, f):
    """Exact (a // f, a % f) for the encoder's u32 state and 1 <= f < 2^16.

    The reference builds this from float estimates because a TPU has no
    fast u32 division; int64 division here (and u32 division in the CUDA
    kernel) is exact as it is."""
    return torch.div(a, f, rounding_mode="floor"), torch.remainder(a, f)


def encode_scan(starts, freqs, active):
    """Run W interleaved rANS encoders over T steps, in reverse time.

    Args:
        starts: int [T, W] quantized CDF at each symbol (< 2^16).
        freqs: int [T, W] bin widths (>= 1 where active).
        active: bool [T, W] validity mask (padding lanes are skipped).

    Returns:
        states: int64 [W] final lane states (decoder init values).
        words: int32 [T, W] candidate emission words.
        emits: bool [T, W] emission mask (in decoder consumption order).
    """
    T, W = starts.shape
    starts = starts.long()
    freqs = freqs.long()
    x = torch.full((W,), RANS_L, dtype=torch.int64, device=starts.device)
    words = torch.empty((T, W), dtype=torch.int32, device=starts.device)
    emits = torch.empty((T, W), dtype=torch.bool, device=starts.device)
    for t in range(T - 1, -1, -1):
        act = active[t]
        freq = freqs[t]
        emit = act & (x >= (freq << 16))
        words[t] = (x & MASK16).to(torch.int32)
        emits[t] = emit
        x1 = torch.where(emit, x >> 16, x)
        q, r = divmod_rans(x1, torch.where(act, freq, 1))
        x2 = ((q << 16) + r + starts[t]) & MASK32
        x = torch.where(act, x2, x)
    return x, words, emits


def pack_words(words, emits):
    """Compact [T, W] emissions into a flat stream in (t, lane) order.

    Returns (stream int32 [T*W] zero-padded, n_words int64 scalar tensor).
    Runs as torch ops on any device (a cumsum and a scatter), as the
    reference leaves it to XLA; nothing here waits for the device.
    """
    T, W = words.shape
    flat_w = words.reshape(-1).to(torch.int32)
    flat_e = emits.reshape(-1)
    pos = torch.cumsum(flat_e.to(torch.int64), 0) - 1
    n_words = pos[-1] + 1
    # non-emitting entries scatter into one spare slot that is cut off
    idx = torch.where(flat_e, pos, T * W)
    stream = torch.zeros(T * W + 1, dtype=torch.int32, device=words.device)
    stream.scatter_(0, idx, flat_w)
    return stream[: T * W], n_words


def decode_scan(states, stream, rows, active, lo: int):
    """Decode T*W symbols with per-symbol CDF rows.

    Args:
        states: int64 [W] lane init states (from the encoder).
        stream: int [S] word stream in consumption order (u16 values).
        rows: int [T, W, L] non-decreasing boundary CDFs, rows[..., 0] the
            CDF below the first bin and rows[..., L-1] = 65536. Symbol value
            = lo + bin.
        active: bool [T, W].
        lo: value of the first bin.

    Returns:
        symbols: int32 [T, W] decoded values (0 where inactive).
    """
    T, W, L = rows.shape
    dev = rows.device
    # pad the stream so a W-word window never reads short (as the reference)
    stream = torch.cat([stream.long(),
                        torch.zeros(W, dtype=torch.int64, device=dev)])
    x = states.long() & MASK32
    g = torch.zeros((), dtype=torch.int64, device=dev)
    limit = stream.shape[0] - W  # the reference's dynamic_slice clamps here
    symbols = torch.empty((T, W), dtype=torch.int32, device=dev)
    for t in range(T):
        row = rows[t].long()
        act = active[t]
        cf = x & MASK16
        below = row <= cf[:, None]
        count = below.sum(1)
        s = torch.clamp(count - 1, 0, L - 2)
        start = torch.where(below, row, 0).amax(1)
        nxt = torch.where(below, 65536, row).amin(1)
        x2 = ((nxt - start) * (x >> 16) + cf - start) & MASK32
        need = act & (x2 < RANS_L)
        need_i = need.long()
        rank = torch.cumsum(need_i, 0) - need_i
        word = stream[torch.clamp(g, max=limit) + rank]
        x3 = torch.where(need, ((x2 << 16) | word) & MASK32, x2)
        x = torch.where(act, x3, x)
        g = g + need_i.sum()
        symbols[t] = torch.where(act, lo + s, 0).to(torch.int32)
    return symbols


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def layout(n: int, w: int):
    """(T, pad) for laying n symbols over w lanes."""
    t = -(-max(n, 1) // w)
    return t, t * w - n


def to_lanes(x, w: int, fill=0):
    """[N, ...] -> [T, W, ...] row-major with padding."""
    n = x.shape[0]
    t, pad = layout(n, w)
    if pad:
        block = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device)
        x = torch.cat([x, block])
    return x.reshape((t, w) + tuple(x.shape[1:]))


def active_mask(n: int, t: int, w: int, device=None):
    idx = torch.arange(t * w, device=device).reshape(t, w)
    return idx < n


def from_lanes(x, n: int):
    """[T, W, ...] -> [N, ...]."""
    t, w = x.shape[:2]
    return x.reshape((t * w,) + tuple(x.shape[2:]))[:n]

"""Pure-Python/numpy rANS coder (the port's copy of
flashgmm_tpu/ans/rans_numpy.py; numpy only).

Implements the same bitstream format as the FlashGMM/CompressAI coder
(the reference's compressai/cpp_exts/rans/rans_interface.cpp and
third_party/ryg_rans/rans64.h): 64-bit rANS state, 32-bit word
renormalization, 16-bit probability precision, 4-bit bypass chunks.

Two symbol families:

* **table path** (``encode_with_indexes``/``decode_with_indexes``): per-symbol
  quantized-CDF tables with out-of-range escape into the last bin + bypass
  coding of the raw overflow value (rans_interface.cpp:334-399, 619-688).

* **rows path** (``encode_rows``/``decode_rows``): table-free coding where the
  per-symbol boundary CDFs (uint16) have been precomputed — on the device,
  in this framework — as ``rows[i, j] = u16(cdf_i(lo + j - 0.5) * 65535)``.
  A pmf of zero escapes to bypass with sentinel ``cum_freq == 65535``
  (rans_interface.cpp:458-554, 766-883). This path produces bitstreams
  identical to the reference GMM/GSM coder whenever the row values match the
  reference's float evaluation.

The host coder (``flashgmm_tpu_torch.ans.cext``, the port's build of
csrc/rans.cpp) writes the same bytes. This module is the slow,
obviously-correct cross-check: it is reached by importing it, never as a
fallback of ``RansEncoder`` / ``RansDecoder``, which raise when the host
coder does not build.
"""

import numpy as np

RANS64_L = 1 << 31
PRECISION = 16
MAX_CDF_VALUE = (1 << PRECISION) - 1  # 65535
BYPASS_PRECISION = 4
MAX_BYPASS_VAL = (1 << BYPASS_PRECISION) - 1

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


class _SymbolBuffer:
    """Buffered (start, freq, is_raw_bits) symbols, flushed in reverse."""

    def __init__(self):
        self.syms = []

    def put(self, start, freq):
        self.syms.append((int(start), int(freq), False))

    def put_bits(self, val):
        self.syms.append((int(val), 0, True))

    def put_bypass_value(self, raw_val):
        """Encode a non-negative raw value as a chunk-count prefix plus
        BYPASS_PRECISION-bit chunks (LSB-first)."""
        raw_val = int(raw_val) & _MASK32
        n_bypass = 0
        while (raw_val >> (n_bypass * BYPASS_PRECISION)) != 0:
            n_bypass += 1
        val = n_bypass
        while val >= MAX_BYPASS_VAL:
            self.put_bits(MAX_BYPASS_VAL)
            val -= MAX_BYPASS_VAL
        self.put_bits(val)
        for j in range(n_bypass):
            self.put_bits((raw_val >> (j * BYPASS_PRECISION)) & MAX_BYPASS_VAL)

    def flush(self) -> bytes:
        state = RANS64_L
        words = []
        for start, freq, is_bits in reversed(self.syms):
            if is_bits:
                nbits = BYPASS_PRECISION
                f = 1 << (16 - nbits)
                x_max = ((RANS64_L >> 16) << 32) * f
                if state >= x_max:
                    words.append(state & _MASK32)
                    state >>= 32
                state = (state << nbits) | start
            else:
                x_max = ((RANS64_L >> PRECISION) << 32) * freq
                if state >= x_max:
                    words.append(state & _MASK32)
                    state >>= 32
                state = ((state // freq) << PRECISION) + (state % freq) + start
        out = [state & _MASK32, (state >> 32) & _MASK32]
        out.extend(reversed(words))
        return np.asarray(out, dtype=np.uint32).tobytes()


class _Decoder:
    def __init__(self, data: bytes):
        nwords = len(data) // 4
        self.words = np.frombuffer(data[: nwords * 4], dtype=np.uint32)
        # Guard against reads past the stream end (matches C++ UB-free usage).
        self.pos = 2
        self.state = int(self.words[0]) | (int(self.words[1]) << 32)

    def peek(self):
        return self.state & _MASK16

    def _renorm(self, x):
        if x < RANS64_L and self.pos < len(self.words):
            x = (x << 32) | int(self.words[self.pos])
            self.pos += 1
        return x

    def advance(self, start, freq):
        x = self.state
        x = freq * (x >> PRECISION) + (x & _MASK16) - start
        self.state = self._renorm(x)

    def get_bits(self, nbits=BYPASS_PRECISION):
        x = self.state
        val = x & ((1 << nbits) - 1)
        self.state = self._renorm(x >> nbits)
        return int(val)

    def get_bypass_value(self) -> int:
        val = self.get_bits()
        n_bypass = val
        while val == MAX_BYPASS_VAL:
            val = self.get_bits()
            n_bypass += val
        raw = 0
        for j in range(n_bypass):
            raw |= self.get_bits() << (j * BYPASS_PRECISION)
        return raw


# ---------------------------------------------------------------------------
# Table path (EntropyBottleneck / GaussianConditional)
# ---------------------------------------------------------------------------


def encode_with_indexes(symbols, indexes, cdfs, cdfs_sizes, offsets) -> bytes:
    """Table-indexed encoding with out-of-range bypass escape.

    Args:
        symbols: int32 [N] quantized values (offsets NOT yet subtracted).
        indexes: int32 [N] row into ``cdfs`` per symbol.
        cdfs: int32 [num_cdfs, max_len] quantized CDFs (rows padded).
        cdfs_sizes: int32 [num_cdfs] valid lengths.
        offsets: int32 [num_cdfs].
    """
    symbols = np.asarray(symbols, dtype=np.int64).ravel()
    indexes = np.asarray(indexes, dtype=np.int64).ravel()
    cdfs = np.asarray(cdfs, dtype=np.int64)
    cdfs_sizes = np.asarray(cdfs_sizes, dtype=np.int64).ravel()
    offsets = np.asarray(offsets, dtype=np.int64).ravel()

    buf = _SymbolBuffer()
    for i in range(symbols.shape[0]):
        idx = indexes[i]
        cdf = cdfs[idx]
        max_value = cdfs_sizes[idx] - 2
        value = symbols[i] - offsets[idx]

        raw_val = 0
        if value < 0:
            raw_val = -2 * value - 1
            value = max_value
        elif value >= max_value:
            raw_val = 2 * (value - max_value)
            value = max_value

        buf.put(cdf[value], cdf[value + 1] - cdf[value])

        if value == max_value:
            buf.put_bypass_value(raw_val)
    return buf.flush()


def decode_with_indexes(encoded, indexes, cdfs, cdfs_sizes, offsets):
    indexes = np.asarray(indexes, dtype=np.int64).ravel()
    cdfs = np.asarray(cdfs, dtype=np.int64)
    cdfs_sizes = np.asarray(cdfs_sizes, dtype=np.int64).ravel()
    offsets = np.asarray(offsets, dtype=np.int64).ravel()

    out = np.empty(indexes.shape[0], dtype=np.int32)
    dec = _Decoder(encoded)
    for i in range(indexes.shape[0]):
        idx = indexes[i]
        cdf = cdfs[idx]
        size = cdfs_sizes[idx]
        max_value = size - 2

        cum_freq = dec.peek()
        # leftmost s with cdf[s] <= cum_freq < cdf[s+1]
        s = int(np.searchsorted(cdf[:size], cum_freq, side="right")) - 1
        dec.advance(cdf[s], cdf[s + 1] - cdf[s])

        value = s
        if value == max_value:
            raw_val = dec.get_bypass_value()
            value = raw_val >> 1
            if raw_val & 1:
                value = -value - 1
            else:
                value += max_value
        out[i] = value + offsets[idx]
    return out


# ---------------------------------------------------------------------------
# Rows path (table-free GMM / single-Gaussian; boundary CDFs from the device)
# ---------------------------------------------------------------------------


def encode_rows(values, rows, lo: int) -> bytes:
    """Encode with precomputed per-symbol boundary CDF rows.

    Args:
        values: int32 [N] quantized symbol values.
        rows: uint16 [N, L] with ``rows[i, j] = u16(cdf_i(lo + j - 0.5)*65535)``.
        lo: integer value of the first bin.
    """
    values = np.asarray(values, dtype=np.int64).ravel()
    rows = np.asarray(rows, dtype=np.uint16)
    assert rows.shape[0] == values.shape[0]

    buf = _SymbolBuffer()
    for i in range(values.shape[0]):
        v = values[i]
        j = int(v - lo)
        start = int(rows[i, j])
        nxt = int(rows[i, j + 1])
        pmf = (nxt - start) & _MASK16
        if pmf == 0:
            # bypass: sentinel slot [65535, 65536), then raw int32 chunks
            buf.put(MAX_CDF_VALUE, 1)
            buf.put_bypass_value(np.int64(v) & _MASK32)
        else:
            buf.put(start, pmf)
    return buf.flush()


def decode_rows(encoded, rows, lo: int):
    """Decode with precomputed rows; binary search per symbol.

    Mirrors rans_interface.cpp:766-883 (search-based GMM decode): the bin
    containing ``cum_freq`` is the encoded symbol; ``cum_freq == 65535``
    escapes to bypass.
    """
    rows = np.asarray(rows, dtype=np.uint16)
    n, L = rows.shape
    out = np.empty(n, dtype=np.int32)
    dec = _Decoder(encoded)
    for i in range(n):
        cum_freq = dec.peek()
        if cum_freq == MAX_CDF_VALUE:
            dec.advance(MAX_CDF_VALUE, 1)
            raw = dec.get_bypass_value()
            out[i] = np.int32(np.uint32(raw))
        else:
            row = rows[i]
            s = int(np.searchsorted(row, cum_freq, side="right")) - 1
            s = max(0, min(s, L - 2))
            start = int(row[s])
            pmf = (int(row[s + 1]) - start) & _MASK16
            if pmf == 0:
                pmf = 1
                if start + pmf > (1 << PRECISION):
                    start = (1 << PRECISION) - pmf
            dec.advance(start, pmf)
            out[i] = lo + s
    return out

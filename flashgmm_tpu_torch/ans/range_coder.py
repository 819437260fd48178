"""Optional range-coder backend (the port's copy of
flashgmm_tpu/ans/range_coder.py; cf. the reference's optional
``range_coder`` pip backend, compressai/__init__.py:53-58).

A carry-less byte-oriented range coder (Subbotin style) implementing the
same table-path semantics as the rANS backend (same CDF tables, same
out-of-range escape folding) AND the search-path "rows" semantics used by
the GSM/GMM entropy models (same per-symbol quantized boundary rows, same
``cum_freq == 65535`` bypass sentinel), so models can switch backends via
``flashgmm_tpu_torch.set_entropy_coder("rangecoder")`` for both table-based
and table-free real coding. Pure numpy; slower than the C++ rANS path —
provided for API parity and cross-checking. Note: the reference's optional
backend covers the table path only; the rows path here goes beyond it.
"""

import numpy as np

TOP = 1 << 24
BOT = 1 << 16
PRECISION = 16
BYPASS_PRECISION = 4
MAX_BYPASS_VAL = (1 << BYPASS_PRECISION) - 1
MASK32 = 0xFFFFFFFF


class RangeEncoder:
    def __init__(self):
        self.low = 0
        self.range = MASK32
        self.out = bytearray()

    def _normalize(self):
        while True:
            hi = (self.low + self.range) & MASK32
            if (self.low ^ hi) < TOP:
                pass
            elif self.range < BOT:
                self.range = (-self.low) & (BOT - 1)
            else:
                break
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & MASK32
            self.range = (self.range << 8) & MASK32

    def encode(self, start, freq, total_bits=PRECISION):
        total = 1 << total_bits
        r = self.range // total
        self.low = (self.low + r * start) & MASK32
        self.range = r * freq
        self._normalize()

    def encode_bits(self, val, nbits):
        self.encode(val, 1, nbits)

    def finish(self) -> bytes:
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & MASK32
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.low = 0
        self.range = MASK32
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & MASK32

    def _byte(self):
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def _normalize(self):
        while True:
            hi = (self.low + self.range) & MASK32
            if (self.low ^ hi) < TOP:
                pass
            elif self.range < BOT:
                self.range = (-self.low) & (BOT - 1)
            else:
                break
            self.code = ((self.code << 8) | self._byte()) & MASK32
            self.low = (self.low << 8) & MASK32
            self.range = (self.range << 8) & MASK32

    def get_freq(self, total_bits=PRECISION):
        total = 1 << total_bits
        r = self.range // total
        f = ((self.code - self.low) & MASK32) // r
        return min(f, total - 1)

    def decode(self, start, freq, total_bits=PRECISION):
        r = self.range // (1 << total_bits)
        self.low = (self.low + r * start) & MASK32
        self.range = r * freq
        self._normalize()

    def decode_bits(self, nbits):
        val = self.get_freq(nbits)
        self.decode(val, 1, nbits)
        return int(val)


def encode_with_indexes(symbols, indexes, cdfs, cdfs_sizes, offsets) -> bytes:
    """Table-path encoding with the same escape folding as the rANS backend
    (different bitstream format; self-consistent with decode below)."""
    symbols = np.asarray(symbols, np.int64).ravel()
    indexes = np.asarray(indexes, np.int64).ravel()
    cdfs = np.asarray(cdfs, np.int64)
    cdfs_sizes = np.asarray(cdfs_sizes, np.int64).ravel()
    offsets = np.asarray(offsets, np.int64).ravel()

    enc = RangeEncoder()
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

        enc.encode(int(cdf[value]), int(cdf[value + 1] - cdf[value]))

        if value == max_value:
            raw_val = int(raw_val)
            n_bypass = 0
            while (raw_val >> (n_bypass * BYPASS_PRECISION)) != 0:
                n_bypass += 1
            v = n_bypass
            while v >= MAX_BYPASS_VAL:
                enc.encode_bits(MAX_BYPASS_VAL, BYPASS_PRECISION)
                v -= MAX_BYPASS_VAL
            enc.encode_bits(v, BYPASS_PRECISION)
            for j in range(n_bypass):
                enc.encode_bits(
                    (raw_val >> (j * BYPASS_PRECISION)) & MAX_BYPASS_VAL,
                    BYPASS_PRECISION,
                )
    return enc.finish()


def decode_with_indexes(encoded, indexes, cdfs, cdfs_sizes, offsets):
    indexes = np.asarray(indexes, np.int64).ravel()
    cdfs = np.asarray(cdfs, np.int64)
    cdfs_sizes = np.asarray(cdfs_sizes, np.int64).ravel()
    offsets = np.asarray(offsets, np.int64).ravel()

    out = np.empty(indexes.shape[0], np.int32)
    dec = RangeDecoder(encoded)
    for i in range(indexes.shape[0]):
        idx = indexes[i]
        cdf = cdfs[idx]
        size = cdfs_sizes[idx]
        max_value = size - 2

        f = dec.get_freq()
        s = int(np.searchsorted(cdf[:size], f, side="right")) - 1
        dec.decode(int(cdf[s]), int(cdf[s + 1] - cdf[s]))

        value = s
        if value == max_value:
            v = dec.decode_bits(BYPASS_PRECISION)
            n_bypass = v
            while v == MAX_BYPASS_VAL:
                v = dec.decode_bits(BYPASS_PRECISION)
                n_bypass += v
            raw_val = 0
            for j in range(n_bypass):
                raw_val |= dec.decode_bits(BYPASS_PRECISION) << (
                    j * BYPASS_PRECISION
                )
            value = raw_val >> 1
            if raw_val & 1:
                value = -value - 1
            else:
                value += max_value
        out[i] = value + offsets[idx]
    return out


# ---------------------------------------------------------------------------
# Search-path "rows" coding (GSM / GMM; same semantics as rans_numpy
# encode_rows / decode_rows and csrc fg_encode_rows / fg_decode_rows)
# ---------------------------------------------------------------------------

MAX_CDF_VALUE = (1 << PRECISION) - 1


def _put_bypass_value(enc: RangeEncoder, raw_val: int) -> None:
    """Chunk-count prefix + BYPASS_PRECISION-bit chunks, LSB-first
    (mirrors rans_numpy._SymbolBuffer.put_bypass_value)."""
    raw_val = int(raw_val) & MASK32
    n_bypass = 0
    while (raw_val >> (n_bypass * BYPASS_PRECISION)) != 0:
        n_bypass += 1
    val = n_bypass
    while val >= MAX_BYPASS_VAL:
        enc.encode_bits(MAX_BYPASS_VAL, BYPASS_PRECISION)
        val -= MAX_BYPASS_VAL
    enc.encode_bits(val, BYPASS_PRECISION)
    for j in range(n_bypass):
        enc.encode_bits(
            (raw_val >> (j * BYPASS_PRECISION)) & MAX_BYPASS_VAL,
            BYPASS_PRECISION,
        )


def _get_bypass_value(dec: RangeDecoder) -> int:
    val = dec.decode_bits(BYPASS_PRECISION)
    n_bypass = val
    while val == MAX_BYPASS_VAL:
        val = dec.decode_bits(BYPASS_PRECISION)
        n_bypass += val
    raw = 0
    for j in range(n_bypass):
        raw |= dec.decode_bits(BYPASS_PRECISION) << (j * BYPASS_PRECISION)
    return raw


def encode_rows(values, rows, lo: int) -> bytes:
    """Encode with precomputed per-symbol boundary CDF rows.

    Args:
        values: int32 [N] quantized symbol values.
        rows: uint16 [N, L] with ``rows[i, j] = u16(cdf_i(lo + j - 0.5)*65535)``.
        lo: integer value of the first bin.
    """
    values = np.asarray(values, np.int64).ravel()
    rows = np.asarray(rows, np.uint16)
    assert rows.shape[0] == values.shape[0]

    enc = RangeEncoder()
    for i in range(values.shape[0]):
        j = int(values[i] - lo)
        start = int(rows[i, j])
        pmf = (int(rows[i, j + 1]) - start) & 0xFFFF
        if pmf == 0:
            # bypass: sentinel slot [65535, 65536), then raw u32 chunks
            enc.encode(MAX_CDF_VALUE, 1)
            _put_bypass_value(enc, int(values[i]))
        else:
            enc.encode(start, pmf)
    return enc.finish()


def decode_rows(encoded, rows, lo: int):
    """Decode with precomputed rows; binary search per symbol (the
    FlashGMM search-based decode, over the range coder)."""
    rows = np.asarray(rows, np.uint16)
    n, L = rows.shape
    out = np.empty(n, np.int32)
    dec = RangeDecoder(encoded)
    for i in range(n):
        cum_freq = dec.get_freq()
        if cum_freq == MAX_CDF_VALUE:
            dec.decode(MAX_CDF_VALUE, 1)
            out[i] = np.int32(np.uint32(_get_bypass_value(dec)))
        else:
            row = rows[i]
            s = int(np.searchsorted(row, cum_freq, side="right")) - 1
            s = max(0, min(s, L - 2))
            start = int(row[s])
            pmf = (int(row[s + 1]) - start) & 0xFFFF
            if pmf == 0:
                pmf = 1
                if start + pmf > (1 << PRECISION):
                    start = (1 << PRECISION) - pmf
            dec.decode(start, pmf)
            out[i] = lo + s
    return out

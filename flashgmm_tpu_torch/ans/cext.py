"""ctypes binding of the host rANS coder ``csrc/rans.cpp`` (the port's own
copy of flashgmm_tpu/ans/cext.py, ABI version 8): the table path
(``encode_with_indexes``, ``decode_with_indexes``, ``StreamingDecoder``),
the rows path over uint16 boundary rows (``encode_rows``, ``decode_rows``)
and the host-math GMM and GSM coders, whose streams are byte-identical to
the reference C++ coder's.

The library is built at first use, never at import: ``g++ -O3 -std=c++17
-shared -fPIC -march=native -ffp-contract=off`` (the JAX package's flags;
without ``-ffp-contract=off`` gcc contracts the GMM mixture sums into FMAs
and the streams no longer equal the reference's), into
``build/flashgmm_tpu_torch/librans_<hash>.so`` at the repository root,
named by a hash of the source and the flags. The compiler writes a name
of its own process, which is then renamed into place, so processes that
build at once never load a half-written library. There is no fallback: if
the build fails, :func:`available` is False and every call raises
``RuntimeError`` with the compiler's message.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

ABI_VERSION = 8

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "rans.cpp"
BUILD_DIR = _ROOT / "build" / "flashgmm_tpu_torch"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
          "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_build_error = None


def library_path() -> Path:
    """Where the library of this source and these flags lands."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librans_{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed ({out.returncode}):\n"
                               f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    """The loaded library; raises RuntimeError naming the build's error."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                version = lib.fg_abi_version()
                if version != ABI_VERSION:
                    raise RuntimeError(f"{path}: ABI version {version}, "
                                       f"expected {ABI_VERSION}")
                _declare(lib)
                _lib = lib
            except Exception as e:  # noqa: BLE001 - kept, raised on each call
                _build_error = e
        if _lib is None:
            raise RuntimeError("the host rANS coder (csrc/rans.cpp) is not "
                               f"available: {_build_error}") from _build_error
        return _lib


def available() -> bool:
    """Whether the host coder builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _declare(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32

    lib.fg_abi_version.restype = i32
    lib.fg_abi_version.argtypes = []
    lib.fg_encode_with_indexes.restype = i64
    lib.fg_encode_with_indexes.argtypes = [
        i32p, i32p, i64, i32p, i64, i32p, i32p, u8p, i64]
    lib.fg_decode_with_indexes.restype = i64
    lib.fg_decode_with_indexes.argtypes = [
        u8p, i64, i32p, i64, i32p, i64, i32p, i32p, i32p]
    lib.fg_encode_rows.restype = i64
    lib.fg_encode_rows.argtypes = [i32p, i64, u16p, i64, i32, u8p, i64]
    lib.fg_decode_rows.restype = i64
    lib.fg_decode_rows.argtypes = [u8p, i64, u16p, i64, i64, i32, i32p]
    lib.fg_encode_gmm_host.restype = i64
    lib.fg_encode_gmm_host.argtypes = [i32p, i64, f32p, f32p, f32p, i32, i32,
                                       i32, u8p, i64]
    lib.fg_decode_gmm_host.restype = i64
    lib.fg_decode_gmm_host.argtypes = [u8p, i64, i64, f32p, f32p, f32p, i32,
                                       i32, i32, i32, i32p]
    lib.fg_decoder_new.restype = ctypes.c_void_p
    lib.fg_decoder_new.argtypes = [u8p, i64]
    lib.fg_decoder_decode.restype = i64
    lib.fg_decoder_decode.argtypes = [
        ctypes.c_void_p, i32p, i64, i32p, i64, i32p, i32p, i32p]
    lib.fg_decoder_free.restype = None
    lib.fg_decoder_free.argtypes = [ctypes.c_void_p]


_ERR_INVALID_CDF = -(2**63)  # kErrInvalidCdf in csrc/rans.cpp
_ERR_SHORT_BUFFER = -(2**63) + 1  # kErrShortBuffer


def _check_rc(nbytes: int) -> int:
    """Raise on the coder's error sentinels. Other negative returns pass
    through: an encoder returns ``-needed_capacity`` when its output buffer
    was too small (csrc/rans.cpp SymbolBuffer::flush), and the encode
    functions retry with that capacity."""
    if nbytes == _ERR_INVALID_CDF:
        raise ValueError(
            "invalid CDF table passed to the host coder (non-monotone row or "
            "bad first/last entry); detected because FLASHGMM_DEBUG=1")
    if nbytes == _ERR_SHORT_BUFFER:
        raise ValueError(
            "encoded stream shorter than the 8-byte rANS initial state "
            "(truncated or corrupt input)")
    return nbytes


def _check_decode_rc(nbytes: int) -> int:
    """Decoders have no capacity retry: any negative return is an error."""
    nbytes = _check_rc(nbytes)
    if nbytes < 0:
        raise ValueError(f"host coder error {nbytes}")
    return nbytes


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _enc_capacity(n_symbols: int) -> int:
    # worst case a symbol: one coded slot and ~10 bypass chunks, each possibly
    # emitting a 4-byte renormalisation word; 8 flush bytes
    return 48 * max(n_symbols, 1) + 64


def _encode(call, n: int) -> bytes:
    """``call(out, capacity)`` into a buffer sized for n symbols, once more
    at the capacity the coder asks for if that was too small."""
    out = np.empty(_enc_capacity(n), dtype=np.uint8)
    nbytes = _check_rc(call(_ptr(out, ctypes.c_uint8), out.shape[0]))
    if nbytes < 0:
        out = np.empty(-nbytes, dtype=np.uint8)
        nbytes = _check_rc(call(_ptr(out, ctypes.c_uint8), out.shape[0]))
    return out[:nbytes].tobytes()


def _tables(cdfs, cdfs_sizes, offsets):
    return (np.ascontiguousarray(cdfs, dtype=np.int32),
            np.ascontiguousarray(cdfs_sizes, dtype=np.int32).ravel(),
            np.ascontiguousarray(offsets, dtype=np.int32).ravel())


def encode_with_indexes(symbols, indexes, cdfs, cdfs_sizes, offsets) -> bytes:
    """The table path: symbol i under CDF row indexes[i]."""
    lib = _load()
    symbols = np.ascontiguousarray(symbols, dtype=np.int32).ravel()
    indexes = np.ascontiguousarray(indexes, dtype=np.int32).ravel()
    cdfs, cdfs_sizes, offsets = _tables(cdfs, cdfs_sizes, offsets)
    i32 = ctypes.c_int32
    return _encode(lambda out, cap: lib.fg_encode_with_indexes(
        _ptr(symbols, i32), _ptr(indexes, i32), symbols.shape[0],
        _ptr(cdfs, i32), cdfs.shape[1], _ptr(cdfs_sizes, i32),
        _ptr(offsets, i32), out, cap), symbols.shape[0])


def decode_with_indexes(encoded: bytes, indexes, cdfs, cdfs_sizes, offsets):
    """int32 symbols of the table path."""
    lib = _load()
    indexes = np.ascontiguousarray(indexes, dtype=np.int32).ravel()
    cdfs, cdfs_sizes, offsets = _tables(cdfs, cdfs_sizes, offsets)
    data = np.frombuffer(encoded, dtype=np.uint8)
    out = np.empty(indexes.shape[0], dtype=np.int32)
    i32 = ctypes.c_int32
    _check_decode_rc(lib.fg_decode_with_indexes(
        _ptr(data, ctypes.c_uint8), data.shape[0], _ptr(indexes, i32),
        indexes.shape[0], _ptr(cdfs, i32), cdfs.shape[1],
        _ptr(cdfs_sizes, i32), _ptr(offsets, i32), _ptr(out, i32)))
    return out


def encode_rows(values, rows, lo: int) -> bytes:
    """Symbol i (in [lo, lo + L - 1)) under uint16 boundary row rows[i]."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.int32).ravel()
    rows = np.ascontiguousarray(rows, dtype=np.uint16)
    return _encode(lambda out, cap: lib.fg_encode_rows(
        _ptr(values, ctypes.c_int32), values.shape[0],
        _ptr(rows, ctypes.c_uint16), rows.shape[1], int(lo), out, cap),
        values.shape[0])


def decode_rows(encoded: bytes, rows, lo: int):
    """int32 symbols, one a row of uint16 boundary rows [N, L]."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.uint16)
    data = np.frombuffer(encoded, dtype=np.uint8)
    out = np.empty(rows.shape[0], dtype=np.int32)
    _check_decode_rc(lib.fg_decode_rows(
        _ptr(data, ctypes.c_uint8), data.shape[0],
        _ptr(rows, ctypes.c_uint16), rows.shape[0], rows.shape[1], int(lo),
        _ptr(out, ctypes.c_int32)))
    return out


def get_use_simd() -> int:
    """The reference's USE_SIMD (rans_interface.cpp:119-130): on unless the
    variable is exactly "0". Its SIMD and scalar CDF paths write DIFFERENT
    streams (Cephes exp and a horizontal-add sum against libm exp and a
    sequential sum), so a decoder must use the encoder's setting."""
    return 0 if os.environ.get("USE_SIMD") == "0" else 1


def _gmm_params(scales, means, weights):
    return tuple(np.ascontiguousarray(p, dtype=np.float32)
                 for p in (scales, means, weights))


def encode_gmm_host(values, scales, means, weights, approx_mode: int = 0,
                    use_simd=None) -> bytes:
    """Host-math GMM encode: each symbol's CDF evaluated by the host with
    the reference's float32 formulas from float32 [N, K] parameters."""
    lib = _load()
    use_simd = get_use_simd() if use_simd is None else int(use_simd)
    values = np.ascontiguousarray(values, dtype=np.int32).ravel()
    scales, means, weights = _gmm_params(scales, means, weights)
    f32 = ctypes.c_float
    return _encode(lambda out, cap: lib.fg_encode_gmm_host(
        _ptr(values, ctypes.c_int32), values.shape[0], _ptr(scales, f32),
        _ptr(means, f32), _ptr(weights, f32), scales.shape[1],
        int(approx_mode), use_simd, out, cap), values.shape[0])


def decode_gmm_host(encoded: bytes, scales, means, weights, max_bs_value: int,
                    approx_mode: int = 0, use_simd=None):
    """Search-based host-math GMM decode of N symbols in
    [-max_bs_value, max_bs_value]."""
    lib = _load()
    use_simd = get_use_simd() if use_simd is None else int(use_simd)
    scales, means, weights = _gmm_params(scales, means, weights)
    data = np.frombuffer(encoded, dtype=np.uint8)
    out = np.empty(scales.shape[0], dtype=np.int32)
    f32 = ctypes.c_float
    _check_decode_rc(lib.fg_decode_gmm_host(
        _ptr(data, ctypes.c_uint8), data.shape[0], scales.shape[0],
        _ptr(scales, f32), _ptr(means, f32), _ptr(weights, f32),
        scales.shape[1], int(max_bs_value), int(approx_mode), use_simd,
        _ptr(out, ctypes.c_int32)))
    return out


def _unit_mixture(scales):
    scales = np.ascontiguousarray(scales, dtype=np.float32).reshape(-1, 1)
    return scales, np.zeros_like(scales), np.ones_like(scales)


def encode_gsm_host(values, scales, approx_mode: int = 0) -> bytes:
    """Table-free single-Gaussian (GSM) host encode, byte-identical to the
    reference's ``encode_with_indexes(symbols, scales, max_value)``
    (rans_interface.cpp:401-456): a K=1 mixture of mean 0 and weight 1
    gives exactly the same float32 CDF."""
    return encode_gmm_host(values, *_unit_mixture(scales), approx_mode,
                           use_simd=0)


def decode_gsm_host(encoded: bytes, scales, max_bs_value: int,
                    approx_mode: int = 0):
    """Search-based GSM host decode (cf. rans_interface.cpp:690-764)."""
    return decode_gmm_host(encoded, *_unit_mixture(scales), max_bs_value,
                           approx_mode, use_simd=0)


class StreamingDecoder:
    """Stateful table-path decoder (decode a few symbols, feed them to a
    context model, decode the next)."""

    def __init__(self, encoded: bytes, cdfs, cdfs_sizes, offsets):
        self._lib = _load()
        self._handle = None
        self._data = np.frombuffer(encoded, dtype=np.uint8)
        self._handle = self._lib.fg_decoder_new(
            _ptr(self._data, ctypes.c_uint8), self._data.shape[0])
        if not self._handle:  # a stream shorter than the rANS state
            raise ValueError(
                "encoded stream shorter than the 8-byte rANS initial state "
                "(truncated or corrupt input)")
        self._cdfs, self._sizes, self._offsets = _tables(cdfs, cdfs_sizes,
                                                         offsets)

    def decode(self, indexes):
        indexes = np.ascontiguousarray(indexes, dtype=np.int32).ravel()
        out = np.empty(indexes.shape[0], dtype=np.int32)
        i32 = ctypes.c_int32
        self._lib.fg_decoder_decode(
            self._handle, _ptr(indexes, i32), indexes.shape[0],
            _ptr(self._cdfs, i32), self._cdfs.shape[1],
            _ptr(self._sizes, i32), _ptr(self._offsets, i32), _ptr(out, i32))
        return out

    def close(self):
        if self._handle is not None:
            self._lib.fg_decoder_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, and one more ``nvcc`` links them into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a
build takes seconds, not minutes). The library lands in
``build/flashgmm_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads.
The build happens at first use, never at import.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent
_SOURCES = ("csrc/rans_kernels.cu", "csrc/conv_kernel.cu",
            "csrc/conv_bf16.cu", "csrc/gmm_rows.cu")
# included by the sources: hashed too
_HEADERS = ("csrc/gmm_entry.cuh", "csrc/mbarrier.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
BUILD_DIR = _PKG.parent / "build" / "flashgmm_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # starts, freqs, active, T, W, states, words, emits, stream
    "fg_rans_encode": (_P, _P, _P, _I, _I, _P, _P, _P, _P),
    # values, scales, means, weights, n, K, lo, L, mode, T, W,
    # states (int64), words, emits, stream
    "fg_rans_encode_gmm": (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                           _I, _I, _P, _P, _P, _P),
    # states, stream words, n_stream, rows, active, lo, T, W, L,
    # max cluster, out, err, stream
    "fg_rans_decode": (_P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I,
                       _P, _P, _P),
    # states, stream words, n_stream, scales, means, weights, n, K, active,
    # lo, T, W, L, mode, max cluster, out, err, stream
    "fg_rans_decode_gmm": (_P, _P, ctypes.c_longlong, _P, _P, _P,
                           ctypes.c_longlong, _I, _P, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P),
    # x, w, bias, res, y, N, H, W, Cin, Cout, K, leaky, neg_slope, tile,
    # stream
    "fg_conv2d_nhwc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P),
    # x, packed w, bias, res, y, y f32, N, H, W, Cin, Cout, K, leaky,
    # neg_slope, stream
    "fg_conv2d_nhwc_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, ctypes.c_float, _P),
    # scales, means, weights, N, K, lo, L, mode, rows, stream
    "fg_gmm_rows": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    # values, scales, means, weights, N, K, lo, L, mode, start, freq, stream
    "fg_gmm_bounds": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # scales, means, weights, N, K, lo, L, mode, uint16 rows, stream
    "fg_gmm_boundary_rows": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    # logits, weights, outer, K, M, stream
    "fg_gmm_softmax": (_P, _P, ctypes.c_longlong, _I, _I, _P),
}


class Kernels(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # build time; 0.0 when an earlier build was loaded
    ptxas: tuple  # the -Xptxas -v lines of the library's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


@functools.cache
def load() -> Kernels:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = [_PKG / s for s in _SOURCES]
    digest = hashlib.sha256(" ".join(_FLAGS + _LINK_FLAGS).encode())
    for src in sources + [_PKG / h for h in _HEADERS]:
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"libflashgmm_kernels_{digest.hexdigest()[:16]}.so"
    log = path.with_suffix(".ptxas")  # kept beside the library
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        # one nvcc per source, all at once; then one link
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
                 for cmd in ([_nvcc(), *_FLAGS, "-c", "-o", str(obj), str(src)]
                             for src, obj in zip(sources, objs))]
        outs = []
        try:
            for cmd, proc in procs:
                out, err = proc.communicate(timeout=600)
                outs.append((cmd, proc.returncode, out, err))
        finally:  # a timeout leaves no compiler running
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if all(rc == 0 for _, rc, _, _ in outs):
            cmd = [_nvcc(), *_LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
            link = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            outs.append((cmd, link.returncode, link.stdout, link.stderr))
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, rc, out, err in outs:
            if rc != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{out}\n{err}")
        # "ptxas info" lines, and the spill counts under each function's
        ptxas = [line.strip() for _, _, _, err in outs
                 for line in err.splitlines()
                 if "ptxas" in line or "bytes spill" in line]
        tmp.with_suffix(".ptxas").write_text("\n".join(ptxas) + "\n")
        os.replace(tmp.with_suffix(".ptxas"), log)
        os.replace(tmp, path)
    ptxas = tuple(log.read_text().splitlines()) if log.exists() else ()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Kernels(lib, path, seconds, ptxas)


def check(code: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """A kernel takes CUDA tensors on one device; anything else is refused."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {[str(u.device) for u in tensors]}")

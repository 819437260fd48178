"""Build of the standalone C++ codec's binaries, ``fgsc_encode`` and
``fgsc_decode`` (csrc/standalone/encoder_main.cpp, decoder_main.cpp, over
the host rANS coder csrc/rans.cpp), with the Makefile's ``standalone``
flags:

    g++ -O3 -std=c++17 -ffp-contract=off -c csrc/rans.cpp -o rans.o
    g++ -O3 -std=c++17 -march=native csrc/standalone/encoder_main.cpp rans.o
    g++ -O3 -std=c++17 -march=native csrc/standalone/decoder_main.cpp rans.o

into ``build/flashgmm_tpu_torch/standalone_<hash>/`` at the repository
root, named by a hash of the sources and the flags; never into the
repository's ``build/``, which ``make standalone`` owns. The binaries are
built in a directory of this process's own and renamed into place, so
processes that build at once never run a half-written binary. A failed
build raises ``RuntimeError`` with the compiler's message.

    python -m flashgmm_tpu_torch.standalone   # builds, prints both paths
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _ROOT / "build" / "flashgmm_tpu_torch"
_RANS = _ROOT / "csrc" / "rans.cpp"
_STANDALONE = _ROOT / "csrc" / "standalone"
_RANS_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off")
_MAIN_FLAGS = ("-O3", "-std=c++17", "-march=native")
_MAINS = (("fgsc_encode", "encoder_main.cpp"),
          ("fgsc_decode", "decoder_main.cpp"))


def _sources():
    return [_RANS, *sorted(_STANDALONE.glob("*.h")),
            *sorted(_STANDALONE.glob("*.cpp"))]


def binaries_dir() -> Path:
    """Where the binaries of these sources and flags land."""
    digest = hashlib.sha256(" ".join(_RANS_FLAGS + _MAIN_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"standalone_{digest.hexdigest()[:16]}"


def _run(*cmds):
    """Run the commands side by side; raise on the first that failed."""
    procs = [(cmd, subprocess.Popen([str(c) for c in cmd], text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT))
             for cmd in cmds]
    for cmd, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(map(str, cmd))}\n{out}")


def build_binaries():
    """(path of fgsc_encode, path of fgsc_decode), built if absent."""
    final = binaries_dir()
    paths = tuple(final / name for name, _ in _MAINS)
    if all(p.exists() for p in paths):
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    try:
        obj = tmp / "rans.o"
        _run(["g++", *_RANS_FLAGS, "-c", _RANS, "-o", obj])
        _run(*(["g++", *_MAIN_FLAGS, _STANDALONE / main, obj, "-o",
                tmp / name] for name, main in _MAINS))
        obj.unlink()
        try:
            os.rename(tmp, final)
        except OSError:  # another process put its build in place first
            if not all(p.exists() for p in paths):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths

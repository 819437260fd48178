"""``python -m flashgmm_tpu_torch.standalone``: build the standalone C++
codec's binaries (``build.build_binaries``) and print their paths."""

import sys

from flashgmm_tpu_torch.standalone.build import build_binaries

if __name__ == "__main__":
    for path in build_binaries():
        print(path)
    sys.exit(0)

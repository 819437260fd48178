"""Plot video RD curves (port of flashgmm_tpu/utils/video/plot; cf.
compressai/utils/video/plot): the image plot's implementation
(``utils.plot``) over the video reports.

Usage: python -m flashgmm_tpu_torch.utils.video.plot -f a.json -o rd.png
"""

import sys

from flashgmm_tpu_torch.utils.plot.__main__ import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

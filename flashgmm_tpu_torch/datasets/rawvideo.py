"""Raw YUV video sequences (a copy of flashgmm_tpu/datasets/rawvideo.py,
which is numpy only; CompressAI's compressai/datasets/rawvideo.py:39-321).

Parses ``name_WxH_fps_420.yuv``-style filenames and memory-maps frames.
"""

import re
from enum import Enum
from pathlib import Path

import numpy as np


class VideoFormat(Enum):
    YUV400 = "yuv400"
    YUV420 = "yuv420"
    YUV422 = "yuv422"
    YUV444 = "yuv444"


SUBSAMPLING = {
    VideoFormat.YUV400: (0, 0),
    VideoFormat.YUV420: (2, 2),
    VideoFormat.YUV422: (2, 1),
    VideoFormat.YUV444: (1, 1),
}

# e.g. "BasketballDrill_832x480_50_420_8bit.yuv"
_FILENAME_RE = re.compile(
    r"(?P<name>.+?)[_-](?P<width>\d+)x(?P<height>\d+)"
    r"(?:[_-](?P<fps>\d+(?:\.\d+)?)(?:fps)?)?"
    r"(?:[_-](?P<format>[0-9]{3}|yuv[0-9]{3}))?"
    r"(?:[_-](?P<bitdepth>\d+)bit)?"
    r"\.yuv$",
    re.IGNORECASE,
)


def get_raw_video_file_info(filename: str):
    m = _FILENAME_RE.search(Path(filename).name)
    if m is None:
        raise ValueError(f'Unable to parse video file name "{filename}"')
    info = m.groupdict()
    fmt = (info.get("format") or "420").lower().replace("yuv", "")
    return {
        "width": int(info["width"]),
        "height": int(info["height"]),
        "fps": float(info["fps"]) if info["fps"] else 30.0,
        "format": VideoFormat(f"yuv{fmt}"),
        "bitdepth": int(info["bitdepth"]) if info["bitdepth"] else 8,
    }


class RawVideoSequence:
    """Memory-mapped YUV sequence; index -> (y, u, v) numpy planes."""

    def __init__(self, path, width=None, height=None, fmt=None, bitdepth=None):
        path = Path(path)
        if width is None:
            info = get_raw_video_file_info(path.name)
            width, height = info["width"], info["height"]
            fmt, bitdepth = info["format"], info["bitdepth"]
        self.width, self.height = width, height
        self.format = fmt
        self.bitdepth = bitdepth

        sw, sh = SUBSAMPLING[fmt]
        dtype = np.uint8 if bitdepth == 8 else np.uint16
        y_size = width * height
        c_size = 0 if sw == 0 else (width // sw) * (height // sh)
        self.frame_size = y_size + 2 * c_size
        self._y_size, self._c_size = y_size, c_size
        self._sw, self._sh = sw, sh
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.total_frames = self.data.size // self.frame_size

    def __len__(self):
        return self.total_frames

    def __getitem__(self, idx):
        off = idx * self.frame_size
        y = self.data[off : off + self._y_size].reshape(self.height, self.width)
        if self._c_size == 0:
            return (y, None, None)
        cw, ch = self.width // self._sw, self.height // self._sh
        u = self.data[
            off + self._y_size : off + self._y_size + self._c_size
        ].reshape(ch, cw)
        v = self.data[
            off + self._y_size + self._c_size : off + self.frame_size
        ].reshape(ch, cw)
        return (y, u, v)

    def to_float(self, planes):
        """uint planes -> float32 [0, 1]."""
        maxv = float(2**self.bitdepth - 1)
        return tuple(
            None if p is None else np.asarray(p, np.float32) / maxv for p in planes
        )

"""Class wrappers of the functional colour transforms (port of
flashgmm_tpu/transforms/transforms.py; CompressAI's
compressai/transforms/transforms.py)."""

from . import functional as F_t


class RGB2YCbCr:
    def __call__(self, rgb):
        return F_t.rgb2ycbcr(rgb)

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class YCbCr2RGB:
    def __call__(self, ycbcr):
        return F_t.ycbcr2rgb(ycbcr)

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class YUV444To420:
    def __init__(self, mode: str = "avg_pool"):
        self.mode = mode

    def __call__(self, yuv):
        return F_t.yuv_444_to_420(yuv, self.mode)

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class YUV420To444:
    def __init__(self, mode: str = "bilinear", return_tuple: bool = False):
        self.mode = mode
        self.return_tuple = return_tuple

    def __call__(self, yuv):
        return F_t.yuv_420_to_444(yuv, self.mode, self.return_tuple)

    def __repr__(self):
        return f"{self.__class__.__name__}(return_tuple={self.return_tuple})"

"""Colour transforms (port of flashgmm_tpu/transforms). The point-cloud
transforms (``transforms/point.py`` of the JAX package) come with the
point-cloud models."""

from .functional import (rgb2ycbcr, ycbcr2rgb, yuv_420_to_444,
                         yuv_444_to_420)
from .transforms import RGB2YCbCr, YCbCr2RGB, YUV420To444, YUV444To420

__all__ = ["rgb2ycbcr", "ycbcr2rgb", "yuv_444_to_420", "yuv_420_to_444",
           "RGB2YCbCr", "YCbCr2RGB", "YUV444To420", "YUV420To444"]

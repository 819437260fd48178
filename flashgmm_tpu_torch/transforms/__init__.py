"""Colour transforms and point-cloud transforms (port of
flashgmm_tpu/transforms)."""

from .functional import (rgb2ycbcr, ycbcr2rgb, yuv_420_to_444,
                         yuv_444_to_420)
from .point import (GeneratePositionNormals, NormalizeScaleV2,
                    RandomPermutation, RandomRotateFull, RandomSample,
                    SamplePointsV2, ToDict, random_rotation_matrix)
from .transforms import RGB2YCbCr, YCbCr2RGB, YUV420To444, YUV444To420

__all__ = ["rgb2ycbcr", "ycbcr2rgb", "yuv_444_to_420", "yuv_420_to_444",
           "RGB2YCbCr", "YCbCr2RGB", "YUV444To420", "YUV420To444",
           "GeneratePositionNormals", "NormalizeScaleV2", "RandomPermutation",
           "RandomRotateFull", "RandomSample", "SamplePointsV2", "ToDict",
           "random_rotation_matrix"]

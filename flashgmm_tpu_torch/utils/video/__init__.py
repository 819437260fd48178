"""The video CLIs (port of flashgmm_tpu/utils/video): ``eval_model``
(ssf2020 on raw YUV), ``bench`` (x264, x265 and VTM through their
binaries) and ``plot``."""

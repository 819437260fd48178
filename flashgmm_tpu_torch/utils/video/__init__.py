"""The video CLIs (port of flashgmm_tpu/utils/video): ``eval_model``."""

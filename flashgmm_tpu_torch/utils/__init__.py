"""Training utilities: checkpoints, logging and the RD probe, image
quality metrics and phase timers (ports of flashgmm_tpu/utils/checkpoint.py,
logging.py, metrics.py and profiler.py), and the CLIs: ``python -m
flashgmm_tpu_torch.utils.eval_model`` and ``... .update_model`` (the
port's models), ``... .bench``, ``... .find_close`` and ``... .plot``
(classical codecs and RD curves, on the host), and their video
counterparts under ``utils.video``."""

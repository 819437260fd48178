"""Training utilities: checkpoints, logging and the RD probe, and image
quality metrics (ports of flashgmm_tpu/utils/checkpoint.py, logging.py and
metrics.py), and the evaluation CLIs ``python -m
flashgmm_tpu_torch.utils.eval_model`` and ``... .utils.update_model``. The
JAX package's other CLIs (bench, plot, find_close, video) wait for ROADMAP
item 15."""

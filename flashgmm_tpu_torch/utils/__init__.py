"""Training utilities: checkpoints, logging and the RD probe, and image
quality metrics (ports of flashgmm_tpu/utils/checkpoint.py, logging.py and
metrics.py). The JAX package's CLIs (eval_model, update_model, bench, plot,
find_close, video) wait for ROADMAP item 15."""

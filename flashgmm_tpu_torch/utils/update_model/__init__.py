"""``python -m flashgmm_tpu_torch.utils.update_model``: materialize a
checkpoint's entropy-coder tables (see ``__main__``)."""

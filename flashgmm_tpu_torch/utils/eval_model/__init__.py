"""``python -m flashgmm_tpu_torch.utils.eval_model``: evaluate a model on a
directory of images (see ``__main__``)."""

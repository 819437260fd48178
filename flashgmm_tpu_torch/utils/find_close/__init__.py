"""``python -m flashgmm_tpu_torch.utils.find_close``: the codec quality
nearest a target metric value, by bisection (see ``__main__``)."""

"""``python -m flashgmm_tpu_torch.utils.plot``: rate-distortion curves from
evaluation reports (see ``__main__``)."""

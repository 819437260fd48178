"""``python -m flashgmm_tpu_torch.utils.video.plot``: video rate-distortion
curves (see ``__main__``)."""

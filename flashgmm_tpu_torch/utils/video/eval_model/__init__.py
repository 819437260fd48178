"""``python -m flashgmm_tpu_torch.utils.video.eval_model``: evaluate a video
model on a raw YUV sequence (see ``__main__``)."""

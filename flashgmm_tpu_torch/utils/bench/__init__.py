"""``python -m flashgmm_tpu_torch.utils.bench``: classical codecs (JPEG,
WebP, JPEG2000 through Pillow; BPG, VTM, HM, AV1, TFCI through their
binaries) over a directory of images (see ``__main__`` and ``codecs``)."""

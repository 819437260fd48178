"""``python -m flashgmm_tpu_torch.utils.video.bench``: classical video
codecs (x264 and x265 through ffmpeg, VTM) on raw YUV sequences (see
``__main__``)."""

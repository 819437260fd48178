from .rate_distortion import (RateDistortionLoss, rate_distortion_loss,
                              video_rate_distortion_loss)
from .utils import compute_rate_loss

__all__ = ["RateDistortionLoss", "rate_distortion_loss", "compute_rate_loss",
           "video_rate_distortion_loss"]

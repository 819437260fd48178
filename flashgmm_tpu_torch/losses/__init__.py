from .pointcloud import (ChamferPccRateDistortionLoss,
                         RateDistortionLossHrtzxf2022, chamfer_distance,
                         chamfer_with_index)
from .rate_distortion import (RateDistortionLoss, rate_distortion_loss,
                              video_rate_distortion_loss)
from .utils import compute_rate_loss

__all__ = ["ChamferPccRateDistortionLoss", "RateDistortionLoss",
           "RateDistortionLossHrtzxf2022", "chamfer_distance",
           "chamfer_with_index", "compute_rate_loss", "rate_distortion_loss",
           "video_rate_distortion_loss"]

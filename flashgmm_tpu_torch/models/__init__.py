from .base import CompressionModel
from .ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2

__all__ = ["CompressionModel", "Cheng2020AnchorCheckerboardGMMv2"]

from .base import CompressionModel, SimpleVAECompressionModel
from .ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2

__all__ = ["CompressionModel", "SimpleVAECompressionModel",
           "Cheng2020AnchorCheckerboardGMMv2"]

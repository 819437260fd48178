from .base import CompressionModel, SimpleVAECompressionModel
from .ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2
from .elic_gmm import Elic2022GMM

__all__ = ["CompressionModel", "SimpleVAECompressionModel",
           "Cheng2020AnchorCheckerboardGMMv2", "Elic2022GMM"]

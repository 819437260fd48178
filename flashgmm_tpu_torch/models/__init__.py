from .base import CompressionModel, SimpleVAECompressionModel
from .ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2
from .elic_gmm import Elic2022GMM
from .sensetime import Cheng2020AnchorCheckerboard, Elic2022Official

__all__ = ["CompressionModel", "SimpleVAECompressionModel",
           "Cheng2020AnchorCheckerboard", "Cheng2020AnchorCheckerboardGMMv2",
           "Elic2022GMM", "Elic2022Official"]

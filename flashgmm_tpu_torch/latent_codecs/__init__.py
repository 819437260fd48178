from .checkerboard import CheckerboardLatentCodec
from .gaussian_mixture_conditional import GaussianMixtureConditionalLatentCodec
from .hyper import HyperLatentCodec
from .hyperprior import HyperpriorLatentCodec

__all__ = [
    "CheckerboardLatentCodec",
    "GaussianMixtureConditionalLatentCodec",
    "HyperLatentCodec",
    "HyperpriorLatentCodec",
]

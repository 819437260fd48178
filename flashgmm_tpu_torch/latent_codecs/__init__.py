from .channel_groups import ChannelGroupsLatentCodec
from .checkerboard import CheckerboardLatentCodec
from .gaussian_conditional import GaussianConditionalLatentCodec
from .gaussian_mixture_conditional import GaussianMixtureConditionalLatentCodec
from .hyper import HyperLatentCodec
from .hyperprior import HyperpriorLatentCodec

__all__ = [
    "ChannelGroupsLatentCodec",
    "CheckerboardLatentCodec",
    "GaussianConditionalLatentCodec",
    "GaussianMixtureConditionalLatentCodec",
    "HyperLatentCodec",
    "HyperpriorLatentCodec",
]

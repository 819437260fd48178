from .base import LatentCodec
from .channel_groups import ChannelGroupsLatentCodec
from .checkerboard import CheckerboardLatentCodec
from .entropy_bottleneck import EntropyBottleneckLatentCodec
from .gain import GainHyperLatentCodec, GainHyperpriorLatentCodec
from .gaussian_conditional import GaussianConditionalLatentCodec
from .gaussian_mixture_conditional import GaussianMixtureConditionalLatentCodec
from .hyper import HyperLatentCodec
from .hyperprior import HyperpriorLatentCodec
from .rasterscan import RasterScanLatentCodec

__all__ = [
    "LatentCodec",
    "ChannelGroupsLatentCodec",
    "CheckerboardLatentCodec",
    "EntropyBottleneckLatentCodec",
    "GainHyperLatentCodec",
    "GainHyperpriorLatentCodec",
    "GaussianConditionalLatentCodec",
    "GaussianMixtureConditionalLatentCodec",
    "HyperLatentCodec",
    "HyperpriorLatentCodec",
    "RasterScanLatentCodec",
]

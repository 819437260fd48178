from .hyper import GainHyperLatentCodec
from .hyperprior import GainHyperpriorLatentCodec

__all__ = ["GainHyperLatentCodec", "GainHyperpriorLatentCodec"]

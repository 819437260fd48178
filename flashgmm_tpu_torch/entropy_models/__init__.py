from .entropy_models import (
    EntropyBottleneck,
    EntropyModel,
    GaussianConditional,
    GaussianMixtureConditional,
)
from .entropy_models_vbr import EntropyBottleneckVbr, GaussianConditionalVbr

__all__ = ["EntropyBottleneck", "EntropyModel", "GaussianConditional",
           "GaussianMixtureConditional", "EntropyBottleneckVbr",
           "GaussianConditionalVbr"]

from .entropy_models import (
    EntropyBottleneck,
    EntropyModel,
    GaussianConditional,
    GaussianMixtureConditional,
)

__all__ = ["EntropyBottleneck", "EntropyModel", "GaussianConditional",
           "GaussianMixtureConditional"]

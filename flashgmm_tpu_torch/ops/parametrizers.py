"""Non-negative reparametrization used by GDN (port of
flashgmm_tpu/ops/parametrizers.py): parameters are stored as
``sqrt(value + pedestal)`` and squared (minus pedestal) on use."""

import torch

from .bound_ops import lower_bound


class NonNegativeParametrizer:
    def __init__(self, minimum: float = 0.0, reparam_offset: float = 2**-18):
        self.minimum = float(minimum)
        self.reparam_offset = float(reparam_offset)
        self.pedestal = self.reparam_offset**2
        self.bound = (self.minimum + self.reparam_offset**2) ** 0.5

    def init(self, x):
        """Map an initial (non-negative) value into reparametrized space."""
        return torch.sqrt(torch.clamp_min(x + self.pedestal, self.pedestal))

    def __call__(self, x):
        out = lower_bound(x, self.bound)
        return out * out - self.pedestal

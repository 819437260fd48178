"""Bound operator (port of flashgmm_tpu/ops/bound_ops.py, forward only).

The reference's straight-through gradient is training work, which this
slice of the port does not cover.
"""

import torch


def lower_bound(x, bound: float):
    """``max(x, bound)``."""
    return torch.clamp_min(x, bound)

"""Bound operator with a straight-through gradient (port of
flashgmm_tpu/ops/bound_ops.py): the forward is ``max(x, bound)``; the
gradient passes where ``x >= bound`` or where it is negative (it would move
``x`` up towards the bound), and is zero elsewhere. ``bound`` gets no
gradient.
"""

import torch


class LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        # bound stays a Python number: no tensor is made from it, so
        # nothing crosses to the device (the codec's graphs capture this)
        ctx.bound = float(bound)
        ctx.save_for_backward(x)
        return torch.clamp_min(x, ctx.bound)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (grad < 0)
        return torch.where(pass_through, grad, torch.zeros_like(grad)), None


def lower_bound(x, bound: float):
    """``max(x, bound)`` with the straight-through gradient above."""
    return LowerBound.apply(x, bound)

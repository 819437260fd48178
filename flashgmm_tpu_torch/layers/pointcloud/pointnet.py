"""PointNet building blocks (port of flashgmm_tpu/layers/pointcloud/
pointnet.py): per-point MLPs over channels-last [B, N, C] tensors, a global
max-pool, and farthest-point sampling.

Every step that produces indices (FPS here, the kNN and ball queries of
the sibling modules, the chamfer loss's argmin) computes its distances in
full float32 on the card whatever the caller's TF32 settings are
(:func:`f32_einsum`), so that the indices do not drift with a global
setting.
"""

import contextlib

import torch
from torch import nn

from flashgmm_tpu_torch.layers import linear, pinned_library_settings


def f32_einsum(equation, a, b):
    """``torch.einsum`` in full float32: on the card under
    :func:`flashgmm_tpu_torch.layers.pinned_library_settings` (no TF32).
    The operands are copied into the library's own allocations first: the
    CPU BLAS rounds otherwise for another alignment of its operands (a
    tensor over a numpy array is aligned to 16 bytes, at an offset that
    depends on the heap), and a kNN near-tie then flipped with what the
    process had imported before."""
    with pinned_library_settings() if a.is_cuda else contextlib.nullcontext():
        return torch.einsum(equation, a.clone(), b.clone())


class SharedMLP(nn.Module):
    """Per-point MLP: [B, N, Cin] -> [B, N, Cout] with ReLU between layers
    (and after the last unless ``final_act`` is false)."""

    def __init__(self, dims, final_act: bool = True, *, generator=None):
        super().__init__()
        self.linears = nn.ModuleList(
            [linear(i, o, generator) for i, o in zip(dims[:-1], dims[1:])])
        self.final_act = final_act

    def forward(self, x):
        n = len(self.linears)
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < n - 1 or self.final_act:
                x = torch.relu(x)
        return x


class PointNetSetMLP(nn.Module):
    """Shared MLP + global max-pool: [B, N, C] -> [B, F]."""

    def __init__(self, dims, *, generator=None):
        super().__init__()
        self.mlp = SharedMLP(dims, generator=generator)

    def forward(self, x):
        return torch.amax(self.mlp(x), dim=1)


def farthest_point_sample(points, num_samples: int):
    """Deterministic farthest-point sampling, [B, N, 3] -> int64 indices
    [B, S], the first index 0: a loop of S - 1 steps, each the squared
    distance to the last pick (summed x, y, z in that order, as XLA sums),
    the running minimum, and the first maximum (``jnp.argmax``'s tie rule,
    and ``torch.argmax``'s). Nothing in the loop waits for the device."""
    b, n, _ = points.shape
    dists = torch.full((b, n), float("inf"), dtype=points.dtype,
                       device=points.device)
    last = torch.zeros((b, 1, 1), dtype=torch.int64, device=points.device)
    picks = [last.view(b, 1)]
    for _ in range(num_samples - 1):
        sq = (points - torch.gather(points, 1, last.expand(b, 1, 3))) ** 2
        dists = torch.minimum(dists, sq[..., 0] + sq[..., 1] + sq[..., 2])
        last = torch.argmax(dists, dim=-1).view(b, 1, 1)
        picks.append(last.view(b, 1))
    return torch.cat(picks, dim=1)

"""PointNet++ set-abstraction layers (Qi et al. 2017; port of
flashgmm_tpu/layers/pointcloud/pointnet2.py, CompressAI's layers/
pointcloud/pointnet2.py): FPS centroids, a ball query over dense pairwise
distances (in full float32, ``pointnet.f32_einsum``), a shared MLP with a
per-cloud GroupNorm (``num_groups=1``) and a local max-pool. Channels-last
[b, n, c]."""

import torch
from torch import nn

from flashgmm_tpu_torch.layers import linear

from .hrtzxf2022 import GroupNorm, index_points
from .pointnet import f32_einsum, farthest_point_sample

__all__ = [
    "square_distance",
    "query_ball_point",
    "sample_and_group",
    "sample_and_group_all",
    "PointNetSetAbstraction",
]


def square_distance(src, dst):
    """Pairwise squared L2: [b, n, 3] x [b, m, 3] -> [b, n, m]."""
    return ((src ** 2).sum(-1)[..., None]
            - 2.0 * f32_einsum("bnc,bmc->bnm", src, dst)
            + (dst ** 2).sum(-1)[:, None, :])


def query_ball_point(radius, nsample, xyz, new_xyz):
    """Indices [b, s, nsample] of up to ``nsample`` points of ``xyz``
    within ``radius`` of each query in ``new_xyz``, in their order; the
    slots past the ball's points repeat its first one, so each group has
    exactly nsample (possibly repeated) members."""
    d2 = square_distance(new_xyz, xyz)  # [b, s, n]
    n = xyz.shape[1]
    idx = torch.arange(n, device=xyz.device).expand(d2.shape)
    idx = torch.where(d2 > radius ** 2, n, idx)
    idx = torch.sort(idx, dim=-1).values[..., :nsample]
    first = idx[..., :1].expand(idx.shape)
    return torch.where(idx == n, first, idx).clamp(0, n - 1)


def sample_and_group(npoint, radius, nsample, xyz, points=None,
                     returnfps=False):
    """FPS centroids and ball-query groups, the grouped coordinates
    centred on their centroid: xyz [b, n, 3], points [b, n, d] -> new_xyz
    [b, npoint, 3], new_points [b, npoint, nsample, 3(+d)]."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)
    grouped_xyz_norm = grouped_xyz - new_xyz[:, :, None, :]
    if points is not None:
        new_points = torch.cat([grouped_xyz_norm, index_points(points, idx)],
                               dim=-1)
    else:
        new_points = grouped_xyz_norm
    if returnfps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz, points=None, returnfps=False):
    """One group holding the whole cloud."""
    b = xyz.shape[0]
    new_xyz = torch.zeros((b, 1, 3), dtype=xyz.dtype, device=xyz.device)
    grouped_xyz = xyz[:, None, :, :]
    if points is not None:
        new_points = torch.cat([grouped_xyz, points[:, None]], dim=-1)
    else:
        new_points = grouped_xyz
    if returnfps:
        return new_xyz, new_points, grouped_xyz, None
    return new_xyz, new_points


class PointNetSetAbstraction(nn.Module):
    """One SA level: sample, group, shared MLP (Linear -> GroupNorm ->
    ReLU per layer), local max-pool."""

    def __init__(self, npoint, radius, nsample, in_channel, mlp,
                 group_all=False, *, generator=None):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all
        dims = [in_channel] + list(mlp)
        self.linears = nn.ModuleList(
            [linear(i, o, generator) for i, o in zip(dims[:-1], dims[1:])])
        self.norms = nn.ModuleList([GroupNorm(o, num_groups=1) for o in mlp])

    def forward(self, xyz, points=None):
        """xyz [b, n, 3], points [b, n, d] ->
        (new_xyz [b, s, 3], new_points [b, s, c_out])"""
        if self.group_all:
            new_xyz, h = sample_and_group_all(xyz, points)
        else:
            new_xyz, h = sample_and_group(self.npoint, self.radius,
                                          self.nsample, xyz, points)
        for lin, norm in zip(self.linears, self.norms):
            h = torch.relu(norm(lin(h)))
        return new_xyz, torch.amax(h, dim=2)

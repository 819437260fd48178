"""PointNet++-style point-cloud compression (port of flashgmm_tpu/models/
pointcloud/sfu_pointnet2.py; CompressAI's models/pointcloud/sfu.py
"sfu-pcc-rec-pointnet2"): two set-abstraction levels (FPS centroids,
radius grouping over dense pairwise distances, a shared MLP, a local
max-pool), a global MLP and max-pool to one latent vector, an
EntropyBottleneck, an MLP decoder.

The sorts are stable, as ``jnp.argsort``; the second level's feature
neighbours are its k nearest points whatever the radius, as in the JAX
model.
"""

import torch

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.layers.pointcloud import (SharedMLP, f32_einsum,
                                                  farthest_point_sample,
                                                  index_points)
from flashgmm_tpu_torch.registry import register_model

from .sfu_pointnet import _generator, _PointNetFamily


def _center_distances(centers, points):
    """Squared distances [B, S, N] in the JAX model's op order."""
    return ((centers ** 2).sum(-1)[:, :, None]
            + (points ** 2).sum(-1)[:, None, :]
            - 2 * f32_einsum("bsc,bnc->bsn", centers, points))


def ball_group(points, centers, radius: float, k: int):
    """For each center, its k nearest points within ``radius`` (a stable
    sort of the distances), relative to the center, zero past the ball's
    points: points [B, N, 3], centers [B, S, 3] -> [B, S, k, 3]."""
    d2 = _center_distances(centers, points)
    d2 = torch.where(d2 <= radius ** 2, d2, float("inf"))
    idx = torch.argsort(d2, dim=-1, stable=True)[..., :k]
    valid = torch.gather(d2, 2, idx) < float("inf")
    rel = index_points(points, idx) - centers[:, :, None, :]
    return torch.where(valid[..., None], rel, 0.0)


class SetAbstraction(torch.nn.Module):
    def __init__(self, num_centers, radius, k, dims, *, generator=None):
        super().__init__()
        self.num_centers = num_centers
        self.radius = radius
        self.k = k
        self.mlp = SharedMLP(dims, generator=generator)

    def forward(self, points, feats=None):
        idx = farthest_point_sample(points, self.num_centers)
        centers = index_points(points, idx)
        rel = ball_group(points, centers, self.radius, self.k)
        if feats is not None:
            nidx = torch.argsort(_center_distances(centers, points), dim=-1,
                                 stable=True)[..., :self.k]
            rel = torch.cat([rel, index_points(feats, nidx)], dim=-1)
        b, s, k, c = rel.shape
        out = self.mlp(rel.reshape(b, s * k, c)).reshape(b, s, k, -1)
        return centers, torch.amax(out, dim=2)


@register_model("sfu-pcc-rec-pointnet2")
class PointNet2ReconstructionPccModel(_PointNetFamily):
    def __init__(self, num_points: int = 1024, latent_dim: int = 512, *,
                 seed: int = 0, device="cuda", generator=None, **kwargs):
        super().__init__()
        g = _generator(seed, generator)
        self.num_points = int(num_points)
        self.latent_dim = int(latent_dim)
        self.sa1 = SetAbstraction(256, 0.2, 16, [3, 64, 64], generator=g)
        self.sa2 = SetAbstraction(64, 0.4, 16, [3 + 64, 128, 128],
                                  generator=g)
        self.global_mlp = SharedMLP([3 + 128, 256, latent_dim], generator=g)
        self.g_s = SharedMLP([latent_dim, 512, 1024, num_points * 3],
                             final_act=False, generator=g)
        self.entropy_bottleneck = EntropyBottleneck(latent_dim, generator=g)
        self.to(device)

    def _encode_latent(self, points):
        c1, f1 = self.sa1(points)
        c2, f2 = self.sa2(c1, f1)
        return torch.amax(self.global_mlp(torch.cat([c2, f2], dim=-1)), dim=1)

    def _decode(self, y_hat, batch):
        return self.g_s(y_hat[:, None, :])[:, 0].reshape(
            batch, self.num_points, 3)

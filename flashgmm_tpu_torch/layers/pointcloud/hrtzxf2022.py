"""Density-preserving point-cloud compression blocks (He2022, "Density-
preserving Deep Point Cloud Compression"; port of flashgmm_tpu/layers/
pointcloud/hrtzxf2022.py, CompressAI's layers/pointcloud/hrtzxf2022.py).

Channels-last [b, n, c] throughout: per-point MLPs are ``nn.Linear`` over
the last dimension, neighbourhoods are gathered with ``torch.gather``, FPS
is a loop over the points (``pointnet.farthest_point_sample``) and kNN a
pairwise-distance stable sort (ties in ``lax.top_k``'s order). Shapes are
fixed by the rates: the density-driven point selection packs the kept
candidates by a stable sort instead of ``nonzero``. Index-producing
distances run in full float32 (``pointnet.f32_einsum``); everything
downstream of a neighbour set is order-free up to float sums.

GroupNorm here is flax's ``nnx.GroupNorm``, not ``nn.GroupNorm``: its
statistics span every axis but the batch axis (all points and all
neighbours of one cloud), epsilon 1e-6, the variance max(0, E[x^2] -
E[x]^2); its parameters are ``scale`` and ``bias`` as in the JAX package's
weight files.
"""

import math

import numpy as np
import torch
from torch import nn

from flashgmm_tpu_torch.layers import linear

from .pointnet import f32_einsum, farthest_point_sample

__all__ = [
    "GroupNorm",
    "index_points",
    "knn_indices",
    "nearby_distance_sum",
    "select_xyzs_and_feats",
    "icosphere_directions",
    "PointTransformerLayer",
    "PositionEmbeddingLayer",
    "DensityEmbeddingLayer",
    "DownsampleLayer",
    "UpsampleLayer",
    "UpsampleNumLayer",
    "RefineLayer",
    "XyzsUpsampleLayer",
    "FeatsUpsampleLayer",
    "SubPointConv",
    "EdgeConv",
]


# ---------------------------------------------------------------------------
# Geometry primitives
# ---------------------------------------------------------------------------


def index_points(points, idx):
    """Gather rows: points [b, n, c], idx [b, m] or [b, m, k] ->
    [b, m, c] / [b, m, k, c]."""
    b, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1)
    out = torch.gather(points, 1, flat[..., None].expand(*flat.shape, c))
    return out.reshape(*idx.shape, c)


def knn_indices(query, ref, k: int):
    """k nearest neighbours of each query point among ref points, nearest
    first: query [b, m, c], ref [b, n, c] -> int64 idx [b, m, k]. Dense
    pairwise distances, then a stable sort: equal distances keep the lower
    index first, as ``lax.top_k`` orders ties (``torch.topk`` leaves their
    order open). Ties are real here: a decoded cloud repeats points (the
    cycle-fill of :func:`select_xyzs_and_feats`), and its nearest latent
    point (k=1) must then be JAX's for the collapsed sets to agree."""
    d2 = ((query ** 2).sum(-1)[..., None]
          - 2.0 * f32_einsum("bmc,bnc->bmn", query, ref)
          + (ref ** 2).sum(-1)[:, None, :])
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def _norm(x, keepdim=False):
    """Euclidean norm over the last axis as ``jnp.linalg.norm`` computes
    it (sqrt of the sum of squares; its gradient at 0 is not finite, as
    JAX's)."""
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def nearby_distance_sum(a_xyzs, b_xyzs, k: int):
    """Sum of distances from each a-point to its collapsed point set C(a),
    the b-points whose nearest a-point is a, among a's k nearest b-points.

    a_xyzs [b, m, 3], b_xyzs [b, n, 3] ->
      distance [b, m], mask [b, m, k], knn_idx [b, m, k], nn_idx [b, n]
    """
    m = a_xyzs.shape[1]
    k = min(k, b_xyzs.shape[1])
    nn_idx = knn_indices(b_xyzs, a_xyzs, 1)[..., 0]  # nearest a per b
    knn_idx = knn_indices(a_xyzs, b_xyzs, k)  # nearest b per a
    expect = torch.arange(m, device=nn_idx.device)[None, :, None]
    actual = torch.gather(nn_idx, 1, knn_idx.reshape(nn_idx.shape[0], -1))
    mask = actual.reshape(knn_idx.shape) == expect
    knn_xyzs = index_points(b_xyzs, knn_idx)
    d = _norm(knn_xyzs - a_xyzs[:, :, None, :])
    distance = (d * mask.to(d.dtype)).sum(-1)
    return distance, mask, knn_idx, nn_idx


def select_xyzs_and_feats(candidate_xyzs, candidate_feats, upsample_num,
                          upsample_rate: float):
    """Density-matching subsample: from each group of s candidates keep
    ``round(upsample_num)`` (half to even, clipped to [1, s]), pack the
    kept points into m = ceil(n * upsample_rate) slots by a stable sort,
    and cycle through them when fewer than m were kept.

    candidate_xyzs [b, n, s, 3], candidate_feats [b, n, s, c],
    upsample_num [b, n] -> (xyzs [b, m, 3], feats [b, m, c])
    """
    b, n, s, _ = candidate_xyzs.shape
    m = math.ceil(n * upsample_rate)
    dev = candidate_xyzs.device
    keep = torch.round(upsample_num).to(torch.int64).clamp(1, s)
    slot = torch.arange(s, device=dev)[None, None, :]
    mask = (slot < keep[:, :, None]).reshape(b, n * s)
    # kept points first, in their order
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    packed = order[:, :m]
    n_kept = mask.sum(-1).clamp(min=1)
    pos = torch.arange(m, device=dev)[None]
    idx = torch.gather(packed, 1, pos % n_kept[:, None])
    xyzs = index_points(candidate_xyzs.reshape(b, n * s, 3), idx)
    feats = index_points(
        candidate_feats.reshape(b, n * s, candidate_feats.shape[-1]), idx)
    return xyzs, feats


def icosphere_directions(level: int = 1):
    """Unit direction vectors of a subdivided icosahedron (42 at level 1),
    float32 [n, 3]: the golden-ratio icosahedron's vertices, each face cut
    into four ``level`` times."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = []
    for a, b_ in [(-1, phi), (1, phi), (-1, -phi), (1, -phi)]:
        verts.append((a, b_, 0.0))
    for a, b_ in [(-1, phi), (1, phi), (-1, -phi), (1, -phi)]:
        verts.append((0.0, a, b_))
    for a, b_ in [(-1, phi), (1, phi), (-1, -phi), (1, -phi)]:
        verts.append((b_, 0.0, a))
    verts = np.asarray(verts, np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    )
    for _ in range(level):
        new_pts = list(verts)
        cache = {}
        new_faces = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                p = (verts[i] + verts[j]) / 2.0
                p /= np.linalg.norm(p)
                cache[key] = len(new_pts)
                new_pts.append(p)
            return cache[key]

        for (i, j, l) in faces:
            a_, b_, c_ = midpoint(i, j), midpoint(j, l), midpoint(l, i)
            new_faces += [(i, a_, c_), (j, b_, a_), (l, c_, b_), (a_, b_, c_)]
        verts = np.asarray(new_pts)
        faces = np.asarray(new_faces)
    return verts.astype(np.float32)


# ---------------------------------------------------------------------------
# Normalization and MLP helpers
# ---------------------------------------------------------------------------


class GroupNorm(nn.Module):
    """flax's ``nnx.GroupNorm`` over channels-last inputs [b, ..., c]: the
    statistics of each group span every axis but the batch axis, the
    variance is max(0, E[x^2] - E[x]^2), y = (x - mean) * (rsqrt(var +
    epsilon) * scale) + bias."""

    def __init__(self, num_features: int, num_groups: int = 1,
                 epsilon: float = 1e-6):
        super().__init__()
        self.num_groups = int(num_groups)
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        g = self.num_groups
        c = x.shape[-1]
        xg = x.reshape(*x.shape[:-1], g, c // g)
        axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
        mean = xg.mean(axes, keepdim=True)
        mean2 = (xg * xg).mean(axes, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.view(g, c // g)
        y = (xg - mean) * mul + self.bias.view(g, c // g)
        return y.reshape(x.shape)


class _MLP(nn.Module):
    """Linear -> GroupNorm (per cloud) -> ReLU -> Linear over the last
    dim."""

    def __init__(self, cin, hidden, cout, ngroups=1, *, generator=None):
        super().__init__()
        self.fc1 = linear(cin, hidden, generator)
        self.norm = GroupNorm(hidden, num_groups=ngroups)
        self.fc2 = linear(hidden, cout, generator)

    def forward(self, x):
        return self.fc2(torch.relu(self.norm(self.fc1(x))))


def _masked_softmax(attn, mask):
    """Softmax over the neighbour axis 2, masked entries set to the
    float32 minimum first."""
    attn = torch.where(mask[..., None], attn,
                       torch.finfo(attn.dtype).min)
    return torch.softmax(attn, dim=2)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class PointTransformerLayer(nn.Module):
    """Vector attention (Zhao2021 Point Transformer), channels-last."""

    def __init__(self, in_fdim, out_fdim, hidden_dim, ngroups=1, *,
                 generator=None):
        super().__init__()
        g = generator
        self.w_qs = linear(in_fdim, hidden_dim, g)
        self.w_ks = linear(in_fdim, hidden_dim, g)
        self.w_vs = linear(in_fdim, hidden_dim, g)
        self.conv_delta = _MLP(3, hidden_dim, hidden_dim, ngroups, generator=g)
        self.conv_gamma = _MLP(hidden_dim, hidden_dim, hidden_dim, ngroups,
                               generator=g)
        self.post = linear(hidden_dim, out_fdim, g)

    def forward(self, q_xyzs, k_xyzs, q_feats, k_feats, v_feats, knn_idx,
                mask):
        # q_xyzs [b,m,3], k_xyzs [b,n,3], feats [b,*,c], knn_idx/mask [b,m,k]
        knn_xyzs = index_points(k_xyzs, knn_idx)
        identity = q_feats
        query = self.w_qs(q_feats)
        key = index_points(self.w_ks(k_feats), knn_idx)
        value = index_points(self.w_vs(v_feats), knn_idx)
        pos_enc = self.conv_delta(q_xyzs[:, :, None, :] - knn_xyzs)
        attn = self.conv_gamma(query[:, :, None, :] - key + pos_enc)
        attn = attn / torch.sqrt(torch.tensor(float(key.shape[-1]),
                                              device=attn.device))
        attn = _masked_softmax(attn, mask)
        result = (attn * (value + pos_enc)).sum(2)
        return self.post(result) + identity


class PositionEmbeddingLayer(nn.Module):
    """Magnitude-direction offset embedding reduced by self-attention."""

    def __init__(self, hidden_dim, dim, ngroups=1, *, generator=None):
        super().__init__()
        self.embed = _MLP(4, hidden_dim, dim, ngroups, generator=generator)
        self.attention = _MLP(dim, hidden_dim, dim, ngroups,
                              generator=generator)

    def forward(self, q_xyzs, k_xyzs, knn_idx, mask):
        knn_xyzs = index_points(k_xyzs, knn_idx)
        offset = knn_xyzs - q_xyzs[:, :, None, :]
        dist = _norm(offset, keepdim=True)
        direction = offset / torch.clamp(dist, min=1e-12)
        emb = self.embed(torch.cat([direction, dist], dim=-1))
        attn = _masked_softmax(self.attention(emb), mask)
        return (emb * attn).sum(2)


class DensityEmbeddingLayer(nn.Module):
    """Scalar local-density embedding: [b, n] -> [b, n, c]."""

    def __init__(self, hidden_dim, dim, ngroups=1, *, generator=None):
        super().__init__()
        self.embed = _MLP(1, hidden_dim, dim, ngroups, generator=generator)

    def forward(self, downsample_num):
        return self.embed(downsample_num[..., None])


class DownsampleLayer(nn.Module):
    """FPS downsample + density estimation + feature / position / density
    aggregation."""

    def __init__(self, downsample_rate, dim, hidden_dim, k=16, ngroups=1, *,
                 generator=None):
        super().__init__()
        g = generator
        self.k = int(k)
        self.downsample_rate = float(downsample_rate)
        self.pre = linear(dim, dim, g)
        self.embed_features = PointTransformerLayer(dim, dim, hidden_dim,
                                                    ngroups, generator=g)
        self.embed_positions = PositionEmbeddingLayer(hidden_dim, dim,
                                                      ngroups, generator=g)
        self.embed_densities = DensityEmbeddingLayer(hidden_dim, dim,
                                                     ngroups, generator=g)
        self.post = linear(dim * 3, dim, g)

    def forward(self, xyzs, feats):
        # xyzs [b,n,3], feats [b,n,c]
        n = xyzs.shape[1]
        m = round(n * self.downsample_rate)
        sample_idx = farthest_point_sample(xyzs, m)
        sampled_xyzs = index_points(xyzs, sample_idx)

        k = min(self.k, n)
        distance, mask, knn_idx, _ = nearby_distance_sum(sampled_xyzs, xyzs,
                                                         k)
        downsample_num = mask.sum(-1).to(feats.dtype)
        mean_distance = distance / torch.clamp(downsample_num, min=1.0)

        identity = index_points(feats, sample_idx)
        f = self.pre(feats)
        sampled_f = index_points(f, sample_idx)
        emb = torch.cat([
            self.embed_features(sampled_xyzs, xyzs, sampled_f, f, f, knn_idx,
                                mask),
            self.embed_positions(sampled_xyzs, xyzs, knn_idx, mask),
            self.embed_densities(downsample_num),
        ], dim=-1)
        sampled_feats = self.post(emb) + identity
        return sampled_xyzs, sampled_feats, downsample_num, mean_distance


class EdgeConv(nn.Module):
    """DGCNN EdgeConv: feature-space kNN grouping and a max-reduced MLP
    over (f_j - f_i, f_i) pairs."""

    def __init__(self, in_fdim, out_fdim, hidden_dim, k=16, *,
                 generator=None):
        super().__init__()
        self.k = int(k)
        self.fc1 = linear(2 * in_fdim, hidden_dim, generator)
        self.fc2 = linear(hidden_dim, out_fdim, generator)

    def forward(self, feats):
        k = min(self.k, feats.shape[1])
        knn_idx = knn_indices(feats, feats, k)
        knn_feats = index_points(feats, knn_idx)
        center = feats[:, :, None, :].expand(knn_feats.shape)
        graph = torch.cat([knn_feats - center, center], dim=-1)
        h = self.fc2(torch.relu(self.fc1(graph)))
        return torch.amax(h, dim=2)


class SubPointConv(nn.Module):
    """Grouped per-slice MLP for upsampling: the feature is cut into g
    slices, each mapped by one shared MLP to one upsampled point's
    output; or an EdgeConv reshaped to the g points."""

    def __init__(self, hidden_dim, k, mode, in_fdim, out_fdim, group_num, *,
                 generator=None):
        super().__init__()
        self.mode = mode
        self.group_num = int(group_num)
        self.group_in = in_fdim // group_num
        self.group_out = out_fdim // group_num
        if mode == "mlp":
            self.fc1 = linear(self.group_in, hidden_dim, generator)
            self.fc2 = linear(hidden_dim, self.group_out, generator)
        elif mode == "edge_conv":
            self.edge = EdgeConv(in_fdim, out_fdim, hidden_dim, k,
                                 generator=generator)
        else:
            raise ValueError(f"Unknown mode: {mode}")

    def forward(self, feats):
        # feats [b, n, cin] -> [b, n, g, group_out]
        b, n, _ = feats.shape
        if self.mode == "mlp":
            h = feats.reshape(b, n, self.group_num, self.group_in)
            return self.fc2(torch.relu(self.fc1(h)))
        return self.edge(feats).reshape(b, n, self.group_num, self.group_out)


class XyzsUpsampleLayer(nn.Module):
    """Upsampled positions: each candidate's direction is a softmax-
    weighted sum of 43 hypotheses (zero and the level-1 icosphere),
    normalized and scaled by a learned magnitude. The hypotheses are a
    non-persistent buffer (no weight file holds them)."""

    def __init__(self, dim, hidden_dim, k, sub_point_conv_mode, upsample_rate,
                 *, generator=None):
        super().__init__()
        self.upsample_rate = int(upsample_rate)
        hyp = np.concatenate(
            [np.zeros((1, 3), np.float32), icosphere_directions(1)], axis=0)
        self.register_buffer("hypothesis", torch.from_numpy(hyp),
                             persistent=False)
        self.weight_nn = SubPointConv(hidden_dim, k, sub_point_conv_mode, dim,
                                      43 * upsample_rate, upsample_rate,
                                      generator=generator)
        self.scale_nn = SubPointConv(hidden_dim, k, sub_point_conv_mode, dim,
                                     1 * upsample_rate, upsample_rate,
                                     generator=generator)

    def forward(self, xyzs, feats):
        # xyzs [b,n,3], feats [b,n,c] -> [b, n, u, 3]
        weights = torch.softmax(self.weight_nn(feats), dim=-1)
        directions = torch.einsum("bnuh,hc->bnuc", weights, self.hypothesis)
        directions = directions / torch.clamp(_norm(directions, True),
                                              min=1e-12)
        return xyzs[:, :, None, :] + directions * self.scale_nn(feats)


class FeatsUpsampleLayer(nn.Module):
    """Upsampled features (a residual over the centroid's feature unless
    the layer decodes normals)."""

    def __init__(self, dim, hidden_dim, k, sub_point_conv_mode, upsample_rate,
                 decompress_normal=False, *, generator=None):
        super().__init__()
        self.upsample_rate = int(upsample_rate)
        self.decompress_normal = decompress_normal
        out_fdim = (3 if decompress_normal else dim) * upsample_rate
        self.feats_nn = SubPointConv(hidden_dim, k, sub_point_conv_mode, dim,
                                     out_fdim, upsample_rate,
                                     generator=generator)

    def forward(self, feats):
        up = self.feats_nn(feats)
        if not self.decompress_normal:
            up = up + feats[:, :, None, :]
        return up


class UpsampleLayer(nn.Module):
    """Candidate upsampling of positions and features."""

    def __init__(self, dim, hidden_dim, k, sub_point_conv_mode, upsample_rate,
                 *, generator=None):
        super().__init__()
        self.xyzs_nn = XyzsUpsampleLayer(dim, hidden_dim, k,
                                         sub_point_conv_mode, upsample_rate,
                                         generator=generator)
        self.feats_nn = FeatsUpsampleLayer(dim, hidden_dim, k,
                                           sub_point_conv_mode, upsample_rate,
                                           generator=generator)

    def forward(self, xyzs, feats):
        return self.xyzs_nn(xyzs, feats), self.feats_nn(feats)


class UpsampleNumLayer(nn.Module):
    """How many of the u candidates each centroid keeps, in [1, u]."""

    def __init__(self, dim, hidden_dim, upsample_rate, *, generator=None):
        super().__init__()
        self.upsample_rate = int(upsample_rate)
        self.fc1 = linear(dim, hidden_dim, generator)
        self.fc2 = linear(hidden_dim, 1, generator)

    def forward(self, feats):
        frac = torch.sigmoid(self.fc2(torch.relu(self.fc1(feats))))[..., 0]
        return frac * (self.upsample_rate - 1) + 1


class RefineLayer(nn.Module):
    """Refines the selected points with rate-1 upsample layers."""

    def __init__(self, dim, hidden_dim, k, sub_point_conv_mode,
                 decompress_normal=False, *, generator=None):
        super().__init__()
        self.xyzs_nn = XyzsUpsampleLayer(dim, hidden_dim, k,
                                         sub_point_conv_mode, 1,
                                         generator=generator)
        self.feats_nn = FeatsUpsampleLayer(dim, hidden_dim, k,
                                           sub_point_conv_mode, 1,
                                           decompress_normal,
                                           generator=generator)

    def forward(self, xyzs, feats):
        return (self.xyzs_nn(xyzs, feats)[:, :, 0, :],
                self.feats_nn(feats)[:, :, 0, :])

"""Point-cloud transforms in numpy (a copy of flashgmm_tpu/transforms/
point.py, registered in the port's registry).

Equivalents of compressai/transforms/point/* (torch-geometric
BaseTransforms over ``Data``) for plain-dict point-cloud items ({"pos":
[n, 3], optional "normal"/"face"/...}): no torch-geometric dependency,
seeded via numpy Generators.
"""

import numpy as np

from flashgmm_tpu_torch.registry import register_transform

__all__ = [
    "GeneratePositionNormals",
    "NormalizeScaleV2",
    "RandomPermutation",
    "RandomRotateFull",
    "RandomSample",
    "SamplePointsV2",
    "ToDict",
    "random_rotation_matrix",
]


def _as_dict(data):
    if isinstance(data, dict):
        return dict(data)
    return {"pos": np.asarray(data)}


@register_transform("ToDict")
class ToDict:
    """Convert a mapping / bare array item to a plain dict of ndarrays
    (reference to_dict.py; the torch_geometric.Data wrapper option does
    not apply here)."""

    def __call__(self, data):
        return {k: np.asarray(v) for k, v in _as_dict(data).items()}


@register_transform("NormalizeScaleV2")
class NormalizeScaleV2:
    """Center positions and scale into [-1, 1]
    (reference normalize_scale_v2.py: linf or l2 scale)."""

    def __init__(self, *, center=True, scale_method="linf"):
        if scale_method not in ("linf", "l2"):
            raise ValueError(f"Unknown scale method: {scale_method}")
        self.center = center
        self.scale_method = scale_method

    def __call__(self, data):
        data = _as_dict(data)
        pos = np.asarray(data["pos"], np.float32)
        if self.center:
            pos = pos - pos.mean(axis=0, keepdims=True)
        if self.scale_method == "l2":
            scale = np.sqrt((pos**2).sum(-1)).max()
        else:
            scale = np.abs(pos).max()
        data["pos"] = pos / max(float(scale), 1e-12)
        return data


@register_transform("RandomPermutation")
class RandomPermutation:
    """Randomly permute points and the listed attributes
    (reference random_permutation.py)."""

    def __init__(self, *, attrs=("pos",), seed=None):
        self.attrs = tuple(attrs)
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        data = _as_dict(data)
        perm = self.rng.permutation(np.asarray(data[self.attrs[0]]).shape[0])
        return {
            k: np.asarray(v)[perm] if k in self.attrs else v
            for k, v in data.items()
        }


def random_rotation_matrix(batch_size: int, ndim: int = 3, rng=None):
    """Uniform random rotations (QR of a Gaussian with sign fix + det
    correction, reference random_rotate_full.py:53-63). [b, ndim, ndim]."""
    rng = rng or np.random.default_rng()
    z = rng.standard_normal((batch_size, ndim, ndim)).astype(np.float32)
    q, r = np.linalg.qr(z)
    sign = 2.0 * (np.diagonal(r, axis1=-2, axis2=-1) >= 0) - 1.0
    rot = q * sign[:, None, :]
    rot[:, 0, :] *= np.linalg.det(rot)[:, None]
    return rot


@register_transform("RandomRotateFull")
class RandomRotateFull:
    """Random full rotation of positions about the origin
    (reference random_rotate_full.py)."""

    def __init__(self, *, seed=None):
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        data = _as_dict(data)
        pos = np.asarray(data["pos"], np.float32)
        rot = random_rotation_matrix(1, pos.shape[1], self.rng)[0]
        data["pos"] = pos @ rot.T
        if "normal" in data:
            data["normal"] = np.asarray(data["normal"], np.float32) @ rot.T
        return data


@register_transform("RandomSample")
class RandomSample:
    """Sample ``num`` points (with replacement iff fewer are available),
    optionally deduplicating / preserving order (reference
    random_sample.py)."""

    def __init__(self, num, *, attrs=("pos",), remove_duplicates_by=None,
                 preserve_order=False, seed=None, static_seed=None):
        self.num = int(num)
        self.attrs = tuple(attrs)
        self.remove_duplicates_by = remove_duplicates_by
        self.preserve_order = preserve_order
        self.seed = seed
        self.static_seed = static_seed
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        data = _as_dict(data)
        if self.static_seed is not None:
            self.rng = np.random.default_rng(self.static_seed)
        if self.remove_duplicates_by is not None:
            _, keep = np.unique(
                np.asarray(data[self.remove_duplicates_by]), axis=0,
                return_index=True,
            )
            for attr in self.attrs:
                data[attr] = np.asarray(data[attr])[keep]
        n = np.asarray(data[self.attrs[0]]).shape[0]
        if n >= self.num:
            perm = self.rng.choice(n, self.num, replace=False)
        else:
            perm = self.rng.integers(0, n, self.num)
        if self.preserve_order:
            perm = np.sort(perm)
        return {
            k: np.asarray(v)[perm] if k in self.attrs else v
            for k, v in data.items()
        }


@register_transform("SamplePointsV2")
class SamplePointsV2:
    """Uniformly sample ``num`` points on mesh faces by face area, with
    optional per-point normals (reference sample_points_v2.py). Input
    needs {"pos": [n, 3], "face": [3, f] or [f, 3]}."""

    def __init__(self, num, *, remove_faces=True, include_normals=False,
                 seed=None, static_seed=None):
        self.num = int(num)
        self.remove_faces = remove_faces
        self.include_normals = include_normals
        self.static_seed = static_seed
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        data = _as_dict(data)
        if self.static_seed is not None:
            self.rng = np.random.default_rng(self.static_seed)
        pos = np.asarray(data["pos"], np.float32)
        face = np.asarray(data["face"], np.int64)
        if face.shape[0] != 3:
            face = face.T
        scale = max(float(np.abs(pos).max()), 1e-12)
        p = pos / scale

        e1 = p[face[1]] - p[face[0]]
        e2 = p[face[2]] - p[face[0]]
        cross = np.cross(e1, e2)
        area = np.linalg.norm(cross, axis=1) / 2.0
        prob = area / max(area.sum(), 1e-30)
        sample = self.rng.choice(face.shape[1], self.num, p=prob)

        u = self.rng.random((self.num, 1)).astype(np.float32)
        v = self.rng.random((self.num, 1)).astype(np.float32)
        flip = (u + v) > 1
        u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
        f = face[:, sample]
        pts = p[f[0]] + u * (p[f[1]] - p[f[0]]) + v * (p[f[2]] - p[f[0]])
        data["pos"] = pts * scale
        if self.include_normals:
            nrm = cross[sample]
            data["normal"] = nrm / np.maximum(
                np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12
            )
        if self.remove_faces:
            data.pop("face", None)
        return data


@register_transform("GeneratePositionNormals")
class GeneratePositionNormals:
    """Estimate per-point normals from node positions via local-PCA over
    k nearest neighbours (reference generate_position_normals.py; its
    open3d backend does the same covariance-eigenvector estimate)."""

    def __init__(self, *, method="any", k=16, **kwargs):
        del method, kwargs  # single numpy backend
        self.k = int(k)

    def __call__(self, data):
        data = _as_dict(data)
        pos = np.asarray(data["pos"], np.float32)
        n = pos.shape[0]
        k = min(self.k, n)
        # chunk the kNN queries: a full [n, n] distance matrix would need
        # ~58 GB for a raw SemanticKITTI sweep (~120k points)
        chunk = max(1, int(16_000_000 // max(n, 1)))
        normals = np.empty((n, 3), np.float32)
        sq = (pos**2).sum(-1)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            d2 = sq[lo:hi, None] - 2.0 * (pos[lo:hi] @ pos.T) + sq[None, :]
            nbr = np.argpartition(d2, k - 1, axis=1)[:, :k]
            local = pos[nbr]  # [chunk, k, 3]
            local = local - local.mean(axis=1, keepdims=True)
            cov = np.einsum("nki,nkj->nij", local, local) / k
            _, vecs = np.linalg.eigh(cov)  # ascending: smallest = normal
            normals[lo:hi] = vecs[:, :, 0]
        data["normal"] = normals
        return data

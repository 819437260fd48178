"""Point-cloud datasets (a copy of flashgmm_tpu/datasets/pointcloud.py;
cf. compressai/datasets/pointcloud/*: shapenet, modelnet, s3dis,
semantic-kitti).

Self-contained numpy loaders: .npy / .npz / ascii or binary .ply / .off /
.txt point files under a split directory, sampled to a fixed point count
by a seeded ``random.Random``.
"""

import random
from pathlib import Path

import numpy as np

PC_EXTENSIONS = (".npy", ".npz", ".ply", ".off", ".txt", ".xyz")


def load_point_cloud(path):
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        pts = np.load(path)
    elif suffix == ".npz":
        data = np.load(path)
        pts = data[list(data.keys())[0]]
    elif suffix == ".ply":
        pts = _load_ascii_ply(path)
    elif suffix == ".off":
        pts = _load_off(path)
    else:  # .txt / .xyz: whitespace-separated rows
        pts = np.loadtxt(path, dtype=np.float32)
    return np.asarray(pts[:, :3], np.float32)


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _load_ascii_ply(path):
    """ASCII or binary PLY -> [n, 3] xyz float32 (vertex element only)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(
            (h.split()[1] for h in header if h.startswith("format")), "ascii"
        )
        elements = [h.split()[1] for h in header if h.startswith("element")]
        if not elements or elements[0] != "vertex":
            # data blocks are stored in element-declaration order; reading
            # from the top is only valid when vertex comes first
            raise ValueError(
                f"unsupported PLY layout: element order {elements} "
                "(vertex must be the first element)"
            )
        n = next(
            int(h.split()[-1]) for h in header if h.startswith("element vertex")
        )
        if fmt == "ascii":
            rows = [f.readline().split()[:3] for _ in range(n)]
            return np.asarray(rows, np.float32)
        # binary: build a structured dtype from the vertex properties
        # (properties of other elements — faces etc. — come after the
        # vertex block, so reading n records is enough for xyz)
        endian = "<" if "little" in fmt else ">"
        props = []
        in_vertex = False
        for h in header:
            if h.startswith("element"):
                in_vertex = h.split()[1] == "vertex"
            elif in_vertex and h.startswith("property"):
                parts = h.split()
                if parts[1] == "list":
                    raise ValueError("list property inside vertex element")
                props.append((parts[2], endian + _PLY_DTYPES[parts[1]]))
        names = [p[0] for p in props]
        if not {"x", "y", "z"}.issubset(names):
            raise ValueError(
                f"PLY vertex element lacks x/y/z properties (got {names})"
            )
        rec = np.dtype(props)
        data = np.frombuffer(f.read(rec.itemsize * n), dtype=rec, count=n)
        return np.stack(
            [data["x"], data["y"], data["z"]], axis=1
        ).astype(np.float32)


def _load_off(path):
    with open(path) as f:
        first = f.readline().strip()
        counts = f.readline().split() if first == "OFF" else first[3:].split()
        n = int(counts[0])
        rows = [f.readline().split()[:3] for _ in range(n)]
    return np.asarray(rows, np.float32)


def sample_points(pts, num_points: int, rng=None):
    rng = rng or random
    n = pts.shape[0]
    if n >= num_points:
        idx = rng.sample(range(n), num_points)
    else:
        idx = [rng.randrange(n) for _ in range(num_points)]
    return pts[np.asarray(idx)]


def normalize_unit_cube(pts):
    mins = pts.min(0)
    maxs = pts.max(0)
    scale = max(float((maxs - mins).max()), 1e-9)
    return (pts - mins) / scale


class PointCloudFolder:
    """root/{split}/ *.npy|*.ply|... -> [num_points, 3] float32 in [0,1]."""

    def __init__(self, root, split="train", num_points=1024, normalize=True,
                 seed=0):
        splitdir = Path(root) / split
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{splitdir}"')
        self.samples = sorted(
            f for f in splitdir.rglob("*") if f.suffix.lower() in PC_EXTENSIONS
        )
        self.num_points = num_points
        self.normalize = normalize
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        pts = load_point_cloud(self.samples[index])
        if self.normalize:
            pts = normalize_unit_cube(pts)
        return sample_points(pts, self.num_points, self._rng)


# ---------------------------------------------------------------------------
# Named-dataset loaders (reference compressai/datasets/pointcloud/*): same
# on-disk layouts, no downloaders (place the extracted archives at
# ``root``).
# ---------------------------------------------------------------------------


class ShapeNetCorePartDataset:
    """ShapeNet-Part (processed point clouds + normals; reference
    shapenet.py:48-280).

    Layout: ``root/synsetoffset2category.txt``,
    ``root/train_test_split/shuffled_{split}_file_list.json``,
    ``root/<category_id>/<hash>.txt`` with rows ``x y z nx ny nz label``.

    Items are dicts ``{"pos": [n,3], "normal": [n,3],
    "semantic_index": [n]}`` sampled to ``num_points``.
    """

    def __init__(self, root, split="train", num_points=2048, normalize=True,
                 seed=0):
        import json

        self.root = Path(root)
        self.num_points = num_points
        self.normalize = normalize
        self._rng = random.Random(seed)
        with open(self.root / "synsetoffset2category.txt") as f:
            pairs = [line.split() for line in f if line.strip()]
        self.category_ids = sorted(cid for _, cid in pairs)
        self.category_index = {c: i for i, c in enumerate(self.category_ids)}
        list_file = (
            self.root / "train_test_split" / f"shuffled_{split}_file_list.json"
        )
        if list_file.exists():
            with open(list_file) as f:
                rel = json.load(f)
            # entries look like "shape_data/<category_id>/<hash>"
            self.samples = [
                self.root / p.split("/", 1)[1] for p in rel
            ]
        else:  # fall back: every .txt under each category dir
            self.samples = sorted(
                p for cid in self.category_ids
                for p in (self.root / cid).glob("*.txt")
            )

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        path = self.samples[index]
        if path.suffix != ".txt":
            path = path.with_suffix(".txt")
        data = np.loadtxt(path, dtype=np.float32)
        if data.ndim == 1:
            data = data[None]
        pos = data[:, :3]
        normal = data[:, 3:6] if data.shape[1] >= 6 else np.zeros_like(pos)
        label = (
            data[:, 6].astype(np.int32)
            if data.shape[1] >= 7
            else np.zeros(len(pos), np.int32)
        )
        if self.normalize:
            pos = normalize_unit_cube(pos)
        n = pos.shape[0]
        if n >= self.num_points:
            idx = np.asarray(self._rng.sample(range(n), self.num_points))
        else:
            idx = np.asarray(
                [self._rng.randrange(n) for _ in range(self.num_points)]
            )
        return {
            "pos": pos[idx],
            "normal": normal[idx],
            "semantic_index": label[idx],
            "category_index": self.category_index.get(path.parent.name, 0),
        }


class ModelNetDataset(PointCloudFolder):
    """ModelNet10/40 mesh-vertex clouds (reference modelnet.py): layout
    ``root/<class>/{train,test}/<class>_NNNN.off``."""

    def __init__(self, root, split="train", num_points=1024, normalize=True,
                 seed=0):
        self.samples = sorted(Path(root).glob(f"*/{split}/*.off"))
        if not self.samples:
            raise RuntimeError(f"no {split} .off files under {root}")
        self.num_points = num_points
        self.normalize = normalize
        self._rng = random.Random(seed)


class S3disDataset:
    """S3DIS indoor scans (reference s3dis.py): layout
    ``root/Area_N/<room>/<room>.txt`` with rows ``x y z r g b``."""

    def __init__(self, root, split="train", test_area=6, num_points=4096,
                 normalize=True, seed=0):
        areas = sorted(Path(root).glob("Area_*"))
        test_name = f"Area_{test_area}"
        keep = (
            [a for a in areas if a.name != test_name]
            if split == "train"
            else [a for a in areas if a.name == test_name]
        )
        self.samples = sorted(
            p for a in keep for p in a.glob("*/*.txt") if p.stem == p.parent.name
        )
        self.num_points = num_points
        self.normalize = normalize
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        data = np.loadtxt(self.samples[index], dtype=np.float32)
        pos, color = data[:, :3], data[:, 3:6] / 255.0
        if self.normalize:
            pos = normalize_unit_cube(pos)
        n = pos.shape[0]
        if n >= self.num_points:
            idx = np.asarray(self._rng.sample(range(n), self.num_points))
        else:
            idx = np.asarray(
                [self._rng.randrange(n) for _ in range(self.num_points)]
            )
        return {"pos": pos[idx], "color": color[idx]}


class SemanticKittiDataset:
    """SemanticKITTI LiDAR sweeps (reference semantic_kitti.py): layout
    ``root/sequences/NN/velodyne/*.bin`` (float32 x y z remission)."""

    TRAIN_SEQS = tuple(f"{i:02d}" for i in range(11) if i != 8)
    VAL_SEQS = ("08",)

    def __init__(self, root, split="train", num_points=8192, normalize=True,
                 seed=0):
        seqs = self.TRAIN_SEQS if split == "train" else self.VAL_SEQS
        self.samples = sorted(
            p
            for s in seqs
            for p in (Path(root) / "sequences" / s / "velodyne").glob("*.bin")
        )
        self.num_points = num_points
        self.normalize = normalize
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        raw = np.fromfile(self.samples[index], dtype=np.float32).reshape(-1, 4)
        pos, remission = raw[:, :3], raw[:, 3]
        if self.normalize:
            pos = normalize_unit_cube(pos)
        n = pos.shape[0]
        if n >= self.num_points:
            idx = np.asarray(self._rng.sample(range(n), self.num_points))
        else:
            idx = np.asarray(
                [self._rng.randrange(n) for _ in range(self.num_points)]
            )
        return {"pos": pos[idx], "remission": remission[idx]}

"""The port's point-cloud data path against the JAX package's, on the CPU:
the point-file loaders, the five datasets, the point transforms, and the
trainer ``python -m flashgmm_tpu_torch.examples.train_pointcloud``.

Held:
- ``load_point_cloud`` of each format (ascii PLY, binary little- and
  big-endian PLY, OFF, npy, npz, txt) returns JAX's array;
- PointCloudFolder, ShapeNetCorePartDataset, ModelNetDataset, S3disDataset
  and SemanticKittiDataset, each over a small tree of its on-disk layout
  with the same seed, return JAX's items (every key, every array);
- each point transform under the same seed returns JAX's dict;
- the trainer: 2 epochs of 2 steps (PointNet, chamfer loss, 256 points),
  then a resume from ``latest`` to a third epoch; its checkpoints load
  into a new model bit for bit (every parameter and both Adam states);
  and one epoch of hrtzxf2022 under its own loss.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from flashgmm_tpu import transforms as j_tf
from flashgmm_tpu.datasets import pointcloud as j_pc
from flashgmm_tpu_torch import transforms as t_tf
from flashgmm_tpu_torch.datasets import pointcloud as t_pc
from flashgmm_tpu_torch.examples.train_pointcloud import main as train_main
from flashgmm_tpu_torch.models import PointNetReconstructionPccModel
from flashgmm_tpu_torch.parallel import make_train_state
from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)


def _points(n=50, seed=0):
    return np.random.RandomState(seed).rand(n, 3).astype(np.float32)


def _write_ply_ascii(path, pts):
    head = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
            "property float x", "property float y", "property float z",
            "property uchar red", "element face 0",
            "property list uchar int vertex_indices", "end_header"]
    rows = [f"{x:.6f} {y:.6f} {z:.6f} 7" for x, y, z in pts]
    path.write_text("\n".join(head + rows) + "\n")


def _write_ply_binary(path, pts, endian):
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    head = ["ply", f"format {fmt} 1.0", f"element vertex {len(pts)}",
            "property double x", "property float y", "property float z",
            "property uchar alpha", "end_header"]
    rec = np.zeros(len(pts), np.dtype([("x", endian + "f8"),
                                       ("y", endian + "f4"),
                                       ("z", endian + "f4"), ("a", "u1")]))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    path.write_bytes(("\n".join(head) + "\n").encode() + rec.tobytes())


def _write_off(path, pts):
    rows = [f"{x} {y} {z}" for x, y, z in pts]
    path.write_text("OFF\n" + f"{len(pts)} 1 0\n" + "\n".join(rows)
                    + "\n3 0 1 2\n")


WRITERS = {
    "ply-ascii": lambda p, x: _write_ply_ascii(p.with_suffix(".ply"), x),
    "ply-le": lambda p, x: _write_ply_binary(p.with_suffix(".ply"), x, "<"),
    "ply-be": lambda p, x: _write_ply_binary(p.with_suffix(".ply"), x, ">"),
    "off": lambda p, x: _write_off(p.with_suffix(".off"), x),
    "npy": lambda p, x: np.save(p.with_suffix(".npy"), x),
    "npz": lambda p, x: np.savez(p.with_suffix(".npz"), points=x),
    "txt": lambda p, x: np.savetxt(p.with_suffix(".txt"),
                                   np.concatenate([x, x[:, :1]], 1)),
}


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_loader_formats_match_jax(tmp_path, fmt):
    WRITERS[fmt](tmp_path / "cloud", _points())
    (path,) = list(tmp_path.iterdir())
    got = t_pc.load_point_cloud(path)
    want = j_pc.load_point_cloud(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (50, 3)
    np.testing.assert_array_equal(got, want)


def _folder(root):
    for split, n in (("train", 3), ("test", 2)):
        (root / split / "sub").mkdir(parents=True)
        for i in range(n):
            np.save(root / split / "sub" / f"{i}.npy", _points(40 + i, i))
        _write_off(root / split / "x.off", _points(30, 9))
    return {"root": root}


def _shapenet(root):
    (root / "train_test_split").mkdir(parents=True)
    (root / "synsetoffset2category.txt").write_text(
        "Airplane 02691156\nChair 03001627\n")
    names = []
    for cid in ("02691156", "03001627"):
        (root / cid).mkdir()
        for i in range(2):
            rs = np.random.RandomState(i + len(names))
            rows = np.concatenate([rs.rand(60, 6), rs.randint(0, 4, (60, 1))],
                                  1)
            np.savetxt(root / cid / f"h{i}.txt", rows)
            names.append(f"shape_data/{cid}/h{i}")
    (root / "train_test_split" / "shuffled_train_file_list.json").write_text(
        json.dumps(names[::-1]))
    return {"root": root, "num_points": 80}


def _modelnet(root):
    for cls in ("chair", "desk"):
        (root / cls / "train").mkdir(parents=True)
        for i in range(2):
            _write_off(root / cls / "train" / f"{cls}_{i:04d}.off",
                       _points(70, i))
    return {"root": root, "num_points": 64}


def _s3dis(root):
    for area in (1, 6):
        room = root / f"Area_{area}" / "office_1"
        room.mkdir(parents=True)
        rs = np.random.RandomState(area)
        np.savetxt(room / "office_1.txt",
                   np.concatenate([rs.rand(90, 3), rs.randint(0, 256, (90, 3))],
                                  1))
    return {"root": root, "num_points": 100}


def _kitti(root):
    for seq in ("00", "08"):
        d = root / "sequences" / seq / "velodyne"
        d.mkdir(parents=True)
        for i in range(2):
            np.random.RandomState(i).rand(120, 4).astype(np.float32).tofile(
                d / f"{i:06d}.bin")
    return {"root": root, "num_points": 64}


DATASETS = {"PointCloudFolder": _folder, "ShapeNetCorePartDataset": _shapenet,
            "ModelNetDataset": _modelnet, "S3disDataset": _s3dis,
            "SemanticKittiDataset": _kitti}


def _equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_match_jax(tmp_path, name):
    kwargs = DATASETS[name](tmp_path)
    root = kwargs.pop("root")
    for split in ("train", "test") if name == "PointCloudFolder" \
            else ("train",):
        got = getattr(t_pc, name)(root, split=split, seed=3, **kwargs)
        want = getattr(j_pc, name)(root, split=split, seed=3, **kwargs)
        assert len(got) == len(want) > 0
        for i in list(range(len(want))) * 2:  # the samplers advance alike
            _equal(got[i], want[i])


def _mesh():
    rs = np.random.RandomState(4)
    return {"pos": rs.rand(30, 3).astype(np.float32),
            "face": rs.randint(0, 30, (3, 40)),
            "normal": rs.rand(30, 3).astype(np.float32)}


TRANSFORMS = {
    "ToDict": ({}, lambda: _points()),
    "NormalizeScaleV2": ({"scale_method": "l2"}, _mesh),
    "RandomPermutation": ({"attrs": ("pos", "normal"), "seed": 5}, _mesh),
    "RandomRotateFull": ({"seed": 5}, _mesh),
    "RandomSample": ({"num": 20, "attrs": ("pos", "normal"), "seed": 5,
                      "preserve_order": True}, _mesh),
    "SamplePointsV2": ({"num": 25, "include_normals": True, "seed": 5},
                       _mesh),
    "GeneratePositionNormals": ({"k": 8}, _mesh),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    kwargs, item = TRANSFORMS[name]
    got_tf = getattr(t_tf, name)(**kwargs)
    want_tf = getattr(j_tf, name)(**kwargs)
    for _ in range(2):  # the seeded generators advance alike
        _equal(got_tf(item()), want_tf(item()))
    assert t_tf.random_rotation_matrix(3, 3, np.random.default_rng(1)) \
        .tolist() == j_tf.point.random_rotation_matrix(
            3, 3, np.random.default_rng(1)).tolist()


def _run(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_main(args) == 0
    return buf.getvalue()


def test_trainer_cli_runs_resumes_and_reloads(tmp_path):
    (tmp_path / "data" / "train").mkdir(parents=True)
    for i in range(8):
        np.save(tmp_path / "data" / "train" / f"{i}.npy", _points(300, i))
    ck = tmp_path / "ck"
    common = ["-d", str(tmp_path / "data"), "--num-points", "256",
              "--batch-size", "4", "--num-workers", "1", "--lambda", "600",
              "--checkpoint-dir", str(ck), "--device", "cpu"]
    log = _run(common + ["-e", "2", "--lr-milestones", "1"])
    assert "epoch 0:" in log and "epoch 1:" in log
    meta = json.loads((ck / "latest.meta.json").read_text())
    assert meta["epoch"] == 1 and np.isfinite(meta["loss"])
    log = _run(common + ["-e", "3", "--checkpoint", str(ck / "latest")])
    assert "at epoch 2" in log and "epoch 2:" in log
    tree = torch.load(ck / "latest", weights_only=True)
    model = PointNetReconstructionPccModel(num_points=256, device="cpu")
    opt_net, opt_aux = make_train_state(model)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt_net, [1], 0.1)
    assert load_checkpoint(ck / "latest", model, opt_net, opt_aux,
                           sched)["epoch"] == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, tree["model"][k]), k
    for opt, key in ((opt_net, "opt_net"), (opt_aux, "opt_aux")):
        for i, st in opt.state_dict()["state"].items():
            for name, v in st.items():
                assert torch.equal(v, tree[key]["state"][i][name]), name
    assert opt_net.param_groups[0]["lr"] == pytest.approx(1e-5)
    log = _run(["-d", str(tmp_path / "data"), "--model", "hrtzxf2022-pcc-rec",
                "--num-points", "256", "--batch-size", "4", "-e", "1",
                "--num-workers", "1", "--checkpoint-dir", str(tmp_path / "h"),
                "--device", "cpu"])
    assert "epoch 0:" in log and "rec_loss" in log

"""The port's trainer (``python -m flashgmm_tpu_torch.examples.train``) end
to end on the CPU at N=16, K=2 over a folder of 64x64 PNG and binary PPM
images: two epochs across a learning-rate milestone, then a resume; and
the pieces it stands on: checkpoints (entropy tables included), the
train step's guard and its net/aux isolation, the registry, the loader's
error path and the PPM reader.

TensorBoard is made unimportable here (importing it imports TensorFlow,
~10 s), so the trainer's ScalarWriter writes its JSONL mirror alone.
"""

import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from flashgmm_tpu_torch.datasets import BatchLoader, load_image, save_image
from flashgmm_tpu_torch.datasets import textured_leaves
from flashgmm_tpu_torch.examples.train import main
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.optimizers import net_aux_partition
from flashgmm_tpu_torch.parallel import make_train_state, train_step
from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)


@pytest.fixture
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _folder(root):
    for split, n in (("train", 4), ("test", 2)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            img = textured_leaves(64, 64, seed=100 * (split == "test") + i)
            if i % 2:
                save_image(root / split / f"{i}.ppm", img)
            else:
                Image.fromarray(np.clip(img * 255 + 0.5, 0, 255).astype(
                    np.uint8)).save(root / split / f"{i}.png")
    return root


def _args(data, ck, epochs, *extra):
    return ["-d", str(data), "-n", "16", "-K", "2", "--epochs", str(epochs),
            "--batch-size", "2", "--patch-size", "64", "--lr-milestones", "1",
            "--num-workers", "1", "--checkpoint-dir", str(ck),
            "--device", "cpu", *extra]


def test_trainer_cli_milestone_resume_and_checkpoints(tmp_path, no_tensorboard):
    data, ck = _folder(tmp_path / "data"), tmp_path / "ck"
    assert main(_args(data, ck, 2)) == 0
    assert main(_args(data, ck, 3, "--checkpoint", str(ck / "latest"),
                      "--probe-dir", str(data / "test"))) == 0

    records = [json.loads(line) for line in
               (ck / "train_log.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert [r["lr"] for r in records] == pytest.approx([1e-4, 1e-5, 1e-5],
                                                       rel=1e-12)
    for r in records:
        assert r["steps"] == 2
        for key in ("loss", "bpp_loss", "mse_loss", "aux_loss", "test_loss"):
            assert np.isfinite(r[key]), key
    assert records[2]["probe_images"] == 2 and np.isfinite(
        records[2]["probe_psnr"])
    scalars = (ck / "tb" / "scalars.jsonl").read_text().splitlines()
    assert {"train/loss", "train/lr", "train/test_loss"} <= {
        json.loads(line)["tag"] for line in scalars}

    for name in ("latest", "best", "epoch_0"):
        assert (ck / name).is_file() and (ck / f"{name}.meta.json").is_file()
    assert json.loads((ck / "latest.meta.json").read_text())["epoch"] == 2
    assert json.loads((ck / "epoch_0.meta.json").read_text())["epoch"] == 0
    assert not (ck / "epoch_1").exists()

    # latest and best load into a fresh model bit for bit, with both
    # optimizers' states and the scheduler's (3 epochs of 2 steps)
    for name in ("latest", "best"):
        saved = torch.load(ck / name, weights_only=True)
        model = TModel(N=16, K=2, seed=7, device="cpu")
        opt_net, opt_aux = make_train_state(model)
        sched = torch.optim.lr_scheduler.MultiStepLR(opt_net, [1], 0.1)
        meta = load_checkpoint(ck / name, model, opt_net, opt_aux, sched)
        assert meta["epoch"] in (0, 1, 2) and np.isfinite(meta["best_loss"])
        for key, p in model.named_parameters():
            assert torch.equal(p.detach(), saved["model"][key]), key
        steps = 2 * (meta["epoch"] + 1)
        for opt in (opt_net, opt_aux):
            assert {int(s["step"]) for s in opt.state.values()} == {steps}
        assert sched.last_epoch == meta["epoch"] + 1


def test_checkpoint_keeps_entropy_tables(tmp_path):
    """Tables that update() materialized load into a freshly built model,
    whose own tables are empty."""
    model = TModel(N=16, K=2, device="cpu")
    model.update(update_quantiles=True)
    save_checkpoint(tmp_path / "ck", model, meta={"epoch": 0})
    fresh = TModel(N=16, K=2, seed=3, device="cpu")
    eb = "latent_codec.latent_codec.hyper.entropy_bottleneck"
    assert dict(fresh.named_buffers())[f"{eb}._quantized_cdf"].numel() == 0
    assert load_checkpoint(tmp_path / "ck", fresh) == {"epoch": 0}
    want = dict(model.named_buffers())
    got = dict(fresh.named_buffers())
    tables = [k for k in want if k.rsplit(".", 1)[-1] in (
        "_offset", "_quantized_cdf", "_cdf_length", "scale_table")]
    assert f"{eb}._quantized_cdf" in tables and len(tables) >= 7
    for key in tables:
        assert want[key].numel() > 0 and torch.equal(got[key], want[key]), key
    for key, p in model.named_parameters():
        assert torch.equal(dict(fresh.named_parameters())[key], p), key
    assert not fresh.update()  # the tables are there: nothing to rebuild


def _step_model():
    model = TModel(N=16, K=2, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 3).astype(
        np.float32))
    return model, x


def test_train_step_guard_keeps_parameters_finite():
    """A batch holding a NaN: the loss is not finite, every gradient is
    zeroed, Adam still steps (momentum from the first step moves the
    parameters) and counts the step; every parameter stays finite."""
    model, x = _step_model()
    opt_net, opt_aux = make_train_state(model)
    gen = torch.Generator().manual_seed(0)
    out = train_step(model, opt_net, opt_aux, x, gen)
    assert all(np.isfinite(float(v)) for v in out.values())
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    bad = x.clone()
    bad[0, 5, 7, 1] = float("nan")
    out = train_step(model, opt_net, opt_aux, bad, gen)
    assert not np.isfinite(float(out["loss"]))
    assert np.isfinite(float(out["aux_loss"]))
    for key, p in model.named_parameters():
        assert bool(torch.isfinite(p).all()), key
    assert any(not torch.equal(p, before[k])
               for k, p in model.named_parameters())
    for opt in (opt_net, opt_aux):
        assert {int(s["step"]) for s in opt.state.values()} == {2}


@pytest.mark.parametrize("frozen", ["net", "aux"])
def test_train_step_isolates_net_and_aux(frozen):
    """The net step trains every parameter but the quantiles, the aux step
    the quantiles alone: with one side's learning rate 0, exactly the other
    side's parameters move."""
    model, x = _step_model()
    lr, aux_lr = (0.0, 1e-3) if frozen == "net" else (1e-4, 0.0)
    opt_net, opt_aux = make_train_state(model, lr, aux_lr)
    net, aux = net_aux_partition(model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    train_step(model, opt_net, opt_aux, x, torch.Generator().manual_seed(0))
    moved = {k for k, p in model.named_parameters()
             if not torch.equal(p, before[k])}
    if frozen == "net":
        assert moved == set(aux)
    else:
        assert "g_a.layers.0.conv1.weight" in moved and not moved & set(aux)


def test_registry_matches_jax_names():
    import flashgmm_tpu.losses.pointcloud  # noqa: F401
    from flashgmm_tpu.registry import CRITERIONS as J_CRITERIONS
    from flashgmm_tpu.registry import MODELS as J_MODELS

    import flashgmm_tpu_torch.losses  # noqa: F401
    import flashgmm_tpu_torch.models  # noqa: F401
    import flashgmm_tpu_torch.optimizers  # noqa: F401
    from flashgmm_tpu_torch.registry import CRITERIONS, MODELS, OPTIMIZERS

    names = {"cheng2020-anchor-checkerboard-gmm", "elic2022-official",
             "cheng2020-anchor-checkerboard", "elic2022-gaussian",
             "bmshj2018-factorized", "bmshj2018-factorized-relu",
             "bmshj2018-hyperprior", "mbt2018-mean", "mbt2018",
             "cheng2020-anchor", "cheng2020-attn", "elic2022-chandelier",
             "sigmoid-cdf", "bmshj2018-hyperprior-vbr", "mbt2018-mean-vbr",
             "mbt2018-vbr", "ssf2020", "hrtzxf2022-pcc-rec",
             "folding-pcc-rec", "sfu-pcc-rec-pointnet",
             "sfu-pcc-rec-pointnet2"}
    assert set(MODELS) == names
    for name in names:
        assert MODELS[name].__module__.startswith("flashgmm_tpu_torch.")
        assert MODELS[name].__name__ == J_MODELS[name].__name__, name
    for name in ("RateDistortionLoss", "RateDistortionLoss_hrtzxf2022",
                 "ChamferPccRateDistortionLoss"):
        assert CRITERIONS[name].__module__.startswith("flashgmm_tpu_torch.")
        assert CRITERIONS[name].__name__ == J_CRITERIONS[name].__name__
    opts = OPTIMIZERS["net_optimizer"](TModel(N=16, K=2, device="cpu"),
                                       {"net": {"type": "Adam", "lr": 1e-3}})
    assert set(opts) == {"net"}
    assert opts["net"].param_groups[0]["lr"] == 1e-3


def test_loader_raises_a_worker_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise OSError("unreadable image")
            return np.zeros((4, 4, 3), np.float32)

    loader = BatchLoader(Broken(), 2, shuffle=False, num_workers=2)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)


def test_ppm_reader_takes_comments_and_equals_pillow(tmp_path):
    rs = np.random.RandomState(3)
    arr = rs.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n7 5\n# another\n255\n" + arr.tobytes())
    got = load_image(path)
    assert got.dtype == np.float32 and got.shape == (5, 7, 3)
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0)
    # maxval other than 255 goes through Pillow
    path16 = tmp_path / "d.ppm"
    path16.write_bytes(b"P6 7 5 100\n" + (arr // 3).tobytes())
    np.testing.assert_array_equal(
        load_image(path16),
        np.asarray(Image.open(path16).convert("RGB"), np.float32) / 255.0)

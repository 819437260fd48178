"""The port's video training (ssf2020) against the JAX package's, on the
CPU: the multi-frame RD loss, ``video_train_step``, the net/aux split, the
video datasets and the trainer ``python -m
flashgmm_tpu_torch.examples.train_video``.

The model is JAX's ScaleSpaceFlow at its full width (it has no width
arguments), built with ``nnx.Rngs(0)`` and carried to the port through
``zoo.load_jax_params``, on one GOP of three 128x128 frames. The training
noise is made equal in both packages as in test_torch_port_train.py: JAX's
``jax.random.uniform`` and the port's ``uniform_noise`` are patched to one
numpy array per shape, JAX's caches cleared around the patched calls.

Held:
- ``video_rate_distortion_loss`` of one output in both packages: every
  term within rtol 1e-6;
- the RD loss of one GOP of 3 (rtol 1e-5) and its gradient with respect
  to every net parameter, against ``jax.value_and_grad``, each within a
  share of its largest element: 1e-4, and 1e-2 for the parameters whose
  gradient passes the residual decoder's ReLUs (``res_encoder``,
  ``res_decoder``, ``motion_encoder``): the forwards agree to float
  rounding, but one ReLU input of frame 1's residual decoder lies that
  close to zero and falls on the other side in the port, which moves the
  gradients upstream of it by more than 1e-4 of their largest element.
  Every transform and each hyperprior's encoder and decoders have a
  gradient that is not zero;
- that check fails on each of four faults made on purpose, some gradient
  off by 0.3 of its largest element or more: later references detached,
  ``qrelu``'s surrogate gradient replaced by the clamp's, the warp's
  gradient with respect to the flow or to the scale field cut;
- one ``video_train_step`` at GOP 3 in both packages from the same
  weights (copies of the shared pair): every returned term within rtol
  1e-3; the parameters moved;
- the net/aux split: the port's parameter names, mapped to the converter's
  paths, equal JAX's NET_FILTER and AUX_FILTER paths (the three
  bottlenecks' quantiles in "aux");
- ``VideoFolder`` and ``Vimeo90kDataset`` give JAX's frames after the same
  ``random.seed``;
- the trainer: one epoch of one step, then a resume to a second epoch,
  with ``latest`` and ``best`` checkpoints that reload.
"""

import copy
import json
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from PIL import Image

from flashgmm_tpu.datasets import video as j_video
from flashgmm_tpu.losses.rate_distortion import \
    video_rate_distortion_loss as j_loss
from flashgmm_tpu.models.video import ScaleSpaceFlow as JModel
from flashgmm_tpu.parallel.train import AUX_FILTER, NET_FILTER
from flashgmm_tpu.parallel.train import make_train_state as j_make_train_state
from flashgmm_tpu.parallel.train import video_train_step as j_step
from flashgmm_tpu_torch.datasets import (VideoFolder, Vimeo90kDataset,
                                         textured_leaves)
from flashgmm_tpu_torch.entropy_models import entropy_models as t_entropy
from flashgmm_tpu_torch.examples.train_video import main as train_main
from flashgmm_tpu_torch.losses import video_rate_distortion_loss
from flashgmm_tpu_torch.models.video import ScaleSpaceFlow
from flashgmm_tpu_torch.models.video import google as video_google
from flashgmm_tpu_torch.optimizers import net_aux_partition
from flashgmm_tpu_torch.parallel import (make_train_state, set_guarded_grads,
                                         video_train_step)
from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint
from flashgmm_tpu_torch.zoo import load_jax_params
from torch_port_model_pairs import jax_params

torch.set_num_threads(2)

SIDE = 128


def _noise(shape):
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


@pytest.fixture
def equal_noise(monkeypatch):
    """Both packages' training noise: one numpy array per shape."""

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        assert (minval, maxval) == (-0.5, 0.5)
        return jnp.asarray(_noise(shape), dtype)

    def t_uniform(shape, generator, like):
        return torch.from_numpy(_noise(shape)).to(like.dtype)

    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(t_entropy, "uniform_noise", t_uniform)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.fixture(scope="module")
def pair():
    """Built before the noise is patched (JAX's initialisers draw from
    jax.random.uniform too)."""
    jm = JModel(rngs=nnx.Rngs(0))
    tm = ScaleSpaceFlow(device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    return jm, tm


def _gop(batch=1, n=3, seed=0):
    big = np.stack([textured_leaves(SIDE + 8, SIDE + 8, seed=seed + b)
                    for b in range(batch)])
    return [big[:, i:i + SIDE, 2 * i:2 * i + SIDE].copy() for i in range(n)]


def test_video_loss_matches_jax():
    rng = np.random.RandomState(3)
    frames = [rng.rand(2, 32, 32, 3).astype(np.float32) for _ in range(3)]
    x_hat = [f + rng.normal(0, 0.05, f.shape).astype(np.float32)
             for f in frames]
    lks = [{"keyframe": {"y": rng.uniform(1e-6, 1, (2, 2, 2, 8)),
                         "z": rng.uniform(1e-6, 1, (2, 1, 1, 8))}}]
    lks += [{b: {"y": rng.uniform(1e-6, 1, (2, 2, 2, 8)),
                 "z": rng.uniform(1e-6, 1, (2, 1, 1, 8))}
             for b in ("motion", "residual")} for _ in range(2)]
    lks = [{b: {k: v.astype(np.float32) for k, v in d.items()}
            for b, d in lk.items()} for lk in lks]
    ref = j_loss({"x_hat": [jnp.asarray(x) for x in x_hat],
                  "likelihoods": jax.tree.map(jnp.asarray, lks)},
                 [jnp.asarray(f) for f in frames], lmbda=0.02)
    got = video_rate_distortion_loss(
        {"x_hat": [torch.from_numpy(x) for x in x_hat],
         "likelihoods": [{b: {k: torch.from_numpy(v) for k, v in d.items()}
                          for b, d in lk.items()} for lk in lks]},
        [torch.from_numpy(f) for f in frames], lmbda=0.02)
    assert set(got) == set(ref) == {"loss", "bpp_loss", "mse_loss"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)


def _jax_flat(state):
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in nnx.to_flat_state(state)}


# the parameters whose gradient passes the residual decoder's ReLUs, and
# the share of its largest element each gradient is held to
_PAST_RELU = ("res_encoder", "res_decoder", "motion_encoder")
_SHARE, _SHARE_PAST_RELU = 1e-4, 1e-2
_JAX_GRADS = {}


def _jax_loss_and_grads(jm, tm, frames):
    """JAX's loss and net gradients of one GOP (under the equal noise), in
    the port's layout; computed once a process."""
    if not _JAX_GRADS:
        graphdef, params, rest = nnx.split(jm, NET_FILTER, ...)

        def loss_of(params, rest):
            m = nnx.merge(graphdef, params, rest)
            out = m([jnp.asarray(f) for f in frames], training=True,
                    key=jax.random.key(0))
            return j_loss(out, [jnp.asarray(f) for f in frames],
                          lmbda=0.01)["loss"]

        value, grads = jax.jit(jax.value_and_grad(loss_of))(params, rest)
        # the converter's map takes the gradients to the port's layout
        _JAX_GRADS.update(value=float(value),
                          grads=load_jax_params(_jax_flat(grads), tm))
    return _JAX_GRADS["value"], _JAX_GRADS["grads"]


def _module(name):
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0].endswith("_hyperprior") \
        else parts[0]


def _port_gradient_errors(jm, tm, frames):
    """(the port's loss, JAX's, {parameter: max |port - JAX| gradient over
    JAX's largest element (inf where that is 0 and the port's is not)},
    the modules with a gradient that is not zero)."""
    j_value, j_grads = _jax_loss_and_grads(jm, tm, frames)
    net, _ = net_aux_partition(tm)
    assert set(j_grads) == set(net)
    xt = [torch.from_numpy(f) for f in frames]
    tm.train()
    out = tm(xt, training=True, generator=torch.Generator())
    loss = video_rate_distortion_loss(out, xt, lmbda=0.01)["loss"]
    set_guarded_grads(loss, list(net.values()))
    try:
        errors, moved = {}, set()
        for name, p in net.items():
            ref = j_grads[name].numpy()
            scale = float(np.abs(ref).max())
            diff = float(np.abs(p.grad.numpy() - ref).max())
            errors[name] = diff / scale if scale > 0 else (
                0.0 if diff == 0 else np.inf)
            if scale > 0:
                moved.add(_module(name))
        return float(loss.detach()), j_value, errors, moved
    finally:
        tm.zero_grad(set_to_none=True)


def _over_share(errors):
    return {name: e for name, e in errors.items()
            if e > (_SHARE_PAST_RELU if _module(name) in _PAST_RELU
                    else _SHARE)}


def test_video_loss_and_net_gradients_match_jax(pair, equal_noise):
    jm, tm = pair
    loss, j_value, errors, moved = _port_gradient_errors(jm, tm, _gop())
    np.testing.assert_allclose(loss, j_value, rtol=1e-5)
    assert not _over_share(errors), _over_share(errors)
    want = {"img_encoder", "img_decoder", "motion_encoder",
            "motion_decoder", "res_encoder", "res_decoder"}
    want |= {f"{b}_hyperprior.{part}" for b in ("img", "motion", "res")
             for part in ("hyper_encoder", "hyper_decoder_mean",
                          "hyper_decoder_scale")}
    assert want <= moved, sorted(want - moved)


def _forward_detaching_every_reference(self, frames, training=True,
                                       generator=None):
    x_hat, lk = self.forward_keyframe(frames[0], training, generator)
    reconstructions, frames_likelihoods = [x_hat], [lk]
    x_ref = x_hat.detach()
    for x in frames[1:]:
        x_rec, lk = self.forward_inter(x, x_ref, training, generator)
        reconstructions.append(x_rec)
        frames_likelihoods.append(lk)
        x_ref = x_rec.detach()
    return {"x_hat": reconstructions, "likelihoods": frames_likelihoods}


_WARP = video_google._warp_ncdhw
_FAULTS = {
    "later_references_detached": (
        video_google.ScaleSpaceFlow, "forward",
        _forward_detaching_every_reference),
    "qrelu_clamp_gradient": (
        video_google, "qrelu",
        lambda x, bit_depth=8, beta=100: torch.clamp(x, 0.0, 255.0)),
    "warp_flow_cut": (
        video_google, "_warp_ncdhw",
        lambda volume, flow, scale: _WARP(volume, flow.detach(), scale)),
    "warp_scale_field_cut": (
        video_google, "_warp_ncdhw",
        lambda volume, flow, scale: _WARP(volume, flow, scale.detach())),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_video_net_gradient_check_catches_fault(pair, equal_noise,
                                                monkeypatch, fault):
    """The gradient check above fails on the port with a fault made on
    purpose: some module off by 0.3 of its largest element or more."""
    jm, tm = pair
    owner, attr, replacement = _FAULTS[fault]
    monkeypatch.setattr(owner, attr, replacement)
    _, _, errors, _ = _port_gradient_errors(jm, tm, _gop())
    assert max(_over_share(errors).values(), default=0.0) >= 0.3


def test_video_train_step_matches_jax(pair, equal_noise):
    jm, tm = nnx.clone(pair[0]), copy.deepcopy(pair[1])
    j_net, j_aux = j_make_train_state(jm, 1e-4, 1e-3, 1.0)
    t_net, t_aux = make_train_state(tm, 1e-4, 1e-3, 1.0)
    w0 = tm.res_decoder.layers[0].weight.detach().clone()
    q0 = tm.motion_hyperprior.entropy_bottleneck.quantiles.detach().clone()
    frames = _gop()
    j_out = j_step(jm, j_net, j_aux, tuple(jnp.asarray(f) for f in frames),
                   jax.random.key(0), lmbda=0.01)
    t_out = video_train_step(tm, t_net, t_aux,
                             [torch.from_numpy(f) for f in frames],
                             torch.Generator().manual_seed(0), lmbda=0.01)
    assert set(t_out) == set(j_out) == {"loss", "bpp_loss", "mse_loss",
                                        "aux_loss"}
    for k in t_out:
        assert t_out[k].shape == () and not t_out[k].requires_grad
        np.testing.assert_allclose(float(t_out[k]), float(j_out[k]),
                                   rtol=1e-3, err_msg=k)
    assert not torch.equal(tm.res_decoder.layers[0].weight.detach(), w0)
    assert not torch.equal(
        tm.motion_hyperprior.entropy_bottleneck.quantiles.detach(), q0)
    assert {int(st["step"]) for st in t_net.state.values()} == {1}


def _jax_path(name):
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def _flat(state):
    return {"/".join(str(p) for p in path)
            for path, _ in nnx.to_flat_state(state)}


def test_net_aux_partition_matches_jax_filters(pair):
    jm, tm = pair
    net, aux = net_aux_partition(tm)
    assert {_jax_path(n) for n in aux} == _flat(nnx.state(jm, AUX_FILTER))
    assert {_jax_path(n) for n in net} == _flat(nnx.state(jm, NET_FILTER))
    assert sorted(aux) == [f"{b}_hyperprior.entropy_bottleneck.quantiles"
                           for b in ("img", "motion", "res")]


def _vimeo(root, n_seq=2, tuplet=3, side=72):
    """A vimeo_septuplet-style tree of PNG frames, a panned still each."""
    names = []
    for s in range(n_seq):
        name = f"{s + 1:05d}/0001"
        d = root / "sequences" / name
        d.mkdir(parents=True)
        big = textured_leaves(side + 8, side + 8, seed=s)
        for i in range(tuplet):
            img = big[i:i + side, 2 * i:2 * i + side]
            Image.fromarray(np.clip(img * 255 + 0.5, 0, 255).astype(
                np.uint8)).save(d / f"im{i + 1}.png")
        names.append(name)
    for split in ("train", "test"):
        (root / f"sep_{split}list.txt").write_text("\n".join(names) + "\n")
    return root


@pytest.mark.parametrize("kind", ["vimeo", "folder"])
def test_video_datasets_give_jax_frames(tmp_path, kind):
    root = _vimeo(tmp_path / "data")
    if kind == "vimeo":
        args = dict(split="train", tuplet=3, patch_size=64)
        ours = Vimeo90kDataset(root, **args)
        ref = j_video.Vimeo90kDataset(root, **args)
    else:
        (root / "trainlist.txt").write_text(
            (root / "sep_trainlist.txt").read_text())
        args = dict(rnd_interval=True, rnd_temp_order=True, max_frames=2,
                    patch_size=64)
        ours = VideoFolder(root, **args)
        ref = j_video.VideoFolder(root, **args)
    assert len(ours) == len(ref) == 2
    for i in range(len(ours)):
        random.seed(i)
        got = ours[i]
        random.seed(i)
        want = ref[i]
        assert len(got) == len(want) == (3 if kind == "vimeo" else 2)
        for g, w in zip(got, want):
            assert g.shape == (64, 64, 3) and np.array_equal(g, w)


def test_video_trainer_cli_epoch_resume_and_checkpoints(tmp_path):
    data, ck = _vimeo(tmp_path / "data", side=SIDE + 8), tmp_path / "ck"
    argv = ["-d", str(data), "--batch-size", "1", "--patch-size", str(SIDE),
            "--num-workers", "1", "--steps-per-epoch", "1",
            "--checkpoint-dir", str(ck), "--device", "cpu"]
    assert train_main(argv + ["--epochs", "1"]) == 0
    for name in ("latest", "best"):
        assert (ck / name).is_file() and (ck / f"{name}.meta.json").is_file()
    meta = json.loads((ck / "latest.meta.json").read_text())
    assert meta["epoch"] == 0 and np.isfinite(meta["loss"])
    assert train_main(argv + ["--epochs", "2", "--checkpoint",
                              str(ck / "latest")]) == 0
    assert json.loads((ck / "latest.meta.json").read_text())["epoch"] == 1

    model = ScaleSpaceFlow(seed=5, device="cpu")
    opt_net, opt_aux = make_train_state(model)
    assert load_checkpoint(ck / "latest", model, opt_net, opt_aux)[
        "epoch"] == 1
    assert {int(st["step"]) for st in opt_net.state.values()} == {2}

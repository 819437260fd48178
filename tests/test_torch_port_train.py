"""The port's training path (losses, metrics, the net/aux optimizers, the
train step, the datasets and the loader) against the JAX package's, on the
CPU, at N=32, K=2 (the flagship cut to narrow widths, as in
test_torch_port_forward.py), on the same weights (the JAX model's
parameters through the port's npz converter) and the same numpy inputs made
from a seed.

The training noise is made equal in both packages: ``jax.random.uniform``
and the port's ``uniform_noise`` are patched to one numpy array per shape,
and JAX's caches are cleared around the patched calls, so that no program
traced with real noise is reused (no file of the JAX package changes).

What is held, and how:
- the RD loss (mse and ms-ssim), ``psnr``, ``ssim`` and ``ms_ssim`` on the
  same arrays: rtol 1e-5, at sizes with 5, 3 and 2 MS-SSIM levels;
- the "net"/"aux" partition: the port's parameter names, mapped to the
  converter's paths, equal JAX's NET_FILTER and AUX_FILTER paths;
- the optimizer pair against ``make_train_state``'s optax chains over 5
  steps of the same synthetic gradients (one above the clip norm, one all
  zero, one holding a NaN through the guard): parameters within rtol 1e-6;
- one step's loss (rtol 1e-5) and each net gradient (within 1e-4 of its
  largest entry, the bound of test_torch_port_forward.py) against
  ``jax.value_and_grad`` of the JAX loss;
- three ``train_step``s against three ``data_parallel_train_step``s:
  losses within rtol 1e-3;
- with ``random.seed(s)`` and one loader worker, the port's ``BatchLoader``
  over ``ImageFolder`` gives the JAX copies' batches bit for bit.
"""

import functools
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from PIL import Image

from flashgmm_tpu.datasets import BatchLoader as JBatchLoader
from flashgmm_tpu.datasets import ImageFolder as JImageFolder
from flashgmm_tpu.losses import rate_distortion_loss as j_rd_loss
from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.parallel.train import (AUX_FILTER, NET_FILTER,
                                         _guard_nonfinite,
                                         data_parallel_train_step)
from flashgmm_tpu.parallel.train import make_train_state as j_make_train_state
from flashgmm_tpu.utils import metrics as j_metrics
from flashgmm_tpu_torch.datasets import BatchLoader, ImageFolder, save_image
from flashgmm_tpu_torch.datasets import textured_leaves
from flashgmm_tpu_torch.entropy_models import entropy_models as t_entropy
from flashgmm_tpu_torch.latent_codecs import checkerboard as t_checkerboard
from flashgmm_tpu_torch.losses import rate_distortion_loss
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.optimizers import net_aux_partition
from flashgmm_tpu_torch.parallel import (make_train_state, set_guarded_grads,
                                         train_step)
from flashgmm_tpu_torch.utils import metrics as t_metrics
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

N, K = 32, 2
LMBDA = 0.01
LR = 1e-3  # the optimizer test's net learning rate


def _flat(state):
    return {"/".join(str(p) for p in path): v
            for path, v in nnx.to_flat_state(state)}


def _jax_params(mod, filt=nnx.Param):
    return {k: np.array(v.get_value()) for k, v in _flat(nnx.state(mod, filt)).items()}


def _jax_path(name):
    """A port parameter name as the converter's nnx path."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def _port_layout(name, arr):
    """A JAX parameter in the port's layout (the converter's map)."""
    if arr.ndim == 4 and name.endswith(".weight"):
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW (no transposed convs)
    return arr


@pytest.fixture(scope="module")
def models():
    jm = JModel(N=N, K=K, rngs=nnx.Rngs(0))
    tm = TModel(N=N, K=K, device="cpu")
    tm.load_state_dict(load_jax_params(_jax_params(jm), tm), strict=True)
    return jm, tm


def _fresh_port(tm):
    """A port model of ``tm``'s weights, free to train."""
    fresh = TModel(N=N, K=K, device="cpu")
    fresh.load_state_dict(tm.state_dict(), strict=True)
    return fresh


def _images(b, seed, hw=64):
    return np.random.RandomState(seed).rand(b, hw, hw, 3).astype(np.float32)


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
    monkeypatch.setattr(t_checkerboard, "uniform_noise", t_uniform)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


# -- losses and metrics ---------------------------------------------------

def _rd_case(seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(2, 64, 48, 3).astype(np.float32)
    x_hat = np.clip(x + rs.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    lik = {"y": rs.uniform(1e-4, 1, (2, 4, 3, 8)).astype(np.float32),
           "z": rs.uniform(1e-3, 1, (2, 1, 1, 8)).astype(np.float32)}
    return x, x_hat, lik


@pytest.mark.parametrize("metric", ["mse", "ms-ssim"])
def test_rate_distortion_loss_matches_jax(metric):
    """Every term within rtol 1e-5; the ms-ssim distortion 1 - MS-SSIM is
    held through MS-SSIM itself (the subtraction from 1 cancels digits)."""
    x, x_hat, lik = _rd_case(0)
    ref = j_rd_loss({"x_hat": jnp.asarray(x_hat),
                     "likelihoods": {k: jnp.asarray(v) for k, v in lik.items()}},
                    jnp.asarray(x), lmbda=LMBDA, metric=metric)
    got = rate_distortion_loss(
        {"x_hat": torch.from_numpy(x_hat),
         "likelihoods": {k: torch.from_numpy(v) for k, v in lik.items()}},
        torch.from_numpy(x), lmbda=LMBDA, metric=metric)
    assert set(got) == set(ref) == {"loss", "bpp_loss", f"{metric}_loss"}
    for key in ref:
        g, r = float(got[key]), float(ref[key])
        if key == "ms-ssim_loss":
            g, r = 1 - g, 1 - r
        np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=key)
    with pytest.raises(NotImplementedError):
        rate_distortion_loss({"x_hat": torch.from_numpy(x_hat),
                              "likelihoods": {}}, torch.from_numpy(x),
                             metric="l1")


@pytest.mark.parametrize("shape,levels", [((1, 176, 176, 3), 5),
                                          ((2, 64, 48, 3), 3),
                                          ((1, 24, 30, 3), 2)])
def test_metrics_match_jax(shape, levels):
    """psnr, ssim and ms_ssim; 64x48 and 24x30 drop MS-SSIM levels (each
    level needs the 11x11 window)."""
    assert levels == min(
        lv for lv in range(1, 6)
        if lv == 5 or (min(shape[1:3]) >> lv) < 11)
    rs = np.random.RandomState(sum(shape))
    a = rs.rand(*shape).astype(np.float32)
    b = np.clip(a + rs.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    for fn in ("psnr", "ssim", "ms_ssim"):
        ref = float(getattr(j_metrics, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(t_metrics, fn)(torch.from_numpy(a), torch.from_numpy(b))
        assert got.shape == ()
        np.testing.assert_allclose(float(got), ref, rtol=1e-5, err_msg=fn)


# -- the optimizers --------------------------------------------------------

def test_net_aux_partition_matches_jax_filters(models):
    jm, tm = models
    net, aux = net_aux_partition(tm)
    assert {_jax_path(n) for n in aux} == set(_flat(nnx.state(jm, AUX_FILTER)))
    assert {_jax_path(n) for n in net} == set(_flat(nnx.state(jm, NET_FILTER)))
    assert list(aux) == ["latent_codec.latent_codec.hyper.entropy_bottleneck."
                         "quantiles"]
    assert len(net) + len(aux) == len(list(tm.parameters()))


@functools.partial(jax.jit, static_argnames="tx")
def _optax_step(tx, params, opt_state, grads, loss):
    """One step of a make_train_state chain, with the JAX step's guard."""
    updates, opt_state = tx.update(_guard_nonfinite(loss, grads), opt_state,
                                   params)
    return optax.apply_updates(params, updates), opt_state


def test_optimizer_pair_matches_optax(models, monkeypatch):
    """Five steps of the same synthetic gradients through both packages'
    guard, clip and Adam pairs (lr 1e-3, aux lr 1e-2, clip 1.0): a plain
    step, one of global norm 40 (clipped), an all-zero one, one holding a
    NaN (the guard zeroes it: Adam still moves by its momentum and counts
    the step) and a plain one. optax's Adam computes its bias corrections
    1 - b^t in float32 (1 - 0.999 is 1.3e-5 off at t=1), torch's in
    float64, so each update differs by up to ~1e-5 of its size: the
    parameters are held within rtol 1e-6 plus 1e-5 of the updates' sum."""
    jm, tm = models
    tm = _fresh_port(tm)
    # make_train_state's two chains (its nnx.Optimizers left unbuilt: their
    # eager init compiles a program a parameter shape)
    monkeypatch.setattr(nnx, "Optimizer", lambda model, tx, wrt: tx)
    j_net, j_aux = j_make_train_state(jm, LR, 10 * LR, 1.0)
    monkeypatch.undo()
    t_net, t_aux = make_train_state(tm, LR, 10 * LR, 1.0)
    net, aux = net_aux_partition(tm)
    sides = []
    for filt, params, tx, t_opt, clip in ((NET_FILTER, net, j_net, t_net, 1.0),
                                          (AUX_FILTER, aux, j_aux, t_aux, None)):
        j_params = {k: jnp.asarray(v) for k, v in _jax_params(jm, filt).items()}
        sides.append([params, tx, t_opt, clip, j_params,
                      jax.jit(tx.init)(j_params)])
    rs = np.random.RandomState(12)
    for step, kind in enumerate(("plain", "large", "zero", "nan", "plain")):
        for side in sides:
            params, tx, t_opt, clip, j_params, j_state = side
            grads = {n: rs.normal(0, 0.01, p.shape).astype(np.float32)
                     for n, p in params.items()}
            if kind == "large":
                norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                   for g in grads.values()))
                grads = {n: g * np.float32(40 / norm) for n, g in grads.items()}
            elif kind == "zero":
                grads = {n: np.zeros_like(g) for n, g in grads.items()}
            elif kind == "nan":
                grads[next(iter(grads))].flat[3] = np.nan
            # the port: a loss whose gradient is the synthetic one
            loss = sum((p * torch.from_numpy(grads[n])).sum()
                       for n, p in params.items())
            set_guarded_grads(loss, list(params.values()), clip)
            t_opt.step()
            t_opt.zero_grad(set_to_none=True)
            # JAX: the same gradients in its layout through the chain
            j_grads = {_jax_path(n): jnp.asarray(
                g.transpose(2, 3, 1, 0) if g.ndim == 4 else g)  # OIHW -> HWIO
                for n, g in grads.items()}
            side[4:] = _optax_step(tx, j_params, j_state, j_grads,
                                   jnp.float32(float(loss.detach())))
            for name, p in params.items():
                lr = 10 * LR if name in aux else LR
                np.testing.assert_allclose(
                    p.detach().numpy(),
                    _port_layout(name, np.asarray(side[4][_jax_path(name)])),
                    rtol=1e-6, atol=1e-5 * lr * (step + 1),
                    err_msg=f"step {step} ({kind}): {name}")
    for opt in (t_net, t_aux):
        counts = {int(s["step"]) for s in opt.state.values()}
        assert counts == {5}, counts


# -- the step --------------------------------------------------------------

def test_one_step_loss_and_net_gradients_match_jax(models, equal_noise):
    jm, tm = models
    x = _images(2, 21)
    graphdef, params, rest = nnx.split(jm, NET_FILTER, ...)

    def loss_of(params, rest):
        m = nnx.merge(graphdef, params, rest)
        out = m(jnp.asarray(x), training=True, key=jax.random.key(0))
        return j_rd_loss(out, jnp.asarray(x), lmbda=LMBDA)["loss"]

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_of))(params, rest)
    j_grads = {k: np.asarray(v.get_value()) for k, v in _flat(j_grads).items()}

    net, _ = net_aux_partition(tm)
    xt = torch.from_numpy(x)
    out = tm(xt, training=True, generator=torch.Generator())
    loss = rate_distortion_loss(out, xt, lmbda=LMBDA)["loss"]
    set_guarded_grads(loss, list(net.values()))
    try:
        np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
        assert set(j_grads) == {_jax_path(n) for n in net}
        zero = 0
        for name, p in net.items():
            ref = _port_layout(name, j_grads[_jax_path(name)])
            scale = float(np.abs(ref).max())
            zero += scale == 0
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=1e-4 * scale, err_msg=name)
        # h_s's first conv reads z_hat = round(z - medians) + medians, all
        # zero for these 1x1 latents of a fresh model: its kernel has no
        # gradient in either package
        assert zero == 1
    finally:
        tm.zero_grad(set_to_none=True)


def test_three_train_steps_match_jax(models, equal_noise):
    jm, tm = nnx.clone(models[0]), _fresh_port(models[1])
    j_net, j_aux = j_make_train_state(jm, 1e-4, 1e-3, 1.0)
    t_net, t_aux = make_train_state(tm, 1e-4, 1e-3, 1.0)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.key(0)
    j_losses, t_losses = [], []
    for step in range(3):
        x = _images(2, 30 + step)
        key, sub = jax.random.split(key)
        j_out = data_parallel_train_step(jm, j_net, j_aux, jnp.asarray(x), sub,
                                         LMBDA)
        t_out = train_step(tm, t_net, t_aux, torch.from_numpy(x), gen, LMBDA)
        assert set(t_out) == set(j_out)
        for k in t_out:
            assert t_out[k].shape == () and not t_out[k].requires_grad
        j_losses.append([float(j_out[k]) for k in sorted(j_out)])
        t_losses.append([float(t_out[k]) for k in sorted(t_out)])
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    assert t_losses[2][sorted(t_out).index("loss")] < t_losses[0][
        sorted(t_out).index("loss")]


# -- data ------------------------------------------------------------------

def test_loader_batches_match_jax(tmp_path):
    """PNG and binary PPM images of several sizes (one smaller than the
    patch: reflection padding), 32x32 random crops; with random.seed and one
    worker both packages give the same batches over two epochs."""
    for split in ("train", "test"):
        (tmp_path / split).mkdir()
    for i, (h, w) in enumerate([(40, 48), (64, 36), (33, 70), (28, 40),
                                (50, 50), (45, 61), (38, 38)]):
        img = textured_leaves(h, w, seed=i)
        if i % 2:
            save_image(tmp_path / "train" / f"{i}.ppm", img)
        else:
            Image.fromarray(np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)
                            ).save(tmp_path / "train" / f"{i}.png")
    loaders = [cls_l(cls_f(tmp_path, patch_size=32), 3, num_workers=1, seed=5)
               for cls_l, cls_f in ((JBatchLoader, JImageFolder),
                                    (BatchLoader, ImageFolder))]
    assert len(loaders[0]) == len(loaders[1]) == 2
    runs = []
    for loader in loaders:
        random.seed(77)
        runs.append([b for _ in range(2) for b in loader])
    assert len(runs[0]) == len(runs[1]) == 4
    for a, b in zip(*runs):
        assert a.dtype == b.dtype == np.float32 and a.shape == (3, 32, 32, 3)
        np.testing.assert_array_equal(a, b)
    # the PPM reader gives Pillow's array
    ppm = tmp_path / "train" / "1.ppm"
    from flashgmm_tpu.datasets import load_image as j_load_image
    from flashgmm_tpu_torch.datasets import load_image
    np.testing.assert_array_equal(load_image(ppm), j_load_image(ppm))

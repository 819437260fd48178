"""The port's point-cloud training against the JAX package's, on the CPU:
the two criteria and ``pointcloud_train_step``.

The training noise is made equal in both packages as in
test_torch_port_train.py: JAX's ``jax.random.uniform`` and the port's
``uniform_noise`` return one numpy array per shape. hrtzxf2022's two
latent codecs quantize latents of one shape, so both get the same noise in
both packages (JAX hands both codecs one key; the port rewinds its
generator).

Held:
- ``chamfer_distance``, ``chamfer_with_index`` (the index exactly),
  ``ChamferPccRateDistortionLoss`` and ``RateDistortionLossHrtzxf2022``
  (on a training output of the port's hrtzxf2022, fed to both) against
  JAX's: every term within rtol 1e-5;
- one ``pointcloud_train_step`` in both packages from the same weights,
  for each loss type: hrtzxf2022 under "hrtzxf2022" (its default widths,
  one downsample / upsample level of its three: JAX compiles the step of
  one level in ~17 s, of two in ~41 s, of three in ~110 s; the loss test
  above runs all three) and sfu-pcc-rec-pointnet (latent 64, 256 points)
  under "chamfer" with lambda 600, 2 clouds of 256 points: every returned
  term within rtol 1e-3; the parameters moved, and the port's update of
  all parameters is within 1e-3 of JAX's in relative L2 norm (2.1e-4 and
  1.1e-5 measured; not elementwise: Adam's
  first step is lr * g / (|g| + eps) elementwise, so a parameter whose
  gradient is near eps may move by any share of lr in either package);
- the registry names the two criteria as JAX does.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.losses import pointcloud as JLOSS
from flashgmm_tpu.models.pointcloud import hrtzxf2022 as JH
from flashgmm_tpu.models.pointcloud import sfu_pointnet as JPN
from flashgmm_tpu.parallel.train import make_train_state as j_make_state
from flashgmm_tpu.parallel.train import pointcloud_train_step as j_step
from flashgmm_tpu.registry import CRITERIONS as J_CRITERIONS
from flashgmm_tpu_torch import losses as TLOSS
from flashgmm_tpu_torch.entropy_models import entropy_models as t_entropy
from flashgmm_tpu_torch.models import pointcloud as TMOD
from flashgmm_tpu_torch.parallel import make_train_state, \
    pointcloud_train_step
from flashgmm_tpu_torch.registry import CRITERIONS
from flashgmm_tpu_torch.zoo import load_jax_params
from torch_port_pcc import held_out, load_like, n, t

torch.set_num_threads(2)


def _noise(shape):
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


@pytest.fixture
def equal_noise(monkeypatch):
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


def _j(tree):
    return jax.tree.map(lambda v: jnp.asarray(n(v)), tree,
                        is_leaf=lambda v: isinstance(v, torch.Tensor))


def test_chamfer_matches_jax():
    rs = np.random.RandomState(0)
    a = rs.rand(2, 300, 3).astype(np.float32)
    b = rs.rand(2, 211, 3).astype(np.float32)
    np.testing.assert_allclose(float(TLOSS.chamfer_distance(t(a), t(b))),
                               float(JLOSS.chamfer_distance(a, b)),
                               rtol=1e-5)
    ch, idx = TLOSS.chamfer_with_index(t(a), t(b))
    jch, jidx = JLOSS.chamfer_with_index(a, b)
    np.testing.assert_allclose(float(ch), float(jch), rtol=1e-5)
    np.testing.assert_array_equal(n(idx), np.asarray(jidx))
    lks = {"y": rs.uniform(1e-4, 1, (2, 1, 1, 64)).astype(np.float32)}
    out = {"x_hat": a, "likelihoods": lks}
    target = rs.rand(2, 300, 3).astype(np.float32)
    got = TLOSS.ChamferPccRateDistortionLoss(600.0)(
        {"x_hat": t(a), "likelihoods": {"y": t(lks["y"])}}, t(target))
    want = JLOSS.ChamferPccRateDistortionLoss(600.0)(
        _j(out), jnp.asarray(target))
    for k in ("loss", "bpp_loss", "chamfer_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_hrtzxf_loss_matches_jax(equal_noise):
    jm = JH.DensityPreservingReconstructionPccModel(rngs=nnx.Rngs(0))
    tm = load_like(TMOD.DensityPreservingReconstructionPccModel(
        device="cpu"), jm)
    x = held_out(2, 256)
    with torch.no_grad():
        out = tm(t(x), training=True, generator=torch.Generator())
    got = TLOSS.RateDistortionLossHrtzxf2022()(out, t(x))
    want = JLOSS.RateDistortionLossHrtzxf2022()(_j(out), jnp.asarray(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _jax_flat(state):
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in nnx.to_flat_state(state)}


@pytest.mark.parametrize("loss_type", ["hrtzxf2022", "chamfer"])
def test_train_step_matches_jax(equal_noise, loss_type):
    if loss_type == "hrtzxf2022":
        one_level = {"downsample_rate": (1 / 3,),
                     "candidate_upsample_rate": (8,)}
        jm = JH.DensityPreservingReconstructionPccModel(**one_level,
                                                        rngs=nnx.Rngs(0))
        tm = TMOD.DensityPreservingReconstructionPccModel(**one_level,
                                                          device="cpu")
        lmbda = 1.0
    else:
        jm = JPN.PointNetReconstructionPccModel(num_points=256, latent_dim=64,
                                                rngs=nnx.Rngs(0))
        tm = TMOD.PointNetReconstructionPccModel(num_points=256,
                                                 latent_dim=64, device="cpu")
        lmbda = 600.0
    load_like(tm, jm)
    x = held_out(2, 256)
    j_opts = j_make_state(jm, 1e-3, 1e-3, 1.0)
    want = j_step(jm, *j_opts, jnp.asarray(x), jax.random.key(0),
                  loss_type=loss_type, lmbda=lmbda)
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    t_opts = make_train_state(tm, 1e-3, 1e-3, 1.0)
    got = pointcloud_train_step(tm, *t_opts, t(x), torch.Generator(),
                                loss_type=loss_type, lmbda=lmbda)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3,
                                   err_msg=k)
    after = load_jax_params(_jax_flat(nnx.state(jm, nnx.Param)), tm)
    state = tm.state_dict()
    assert set(after) == set(state)
    d_port = torch.cat([(state[k] - before[k]).reshape(-1) for k in after])
    d_jax = torch.cat([(after[k] - before[k]).reshape(-1) for k in after])
    assert float(d_port.abs().max()) > 0
    rel = float(torch.linalg.vector_norm(d_port - d_jax)
                / torch.linalg.vector_norm(d_jax))
    assert rel <= 1e-3, rel


def test_registry_names_the_criteria():
    for name, cls in (("RateDistortionLoss_hrtzxf2022",
                       TLOSS.RateDistortionLossHrtzxf2022),
                      ("ChamferPccRateDistortionLoss",
                       TLOSS.ChamferPccRateDistortionLoss)):
        assert CRITERIONS[name] is cls
        assert J_CRITERIONS[name].__name__ == cls.__name__

"""The port's ``vbr_train_step`` against the JAX package's, on the CPU, and
the net/aux split of the VBR models.

The VBR model is mbt2018-mean-vbr with the variable-step bottleneck (the
shipped configuration) at N=32, M=48, built by JAX with ``nnx.Rngs(0)`` and
carried to the port through ``zoo.load_jax_params``. The training noise is
made equal in both packages as in test_torch_port_train.py: JAX's
``jax.random.uniform`` and the port's ``uniform_noise`` are patched to one
numpy array per shape, JAX's caches cleared around the patched calls.

Held:
- one step at s=0, then one at s=7 (lambda ``VBR_LMBDAS[s]``) in both
  packages from the same weights: every returned term within rtol 1e-3,
  ``s`` returned as given; ``Gain`` unchanged in both (it gets no
  gradient), g_a's first weight moved;
- ``net_aux_partition`` of each VBR model: the port's parameter names,
  mapped to the converter's paths, equal JAX's NET_FILTER and AUX_FILTER
  paths (``Gain`` and the MLPs in "net").
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models import vbr as j_vbr
from flashgmm_tpu.parallel.train import AUX_FILTER, NET_FILTER
from flashgmm_tpu.parallel.train import make_train_state as j_make_train_state
from flashgmm_tpu.parallel.train import vbr_train_step as j_vbr_train_step
from flashgmm_tpu_torch.entropy_models import entropy_models as t_entropy
from flashgmm_tpu_torch.models import vbr as t_vbr
from flashgmm_tpu_torch.optimizers import net_aux_partition
from flashgmm_tpu_torch.parallel import make_train_state, vbr_train_step
from flashgmm_tpu_torch.zoo import load_jax_params
from torch_port_model_pairs import jax_params

torch.set_num_threads(1)

N, M = 32, 48


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


def _pair(name, **kw):
    jm = getattr(j_vbr, name)(N, M, rngs=nnx.Rngs(0), **kw)
    tm = getattr(t_vbr, name)(N, M, device="cpu", **kw)
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    return jm, tm


def _jax_path(name):
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def _flat(state):
    return {"/".join(str(p) for p in path)
            for path, _ in nnx.to_flat_state(state)}


@pytest.fixture(scope="module")
def shipped_config():
    """Built before the noise is patched (JAX's initialisers draw from
    jax.random.uniform too)."""
    return _pair("MeanScaleHyperpriorVbr", vr_entbttlnck=True)


def test_vbr_train_steps_match_jax(shipped_config, equal_noise):
    jm, tm = shipped_config
    j_net, j_aux = j_make_train_state(jm, 1e-4, 1e-3, 1.0)
    t_net, t_aux = make_train_state(tm, 1e-4, 1e-3, 1.0)
    gain_j = np.asarray(jm.Gain.value).copy()
    gain_t = tm.Gain.detach().clone()
    g_a0 = tm.g_a.layers[0].weight.detach().clone()
    gen = torch.Generator().manual_seed(0)
    key = jax.random.key(0)
    for step, s in enumerate((0, 7)):
        lmbda = t_vbr.VBR_LMBDAS[s]
        x = np.random.RandomState(60 + step).rand(2, 64, 64, 3).astype(
            np.float32)
        key, sub = jax.random.split(key)
        j_out = j_vbr_train_step(jm, j_net, j_aux, jnp.asarray(x), sub,
                                 jnp.int32(s), jnp.float32(lmbda))
        t_out = vbr_train_step(tm, t_net, t_aux, torch.from_numpy(x), gen, s,
                               lmbda)
        assert set(t_out) == set(j_out) == {"loss", "bpp_loss", "mse_loss",
                                            "aux_loss", "s"}
        assert int(t_out["s"]) == int(j_out["s"]) == s
        for k in ("loss", "bpp_loss", "mse_loss", "aux_loss"):
            assert t_out[k].shape == () and not t_out[k].requires_grad
            np.testing.assert_allclose(float(t_out[k]), float(j_out[k]),
                                       rtol=1e-3, err_msg=f"s={s}: {k}")
    assert np.array_equal(np.asarray(jm.Gain.value), gain_j)
    assert torch.equal(tm.Gain.detach(), gain_t)
    assert not torch.equal(tm.g_a.layers[0].weight.detach(), g_a0)
    assert {int(st["step"]) for st in t_net.state.values()} == {2}


@pytest.mark.parametrize("name,kw", [
    ("ScaleHyperpriorVbr", {"vr_entbttlnck": True}),
    ("MeanScaleHyperpriorVbr", {"vr_entbttlnck": False}),
    ("JointAutoregressiveHierarchicalPriorsVbr", {})])
def test_net_aux_partition_matches_jax_filters(name, kw):
    jm, tm = _pair(name, **kw)
    net, aux = net_aux_partition(tm)
    assert {_jax_path(n) for n in aux} == _flat(nnx.state(jm, AUX_FILTER))
    assert {_jax_path(n) for n in net} == _flat(nnx.state(jm, NET_FILTER))
    assert list(aux) == ["entropy_bottleneck.quantiles"]
    assert "Gain" in net and "QuantABCD.linears.0.weight" in net

"""The port's training forward (model, latent codecs, entropy models and
``lower_bound``) against the JAX package's, at N=32, K=2 (the flagship cut
to narrow widths), on the CPU, on the same weights (the JAX model's
parameters through the port's npz converter) and the same numpy inputs
made from a seed.

What is held, and how:
- ``training=False`` forward: x_hat and both likelihoods within atol 2e-4
  (float32 conv chains summed in another order than XLA's, as in
  test_torch_port_codec.py); y_hat, round(y), by a measured flip rate;
- each ``_likelihood`` (EntropyBottleneck, GaussianConditional, GMM) on
  the same noisy inputs: rtol 1e-4 where the likelihood is above 1e-6;
- ``aux_loss`` within rtol 1e-5;
- the GMM likelihood's gradients with respect to scales, means and weights
  against ``jax.vjp`` (rtol 1e-4), ``lower_bound``'s exactly, and the
  gradients of the eval-mode rate through the whole network against
  ``jax.grad`` (within 1e-4 of each gradient's largest entry; measured
  (torch 2.13 CPU, jax 0.9) at most 7.7e-6);
- ``training=True``: the same generator seed gives the same result, and
  the noisy latents lie within 0.5 of the clean ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.entropy_models import GaussianConditional as JGaussian
from flashgmm_tpu.entropy_models import GaussianMixtureConditional as JGmm
from flashgmm_tpu.latent_codecs import (
    GaussianMixtureConditionalLatentCodec as JGmmCodec,
)
from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.ops import lower_bound as j_lower_bound
from flashgmm_tpu_torch.entropy_models import GaussianConditional as TGaussian
from flashgmm_tpu_torch.entropy_models import GaussianMixtureConditional as TGmm
from flashgmm_tpu_torch.latent_codecs import (
    GaussianMixtureConditionalLatentCodec as TGmmCodec,
)
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.ops import lower_bound as t_lower_bound
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

N, K = 32, 2
ATOL = 2e-4


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


@pytest.fixture(scope="module")
def models():
    jm = JModel(N=N, K=K, rngs=nnx.Rngs(0))
    tm = TModel(N=N, K=K, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    return jm, tm


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close_where_likely(got, ref, rtol=1e-4, floor=1e-6):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape
    mask = ref > floor
    assert mask.mean() > 0.5  # the comparison covers most entries
    np.testing.assert_allclose(got[mask], ref[mask], rtol=rtol, atol=0)


def test_eval_forward_matches_jax(models):
    jm, tm = models
    x = _images(2, 3)
    graphdef, state = nnx.split(jm)
    jo = jax.jit(lambda st, v: nnx.merge(graphdef, st)(v, training=False))(
        state, jnp.asarray(x))
    with torch.no_grad():
        to = tm(torch.from_numpy(x), training=False)
    assert set(to) == {"x_hat", "likelihoods"}
    assert set(to["likelihoods"]) == {"y", "z"}
    np.testing.assert_allclose(to["x_hat"].numpy(), np.asarray(jo["x_hat"]),
                               atol=ATOL, rtol=0)
    for name, shape in (("y", (2, 4, 4, N)), ("z", (2, 1, 1, N))):
        got = to["likelihoods"][name].numpy()
        assert got.shape == shape
        np.testing.assert_allclose(got, np.asarray(jo["likelihoods"][name]),
                                   atol=ATOL, rtol=0)


def test_eval_y_hat_is_round_y_and_agrees_with_jax(models):
    """y_hat = round(y) in both packages. g_a sums in another order than
    XLA's convs, so a latent near a rounding boundary may round the other
    way: measured (torch 2.13 CPU, jax 0.9) 0 of the 2048 symbols of these
    two images differ; bound 1 % (20), one step at most."""
    jm, tm = models
    x = _images(2, 4)
    graphdef, state = nnx.split(jm)

    def y_hat(st, v):
        m = nnx.merge(graphdef, st)
        return m.latent_codec(m.g_a(v), training=False)["y_hat"]

    j_hat = jax.jit(y_hat)(state, jnp.asarray(x))
    with torch.no_grad():
        y = tm.g_a(torch.from_numpy(x))
        t_hat = tm.latent_codec(y, training=False)["y_hat"]
    assert torch.equal(t_hat, torch.round(y))
    flips = int((t_hat.numpy() != np.asarray(j_hat)).sum())
    assert flips <= 20, flips
    assert float(np.abs(t_hat.numpy() - np.asarray(j_hat)).max()) <= 1


@pytest.mark.parametrize("model", ["eb", "gaussian", "gmm"])
def test_likelihood_matches_jax(models, model):
    jm, tm = models
    rs = np.random.RandomState(5)
    if model == "eb":
        jeb = jm.latent_codec.latent_codec["hyper"].entropy_bottleneck
        teb = tm.latent_codec.latent_codec["hyper"].entropy_bottleneck
        med = np.asarray(jeb._get_medians())  # [C, 1, 1]
        v = (med + rs.normal(0, 3, (N, 1, 500))
             + rs.uniform(-0.5, 0.5, (N, 1, 500))).astype(np.float32)
        ref = jeb._likelihood(jnp.asarray(v))[0]
        with torch.no_grad():
            got = teb._likelihood(_t(v))[0]
        _close_where_likely(got.numpy(), ref)
        return
    shape = (2, 4, 4, N)
    y = (rs.normal(0, 4, shape) + rs.uniform(-0.5, 0.5, shape)).astype(np.float32)
    if model == "gaussian":
        scales = rs.uniform(0.05, 8, shape).astype(np.float32)
        means = rs.normal(0, 2, shape).astype(np.float32)
        ref = JGaussian(None)._likelihood(jnp.asarray(y), jnp.asarray(scales),
                                          jnp.asarray(means))
        got = TGaussian()._likelihood(_t(y), _t(scales), _t(means))
    else:
        kshape = shape[:-1] + (K * N,)
        scales = rs.uniform(0.05, 8, kshape).astype(np.float32)
        means = rs.normal(0, 3, kshape).astype(np.float32)
        w = rs.uniform(0.1, 1, (2, 4, 4, K, N))
        w = (w / w.sum(-2, keepdims=True)).reshape(kshape).astype(np.float32)
        ref = JGmm(K=K)._likelihood(jnp.asarray(y), jnp.asarray(scales),
                                    jnp.asarray(means), jnp.asarray(w))
        got = TGmm(K=K)._likelihood(_t(y), _t(scales), _t(means), _t(w))
    _close_where_likely(got.numpy(), ref)


def test_aux_loss_matches_jax(models):
    jm, tm = models
    ref = float(jm.aux_loss())
    got = tm.aux_loss()
    assert got.shape == () and float(got) > 1.0
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    # the MLP's parameters get no gradient from it, the quantiles do
    got.backward()
    eb = tm.latent_codec.latent_codec["hyper"].entropy_bottleneck
    try:
        assert eb.matrix0.grad is None
        assert float(eb.quantiles.grad.abs().sum()) > 0
    finally:
        tm.zero_grad(set_to_none=True)


def test_gmm_likelihood_gradients_match_jax():
    rs = np.random.RandomState(6)
    shape = (1, 3, 5, 8)
    kshape = shape[:-1] + (K * 8,)
    y = rs.normal(0, 3, shape).astype(np.float32)
    scales = rs.uniform(0.02, 6, kshape).astype(np.float32)  # some bounded
    means = rs.normal(0, 2, kshape).astype(np.float32)
    w = rs.uniform(0.1, 1, kshape).astype(np.float32)
    cot = rs.normal(0, 1, shape).astype(np.float32)
    jgm = JGmm(K=K)

    def f(s, m, w_):
        return jgm._likelihood(jnp.asarray(y), s, m, w_)

    _, vjp = jax.vjp(f, jnp.asarray(scales), jnp.asarray(means),
                     jnp.asarray(w))
    refs = vjp(jnp.asarray(cot))
    params = [_t(p).requires_grad_() for p in (scales, means, w)]
    TGmm(K=K)._likelihood(_t(y), *params).backward(_t(cot))
    for p, ref in zip(params, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())
    # scales under the bound pass a gradient only where it is negative
    assert (scales < 0.11).any()


def test_lower_bound_gradient_matches_jax():
    rs = np.random.RandomState(7)
    x = rs.normal(0, 1, 400).astype(np.float32)
    cot = rs.normal(0, 1, 400).astype(np.float32)
    out, vjp = jax.vjp(lambda v: j_lower_bound(v, 0.25), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(cot))
    xt = _t(x).requires_grad_()
    got = t_lower_bound(xt, 0.25)
    got.backward(_t(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    # every case of the rule occurs: above, below with g < 0, below g >= 0
    below = x < 0.25
    assert (below & (cot < 0)).any() and (below & (cot >= 0)).any()


def test_eval_rate_gradients_match_jax(models):
    """The eval-mode rate, -sum(log2 likelihoods) / pixels, differentiated
    through the whole network: z's STE rounding, the GDN reparametrizations'
    and the likelihoods' lower bounds, the EntropyBottleneck's MLP."""
    jm, tm = models
    x = _images(1, 8)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def rate(params, rest):
        m = nnx.merge(graphdef, params, rest)
        lik = m(jnp.asarray(x), training=False)["likelihoods"]
        return sum(-jnp.log2(v).sum() for v in lik.values()) / (64 * 64)

    j_grads = jax.jit(jax.grad(rate))(params, rest)
    j_flat = {"/".join(str(p) for p in path): np.asarray(v.get_value())
              for path, v in nnx.to_flat_state(j_grads)}
    lik = tm(torch.from_numpy(x), training=False)["likelihoods"]
    (sum(-torch.log2(v).sum() for v in lik.values()) / (64 * 64)).backward()
    named = dict(tm.named_parameters())
    keys = ("g_a/layers/0/conv1/kernel",
            "latent_codec/latent_codec/hyper/h_a/layers/0/kernel",
            "latent_codec/latent_codec/y/entropy_parameters/layers/4/kernel",
            "latent_codec/latent_codec/hyper/entropy_bottleneck/matrix0",
            "latent_codec/latent_codec/hyper/entropy_bottleneck/quantiles",
            "g_a/layers/0/gdn/gamma")
    try:
        for key in keys:
            ref = j_flat[key]
            got = named[".".join(key.split("/")[:-1] + (
                ["weight"] if key.endswith("kernel") else [key.split("/")[-1]]))]
            got = got.grad.numpy()
            if key.endswith("kernel"):
                got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            scale = float(np.abs(ref).max())
            assert scale > 0, key
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale,
                                       err_msg=key)
    finally:
        tm.zero_grad(set_to_none=True)


def test_training_forward_is_seeded(models):
    _, tm = models
    x = torch.from_numpy(_images(1, 9))

    def run(seed):
        with torch.no_grad():
            return tm(x, training=True,
                      generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    for name in ("y", "z"):
        assert torch.equal(a["likelihoods"][name], b["likelihoods"][name])
        assert not torch.equal(a["likelihoods"][name], c["likelihoods"][name])
    assert torch.equal(a["x_hat"], b["x_hat"])
    with torch.no_grad():
        y = tm.g_a(x)
        out = tm.latent_codec(y, training=True,
                              generator=torch.Generator().manual_seed(3))
        z = tm.latent_codec.latent_codec["hyper"].h_a(y)
        eb = tm.latent_codec.latent_codec["hyper"].entropy_bottleneck
        z_tilde, _ = eb(z, training=True,
                        generator=torch.Generator().manual_seed(4))
    for noisy, clean in ((out["y_hat"], y), (z_tilde, z)):
        d = (noisy - clean).abs()
        assert float(d.max()) <= 0.5 and float(d.min()) >= 0
        assert not torch.equal(noisy, torch.round(clean))
    with pytest.raises(ValueError, match="Generator"):
        tm(x, training=True)


def test_weighted_mean_ste_quantizer_matches_jax():
    """The GMM latent codec's other quantizer, rounding around the
    mixture's weighted mean (straight-through), in eval mode."""
    rs = np.random.RandomState(10)
    y = rs.normal(0, 3, (1, 4, 4, 8)).astype(np.float32)
    ctx = rs.normal(0, 1, (1, 4, 4, 3 * K * 8)).astype(np.float32)
    jc = JGmmCodec(K=K, quantizer="weighted_mean_ste")
    ref = jc(jnp.asarray(y), jnp.asarray(ctx), training=False)
    tc = TGmmCodec(K=K, quantizer="weighted_mean_ste")
    got = tc(_t(y), _t(ctx), training=False)
    np.testing.assert_allclose(got["y_hat"].numpy(), np.asarray(ref["y_hat"]),
                               atol=1e-5, rtol=0)
    _close_where_likely(got["likelihoods"]["y"].numpy(),
                        ref["likelihoods"]["y"])
    # training: the noise on top of the straight-through rounding, so y
    # gets the identity gradient
    yt = _t(y).requires_grad_()
    out = tc(yt, _t(ctx), training=True,
             generator=torch.Generator().manual_seed(0))
    out["y_hat"].sum().backward()
    assert torch.equal(yt.grad, torch.ones_like(yt))


@pytest.mark.parametrize("mode", ["dequantize", "symbols"])
def test_quantize_modes_and_dequantize_match_jax(mode):
    rs = np.random.RandomState(11)
    x = rs.normal(0, 4, (2, 3, 3, 8)).astype(np.float32)
    means = rs.normal(0, 1, (2, 3, 3, 8)).astype(np.float32)
    jgm, tgm = JGmm(K=K), TGmm(K=K)
    for m in (None, means):
        ref = np.asarray(jgm.quantize(jnp.asarray(x), mode, None if m is None
                                      else jnp.asarray(m)))
        got = tgm.quantize(_t(x), mode, None if m is None else _t(m)).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    if mode == "symbols":
        sym = tgm.quantize(_t(x), mode, _t(means))
        np.testing.assert_array_equal(
            tgm.dequantize(sym, _t(means)).numpy(),
            np.asarray(jgm.dequantize(jnp.asarray(sym.numpy()),
                                      jnp.asarray(means))))
        assert tgm.dequantize(sym).dtype == torch.float32
    with pytest.raises(ValueError, match="quantization mode"):
        tgm.quantize(_t(x), "bogus")

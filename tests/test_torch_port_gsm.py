"""The port's single-Gaussian (SenseTime) line against the JAX package's,
on the CPU, on the same weights (the JAX parameters through the port's npz
converter) and the same numpy inputs made from a seed:
``GaussianConditionalLatentCodec``, the checkerboard's two-pass forwards,
``Cheng2020AnchorCheckerboard`` at N=32 and ``Elic2022Official`` at N=32,
M=64, groups [8, 8, 16, 16, 16] (the JAX tests' sizes), 64x64 images.

Tolerances: float32 convs in XLA and in torch sum in different orders.
- GaussianConditionalLatentCodec on the same parameters: likelihoods rtol
  1e-4 where above 1e-6, y_hat atol 1e-5 ("ste": round(y - means) +
  means);
- the two-pass forwards on the latent and side parameters of one image:
  y_hat by a measured flip count held under a bound (a latent whose
  y - mean sits at a rounding boundary may round the other way; measured,
  torch 2.13 CPU, jax 0.9: 0 of 1024; bound 10, one step at most);
- likelihoods under parameters that the network computes: rtol 2e-4 where
  above 1e-6 (at the positions of equal y_hat). The means and scales
  differ by float32 ulps, and a bin's likelihood moves by that times
  |y - mean| / scale^2 relative to itself, most in the tails: measured
  (torch 2.13 CPU, jax 0.9) at most 4.3e-5 relative in these tests, and
  1.03e-4 on three 128x128 images of the same seeds;
- g_a, h_a, h_s (on the rows chain) and g_s: atol 2e-4; the eval
  forward's x_hat atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from flashgmm_tpu.latent_codecs import (
    GaussianConditionalLatentCodec as JGcCodec,
)
from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JGmm
from flashgmm_tpu.models.sensetime import Cheng2020AnchorCheckerboard as JCkbd
from flashgmm_tpu.models.sensetime import Elic2022Official as JElic
from flashgmm_tpu_torch import layers as tl
from flashgmm_tpu_torch.latent_codecs import CheckerboardLatentCodec
from flashgmm_tpu_torch.latent_codecs import (
    GaussianConditionalLatentCodec as TGcCodec,
)
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboard as TCkbd
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TGmm
from flashgmm_tpu_torch.models import Elic2022Official as TElic
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

N, M, GROUPS = 32, 64, [8, 8, 16, 16, 16]
ATOL = 2e-4
RTOL_NET = 2e-4  # the likelihoods under parameters from the network
FLIPS = 10


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


def port_of(jmod, tmod):
    tmod.load_state_dict(load_jax_params(jax_params(jmod), tmod), strict=True)
    return tmod.eval()


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _close_where_large(got, ref, keep=None, rtol=RTOL_NET):
    mask = ref > 1e-6
    if keep is not None:
        mask &= keep
    assert mask.mean() > 0.5
    np.testing.assert_allclose(got[mask], ref[mask], rtol=rtol, atol=0)


def _h_s_grad(tm):
    """The gradient's size on h_s's parameters (the side parameters reach
    the rate through both checkerboard passes)."""
    return sum(float(p.grad.abs().sum()) for p in
               tm.latent_codec.latent_codec["hyper"].h_s.parameters())


@pytest.fixture(scope="module")
def ckbd():
    jm = JCkbd(N=N, rngs=nnx.Rngs(0))
    return jm, port_of(jm, TCkbd(N=N, device="cpu"))


@pytest.fixture(scope="module")
def elic():
    jm = JElic(N=N, M=M, groups=GROUPS, rngs=nnx.Rngs(0))
    return jm, port_of(jm, TElic(N=N, M=M, groups=GROUPS, device="cpu"))


@pytest.mark.parametrize("chunks", [("scales",), ("means",),
                                    ("scales", "means"), ("means", "scales")])
def test_chunk_orders_match_jax(chunks):
    p = np.random.RandomState(1).randn(2, 3, 4, 12).astype(np.float32)
    ref = JGcCodec(chunks=chunks)._chunk(jnp.asarray(p))
    got = TGcCodec(chunks=chunks)._chunk(torch.from_numpy(p))
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("quantizer", ["ste", "noise"])
def test_gaussian_conditional_latent_codec_matches_jax(quantizer):
    rs = np.random.RandomState(2)
    y = (rs.randn(2, 4, 5, 8) * 3).astype(np.float32)
    params = np.concatenate([rs.uniform(0.05, 4, (2, 4, 5, 8)),
                             rs.randn(2, 4, 5, 8) * 2], -1).astype(np.float32)
    jo = JGcCodec(quantizer=quantizer)(jnp.asarray(y), jnp.asarray(params),
                                       training=False)
    to = TGcCodec(quantizer=quantizer)(torch.from_numpy(y),
                                       torch.from_numpy(params),
                                       training=False)
    np.testing.assert_allclose(to["y_hat"].numpy(), np.asarray(jo["y_hat"]),
                               rtol=0, atol=1e-5)
    _close_where_large(to["likelihoods"]["y"].numpy(),
                       np.asarray(jo["likelihoods"]["y"]), rtol=1e-4)
    # training: seeded noise, a straight-through gradient for "ste"
    yt = torch.from_numpy(y).requires_grad_(True)
    outs = [TGcCodec(quantizer=quantizer)(
        yt, torch.from_numpy(params), training=True,
        generator=torch.Generator().manual_seed(4)) for _ in range(2)]
    assert torch.equal(outs[0]["likelihoods"]["y"], outs[1]["likelihoods"]["y"])
    outs[0]["y_hat"].sum().backward()
    assert torch.equal(yt.grad, torch.ones_like(yt))


@pytest.mark.parametrize("method", ["twopass", "twopass_faster"])
def test_two_pass_forwards_match_jax(ckbd, method):
    """The model's checkerboard codec, eval mode, each forward method, on
    the latent and side parameters the JAX model makes of an image."""
    jm, tm = ckbd
    jc, tc = jm.latent_codec["y"], tm.latent_codec.latent_codec["y"]
    hyper = jm.latent_codec["hyper"]
    y = jm.g_a(jnp.asarray(_images(2, 3)))
    side = np.array(hyper.h_s(jnp.round(hyper.h_a(y))))
    y = np.array(y)
    jc.forward_method = tc.forward_method = method
    try:
        jo = jc(jnp.asarray(y), jnp.asarray(side), training=False)
        with torch.no_grad():
            to = tc(torch.from_numpy(y), torch.from_numpy(side),
                    training=False)
    finally:
        jc.forward_method = tc.forward_method = "twopass"
    y_hat, ref = to["y_hat"].numpy(), np.asarray(jo["y_hat"])
    same = np.abs(y_hat - ref) <= 1e-4
    assert int((~same).sum()) <= FLIPS
    assert float(np.abs(y_hat - ref).max()) <= 1 + 1e-4
    _close_where_large(to["likelihoods"]["y"].numpy(),
                       np.asarray(jo["likelihoods"]["y"]), same)


def test_forward_method_is_checked():
    with pytest.raises(ValueError, match="forward method"):
        CheckerboardLatentCodec(forward_method="threepass")


def test_entropy_parameters_widths():
    """N=128, the local weights': 512 -> 426 -> 341 -> 256."""
    tm = TCkbd(N=128, device="cpu")
    ep = tm.latent_codec.latent_codec["y"].entropy_parameters
    assert [(m.in_ch, m.out_ch) for m in ep if isinstance(m, tl.Conv2d)] == \
        [(512, 426), (426, 341), (341, 256)]


def test_flagship_module_paths_unchanged():
    """The flagship builds g_a, g_s, h_a and h_s from the shared Cheng2020
    helpers: its parameters sit at the JAX model's paths, and the GSM
    model's transforms at the same paths."""
    jm = JGmm(N=N, K=2, rngs=nnx.Rngs(0))
    tm = TGmm(N=N, K=2, device="cpu")
    assert set(load_jax_params(jax_params(jm), tm)) == set(tm.state_dict())
    gsm = TCkbd(N=N, device="cpu").state_dict()
    for key in tm.state_dict():
        if key.startswith(("g_a.", "g_s.", "latent_codec.latent_codec.hyper.")):
            assert key in gsm, key
            assert gsm[key].shape == tm.state_dict()[key].shape


def test_synthetic_n128_weights_load_every_tensor():
    from pathlib import Path

    from flashgmm_tpu_torch.zoo import load_npz

    path = (Path(__file__).resolve().parent.parent / "weights"
            / "ckbd_gc_n128_synthetic.npz")
    if not path.exists():
        pytest.skip("weights/ckbd_gc_n128_synthetic.npz not in this checkout")
    tm = TCkbd(N=128, device="cpu")
    with np.load(path) as data:
        n_file = len(data.files)
    assert load_npz(tm, path) == n_file == len(tm.state_dict())


@pytest.mark.parametrize("stage", ["g_a", "h_a", "h_s", "g_s"])
@pytest.mark.parametrize("which", ["ckbd", "elic"])
def test_transforms_match_jax(ckbd, elic, which, stage):
    """h_s on the rows chain (the conv kernel's plain version), the others
    as the forward runs them."""
    jm, tm = ckbd if which == "ckbd" else elic
    m = N if which == "ckbd" else M
    jhyper = jm.latent_codec["hyper"]
    thyper = tm.latent_codec.latent_codec["hyper"]
    rs = np.random.RandomState(11)
    if stage == "g_a":
        x, jmod, run = _images(2, 5), jm.g_a, tm.g_a
    elif stage == "h_a":
        x, jmod, run = rs.randn(2, 4, 4, m).astype(np.float32), jhyper.h_a, \
            thyper.h_a
    elif stage == "h_s":
        x = np.round(rs.randn(2, 2, 3, N) * 3).astype(np.float32)
        jmod = jhyper.h_s
        run = (lambda v: tl.run_canonical(thyper.h_s, v))
    else:
        x, jmod, run = np.round(rs.randn(2, 4, 4, m) * 2).astype(np.float32), \
            jm.g_s, tm.g_s
    ref = np.asarray(jmod(jnp.asarray(x)))
    with torch.no_grad():
        got = run(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["ckbd", "elic"])
def test_eval_forward_matches_jax(ckbd, elic, which):
    jm, tm = ckbd if which == "ckbd" else elic
    m = N if which == "ckbd" else M
    x = _images(2, 3)
    graphdef, state = nnx.split(jm)
    jo = jax.jit(lambda st, v: nnx.merge(graphdef, st)(v, training=False))(
        state, jnp.asarray(x))
    with torch.no_grad():
        to = tm(torch.from_numpy(x), training=False)
        y = tm.g_a(torch.from_numpy(x))
    ref_y = np.asarray(jm.g_a(jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=0, atol=ATOL)
    for name, shape in (("y", (2, 4, 4, m)), ("z", (2, 1, 1, N))):
        got = to["likelihoods"][name].numpy()
        ref = np.asarray(jo["likelihoods"][name])
        assert got.shape == ref.shape == shape
        _close_where_large(got, ref)
    np.testing.assert_allclose(to["x_hat"].numpy(), np.asarray(jo["x_hat"]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("which", ["ckbd", "elic"])
def test_training_forward_is_seeded_and_differentiable(ckbd, elic, which):
    _, tm = ckbd if which == "ckbd" else elic
    x = torch.from_numpy(_images(1, 8))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        outs.append(tm(x, training=True, generator=g))
    for name in ("y", "z"):
        assert torch.equal(outs[0]["likelihoods"][name],
                           outs[1]["likelihoods"][name])
    rate = sum(-torch.log2(v).sum() for v in outs[0]["likelihoods"].values())
    (rate / x[0].numel() + F.mse_loss(outs[0]["x_hat"], x)).backward()
    grads = [p.grad for p in tm.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    assert next(tm.g_a.parameters()).grad.abs().sum() > 0
    assert _h_s_grad(tm) > 0
    tm.zero_grad(set_to_none=True)


def test_jax_export_loads_through_torch_convert(ckbd):
    """A JAX Cheng2020AnchorCheckerboard exported as a CompressAI state
    dict (flashgmm_tpu/zoo/torch_export.py) loads into the port with every
    key taken (the GaussianConditional's scale table and tables too: the
    JAX model's are empty before its update(), and so are the port's), and
    the eval forward equals the npz-loaded port's."""
    from flashgmm_tpu.zoo.torch_export import export_torch_state_dict
    from flashgmm_tpu_torch.zoo import load_torch_state_dict

    jm, tm = ckbd
    sd = export_torch_state_dict(jm)
    fresh = TCkbd(N=N, seed=1, device="cpu")
    unused = load_torch_state_dict(fresh, sd)
    assert unused == [], unused
    gc = fresh.latent_codec.latent_codec["y"].latent_codec["y"] \
        .gaussian_conditional
    np.testing.assert_array_equal(
        gc.scale_table.numpy(),
        sd["latent_codec.y.y.gaussian_conditional.scale_table"])
    x = torch.from_numpy(_images(1, 6))
    with torch.no_grad():
        a, b = fresh.eval()(x, training=False), tm(x, training=False)
    assert torch.equal(a["x_hat"], b["x_hat"])
    for name in ("y", "z"):
        assert torch.equal(a["likelihoods"][name], b["likelihoods"][name])

"""The port's video line (ssf2020) against the JAX package's, on the CPU.

Inputs are made with numpy from seeds and fed to both packages. JAX's
ScaleSpaceFlow has no width arguments, so the model-level tests run it at
its full width on 128x128 frames (3 frames, a textured-leaves still panned
by integer offsets), on the shipped weights weights/ssf2020_synthetic.npz
loaded by each package's zoo (JAX's loader counted against the file and
the model, the port's strict).

Held, with the tolerance of each:
- the colour transforms and the 4:2:0 <-> 4:4:4 conversions within 1e-6
  (the chroma upsample at x2 in both of JAX's ``jax.image.resize`` modes,
  edges included, against ``F.interpolate``);
- ``qrelu``: the forward equal, the gradient against ``jax.vjp`` within
  rtol 1e-5 (the surrogate outside [0, 255], the identity inside);
- ``gaussian_blur`` and ``gaussian_volume`` (3 and 5 levels) within 1e-6;
- ``warp_volume`` with flows and a scale field that reach past the border
  on every axis: values within 1e-5, the gradients for the volume, the
  flow and the scale field within 1e-4 (random coordinates: on one lying
  exactly on the first sample of an axis, torch's border clip gives a
  zero gradient and JAX's integer clip a one-sided difference);
- one ``_Hyperprior`` (nnx.Rngs(0)): the eval forward's y_hat within ATOL,
  likelihoods above 1e-6 within RTOL; after ``update``, compress's z
  strings equal to JAX's and at most 1 % of its y symbols flipped;
- the whole model's eval forward: x_hat a frame within ATOL, the
  likelihoods above 1e-6 within RTOL;
- the port's compress/decompress exact: the decoded frames equal the
  encoder's reconstructions, and ``decompress(details=True)``'s and
  ``decompress_y``'s y_hat of each branch the encoder's, bit for bit;
- y and z symbols of every branch of every frame against JAX's compress:
  at most 1 % flipped (the measured share is printed; 0 in the z branches).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu import transforms as j_tf
from flashgmm_tpu.layers.layers import qrelu as j_qrelu
from flashgmm_tpu.models.video import google as j_google
from flashgmm_tpu.zoo import image_models as j_image_models
from flashgmm_tpu.zoo.npz import load_npz_weights
from flashgmm_tpu_torch import transforms as t_tf
from flashgmm_tpu_torch.datasets import textured_leaves
from flashgmm_tpu_torch.layers import qrelu
from flashgmm_tpu_torch.models.video import google as t_google
from flashgmm_tpu_torch.zoo import image_models, load_jax_params
from torch_port_model_pairs import _update_jax, jax_params

torch.set_num_threads(2)

ATOL = 5e-4  # x_hat and y_hat
RTOL = 2e-4  # likelihoods above 1e-6
FLIPS = 0.01
SIDE, N_FRAMES = 128, 3
NPZ = "weights/ssf2020_synthetic.npz"


def _frames(side=SIDE, n=N_FRAMES, seed=500001):
    """A textured-leaves still panned by (2i, 3i) pixels, frame i."""
    big = textured_leaves(side + 16, side + 16, seed=seed)
    return [big[None, 2 * i:2 * i + side, 3 * i:3 * i + side].copy()
            for i in range(n)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# -- transforms --------------------------------------------------------------

def test_colour_transforms_match_jax():
    rgb = _rand(2, 16, 24, 3, seed=1)
    ycc = t_tf.rgb2ycbcr(_t(rgb))
    np.testing.assert_allclose(ycc.numpy(), np.asarray(
        j_tf.rgb2ycbcr(jnp.asarray(rgb))), rtol=0, atol=1e-6)
    back = t_tf.ycbcr2rgb(ycc)
    np.testing.assert_allclose(back.numpy(), np.asarray(
        j_tf.ycbcr2rgb(jnp.asarray(ycc.numpy()))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), rgb, rtol=0, atol=1e-5)
    t_planes = t_tf.yuv_444_to_420(ycc)
    j_planes = j_tf.yuv_444_to_420(jnp.asarray(ycc.numpy()))
    assert [tuple(p.shape) for p in t_planes] == [
        (2, 16, 24, 1), (2, 8, 12, 1), (2, 8, 12, 1)]
    for got, ref in zip(t_planes, j_planes):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    assert repr(t_tf.YUV420To444()) == repr(j_tf.YUV420To444())


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_chroma_upsample_matches_jax_resize(mode):
    """The x2 upsample of 4:2:0 chroma, edges included."""
    planes = tuple(_rand(2, h, w, 1, seed=s)
                   for s, (h, w) in enumerate([(16, 20), (8, 10), (8, 10)]))
    got = t_tf.YUV420To444(mode)(tuple(_t(p) for p in planes))
    ref = j_tf.YUV420To444(mode)(tuple(jnp.asarray(p) for p in planes))
    assert tuple(got.shape) == (2, 16, 20, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    y, u, v = t_tf.yuv_420_to_444(tuple(_t(p) for p in planes), mode,
                                  return_tuple=True)
    assert torch.equal(u[:, :, :, 0], got[..., 1])


def test_qrelu_forward_and_gradient_match_jax():
    x = np.concatenate([_rand(4000, seed=3, lo=-300.0, hi=600.0),
                        np.float32([0.0, 255.0, -1e-3, 255.001, 127.5])])
    g = _rand(x.size, seed=4, lo=-2.0, hi=2.0)
    j_out, vjp = jax.vjp(lambda v: j_qrelu(v), jnp.asarray(x))
    (j_grad,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    out = qrelu(xt)
    (t_grad,) = torch.autograd.grad(out, xt, _t(g))
    assert np.array_equal(out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-5,
                               atol=1e-30)
    inside = (x >= 0) & (x <= 255)
    assert np.array_equal(t_grad.numpy()[inside], g[inside])
    assert np.abs(t_grad.numpy()[~inside]).max() < np.abs(g).max()


# -- the scale-space volume and its warp ---------------------------------------

def test_gaussian_blur_matches_jax():
    x = _rand(2, 32, 40, 3, seed=5)
    got = t_google.gaussian_blur(_t(x), 1.5)
    ref = j_google.gaussian_blur(jnp.asarray(x), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert np.array_equal(t_google.gaussian_kernel1d(11, 1.5).numpy(),
                          np.asarray(j_google.gaussian_kernel1d(11, 1.5)))


@pytest.mark.parametrize("levels", [3, 5])
def test_gaussian_volume_matches_jax(levels):
    x = _rand(2, 64, 48, 3, seed=6)
    got = t_google.ScaleSpaceFlow.gaussian_volume(None, _t(x), 1.5, levels)
    ref = j_google.ScaleSpaceFlow.gaussian_volume(None, jnp.asarray(x), 1.5,
                                                  levels)
    assert tuple(got.shape) == ref.shape == (2, levels + 1, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_warp_volume_matches_jax_past_every_border():
    n, L, h, w, c = 2, 6, 16, 24, 3
    vol = _rand(n, L, h, w, c, seed=7)
    flow = _rand(n, h, w, 2, seed=8, lo=-1.6, hi=1.6)
    scale = _rand(n, h, w, 1, seed=9, lo=-1.6, hi=1.6)
    cot = _rand(n, h, w, c, seed=10, lo=-1.0, hi=1.0)
    # every axis is reached past both of its ends
    assert flow.min() < -1.1 and flow.max() > 1.1
    assert scale.min() < -1.1 and scale.max() > 1.1

    def j_warp(v, f, s):
        return j_google.ScaleSpaceFlow.warp_volume(None, v, f, s)

    j_out, vjp = jax.vjp(j_warp, *(jnp.asarray(a) for a in (vol, flow,
                                                             scale)))
    j_grads = vjp(jnp.asarray(cot))
    args = [_t(a).requires_grad_(True) for a in (vol, flow, scale)]
    out = t_google.ScaleSpaceFlow.warp_volume(None, *args)
    t_grads = torch.autograd.grad(out, args, _t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=1e-5)
    for name, got, ref in zip(("volume", "flow", "scale"), t_grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4, err_msg=name)
    # coordinates past the border read the edge sample
    edge = t_google.ScaleSpaceFlow.warp_volume(
        None, _t(vol), torch.full((n, h, w, 2), -3.0),
        torch.full((n, h, w, 1), 3.0))
    assert torch.allclose(edge, _t(vol)[:, -1, :1, :1].expand(n, h, w, c),
                          atol=1e-6)


# -- one hyperprior ----------------------------------------------------------

def test_hyperprior_matches_jax():
    jh = j_google._Hyperprior(nnx.Rngs(0))
    th = t_google._Hyperprior(torch.Generator().manual_seed(0))
    th.load_state_dict(load_jax_params(jax_params(jh), th), strict=True)
    y = _rand(1, 8, 8, 192, seed=11, lo=-6.0, hi=6.0)
    j_y_hat, j_lk = jh(jnp.asarray(y), training=False)
    with torch.no_grad():
        t_y_hat, t_lk = th(_t(y), training=False)
    np.testing.assert_allclose(t_y_hat.numpy(), np.asarray(j_y_hat), rtol=0,
                               atol=ATOL)
    for name in ("y", "z"):
        ref = np.asarray(j_lk[name])
        mask = ref > 1e-6
        np.testing.assert_allclose(t_lk[name].numpy()[mask], ref[mask],
                                   rtol=RTOL, err_msg=name)

    _update_jax(jh)
    th.update(force=True)
    j_y_hat, j_out = jh.compress(jnp.asarray(y))
    with torch.inference_mode():
        t_y_hat, t_out = th.compress(_t(y))
        assert torch.equal(th.decompress(t_out["strings"], t_out["shape"]),
                           t_y_hat)
    assert t_out["shape"] == tuple(j_out["shape"]) == (1, 1)
    assert t_out["strings"][1] == j_out["strings"][1]
    flips = int((np.abs(t_y_hat.numpy() - np.asarray(j_y_hat)) > 0.5).sum())
    assert flips <= FLIPS * y.size, flips


# -- the whole model on the shipped weights ----------------------------------

@pytest.fixture(scope="module")
def shipped():
    """(JAX model, port model), each from its zoo's shipped weights, both
    after ``update(force=True)`` (the file's quantiles)."""
    jm = j_image_models("ssf2020", 5, pretrained=True)
    with np.load(NPZ) as data:
        n_file = len(data.files)
    assert load_npz_weights(jm, NPZ) == n_file == len(jax_params(jm))
    tm = image_models("ssf2020", 5, pretrained=True, device="cpu").eval()
    assert len(tm.state_dict()) == n_file
    for name, value in tm.state_dict().items():
        assert value.dtype == torch.float32, name
    _update_jax(jm)
    tm.update(force=True)
    return jm, tm


def test_eval_forward_matches_jax(shipped):
    jm, tm = shipped
    frames = _frames()
    jo = jm([jnp.asarray(f) for f in frames], training=False)
    with torch.no_grad():
        to = tm([_t(f) for f in frames], training=False)
    assert len(to["x_hat"]) == len(jo["x_hat"]) == N_FRAMES
    for i, (got, ref) in enumerate(zip(to["x_hat"], jo["x_hat"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL, err_msg=f"frame {i}")
    for i, (t_lk, j_lk) in enumerate(zip(to["likelihoods"],
                                         jo["likelihoods"])):
        assert set(t_lk) == set(j_lk)
        for branch in t_lk:
            for name in ("y", "z"):
                ref = np.asarray(j_lk[branch][name])
                got = t_lk[branch][name].numpy()
                assert got.shape == ref.shape
                mask = ref > 1e-6
                np.testing.assert_allclose(
                    got[mask], ref[mask], rtol=RTOL,
                    err_msg=f"frame {i} {branch} {name}")


@pytest.fixture(scope="module")
def coded(shipped):
    _, tm = shipped
    frames = [_t(f) for f in _frames()]
    strings, shapes, details = tm.compress(frames, details=True)
    return frames, strings, shapes, details


def test_port_round_trip_is_exact(shipped, coded):
    _, tm = shipped
    _, strings, shapes, details = coded
    assert shapes[0] == (1, 1)
    assert shapes[1] == {"motion": (1, 1), "residual": (1, 1)}
    dec, dec_details = tm.decompress(strings, shapes, details=True)
    assert len(dec) == N_FRAMES
    for i, (got, ref) in enumerate(zip(dec, details["x_hat"])):
        assert got.shape == (1, SIDE, SIDE, 3)
        assert torch.equal(got, ref), f"frame {i}"
    for y_hats in (dec_details["y_hat"], tm.decompress_y(strings, shapes)):
        for i, (got, ref) in enumerate(zip(y_hats, details["y_hat"])):
            assert set(got) == set(ref)
            for branch in got:
                assert torch.equal(got[branch], ref[branch]), (i, branch)


def test_symbols_match_jax_compress(shipped, coded, monkeypatch):
    jm, tm = shipped
    frames, strings, shapes, details = coded
    recorded = []
    compress = j_google._Hyperprior.compress

    def recording(self, y):
        y_hat, out = compress(self, y)
        z_hat = self.entropy_bottleneck.decompress(out["strings"][1],
                                                   out["shape"])
        recorded.append((np.asarray(y_hat), np.asarray(z_hat)))
        return y_hat, out

    monkeypatch.setattr(j_google._Hyperprior, "compress", recording)
    j_strings, j_shapes = jm.compress([jnp.asarray(f.numpy())
                                       for f in frames])
    assert len(j_strings) == N_FRAMES and len(recorded) == 2 * N_FRAMES - 1

    # the port's, in the same order: keyframe, then motion and residual
    t_branches = [(0, "keyframe")] + [(i, b) for i in range(1, N_FRAMES)
                                      for b in ("motion", "residual")]
    hps = {"keyframe": tm.img_hyperprior, "motion": tm.motion_hyperprior,
           "residual": tm.res_hyperprior}
    rates = []
    for (i, branch), (j_y, j_z) in zip(t_branches, recorded):
        s = strings[i] if branch == "keyframe" else strings[i][branch]
        shape = shapes[i] if branch == "keyframe" else shapes[i][branch]
        with torch.inference_mode():
            t_z = hps[branch].entropy_bottleneck.decompress(s[1], shape)
        t_y = details["y_hat"][i][branch]
        for name, got, ref in (("y", t_y.numpy(), j_y),
                               ("z", t_z.numpy(), j_z)):
            assert got.shape == ref.shape, (i, branch, name)
            flips = int((np.abs(got - ref) > 0.5).sum())
            rates.append(f"frame {i} {branch} {name}: {flips}/{got.size}")
            assert flips <= FLIPS * got.size, rates[-1]
    print("symbol flips against JAX: " + "; ".join(rates))

"""The port's reference-format coding against the JAX package's, on the CPU.

- Device rows: the port's plain ``gmm_boundary_rows`` equals JAX's
  ``gmm_boundary_rows`` (flashgmm_tpu/ans/gaussian_cdf.py:71) bit for bit in
  modes 0-2, on the golden files' pass parameters and on seeded edge cases
  (scales at 0.11 and 256, far-out means, weights near 0 and 1, K = 1, 2,
  4); its mixture sum (a0 * b0, then an FMA a term) and XLA's saturating
  float -> uint16 convert are what JAX's CPU code computes.
- Streams cross packages: given the same parameters, the port's
  GaussianMixtureConditional writes the JAX package's bytes in device-rows
  mode and each decodes the other's.
- The mixture weights: the coding softmax's plain version equals JAX's
  ``jax.nn.softmax`` on the CPU bit for bit (0 ulps apart on every
  entry); ``torch.softmax`` is held within one ulp of it.
- The GaussianConditional's tables: the scale table, XLA's erfc and the
  ndtri of the tail mass, and the integer tables equal JAX's ``update()``
  exactly; a JAX export's tables load through ``zoo/torch_convert.py``
  equal to the port's own.
- The port's own round trips at small widths: the flagship and ELIC in both
  modes (device rows, host math), the single-Gaussian checkerboard and
  ELIC's single-Gaussian model on the table path; batch 2 refused as JAX
  refuses it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.ans.gaussian_cdf import gmm_boundary_rows as j_rows
from flashgmm_tpu.entropy_models import GaussianConditional as JGC
from flashgmm_tpu.entropy_models import GaussianMixtureConditional as JGMM
from flashgmm_tpu.latent_codecs import \
    GaussianMixtureConditionalLatentCodec as JGmmCodec
from flashgmm_tpu.models.base import get_scale_table as j_scale_table
from flashgmm_tpu_torch.ans.gaussian_cdf import (gmm_boundary_rows,
                                                 gmm_boundary_rows_plain,
                                                 gmm_softmax,
                                                 gmm_softmax_plain)
from flashgmm_tpu_torch.entropy_models import GaussianConditional as TGC
from flashgmm_tpu_torch.entropy_models import GaussianMixtureConditional as TGMM
from flashgmm_tpu_torch.entropy_models import xla_math
from flashgmm_tpu_torch.latent_codecs import \
    GaussianMixtureConditionalLatentCodec as TGmmCodec
from flashgmm_tpu_torch.models.base import get_scale_table

torch.set_num_threads(1)

DIR = os.path.join(os.path.dirname(__file__), "expected", "reference")


def nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def _golden(arch):
    path = os.path.join(DIR, f"model_interop_{arch}.npz")
    if not os.path.exists(path):
        pytest.skip(f"{arch} model interop goldens not recorded")
    return np.load(path)


def _pass_case(arch, i):
    """A golden pass's y and [1, H, W, K*M] parameters, NHWC float32."""
    g = _golden(arch)
    return [nhwc(g[f"pass{i}/{n}"]) for n in ("y", "scales", "means",
                                              "weights")]


@pytest.fixture
def mode(request, monkeypatch):
    monkeypatch.setenv("APPROX_MODE", str(request.param))
    monkeypatch.delenv("FLASHGMM_HOST_MATH", raising=False)
    return request.param


# -- device rows ---------------------------------------------------------------


def _edge_params(n, k, seed):
    rs = np.random.RandomState(seed)
    s = np.exp(rs.uniform(np.log(0.11), np.log(256), (n, k)))
    s[: n // 8], s[n // 8: n // 4] = 0.11, 256.0
    m = rs.normal(0, 20, (n, k))
    m[n // 4: n // 4 + 16] = 3e4
    m[n // 4 + 16: n // 4 + 32] = -3e4
    logits = rs.normal(0, 3, (n, k))
    logits[n // 2: n // 2 + 32, 0] = 60.0  # weights near 1 and near 0
    logits[n // 2 + 32: n // 2 + 64, 0] = -60.0
    w = gmm_softmax_plain(torch.from_numpy(logits.T[None].astype(np.float32)))
    return (s.astype(np.float32), m.astype(np.float32),
            np.ascontiguousarray(w[0].numpy().T))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_boundary_rows_equal_jax_on_edge_cases(mode, k):
    s, m, w = _edge_params(1000, k, seed=k + 10 * mode)
    for lo, num_bins in ((-8, 17), (-48, 97)):
        ref = np.asarray(j_rows(jnp.asarray(s), jnp.asarray(m),
                                jnp.asarray(w), jnp.int32(lo),
                                num_bins=num_bins, mode=mode))
        got = gmm_boundary_rows(*map(torch.from_numpy, (s, m, w)), lo,
                                num_bins, mode)
        assert got.dtype == torch.uint16
        assert np.array_equal(got.numpy(), ref), (lo, int(
            (got.numpy() != ref).sum()))


def test_boundary_rows_saturate_as_xla_converts():
    """XLA's float -> uint16 convert saturates (NaN -> 0): weights that sum
    above 1 and negative weights give rows at 65535 and 0."""
    s = np.full((4, 2), 1.0, np.float32)
    m = np.zeros((4, 2), np.float32)
    w = np.array([[0.7, 0.7], [-0.5, -0.5], [np.nan, 0.5], [2.0, -3.0]],
                 np.float32)
    for md in (0, 1, 2):
        ref = np.asarray(j_rows(*map(jnp.asarray, (s, m, w)), jnp.int32(-4),
                                num_bins=9, mode=md))
        got = gmm_boundary_rows_plain(*map(torch.from_numpy, (s, m, w)), -4,
                                      9, md).numpy()
        assert np.array_equal(got, ref), md
        assert got.max() == 65535 and got.min() == 0


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("arch,i", [("ckbd", 0), ("ckbd", 1), ("elic", 6)])
def test_boundary_rows_equal_jax_on_golden_pass_parameters(arch, i, mode):
    """The rows the GMM conditional codes with, from a golden pass's
    parameters reshaped as the coder takes them."""
    y, scales, means, weights = _pass_case(arch, i)
    tg = TGMM(K=4)
    zb = (np.abs(np.round(y)).sum(axis=(0, 1, 2)) != 0)
    params = tg._reshape_entropy_parameters(
        *map(torch.from_numpy, (scales, means, weights)), np.nonzero(zb)[0])
    max_bs = tg._round_max_bs(int(np.abs(y).max()) + 1)
    ref = np.asarray(j_rows(*(jnp.asarray(p.numpy()) for p in params),
                            jnp.int32(-max_bs), num_bins=2 * max_bs + 1,
                            mode=mode))
    got = gmm_boundary_rows(*params, -max_bs, 2 * max_bs + 1, mode)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", [0, 1, 2], indirect=True)
@pytest.mark.parametrize("arch,i", [("ckbd", 1), ("elic", 3)])
def test_streams_cross_packages_in_device_rows_mode(arch, i, mode):
    """The same pass coded by both packages: identical containers, and
    each decodes the other's string to the same y_hat."""
    y, scales, means, weights = _pass_case(arch, i)
    jg, tg = JGMM(K=4), TGMM(K=4)
    (j_str, j_max, j_zb), j_y = jg.compress(
        *map(jnp.asarray, (y, scales, means, weights)))
    (t_str, t_max, t_zb), t_y = tg.compress(
        *map(torch.from_numpy, (y, scales, means, weights)))
    assert t_str == j_str and t_max == j_max
    assert np.array_equal(t_zb.numpy(), np.asarray(j_zb))
    assert np.array_equal(t_y.numpy(), np.asarray(j_y))
    t_params = [torch.from_numpy(p) for p in (scales, means, weights)]
    j_params = [jnp.asarray(p) for p in (scales, means, weights)]
    got = tg.decompress(j_str, j_max, torch.from_numpy(np.asarray(j_zb)),
                        *t_params)
    assert np.array_equal(got.numpy(), np.asarray(j_y))
    ref = jg.decompress(t_str, t_max, jnp.asarray(t_zb.numpy()), *j_params)
    assert np.array_equal(np.asarray(ref), t_y.numpy())


# -- the mixture weights -------------------------------------------------------


@pytest.mark.parametrize("k,shape", [(4, (1, 8, 6, 32)), (4, (2, 48, 16, 7)),
                                     (1, (1, 5, 7, 13)), (3, (1, 9, 4, 11))])
def test_coding_softmax_equals_jax(k, shape):
    """The coding paths' softmax (its plain version on the CPU) against
    the JAX codec's on the same logits: bit for bit."""
    rs = np.random.RandomState(k)
    logits = (rs.normal(0, 3, shape[:3] + (k * shape[3],))).astype(np.float32)
    ref = np.asarray(JGmmCodec(K=k)._reshape_gmm_weight(jnp.asarray(logits)))
    tc = TGmmCodec(K=k)
    got = tc._reshape_gmm_weight(torch.from_numpy(logits), exact=True).numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    b, h, w = shape[:3]
    torch_sm = tc._reshape_gmm_weight(torch.from_numpy(logits)).numpy()
    assert np.abs(torch_sm - ref).max() <= 2.0 ** -23  # torch.softmax's ulp
    assert torch.equal(gmm_softmax(torch.from_numpy(logits).reshape(
        b, h, w, k, -1)).reshape(logits.shape), torch.from_numpy(got))


def test_golden_weights_from_their_logits_equal_jax():
    """The golden ELIC pass's weights re-derived: the port's coding softmax
    of JAX-side logits (the log of the file's weights) equals JAX's."""
    _, _, _, weights = _pass_case("elic", 0)
    logits = np.log(np.maximum(weights, 1e-30)).astype(np.float32)
    ref = np.asarray(JGmmCodec(K=4)._reshape_gmm_weight(jnp.asarray(logits)))
    got = TGmmCodec(K=4)._reshape_gmm_weight(torch.from_numpy(logits),
                                             exact=True).numpy()
    assert np.array_equal(got, ref)


# -- the GaussianConditional's tables ----------------------------------------


def test_scale_table_equals_jax():
    for args in ((), (0.5, 100.0, 37), (0.01, 10.0, 200)):
        assert get_scale_table(*args) == j_scale_table(*args)


def test_erfc_and_ndtri_equal_xla():
    import jax

    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-12, 12, 20000), rs.uniform(-2.5, 2.5,
                                                                20000),
                        [0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 30.0, -30.0]]
                       ).astype(np.float32)
    ref = np.asarray(jax.scipy.special.erfc(jnp.asarray(x)))
    got = xla_math.erfc(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    for p in np.concatenate([[5e-10, 0.5, 0.9], 10 ** rs.uniform(-30, 0, 40),
                             rs.uniform(0, 1, 40)]).astype(np.float32):
        assert np.float32(xla_math.ndtri(torch.tensor(float(p)))) == \
            np.float32(jax.scipy.special.ndtri(float(p))), p


@pytest.fixture(scope="module")
def jax_gc():
    """The JAX package's GaussianConditional over the default scale table,
    after update() (its PMF quantizer is a Python loop: done once)."""
    jg = JGC(j_scale_table())
    jg.update()
    return jg


@pytest.mark.parametrize("tail_mass", [1e-9, 1e-6])
def test_gaussian_conditional_tables_equal_jax(jax_gc, tail_mass):
    if tail_mass == 1e-9:
        jg = jax_gc
    else:
        jg = JGC(j_scale_table(), tail_mass=tail_mass)
        jg.update()
    tg = TGC(get_scale_table(), tail_mass=tail_mass)
    tg.update()
    for name in ("quantized_cdf", "offset", "cdf_length"):
        assert np.array_equal(getattr(tg, name).numpy(),
                              np.asarray(getattr(jg, name))), name
    assert np.array_equal(tg.scale_table.numpy(), np.asarray(jg.scale_table))
    scales = torch.from_numpy(np.exp(np.random.RandomState(1).uniform(
        -4, 6, (2, 5, 7, 3))).astype(np.float32))
    assert np.array_equal(tg.build_indexes(scales).numpy(), np.asarray(
        jg.build_indexes(jnp.asarray(scales.numpy()))))


def test_jax_export_tables_load_equal_to_update(jax_gc):
    """A JAX Cheng2020AnchorCheckerboard exported as a CompressAI state dict
    with its GaussianConditional's scale table and tables (JAX's update()
    of that conditional) loads into the port with those tables, equal to
    what the port's own update() computes."""
    from flashgmm_tpu.models.sensetime import Cheng2020AnchorCheckerboard as J
    from flashgmm_tpu.zoo.torch_export import export_torch_state_dict
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboard as T
    from flashgmm_tpu_torch.zoo import load_torch_state_dict

    sd = export_torch_state_dict(J(N=16, rngs=nnx.Rngs(0)))
    prefix = "latent_codec.y.y.gaussian_conditional."
    for name in ("scale_table", "_quantized_cdf", "_offset", "_cdf_length"):
        assert prefix + name in sd
        sd[prefix + name] = np.asarray(getattr(jax_gc, name.lstrip("_")))
    loaded = T(N=16, seed=1, device="cpu")
    assert load_torch_state_dict(loaded, sd) == []
    own = T(N=16, seed=2, device="cpu")
    own.update()
    gcs = [[m for m in model.modules() if isinstance(m, TGC)]
           for model in (loaded, own)]
    assert len(gcs[0]) == 1
    for a, b in zip(*gcs):
        for name in ("quantized_cdf", "offset", "cdf_length", "scale_table"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_fma_takes_the_exact_path_where_it_must():
    """``xla_math._fma`` on the CPU rounds the float64 sum once and takes
    the round-to-odd path only for elements on a float32 tie or outside the
    normal range: its bits equal the round-to-odd path's everywhere, on
    random triples, on sums crafted onto ties, near overflow and among
    subnormals."""
    rs = np.random.RandomState(7)
    n = 100000
    for lo, hi in ((-30, 30), (-140, -100), (100, 128), (-5, 5)):
        a = (rs.normal(0, 1, n) * 2.0 ** rs.randint(lo, hi, n)).astype(
            np.float32)
        b = (rs.normal(0, 1, n) * 2.0 ** rs.randint(-3, 3, n)).astype(
            np.float32)
        c = (rs.normal(0, 1, n) * 2.0 ** rs.randint(lo, hi, n)).astype(
            np.float32)
        for a_, c_ in ((a, c), (np.round(a * 4) / 4, np.round(c)
                                + np.float32(2.0 ** -25)
                                * rs.choice([1, -1, 3], n))):
            ta, tb, tc = (torch.from_numpy(np.ascontiguousarray(
                v, dtype=np.float32)) for v in (a_, b, c_))
            p = ta.double() * tb
            ref = xla_math._fma_round_to_odd(p, tc, p + tc)
            got = xla_math._fma(ta, tb, tc)
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_pmf_quantizer_equals_jax_on_random_pmfs():
    """The port's PMF quantizer (its steal search vectorised) against the
    JAX package's loop on PMFs with many zero-width bins."""
    from flashgmm_tpu.ans.pmf_to_cdf import pmf_to_quantized_cdf as j_pmf
    from flashgmm_tpu_torch.ans.pmf_to_cdf import pmf_to_quantized_cdf

    rs = np.random.RandomState(0)
    for _ in range(100):
        n = rs.randint(2, 300)
        pmf = rs.exponential(1, n) ** rs.uniform(1, 8)
        pmf[rs.rand(n) < rs.uniform(0, 0.9)] = 0
        pmf[0] += pmf.sum() == 0
        pmf = (pmf / pmf.sum()).astype(np.float32)
        tail = np.full(rs.randint(0, 40), 1e-9, np.float32)
        pmf = np.concatenate([pmf, tail])
        assert np.array_equal(pmf_to_quantized_cdf(pmf, 16), j_pmf(pmf, 16))


# -- refusals and the port's own round trips --------------------------------


def test_batch_of_two_refused():
    y, scales, means, weights = (np.concatenate([a, a]) for a in
                                 _pass_case("ckbd", 0))
    tg = TGMM(K=4)
    params = [torch.from_numpy(p) for p in (scales, means, weights)]
    with pytest.raises(ValueError, match="ONE image"):
        tg.compress(torch.from_numpy(y), *params)
    with pytest.raises(ValueError, match="ONE image"):
        tg.decompress(b"\0" * 8, 3, torch.ones(y.shape[-1], dtype=torch.int32),
                      *params)
    with pytest.raises(ValueError, match="ONE image"):
        JGMM(K=4).compress(*map(jnp.asarray, (y, scales, means, weights)))
    with pytest.raises(NotImplementedError, match="item 15"):
        TGMM(K=4, entropy_coder="rangecoder")


def _image(h, w, seed=500001):
    from flashgmm_tpu_torch.datasets import textured_leaves

    return torch.from_numpy(textured_leaves(h, w, seed=seed)[None])


def _roundtrip(model, x):
    out = model.compress(x)
    y_hat = model.latent_codec.decompress(out["strings"], out["shape"])["y_hat"]
    assert torch.equal(y_hat, out["y_hat"])
    x_hat = model.decompress(out["strings"], out["shape"])["x_hat"]
    assert x_hat.shape == x.shape and bool(torch.isfinite(x_hat).all())
    assert 0.0 <= float(x_hat.min()) and float(x_hat.max()) <= 1.0
    return out


@pytest.fixture(scope="module")
def gmm_models():
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboardGMMv2,
                                           Elic2022GMM)

    models = {"ckbd": Cheng2020AnchorCheckerboardGMMv2(N=32, K=4,
                                                        device="cpu"),
              "elic": Elic2022GMM(N=32, M=64, K=4, groups=[8, 8, 16, 16, 16],
                                  device="cpu")}
    for m in models.values():
        m.update(update_quantiles=True)
    return models


@pytest.mark.parametrize("host_math", ["0", "1"])
@pytest.mark.parametrize("arch", ["ckbd", "elic"])
def test_gmm_models_roundtrip_in_both_modes(gmm_models, arch, host_math,
                                            monkeypatch):
    monkeypatch.setenv("FLASHGMM_HOST_MATH", host_math)
    out = _roundtrip(gmm_models[arch], _image(64, 64))
    *y_strings, z_strings = out["strings"]
    assert len(y_strings) == (2 if arch == "ckbd" else 10)
    assert len(z_strings) == 1
    for string, abs_max, zero_bitmap in y_strings:
        assert isinstance(string, bytes) and abs_max >= 1
        assert zero_bitmap.dtype == torch.int32


def test_weighted_mean_ste_codec_roundtrip():
    """The "weighted_mean_ste" quantizer: symbols round(y - weighted mean);
    compress's y_hat is those integers and decompress adds the weighted
    mean back, as in the JAX package."""
    rs = np.random.RandomState(3)
    y = torch.from_numpy(rs.normal(0, 4, (1, 6, 5, 8)).astype(np.float32))
    ctx = torch.from_numpy(rs.normal(0, 1, (1, 6, 5, 3 * 4 * 8)).astype(
        np.float32))
    tc = TGmmCodec(K=4, quantizer="weighted_mean_ste")
    out = tc.compress(y, ctx)
    dec = tc.decompress(out["strings"], out["shape"], ctx)["y_hat"]
    _, means, weights = tc._coding_params(ctx)
    ws, _ = tc._weighted_mean_recenter(means, weights)
    assert torch.equal(out["y_hat"], torch.round(y - ws))
    assert torch.equal(dec, out["y_hat"] + ws)


@pytest.mark.parametrize("which", ["ckbd", "elic"])
def test_single_gaussian_models_roundtrip_on_the_table_path(which):
    """Cheng2020AnchorCheckerboard and Elic2022Official through their
    GaussianConditionals' tables (reference :169-224)."""
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboard,
                                           Elic2022Official)

    model = Cheng2020AnchorCheckerboard(N=32, device="cpu") if which == "ckbd" \
        else Elic2022Official(N=32, M=64, groups=[8, 8, 16, 16, 16],
                              device="cpu")
    model.update(update_quantiles=True)
    out = _roundtrip(model, _image(64, 64))
    assert len(out["strings"]) == (3 if which == "ckbd" else 11)

"""The port's variable-bitrate pieces against the JAX package's, on the CPU:
the variable-step EntropyBottleneck, GaussianConditionalVbr, the gain
codecs and the raster scan's gain-scaled branch (mbt2018-vbr's). The models
are in test_torch_port_vbr_models.py, the train step in
test_torch_port_vbr_train.py.

Held:
- ``EntropyBottleneckVbr`` on JAX's parameters (perturbed from their
  initialisation with a seeded numpy draw), for qs in {0.5, 0.73, 1.0, 1.7}
  as float32 values: ``update_variable``'s three tables equal JAX's
  exactly, ``compress(qs=)``'s strings JAX's byte for byte, ``decompress``
  JAX's values exactly, and the eval forward's likelihoods at that step
  within rtol 2e-4;
- ``GaussianConditionalVbr``'s quantize_variable and dequantize_variable on
  the arrays of tests/test_vbr_video_pcc.py: equal to JAX's;
- the gain codecs, JAX's test_gain_hyperprior_roundtrip setup
  (tests/test_misc_components.py) in both packages: the z strings equal,
  the port's decompress gives its compress's y_hat exactly;
- the raster scan with ``vbr=``: given the same y, params and weights as
  numpy arrays, the port's encoder gives JAX's string byte for byte and
  JAX's decoder's y_hat exactly, and decodes JAX's string to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.entropy_models import EntropyBottleneck as JEB
from flashgmm_tpu.entropy_models import EntropyBottleneckVbr as JEBVbr
from flashgmm_tpu.entropy_models import GaussianConditionalVbr as JGCVbr
from flashgmm_tpu.latent_codecs import (GainHyperLatentCodec as JGainHyper,
                                        GainHyperpriorLatentCodec as JGainHP,
                                        GaussianConditionalLatentCodec as JGCLC)
from flashgmm_tpu.layers import conv as j_conv
from flashgmm_tpu.runtime import rasterscan as j_raster
from flashgmm_tpu_torch.entropy_models import (EntropyBottleneck,
                                               EntropyBottleneckVbr,
                                               GaussianConditionalVbr)
from flashgmm_tpu_torch.latent_codecs import (GainHyperLatentCodec,
                                              GainHyperpriorLatentCodec,
                                              GaussianConditionalLatentCodec)
from flashgmm_tpu_torch.layers import conv
from flashgmm_tpu_torch.models.base import get_scale_table
from flashgmm_tpu_torch.runtime import rasterscan
from flashgmm_tpu_torch.zoo import load_jax_params
from torch_port_model_pairs import _update_jax, jax_params, vbr_pair

torch.set_num_threads(2)

C = 8
QS = [0.5, 0.73, 1.0, 1.7]


def _perturbed_pair(seed=0):
    """(JAX EntropyBottleneckVbr, the port's on its parameters): JAX's
    initial parameters plus seeded noise, so the tables see a trained-like
    density, and quantiles spread around it."""
    jeb = JEBVbr(C, rngs=nnx.Rngs(0))
    rs = np.random.RandomState(seed)
    for name, v in nnx.to_flat_state(nnx.state(jeb, nnx.Param)):
        arr = np.asarray(v.get_value())
        if name[-1] == "quantiles":
            new = np.sort(rs.uniform(-12, 12, arr.shape), axis=-1)
        else:
            new = arr + rs.normal(0, 0.3, arr.shape)
        v.set_value(jnp.asarray(new.astype(np.float32)))
    teb = EntropyBottleneckVbr(C)
    teb.load_state_dict(load_jax_params(jax_params(jeb), teb), strict=True)
    return jeb, teb


@pytest.fixture(scope="module")
def eb_pair():
    return _perturbed_pair()


def _x(shape=(1, 8, 8, C), seed=1):
    return np.random.RandomState(seed).normal(0, 4, shape).astype(np.float32)


@pytest.mark.parametrize("qs", QS)
def test_eb_vbr_tables_strings_and_values_equal_jax(eb_pair, qs):
    jeb, teb = eb_pair
    qs = float(np.float32(qs))
    assert jeb.update_variable(force=True, qs=qs)
    assert teb.update_variable(force=True, qs=qs)
    for name in ("_quantized_cdf", "_offset", "_cdf_length"):
        np.testing.assert_array_equal(getattr(teb, name).numpy(),
                                      np.asarray(getattr(jeb, name).value),
                                      err_msg=name)
    x = _x()
    j_strings = jeb.compress(jnp.asarray(x), qs=qs)
    t_strings = teb.compress(torch.from_numpy(x), qs=qs)
    assert t_strings == j_strings
    t_hat = teb.decompress(t_strings, (8, 8), qs=qs)
    np.testing.assert_array_equal(
        t_hat.numpy(), np.asarray(jeb.decompress(j_strings, (8, 8), qs=qs)))
    medians = teb.quantiles.detach()[:, 0, 1]
    expected = torch.round((torch.from_numpy(x) - medians) / qs) * qs + medians
    torch.testing.assert_close(t_hat, expected, rtol=0, atol=1e-5)

    j_out, j_lik = jeb(jnp.asarray(x), training=False, qs=jnp.float32(qs))
    with torch.no_grad():
        t_out, t_lik = teb(torch.from_numpy(x), training=False,
                           qs=torch.tensor(qs))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)
    ref = np.asarray(j_lik)
    mask = ref > 1e-6
    assert mask.mean() > 0.5
    np.testing.assert_allclose(t_lik.numpy()[mask], ref[mask], rtol=2e-4)


def test_eb_vbr_without_a_step_is_the_bottleneck(eb_pair):
    """qs=None: the unit-step EntropyBottleneck's tables, strings and
    values."""
    jeb, teb = eb_pair
    jeb.update(force=True)
    teb.update(force=True)
    base = EntropyBottleneck(C)
    base.load_state_dict(teb.state_dict(), strict=True)
    base.update(force=True)
    x = _x(seed=2)
    strings = teb.compress(torch.from_numpy(x))
    assert strings == base.compress(torch.from_numpy(x)) \
        == jeb.compress(jnp.asarray(x))
    assert torch.equal(teb.decompress(strings, (8, 8)),
                       base.decompress(strings, (8, 8)))
    assert isinstance(JEBVbr(C, rngs=nnx.Rngs(0)), JEB)


def test_gaussian_conditional_vbr_quantize_variable_equals_jax():
    jgc, tgc = JGCVbr(None), GaussianConditionalVbr(None)
    rng = np.random.RandomState(0)
    x = rng.normal(0, 3, (2, 8, 8, 4)).astype(np.float32)
    means = rng.normal(0, 1, x.shape).astype(np.float32)
    xj, mj = jnp.asarray(x), jnp.asarray(means)
    xt, mt = torch.from_numpy(x), torch.from_numpy(means)
    for qs in (0.5, 1.0, 2.0):
        sym_j = jgc.quantize_variable(xj, "symbols", mj, qs=qs)
        sym_t = tgc.quantize_variable(xt, "symbols", mt, qs=qs)
        assert sym_t.dtype == torch.int32
        np.testing.assert_array_equal(sym_t.numpy(), np.asarray(sym_j))
        np.testing.assert_array_equal(
            tgc.dequantize_variable(sym_t, mt, qs=qs).numpy(),
            np.asarray(jgc.dequantize_variable(sym_j, mj, qs=qs)))
        np.testing.assert_array_equal(
            tgc.quantize_variable(xt, "dequantize", mt, qs=qs).numpy(),
            np.asarray(jgc.quantize_variable(xj, "dequantize", mj, qs=qs)))
    np.testing.assert_array_equal(
        tgc.quantize_variable(xt, "dequantize", mt).numpy(),
        np.asarray(jgc.quantize_variable(xj, "dequantize", mj)))
    with pytest.raises(ValueError):
        tgc.quantize_variable(xt, "ste", mt, qs=0.5)


def test_gain_hyperprior_roundtrip_matches_jax():
    """JAX's test_gain_hyperprior_roundtrip in both packages."""
    rngs = nnx.Rngs(0)
    jlc = JGainHP(latent_codec={
        "y": JGCLC(quantizer="ste"),
        "hyper": JGainHyper(
            entropy_bottleneck=JEB(C, rngs=rngs),
            h_a=j_conv(C, C, kernel_size=3, stride=1, rngs=rngs),
            h_s=j_conv(C, 2 * C, kernel_size=3, stride=1, rngs=rngs)),
    })
    tlc = GainHyperpriorLatentCodec(latent_codec={
        "y": GaussianConditionalLatentCodec(quantizer="ste"),
        "hyper": GainHyperLatentCodec(
            entropy_bottleneck=EntropyBottleneck(C),
            h_a=conv(C, C, kernel_size=3, stride=1),
            h_s=conv(C, 2 * C, kernel_size=3, stride=1)),
    })
    # JAX's tables: the default scale table's (built once a process) and
    # the bottleneck's after its quantiles' update, whose quantiles the port
    # takes with the other parameters
    _update_jax(vbr_pair("mbt2018-vbr")[0])
    from torch_port_model_pairs import _GC_TABLES
    jgc = jlc.latent_codec["y"].gaussian_conditional
    for name, value in _GC_TABLES.items():
        getattr(jgc, name).value = value
    jlc.latent_codec["hyper"].entropy_bottleneck.update(update_quantiles=True)
    tlc.load_state_dict(load_jax_params(jax_params(jlc), tlc), strict=True)
    tlc.latent_codec["y"].gaussian_conditional.update_scale_table(
        get_scale_table())
    tlc.latent_codec["hyper"].entropy_bottleneck.update(force=True)

    y = np.random.RandomState(0).randn(1, 8, 8, C).astype(np.float32)
    gains = [np.ones(C, np.float32) * g for g in (2.0, 1.0, 0.5, 1.0)]
    j_c = jlc.compress(jnp.asarray(y), *map(jnp.asarray, gains))
    t_gains = [torch.from_numpy(g) for g in gains]
    yt = torch.from_numpy(y)
    with torch.no_grad():
        out = tlc(yt, *t_gains, training=False)
        t_c = tlc.compress(yt, *t_gains)
        d = tlc.decompress(t_c["strings"], t_c["shape"], t_gains[2],
                           t_gains[3])
    assert out["y_hat"].shape == yt.shape
    assert t_c["strings"][-1] == j_c["strings"][-1]
    assert torch.equal(d["y_hat"], t_c["y_hat"])
    np.testing.assert_allclose(t_c["y_hat"].numpy(), np.asarray(j_c["y_hat"]),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("s", [0, 7])
def test_vbr_raster_scan_equals_jax(s):
    """mbt2018-vbr's host pieces and vbr dict from each package, on the
    same numpy y and params: the same string, JAX's decoder's y_hat; the
    port's ctx_scl equals JAX's bit for bit."""
    jm, tm = vbr_pair("mbt2018-vbr")
    _update_jax(jm)
    tm.update(force=True)
    j_vbr = jm._vbr_host_args(jm._get_scale(s, 0))
    t_vbr = tm._vbr_host_args(tm._get_scale(s))
    assert t_vbr["scale"] == j_vbr["scale"]
    assert t_vbr["rescale"] == j_vbr["rescale"]
    assert t_vbr["scale_bound"] == j_vbr["scale_bound"]
    assert t_vbr["ctx_scl"].dtype == np.float32
    np.testing.assert_array_equal(t_vbr["ctx_scl"], j_vbr["ctx_scl"])
    rs = np.random.RandomState(40 + s)
    y = rs.normal(0, 3, (4, 4, tm.M)).astype(np.float32)
    params = rs.normal(0, 1, (4, 4, 2 * tm.M)).astype(np.float32)
    j_pieces = jm._host_ar_pieces()
    t_pieces = tm._host_ar_pieces()
    j_string = j_raster.raster_scan_compress_single_stream(
        y, params, *j_pieces, vbr=j_vbr)
    t_string, t_y_hat = rasterscan.raster_scan_encode(y, params, *t_pieces,
                                                      vbr=t_vbr)
    assert t_string == j_string
    assert rasterscan.raster_scan_compress_single_stream(
        y, params, *t_pieces, vbr=t_vbr) == j_string
    j_y_hat = j_raster.raster_scan_decompress_single_stream(
        j_string, params, *j_pieces, (4, 4, tm.M), vbr=j_vbr)
    np.testing.assert_array_equal(t_y_hat, j_y_hat)
    np.testing.assert_array_equal(
        rasterscan.raster_scan_decompress_single_stream(
            j_string, params, *t_pieces, (4, 4, tm.M), vbr=t_vbr), j_y_hat)
    # without offsets: the plain gain-scaled reconstruction
    t_vbr["offset_fn"] = j_vbr["offset_fn"] = None
    j_string = j_raster.raster_scan_compress_single_stream(
        y, params, *j_pieces, vbr=j_vbr)
    t_string, t_y_hat = rasterscan.raster_scan_encode(y, params, *t_pieces,
                                                      vbr=t_vbr)
    assert t_string == j_string
    np.testing.assert_array_equal(
        t_y_hat, j_raster.raster_scan_decompress_single_stream(
            j_string, params, *j_pieces, (4, 4, tm.M), vbr=j_vbr))

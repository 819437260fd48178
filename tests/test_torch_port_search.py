"""The single-Gaussian search coder and the host raster scan of the port
against the JAX package's, on the CPU.

- Rows: ``gaussian_boundary_rows_plain`` (the boundary-rows kernel's plain
  version at K = 1, mean 0, weight 1) equals JAX's
  ``gaussian_boundary_rows`` (flashgmm_tpu/ans/gaussian_cdf.py:170) bit for
  bit in modes 0-2, over scales in [0.11, 256] (the lower bound itself,
  powers of two, random) with max_bs in {8, 16, 64}.
- Search coder: on the same symbols and scales, the port's
  ``GaussianConditional.compress_search`` writes JAX's bytes, and
  ``decompress_search`` gives the symbols back, dequantized around the
  means as JAX's does.
- Raster scan: on the same y, side parameters, weights and tables, the
  port's ``raster_scan_compress_single_stream`` writes JAX's string byte
  for byte and its decompress returns JAX's y_hat exactly; the same for
  ``RasterScanLatentCodec`` and ``EntropyBottleneckLatentCodec`` against
  their JAX counterparts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.ans.gaussian_cdf import gaussian_boundary_rows as j_rows
from flashgmm_tpu.entropy_models import GaussianConditional as JGC
from flashgmm_tpu.latent_codecs import EntropyBottleneckLatentCodec as JEBCodec
from flashgmm_tpu.latent_codecs import RasterScanLatentCodec as JRSCodec
from flashgmm_tpu.layers import MaskedConv2d as JMaskedConv2d
from flashgmm_tpu.layers import Sequential as JSequential
from flashgmm_tpu.layers.layers import Conv2d as JConv2d
from flashgmm_tpu.layers.layers import LeakyReLU as JLeakyReLU
from flashgmm_tpu.models.base import get_scale_table as j_scale_table
from flashgmm_tpu.runtime import rasterscan as j_rs
from flashgmm_tpu_torch.ans.gaussian_cdf import (gaussian_boundary_rows,
                                                 gaussian_boundary_rows_plain)
from flashgmm_tpu_torch.entropy_models import GaussianConditional as TGC
from flashgmm_tpu_torch.latent_codecs import EntropyBottleneckLatentCodec
from flashgmm_tpu_torch.latent_codecs import RasterScanLatentCodec
from flashgmm_tpu_torch.layers import Conv2d, LeakyReLU, MaskedConv2d, Sequential
from flashgmm_tpu_torch.models.base import get_scale_table
from flashgmm_tpu_torch.runtime import rasterscan as t_rs
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(2)

M = 16  # latent channels of the raster-scan cases


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


def _sweep_scales(seed):
    rs = np.random.RandomState(seed)
    s = np.concatenate([[0.11, np.nextafter(np.float32(0.11), 1)],
                        2.0 ** np.arange(-3, 9),
                        np.exp(rs.uniform(np.log(0.11), np.log(256), 3000))])
    return np.clip(s, 0.11, 256).astype(np.float32)


@pytest.mark.parametrize("max_bs", [8, 16, 64])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gaussian_rows_equal_jax(mode, max_bs):
    s = _sweep_scales(mode * 100 + max_bs)
    ref = np.asarray(j_rows(jnp.asarray(s), jnp.int32(-max_bs),
                            num_bins=2 * max_bs + 1, mode=mode))
    got = gaussian_boundary_rows(torch.from_numpy(s), -max_bs,
                                 2 * max_bs + 1, mode)
    assert got.dtype == torch.uint16 and got.shape == ref.shape
    assert int((got.numpy() != ref).sum()) == 0
    assert torch.equal(got, gaussian_boundary_rows_plain(
        torch.from_numpy(s), -max_bs, 2 * max_bs + 1, mode))


def _search_case(seed, b=2, h=8, w=8, c=16):
    rs = np.random.RandomState(seed)
    scales = np.exp(rs.uniform(np.log(0.05), np.log(300), (b, h, w, c)))
    means = rs.normal(0, 4, (b, h, w, c))
    y = means + scales * rs.standard_normal((b, h, w, c)) * 0.7
    y[0, 0, 0, :4] = (40.5, -37.2, 0.49, -0.5)  # past a bucket; near ties
    return [a.astype(np.float32) for a in (y, scales, means)]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_search_coder_writes_jax_bytes_and_roundtrips(mode, monkeypatch):
    monkeypatch.setenv("APPROX_MODE", str(mode))
    y, scales, means = _search_case(mode)
    tgc, jgc = TGC(), JGC()
    t_strings, t_abs = tgc.compress_search(
        torch.from_numpy(y), torch.from_numpy(scales), torch.from_numpy(means))
    j_strings, j_abs = jgc.compress_search(
        jnp.asarray(y), jnp.asarray(scales), means=jnp.asarray(means))
    assert t_abs == j_abs and t_abs > 40
    assert t_strings == j_strings
    got = tgc.decompress_search(t_strings, torch.from_numpy(scales), t_abs,
                                torch.from_numpy(means))
    ref = jgc.decompress_search(j_strings, jnp.asarray(scales), j_abs,
                                means=jnp.asarray(means))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    sym = np.round(y - means)
    np.testing.assert_array_equal(got.numpy(), (sym + means).astype(np.float32))


class _JContext(nnx.Module):
    def __init__(self, rngs):
        self.context_prediction = JMaskedConv2d(M, 2 * M, kernel_size=5,
                                                padding=2, rngs=rngs)
        self.entropy_parameters = JSequential(
            JConv2d(M * 12 // 3, M * 10 // 3, 1, rngs=rngs), JLeakyReLU(),
            JConv2d(M * 10 // 3, M * 8 // 3, 1, rngs=rngs), JLeakyReLU(),
            JConv2d(M * 8 // 3, M * 6 // 3, 1, rngs=rngs))


class _TContext(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.context_prediction = MaskedConv2d(M, 2 * M, kernel_size=5,
                                               padding=2)
        self.entropy_parameters = Sequential(
            Conv2d(M * 12 // 3, M * 10 // 3, 1), LeakyReLU(),
            Conv2d(M * 10 // 3, M * 8 // 3, 1), LeakyReLU(),
            Conv2d(M * 8 // 3, M * 6 // 3, 1))


@pytest.fixture(scope="module")
def contexts():
    """(JAX context modules, the port's on their weights, a JAX Gaussian
    conditional and the port's, both updated over the default scale
    table)."""
    jc = _JContext(nnx.Rngs(3))
    tc = _TContext()
    tc.load_state_dict(load_jax_params(jax_params(jc), tc), strict=True)
    jgc, tgc = JGC(), TGC()
    jgc.update_scale_table(j_scale_table(), force=True)
    tgc.update_scale_table(get_scale_table(), force=True)
    for j, t in zip((jgc.quantized_cdf, jgc.cdf_length, jgc.offset),
                    tgc._tables()):
        np.testing.assert_array_equal(np.asarray(j).reshape(t.shape), t)
    return jc, tc, jgc, tgc


def _latents(seed, b=1, h=6, w=5):
    rs = np.random.RandomState(seed)
    y = (rs.standard_normal((b, h, w, M)) * 3).astype(np.float32)
    params = rs.standard_normal((b, h, w, 2 * M)).astype(np.float32)
    params[..., :M] = np.abs(params[..., :M]) * 4  # the scales' half
    return y, params


def test_raster_scan_writes_jax_bytes(contexts):
    jc, tc, jgc, tgc = contexts
    y, params = _latents(5)
    tables = tgc._tables()
    st = tgc.scale_table.numpy()
    j_pieces = (j_rs.HostMaskedConv(jc.context_prediction),
                j_rs.HostEntropyParameters(jc.entropy_parameters), tables, st,
                jgc.scale_bound)
    t_pieces = t_rs.host_pieces(tgc, tc.context_prediction,
                                tc.entropy_parameters)
    np.testing.assert_array_equal(t_pieces[0].flat, j_pieces[0].flat)
    ref = j_rs.raster_scan_compress_single_stream(y[0], params[0], *j_pieces)
    got = t_rs.raster_scan_compress_single_stream(y[0], params[0], *t_pieces)
    assert got == ref
    shape = y.shape[1:]
    j_hat = j_rs.raster_scan_decompress_single_stream(ref, params[0],
                                                      *j_pieces, shape)
    t_hat = t_rs.raster_scan_decompress_single_stream(got, params[0],
                                                      *t_pieces, shape)
    np.testing.assert_array_equal(t_hat, j_hat)
    _, enc_hat = t_rs.raster_scan_encode(y[0], params[0], *t_pieces)
    np.testing.assert_array_equal(enc_hat, t_hat)


def test_raster_scan_latent_codec_matches_jax(contexts):
    jc, tc, jgc, tgc = contexts
    jcodec = JRSCodec(gaussian_conditional=jgc,
                      entropy_parameters=jc.entropy_parameters,
                      context_prediction=jc.context_prediction)
    tcodec = RasterScanLatentCodec(gaussian_conditional=tgc,
                                   entropy_parameters=tc.entropy_parameters,
                                   context_prediction=tc.context_prediction)
    assert tcodec.kernel_size == jcodec.kernel_size == 5
    y, params = _latents(6, b=2)
    jo = jcodec.compress(jnp.asarray(y), jnp.asarray(params))
    to = tcodec.compress(torch.from_numpy(y), torch.from_numpy(params))
    assert to["strings"] == jo["strings"]
    assert tuple(to["shape"]) == tuple(jo["shape"])
    np.testing.assert_array_equal(to["y_hat"].numpy(), np.asarray(jo["y_hat"]))
    dec = tcodec.decompress(to["strings"], to["shape"],
                            torch.from_numpy(params))
    assert torch.equal(dec["y_hat"], to["y_hat"])
    with torch.no_grad():
        t_fwd = tcodec(torch.from_numpy(y), torch.from_numpy(params),
                       training=False)
    j_fwd = jcodec(jnp.asarray(y), jnp.asarray(params), training=False)
    np.testing.assert_allclose(t_fwd["likelihoods"]["y"].numpy(),
                               np.asarray(j_fwd["likelihoods"]["y"]),
                               rtol=2e-4, atol=1e-7)


def test_entropy_bottleneck_latent_codec_matches_jax():
    jcodec = JEBCodec(channels=M, rngs=nnx.Rngs(1))
    tcodec = EntropyBottleneckLatentCodec(channels=M)
    tcodec.load_state_dict(load_jax_params(jax_params(jcodec), tcodec),
                           strict=True)
    jcodec.entropy_bottleneck.update(force=True)
    tcodec.entropy_bottleneck.update(force=True)
    y = (np.random.RandomState(9).standard_normal((2, 4, 3, M)) * 4
         ).astype(np.float32)
    jo = jcodec.compress(jnp.asarray(y))
    to = tcodec.compress(torch.from_numpy(y))
    assert to["strings"] == jo["strings"]
    np.testing.assert_array_equal(to["y_hat"].numpy(), np.asarray(jo["y_hat"]))
    dec = tcodec.decompress(to["strings"], to["shape"])
    assert torch.equal(dec["y_hat"], to["y_hat"])
    with torch.no_grad():
        t_fwd = tcodec(torch.from_numpy(y), training=False)
    j_fwd = jcodec(jnp.asarray(y), training=False)
    np.testing.assert_allclose(t_fwd["likelihoods"]["y"].numpy(),
                               np.asarray(j_fwd["likelihoods"]["y"]),
                               rtol=2e-4, atol=1e-7)

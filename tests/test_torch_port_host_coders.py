"""The port's numpy host coders (flashgmm_tpu_torch/ans/rans_numpy.py and
range_coder.py), its entropy-coder registry and the "rangecoder" backend,
held against the JAX package's (flashgmm_tpu/ans/rans_numpy.py,
range_coder.py, flashgmm_tpu/__init__.py:28-57).

- On the same seeded symbols, CDF tables and uint16 rows (escapes into
  bypass coding among them): byte-equal streams and equal decodes from both
  packages' ``encode_with_indexes``, ``encode_rows`` and the bypass values,
  and ``rans_numpy``'s bytes equal to the port's host coder (``cext``).
- The registry refuses what JAX's refuses (tests/test_misc_components.py:88).
- ``set_entropy_coder("rangecoder")``: an EntropyBottleneck and a
  GaussianMixtureConditional round trip exactly (tests/test_rans.py:
  200-262), and their strings equal JAX's: the bottleneck's of a
  FactorizedPrior(N=32, M=48) fed JAX's weights and quantiles, on JAX's y;
  the mixture's on the same parameters (the port's CPU rows are XLA's).
"""

import numpy as np
import pytest
import torch
from flax import nnx

import flashgmm_tpu
import flashgmm_tpu_torch
from flashgmm_tpu.ans import range_coder as j_rc
from flashgmm_tpu.ans import rans_numpy as j_rn
from flashgmm_tpu_torch.ans import cext
from flashgmm_tpu_torch.ans import range_coder as t_rc
from flashgmm_tpu_torch.ans import rans_numpy as t_rn
from flashgmm_tpu_torch.ans.pmf_to_cdf import pmf_to_quantized_cdf
from torch_port_model_pairs import jax_params

torch.set_num_threads(2)


def _tables(rng, num_cdfs=6, max_len=18):
    cdfs = np.zeros((num_cdfs, max_len), np.int32)
    sizes = np.zeros(num_cdfs, np.int32)
    offsets = np.zeros(num_cdfs, np.int32)
    for i in range(num_cdfs):
        length = rng.integers(4, max_len - 1)
        pmf = rng.random(length - 1).astype(np.float32) + 0.01
        pmf /= pmf.sum() * 1.0001  # leave tail mass
        cdf = pmf_to_quantized_cdf(np.concatenate([pmf, [1 - pmf.sum()]]),
                                   16)
        cdfs[i, : cdf.shape[0]] = cdf
        sizes[i] = cdf.shape[0]
        offsets[i] = rng.integers(-10, 0)
    return cdfs, sizes, offsets


def _table_case(seed, n=1200):
    rng = np.random.default_rng(seed)
    cdfs, sizes, offsets = _tables(rng)
    indexes = rng.integers(0, cdfs.shape[0], n).astype(np.int32)
    # out-of-range values on both sides: the escape into bypass coding,
    # with raw values long enough for several 4-bit chunk counts
    symbols = np.array([offsets[i] + rng.integers(-40, sizes[i] + 40)
                        for i in indexes], np.int32)
    symbols[::97] += 100000
    return symbols, indexes, cdfs, sizes, offsets


def _rows_case(seed, n=800, L=18, lo=-8):
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4000, (n, L)).astype(np.uint32)
    rows = np.cumsum(steps, axis=1)
    rows = (rows.astype(np.float64) / rows[:, -1:] * 60000).astype(np.uint16)
    rows[:, 0] = 0
    values = rng.integers(lo, lo + L - 2, n).astype(np.int32)
    # pmf == 0 slots escape to bypass (negative raw values among them)
    for i in range(0, n, 29):
        j = int(values[i] - lo)
        rows[i, j + 1] = rows[i, j]
    return values, rows, lo


@pytest.mark.parametrize("port, ref", [(t_rn, j_rn), (t_rc, j_rc)],
                         ids=["rans_numpy", "range_coder"])
@pytest.mark.parametrize("seed", [0, 1])
def test_table_path_bytes_equal_jax(port, ref, seed):
    args = _table_case(seed)
    data = port.encode_with_indexes(*args)
    assert data == ref.encode_with_indexes(*args)
    got = port.decode_with_indexes(data, *args[1:])
    np.testing.assert_array_equal(got, args[0])
    np.testing.assert_array_equal(got, ref.decode_with_indexes(data,
                                                               *args[1:]))


@pytest.mark.parametrize("port, ref", [(t_rn, j_rn), (t_rc, j_rc)],
                         ids=["rans_numpy", "range_coder"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rows_path_bytes_equal_jax(port, ref, seed):
    values, rows, lo = _rows_case(seed)
    data = port.encode_rows(values, rows, lo)
    assert data == ref.encode_rows(values, rows, lo)
    got = port.decode_rows(data, rows, lo)
    np.testing.assert_array_equal(got, values)
    np.testing.assert_array_equal(got, ref.decode_rows(data, rows, lo))


@pytest.mark.parametrize("raw", [0, 1, 14, 15, 16, 255, 2**31 - 1,
                                 2**32 - 1])
def test_bypass_values_equal_jax(raw):
    """The chunk-count prefix and chunks of one bypass value, through both
    packages' rANS symbol buffers and the range coder's helpers."""
    t_buf, j_buf = t_rn._SymbolBuffer(), j_rn._SymbolBuffer()
    for buf in (t_buf, j_buf):
        buf.put(100, 200)
        buf.put_bypass_value(raw)
    data = t_buf.flush()
    assert data == j_buf.flush()
    dec = t_rn._Decoder(data)
    dec.advance(100, 200)
    assert dec.get_bypass_value() == raw
    t_enc, j_enc = t_rc.RangeEncoder(), j_rc.RangeEncoder()
    t_rc._put_bypass_value(t_enc, raw)
    j_rc._put_bypass_value(j_enc, raw)
    data = t_enc.finish()
    assert data == j_enc.finish()
    assert t_rc._get_bypass_value(t_rc.RangeDecoder(data)) == raw


@pytest.mark.parametrize("seed", [0, 1])
def test_rans_numpy_bytes_equal_host_coder(seed):
    args = _table_case(seed)
    assert t_rn.encode_with_indexes(*args) == cext.encode_with_indexes(*args)
    values, rows, lo = _rows_case(seed)
    data = t_rn.encode_rows(values, rows, lo)
    assert data == cext.encode_rows(values, rows, lo)
    np.testing.assert_array_equal(cext.decode_rows(data, rows, lo), values)


def test_registry_as_jax():
    for pkg in (flashgmm_tpu, flashgmm_tpu_torch):
        assert pkg.get_entropy_coder() == "rans"
        assert pkg.available_entropy_coders() == ["rans", "rangecoder"]
        with pytest.raises(ValueError):
            pkg.set_entropy_coder("bogus")
        with pytest.raises(ValueError):
            pkg.set_entropy_coder(3)
    from flashgmm_tpu_torch.entropy_models.entropy_models import EntropyModel

    with pytest.raises(ValueError, match="Unknown entropy coder"):
        EntropyModel(entropy_coder="bogus")
    assert EntropyModel().entropy_coder.name == "rans"
    assert EntropyModel(entropy_coder="rangecoder").entropy_coder.name == \
        "rangecoder"


@pytest.fixture
def rangecoder():
    flashgmm_tpu.set_entropy_coder("rangecoder")
    flashgmm_tpu_torch.set_entropy_coder("rangecoder")
    try:
        yield
    finally:
        flashgmm_tpu.set_entropy_coder("rans")
        flashgmm_tpu_torch.set_entropy_coder("rans")


def test_entropy_bottleneck_round_trip_and_strings_equal_jax(rangecoder):
    import jax.numpy as jnp

    from flashgmm_tpu.models.google import FactorizedPrior as JFactorized
    from flashgmm_tpu_torch.models import FactorizedPrior
    from flashgmm_tpu_torch.zoo import load_jax_params

    jm = JFactorized(N=32, M=48, rngs=nnx.Rngs(0))
    jm.update(update_quantiles=True)
    tm = FactorizedPrior(32, 48, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update(force=True)
    eb_t, eb_j = tm.entropy_bottleneck, jm.entropy_bottleneck
    assert eb_t.entropy_coder.name == eb_j.entropy_coder.name == "rangecoder"

    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    y = np.asarray(jm.g_a(jnp.asarray(x)))
    strings = eb_t.compress(torch.from_numpy(y))
    assert strings == eb_j.compress(jnp.asarray(y))
    y_hat = eb_t.decompress(strings, y.shape[1:3])
    med = eb_t._get_medians()[:, 0, 0]
    torch.testing.assert_close(y_hat, torch.round(torch.from_numpy(y) - med)
                               + med, atol=1e-5, rtol=0)
    # and the model's own compress and decompress on the range coder
    out = tm.compress(torch.from_numpy(x))
    torch.testing.assert_close(tm.decompress_y(out["strings"], out["shape"]),
                               out["y_hat"], atol=0, rtol=0)


def test_gmm_round_trip_and_strings_equal_jax(rangecoder):
    import jax.numpy as jnp

    from flashgmm_tpu.entropy_models import \
        GaussianMixtureConditional as JGmm
    from flashgmm_tpu_torch.entropy_models import GaussianMixtureConditional

    K, m = 3, 6
    rs = np.random.RandomState(0)
    x = (rs.randn(1, 8, 8, m) * 2).astype(np.float32)
    scales = np.abs(rs.randn(1, 8, 8, K * m)).astype(np.float32) + 0.15
    means = rs.randn(1, 8, 8, K * m).astype(np.float32)
    raw_w = np.abs(rs.randn(1, 8, 8, K, m)).astype(np.float32) + 0.1
    weights = (raw_w / raw_w.sum(3, keepdims=True)).reshape(1, 8, 8, K * m)

    gmm = GaussianMixtureConditional(K=K)
    assert gmm.entropy_coder.name == "rangecoder"
    params = [torch.from_numpy(a) for a in (scales, means, weights)]
    (s, abs_max, zbm), _ = gmm.compress(torch.from_numpy(x), *params)
    y_hat = gmm.decompress(s, abs_max, zbm, *params)
    torch.testing.assert_close(y_hat, torch.round(torch.from_numpy(x)),
                               atol=0, rtol=0)
    (s_j, abs_max_j, _), _ = JGmm(K=K).compress(
        jnp.asarray(x), *(jnp.asarray(a) for a in (scales, means, weights)))
    assert (s, abs_max) == (s_j, abs_max_j)

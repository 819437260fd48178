"""The port's single-Gaussian checkerboard codec (FastCheckerboardGsmCodec)
and its K = 1 coder on the CPU, against the JAX package's, at N=32 (the
model cut to narrow widths), lanes=64, 64x64 images made by numpy from a
seed.

What is exact and what is held to a tolerance:
- the K = 1 coder (zero means, unit weights, the GSM passes' rows): the
  port's plain encoder gives JAX's ``gmm_guarded_bounds`` ->
  ``encode_scan`` -> ``pack_words`` BIT FOR BIT, and its plain decoder
  JAX's ``decode_scan`` symbols over JAX's rows, in all three
  approximation modes;
- the port's own encode -> bytes -> decode: y_hat EXACT, batch 1 and 2,
  through ``from_bytes`` and through the packed ``decode_bytes``; the
  overflow fallback too;
- stream capacities EQUAL to the JAX codec's; JAX's ``from_bytes`` reads
  the port's bytes into the same n_words, states and words, and its z
  decoder gives the port's z bins EXACTLY (the EntropyBottleneck tables
  are bit-exact when the port is fed JAX's quantiles);
- each pass's scales and means against the JAX codec's stages
  (``_rows0_impl``, ``_rows1_impl`` and their ``_gsm_pass_params``) on the
  same z bins and anchor symbols: atol 2e-4 (float32 conv chains summed
  in another order than XLA's);
- the symbols of one image, sym = round(y - mu), by a measured flip count
  under a bound: g_a and the means differ by float32 ulps, so a latent at
  a rounding boundary may round the other way (measured, torch 2.13 CPU,
  jax 0.9: 0 of 1024; bound 10, 1 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.ans import interleaved as jil
from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_bounds as j_bounds
from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_rows as j_rows
from flashgmm_tpu.models.sensetime import Cheng2020AnchorCheckerboard as JModel
from flashgmm_tpu.runtime import FastCheckerboardGsmCodec as JCodec
from flashgmm_tpu_torch.ans import interleaved as til
from flashgmm_tpu_torch.ans import rans_kernels
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboard as TModel
from flashgmm_tpu_torch.runtime import FastCheckerboardGsmCodec, StreamOverflow
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

N, LANES = 32, 64
ATOL = 2e-4
LO, NUM_BINS = -48, 97


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


@pytest.fixture(scope="module")
def models():
    jm = JModel(N=N, rngs=nnx.Rngs(0))
    jm.update(update_quantiles=True)
    tm = TModel(N=N, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update()
    return jm, tm


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _codec(tm, **kw):
    return FastCheckerboardGsmCodec(tm, lanes=LANES, bf16_transforms=False,
                                    **kw)


def _jcodec(jm, **kw):
    return JCodec(jm, lanes=LANES, bf16_transforms=False, **kw)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_k1_plain_coder_equals_jax(mode):
    """A GSM pass's coder calls: scales [n, 1], zero means, unit weights;
    n leaves the last step partly inactive. The wrappers run their plain
    versions on CPU tensors and count no launch."""
    rs = np.random.RandomState(40 + mode)
    n = 5 * LANES - 23
    s = rs.uniform(0.11, 20.0, (n, 1)).astype(np.float32)
    zeros, ones = np.zeros_like(s), np.ones_like(s)
    v = np.clip(np.round(rs.normal(0, 6, n)), LO, LO + NUM_BINS - 1)
    v[:8], v[8:16] = LO, LO + NUM_BINS - 1
    v = v.astype(np.int32)
    t, _ = jil.layout(n, LANES)
    active = jil.active_mask(n, t, LANES)
    start, freq = j_bounds(jnp.asarray(v), jnp.asarray(s), jnp.asarray(zeros),
                           jnp.asarray(ones), jnp.int32(LO), NUM_BINS, mode)
    j_states, j_words, j_emits = jil.encode_scan(
        jil.to_lanes(start, LANES), jil.to_lanes(jnp.maximum(freq, 1), LANES),
        active)
    j_stream, j_n = jil.pack_words(j_words, j_emits)
    j_n = int(j_n)

    before = (rans_kernels.encode_scan_gmm.launches_k1,
              rans_kernels.decode_scan_gmm.launches_k1)
    ts, tz, to = (torch.from_numpy(a) for a in (s, zeros, ones))
    states, words, emits = rans_kernels.encode_scan_gmm(
        torch.from_numpy(v), ts, tz, to, LO, NUM_BINS, mode, LANES)
    stream, n_words = til.pack_words(words, emits)
    assert int(n_words) == j_n
    np.testing.assert_array_equal(states.numpy(),
                                  np.asarray(j_states).astype(np.int64))
    np.testing.assert_array_equal(stream[:j_n].numpy(),
                                  np.asarray(j_stream)[:j_n].astype(np.int64))

    rows = j_rows(jnp.asarray(s), jnp.asarray(zeros), jnp.asarray(ones),
                  jnp.int32(LO), NUM_BINS, mode)
    rows_l = jil.to_lanes(rows, LANES, fill=0)
    j_sym = jil.decode_scan(j_states, j_stream, rows_l, active, jnp.int32(LO))
    t_active = til.active_mask(n, t, LANES)
    sym = rans_kernels.decode_scan_gmm(states, stream, ts, tz, to, t_active,
                                       LO, NUM_BINS, mode)
    np.testing.assert_array_equal(til.from_lanes(sym, n).numpy(),
                                  np.asarray(jil.from_lanes(j_sym, n)))
    np.testing.assert_array_equal(til.from_lanes(sym, n).numpy(), v)
    assert (rans_kernels.encode_scan_gmm.launches_k1,
            rans_kernels.decode_scan_gmm.launches_k1) == before


@pytest.fixture(scope="module")
def pass_params(models):
    """Each pass's parameters from both packages' stages on the same seeded
    z bins and anchor symbols (b=2, y latent 8x8), each package's
    non-anchor pass conditioned on its own anchor means."""
    jm, tm = models
    codec = _codec(tm)
    jc = _jcodec(jm)
    rs = np.random.RandomState(5)
    b, h, w = 2, 8, 8
    z_max = np.asarray(codec._z_maxbin)
    z_bin = np.stack([rs.randint(0, z_max + 1) for _ in range(b * 4)]
                     ).reshape(b, h // 4, w // 4, N).astype(np.int32)
    sym0 = rs.randint(-4, 5, (b, h, w // 2, N)).astype(np.int32)

    def scales_of(state, side, ctx):  # the _gsm_pass_params of the stages
        _, ckbd, _, gc_lc = jc._modules(state)
        return jc._gsm_pass_params(ckbd, gc_lc, ctx, side)[0]

    def ctx_of(state, s0, mu0):  # the context stage of _rows1_impl
        _, ckbd, _, _ = jc._modules(state)
        y_hat0 = s0.astype(jnp.float32) + mu0
        y_ = jnp.stack([y_hat0, jnp.zeros_like(y_hat0)])
        return ckbd.unembed(ckbd.context_prediction(ckbd.embed(y_)))[1]

    side_j = jc._side_jit(jc._state, jnp.asarray(z_bin))
    _, mu0_j = jc._rows0_jit(jc._state, side_j[0])
    _, mu1_j = jc._rows1_jit(jc._state, side_j[1], jnp.asarray(sym0), mu0_j)
    ctx_j = jax.jit(ctx_of)(jc._state, jnp.asarray(sym0), mu0_j)
    sc = jax.jit(scales_of)
    ref = [(sc(jc._state, side_j[0], jnp.zeros_like(side_j[0])), mu0_j),
           (sc(jc._state, side_j[1], ctx_j), mu1_j)]
    with torch.no_grad():
        side = codec._side(torch.from_numpy(z_bin))
        (p0, mu0) = codec._params0(side[0])
        (p1, mu1) = codec._params1(side[1], torch.from_numpy(sym0), mu0)
    return [(p0, mu0), (p1, mu1)], ref


@pytest.mark.parametrize("p", [0, 1])
def test_pass_parameters_match_jax_stages(pass_params, p):
    got, ref = pass_params
    (scales, zeros, ones), mu = got[p]
    n = 2 * 8 * 4 * N
    assert scales.shape == zeros.shape == ones.shape == (n, 1)
    assert not zeros.any() and bool((ones == 1).all())
    assert float(scales.min()) >= np.float32(0.11)
    np.testing.assert_allclose(scales.numpy(), np.asarray(ref[p][0]), rtol=0,
                               atol=ATOL)
    assert mu.shape == (2, 8, 4, N)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref[p][1]), rtol=0,
                               atol=ATOL)


def test_symbols_against_jax(models):
    """y_hat = sym + mu of both packages' encoders on one image: a flip is
    a symbol that rounded the other way (a step of one), the rest differ
    by the means' float32 ulps."""
    jm, tm = models
    x = _images(2, 4)
    with torch.no_grad():
        got = _codec(tm, cap_divisor=1).encode(torch.from_numpy(x))["y_hat"]
    ref = np.asarray(_jcodec(jm, cap_divisor=1).encode(jnp.asarray(x))["y_hat"])
    d = np.abs(got.numpy() - ref)
    flips = int((d > 0.5).sum())
    assert flips <= 10, flips
    assert float(d.max()) <= 1 + ATOL
    assert float(d[d <= 0.5].max()) <= ATOL


@pytest.mark.parametrize("batch", [1, 2])
def test_port_roundtrip_exact(models, batch):
    _, tm = models
    codec = _codec(tm, cap_divisor=1)
    x = torch.from_numpy(_images(batch, 10 + batch))
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    assert y_shape == (batch, 4, 4, N)
    assert len(data) == codec.num_bytes(out) + 12
    y_dec = codec.decode_y_hat(codec.from_bytes(data, y_shape), y_shape)
    assert torch.equal(y_dec, out["y_hat"])
    # y_hat is sym + mu, not an integer
    assert not torch.equal(out["y_hat"], torch.round(out["y_hat"]))
    x_hat = codec.decode_bytes(data, y_shape)
    ref = torch.clamp(codec._transform(codec._g_s, out["y_hat"]), 0, 1)
    assert x_hat.shape == x.shape and torch.equal(x_hat, ref)


def test_capped_encode_falls_back_on_overflow(models):
    """A 1/64 cap leaves a pass fewer words than these symbols need:
    to_bytes raises, encode_to_bytes encodes uncapped (full=True), and the
    overflow bytes decode exactly, unpacked."""
    _, tm = models
    codec = _codec(tm, cap_divisor=64)
    x = torch.from_numpy(_images(1, 3))
    with pytest.raises(StreamOverflow):
        codec.to_bytes(codec.encode(x))
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    _, caps = codec.pack(data, y_shape)
    assert caps != codec._pass_caps(y_shape)
    assert torch.equal(codec.decode_y_hat(codec.from_bytes(data, y_shape),
                                          y_shape), out["y_hat"])
    assert torch.equal(codec.decode_bytes(data, y_shape),
                       codec.decode(codec.from_bytes(data, y_shape), y_shape))


@pytest.mark.parametrize("cap_divisor", [1, 4])
def test_stream_capacities_equal_jax(models, cap_divisor):
    jm, tm = models
    jc = _jcodec(jm, cap_divisor=cap_divisor)
    codec = _codec(tm, cap_divisor=cap_divisor)
    for y_shape in ((4, 4, N), (2, 4, 4, N), (3, 8, 12, N)):
        assert codec.stream_capacities(y_shape) == jc.stream_capacities(y_shape)


def test_jax_reads_the_port_bytes(models):
    """JAX's GSM codec parses the port's bytes into the port's passes, and
    its z decoder gives the z bins the port's decoder gives."""
    jm, tm = models
    codec = _codec(tm, cap_divisor=1)
    data, out = codec.encode_to_bytes(torch.from_numpy(_images(2, 21)))
    y_shape = tuple(out["y_hat"].shape)
    jc = _jcodec(jm, cap_divisor=1)
    j_streams = jc.from_bytes(data, y_shape)
    for name in ("z", "y0", "y1"):
        p, q = out[name], j_streams[name]
        n = int(p.n_words)
        assert int(q.n_words) == n
        np.testing.assert_array_equal(np.asarray(q.states),
                                      p.states.numpy().astype(np.uint32))
        np.testing.assert_array_equal(np.asarray(q.stream)[:n],
                                      p.stream[:n].numpy().astype(np.uint16))
    b, h, w, _ = y_shape
    z_j = np.asarray(jc._zdec_jit(jc._state, j_streams["z"],
                                  (b, h // 4, w // 4, N)))
    z_t = codec._decode_z(codec.from_bytes(data, y_shape)["z"], b, h, w)
    np.testing.assert_array_equal(z_t.numpy(), z_j)

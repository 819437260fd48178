"""The port's single-image latency codec (FastLatencyGmmCodec) on the CPU,
against the port's batched codec and the JAX package's latency codec, at
N=32, K=2 (the flagship cut to narrow widths), lanes=64, one 64x64 image
made by numpy from a seed.

On a CPU model the codec runs its three directions (encode, decode-y, g_s)
eagerly on the kernels' plain versions, the same functions its CUDA graphs
capture on the card (tests/test_torch_port_gpu.py holds the graphs against
this eager run). What is exact and what is held to a tolerance:
- certified round trip: y_hat EXACT through the bytes, no fallback;
- bytes EQUAL to the batched codec's at the same lanes and cap_divisor, and
  each codec decodes the other's;
- stream capacities EQUAL to the JAX latency codec's;
- quantized symbols against the JAX latency encoder's: a measured flip rate
  held under a bound (g_a sums in another order than XLA's convs, so a
  latent near a rounding boundary may round the other way);
- the decoders' deferred error flag: the plain path leaves it zero and
  gives the same symbols.
"""

import hashlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.runtime import FastLatencyGmmCodec as JLatency
from flashgmm_tpu_torch.ans import interleaved as il
from flashgmm_tpu_torch.ans import rans_kernels
from flashgmm_tpu_torch.ans.gaussian_cdf import gmm_guarded_rows
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec as TCodec
from flashgmm_tpu_torch.runtime import FastLatencyGmmCodec as TLatency
from flashgmm_tpu_torch.runtime.fast_codec import PassStream, _decode_pass
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

N, K, LANES = 32, 2, 64


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


@pytest.fixture(scope="module")
def models():
    jm = JModel(N=N, K=K, rngs=nnx.Rngs(0))
    jm.update(update_quantiles=True)
    tm = TModel(N=N, K=K, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update()
    return jm, tm


def _image(seed):
    return np.random.RandomState(seed).rand(1, 64, 64, 3).astype(np.float32)


def _certified(codec, x):
    """encode_certified with any RuntimeWarning (the double-failure
    warning) an error."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        return codec.encode_certified(x)


def test_certified_roundtrip(models):
    _, tm = models
    codec = TLatency(tm, lanes=LANES, cap_divisor=1)
    x = torch.from_numpy(_image(9))
    data, y_shape = _certified(codec, x)
    assert not codec._fallback_digests
    assert y_shape == (1, 4, 4, N)
    ps_z, ps0, ps1, _, _, y_hat = codec._batched._encode(x, 1)
    # the encoder's streams have from_bytes' capacities: certification
    # feeds them to decode-y as they are
    cap_z, cap_y = codec.stream_capacities(y_shape)
    assert [p.stream.shape[0] for p in (ps_z, ps0, ps1)] == [cap_z, cap_y,
                                                             cap_y]
    y_dec = codec._decode_y(codec._passes(codec.from_bytes(data, y_shape)),
                            y_shape)
    torch.testing.assert_close(y_dec, y_hat, rtol=0, atol=0)
    assert int(codec._err) == 0
    rec = codec.decode(data, y_shape)
    assert rec.shape == x.shape and bool(torch.isfinite(rec).all())
    assert float(rec.min()) >= 0.0 and float(rec.max()) <= 1.0
    torch.testing.assert_close(codec.decode(data, y_shape), rec, rtol=0,
                               atol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_same_bytes_as_the_batched_codec(models, bf16):
    """The latency bytes are the batched codec's encode_to_bytes at the same
    lanes and cap_divisor, and each codec decodes the other's bytes."""
    _, tm = models
    lat = TLatency(tm, lanes=LANES, cap_divisor=1, bf16_transforms=bf16)
    batched = TCodec(tm, lanes=LANES, cap_divisor=1, bf16_transforms=bf16)
    x = torch.from_numpy(_image(10))
    data, y_shape = _certified(lat, x)
    b_data, out = batched.encode_to_bytes(x)
    assert data == b_data
    y_dec = batched.decode_y_hat(batched.from_bytes(data, y_shape), y_shape)
    torch.testing.assert_close(y_dec, out["y_hat"], rtol=0, atol=0)
    torch.testing.assert_close(lat.decode(b_data, y_shape),
                               batched.decode_bytes(b_data, y_shape),
                               rtol=0, atol=0)


@pytest.mark.parametrize("lanes,cap_divisor", [(64, 1), (64, 4), (1024, 4),
                                               (128, 8), (1000, 3)])
def test_stream_capacities_equal_jax(models, lanes, cap_divisor):
    jm, tm = models
    jc = JLatency(jm, lanes=lanes, cap_divisor=cap_divisor)
    tc = TLatency(tm, lanes=lanes, cap_divisor=cap_divisor)
    for y_shape in ((1, 4, 4, N), (1, 48, 32, N), (1, 8, 12, N),
                    (2, 24, 16, N), (1, 5, 6, N)):
        assert tc.stream_capacities(y_shape) == jc.stream_capacities(y_shape)


@pytest.mark.parametrize("bf16,bound", [(False, 5), (True, 8)])
def test_symbols_agree_with_the_jax_latency_encoder(models, bf16, bound):
    """The port's quantized anchor and non-anchor symbols against the JAX
    latency encoder's (its ``_encode_jit``) on the same image and weights.
    g_a sums in another order than XLA's convs (ROADMAP C2; within atol
    2e-4 in float32, test_torch_port_codec.py), and with bf16 transforms
    the two frameworks also round to bf16 at other places, so a latent near
    a rounding boundary may land on the other side, one step away.
    Measured (torch 2.13 CPU, jax 0.9) of the 512 symbols: 0 differ in
    float32, 4 with bf16 transforms (2 and 4 on two other seeds). Bound:
    twice the measurement, and at least 1 % of the symbols (5)."""
    jm, tm = models
    x = _image(11)
    jc = JLatency(jm, lanes=LANES, cap_divisor=1, bf16_transforms=bf16)
    _, _, _, j_sym0, j_sym1, _ = jc._encode_jit(jc._state, jnp.asarray(x), 1)
    lat = TLatency(tm, lanes=LANES, cap_divisor=1, bf16_transforms=bf16)
    with torch.inference_mode():
        _, _, _, sym0, sym1, _ = lat._encode(torch.from_numpy(x))
    got = np.stack([sym0.numpy(), sym1.numpy()])
    ref = np.stack([np.asarray(j_sym0), np.asarray(j_sym1)])
    assert got.shape == ref.shape == (2, 1, 4, 2, N)  # 512 symbols
    flips = int((got != ref).sum())
    assert flips <= bound, (flips, got.size)
    assert int(np.abs(got - ref).max()) <= 1


def test_transforms_see_canonical_strides(models):
    """ROADMAP C9: a batch-1 image tensor's size-1 batch dimension may carry
    any stride (0 from ``torch.from_numpy(img[None])``, H*W*3 from a slice
    of a batch); on the card cuDNN chose its memory format, algorithm and
    roundings by those strides. The codec hands g_a a copy with canonical
    strides either way, and the bytes are the same."""
    _, tm = models
    codec = TLatency(tm, lanes=LANES, cap_divisor=1)
    img = _image(13)[0]
    seen = []
    hook = codec._batched._g_a.layers[0].register_forward_hook(
        lambda _m, i, _o: seen.append(i[0].stride()))
    try:
        a = torch.from_numpy(img[None])
        b = torch.from_numpy(np.stack([img, img]))[:1]
        assert a.stride()[0] != b.stride()[0]
        data_a, _ = _certified(codec, a)
        data_b, _ = _certified(codec, b)
    finally:
        hook.remove()
    assert data_a == data_b
    assert seen and set(seen) == {(64 * 64 * 3, 64 * 3, 3, 1)}


def test_forced_certification_failure_takes_the_fallback(models):
    _, tm = models
    codec = TLatency(tm, lanes=LANES, cap_divisor=1)
    x = torch.from_numpy(_image(12))
    ref, y_shape = _certified(codec, x)
    fallbacks = []
    encode_to_bytes = codec._batched.encode_to_bytes

    def counting(x_):
        fallbacks.append(1)
        return encode_to_bytes(x_)

    codec._batched.encode_to_bytes = counting
    # the first comparison (the encoder's streams) fails, the
    # cross-certification of the fallback's bytes passes: no warning
    seen = []

    def fails_once(a, b):
        seen.append(1)
        return (a == b).all() & (len(seen) > 1)

    codec._cmp = fails_once
    data, shape = _certified(codec, x)
    assert (len(fallbacks), len(seen)) == (1, 2)
    assert not codec._fallback_digests and shape == y_shape
    assert data == ref  # the batched codec's bytes are the latency codec's
    x_hat = codec.decode(data, y_shape)
    # every comparison fails: the digest is remembered, with the warning
    codec._cmp = lambda a, b: torch.zeros((), dtype=torch.bool)
    with pytest.warns(RuntimeWarning, match="cross-certification"):
        data2, _ = codec.encode_certified(x)
    assert len(fallbacks) == 2
    assert codec._fallback_digests == {hashlib.sha256(data2).hexdigest()}
    del codec._cmp
    routed = codec.decode(data2, y_shape)
    torch.testing.assert_close(routed, codec._batched.decode_bytes(
        data2, y_shape), rtol=0, atol=0)
    torch.testing.assert_close(routed, x_hat, rtol=0, atol=0)


def test_overflow_takes_the_fallback(models):
    """Random pixels through an untrained model code near 16 bits a symbol,
    far over a 1/8 cap: the encoder's streams overflow, and the fallback's
    uncapped bytes (the batched codec's) certify through decode-y at the
    overflow capacity and decode exactly."""
    _, tm = models
    codec = TLatency(tm, lanes=LANES, cap_divisor=8)
    batched = TCodec(tm, lanes=LANES, cap_divisor=8)
    x = torch.from_numpy(_image(3))
    with torch.inference_mode():
        ps = codec._encode(x)[:3]
    assert any(int(p.n_words) > p.stream.shape[0] for p in ps)
    data, y_shape = _certified(codec, x)
    assert not codec._fallback_digests
    b_data, out = batched.encode_to_bytes(x)
    assert data == b_data
    streams = codec.from_bytes(data, y_shape)
    assert streams["y0"].stream.shape[0] > codec.stream_capacities(y_shape)[1]
    y_dec = codec._decode_y(codec._passes(streams), y_shape)
    torch.testing.assert_close(y_dec, out["y_hat"], rtol=0, atol=0)
    torch.testing.assert_close(codec.decode(data, y_shape),
                               batched.decode_bytes(data, y_shape),
                               rtol=0, atol=0)


def test_decoders_error_flag_on_the_cpu():
    """``err`` on the plain path: the flag stays zero, the symbols are those
    of the call without it, for both decoders and the z pass's helper."""
    rs = np.random.RandomState(4)
    n, w, k, lo, num_bins = 700, 64, 3, -16, 33
    params = [rs.uniform(0.2, 6, (n, k)), rs.normal(0, 2, (n, k)),
              rs.uniform(0.1, 1, (n, k))]
    params[2] /= params[2].sum(1, keepdims=True)
    params = [torch.from_numpy(p.astype(np.float32)) for p in params]
    values = torch.from_numpy(np.clip(np.round(rs.normal(0, 4, n)), lo,
                                      lo + num_bins - 1).astype(np.int64))
    states, words, emits = rans_kernels.encode_scan_gmm(
        values, *params, lo, num_bins, 0, w)
    stream, _ = il.pack_words(words, emits)
    t, pad = il.layout(n, w)
    active = il.active_mask(n, t, w)
    rows = gmm_guarded_rows(*params, lo, num_bins)
    rows_l = torch.cat([rows, rows[-1:].expand(pad, -1)]).reshape(t, w, -1)
    err = torch.zeros(1, dtype=torch.int32)
    plain = rans_kernels.decode_scan(states, stream, rows_l, active, lo)
    assert torch.equal(il.from_lanes(plain, n).long(), values)
    assert torch.equal(rans_kernels.decode_scan(states, stream, rows_l,
                                                active, lo, err=err), plain)
    assert torch.equal(rans_kernels.decode_scan_gmm(
        states, stream, *params, active, lo, num_bins, err=err), plain)
    ps = PassStream(states, stream, None)
    assert torch.equal(_decode_pass(ps, rows, n, lo, w, err=err),
                       il.from_lanes(plain, n))
    assert int(err) == 0
    for bad in (torch.zeros(1, dtype=torch.int64),
                torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="err"):
            rans_kernels.decode_scan_gmm(states, stream, *params, active, lo,
                                         num_bins, err=bad)

"""The port's ELIC codecs (FastElicGmmCodec, FastLatencyElicCodec) on the
CPU, against the JAX package's codec stages and bytes at the JAX tests'
size (N=32, M=64, K=2, groups [8, 8, 16, 16, 16], lanes=64, 64x64 images
made by numpy from a seed).

What is exact and what is held to a tolerance:
- the port's own encode -> bytes -> decode: y_hat EXACT, batch 1 and 2,
  eleven streams; the overflow fallback too;
- stream capacities EQUAL to the JAX codec's; the bytes cross packages:
  JAX's ``from_bytes`` reads the port's bytes into the same n_words,
  states and words, and JAX's ``to_bytes`` of the port's passes gives the
  port's bytes;
- each pass's [n, K] GMM parameters against the JAX codec's stages on the
  same z bins and symbols: atol 2e-4 (float32 conv chains summed in
  another order than XLA's; measured, torch 2.13 CPU, jax 0.9: at most
  1.3e-6); the quantized symbols of g_a by a measured
  flip count held under a bound;
- the latency codec, run eagerly on a CPU model: certified round trip, the
  batched codec's bytes, a forced failure taking the fallback.

The reference network's passes are held in test_torch_port_elic_interop.py.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.elic_gmm import Elic2022GMM as JElic
from flashgmm_tpu.runtime import FastElicGmmCodec as JCodec
from flashgmm_tpu.runtime.fast_codec import PassStream as JPassStream
from flashgmm_tpu_torch.models import Elic2022GMM as TElic
from flashgmm_tpu_torch.runtime import (FastElicGmmCodec, FastLatencyElicCodec,
                                        StreamOverflow)
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

N, M, K, GROUPS, LANES = 32, 64, 2, [8, 8, 16, 16, 16], 64
ATOL = 2e-4


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


@pytest.fixture(scope="module")
def models():
    jm = JElic(N=N, M=M, K=K, groups=GROUPS, rngs=nnx.Rngs(0))
    tm = TElic(N=N, M=M, K=K, groups=GROUPS, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update()
    return jm, tm


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _codec(tm, **kw):
    return FastElicGmmCodec(tm, lanes=LANES, bf16_transforms=False, **kw)


@pytest.fixture(scope="module")
def pass_params(models):
    """Every pass's GMM parameters from both packages' stages on the same
    seeded z bins and symbols (b=2, y latent 8x8)."""
    jm, tm = models
    codec = _codec(tm)
    jc = JCodec(jm, lanes=LANES, bf16_transforms=False)
    rs = np.random.RandomState(5)
    b, h, w = 2, 8, 8
    z_max = np.asarray(codec._z_maxbin)
    z_bin = np.stack([rs.randint(0, z_max + 1) for _ in range(b * 4)]
                     ).reshape(b, h // 4, w // 4, N).astype(np.int32)
    syms = [rs.randint(-4, 5, (b, h, w // 2, g)).astype(np.int32)
            for g in GROUPS for _ in range(2)]

    def chain(state, z_hat, jsyms):
        """The JAX codec's stages _side (from the port's dequantized z, as
        the JAX model's tables are not built here), _ctxparams and _rows up
        to the rows, for every pass, in one program."""
        _, cg, hyper = jc._modules(state)
        side_j = hyper.h_s(z_hat)
        ref = []
        for k in range(len(GROUPS)):
            ckbd = cg.latent_codec[f"y{k}"]
            side = ckbd.unembed(jc._ctxparams_impl(state, side_j,
                                                   tuple(jsyms[:2 * k]), k))
            ctx0 = jnp.zeros(side[0].shape[:-1]
                             + (ckbd.context_prediction.out_ch,))
            y_ = jnp.stack([jsyms[2 * k].astype(jnp.float32),
                            jnp.zeros_like(jsyms[2 * k], jnp.float32)])
            ctx1 = ckbd.unembed(ckbd.context_prediction(ckbd.embed(y_)))[1]
            gmm = ckbd.latent_codec["y"]
            ref.append([jc._pass_params(ckbd, gmm, ctx0, side[0]),
                        jc._pass_params(ckbd, gmm, ctx1, side[1])])
        return ref

    z_hat = codec._z_hat(torch.from_numpy(z_bin)).numpy()
    ref = jax.jit(chain)(jc._state, jnp.asarray(z_hat),
                         [jnp.asarray(s) for s in syms])
    tsyms = [torch.from_numpy(s) for s in syms]
    got = []
    with torch.no_grad():
        side_all = codec._side(torch.from_numpy(z_bin))
        for k, ckbd in enumerate(codec._ckbds):
            side = ckbd.unembed(codec._ctxparams(side_all, tsyms[:2 * k], k))
            got.append([codec._pass_params(k, side[0]),
                        codec._pass_params(k, side[1], tsyms[2 * k])])
    return got, ref


@pytest.mark.parametrize("k", range(len(GROUPS)))
def test_pass_parameters_match_jax_stages(pass_params, k):
    got, ref = pass_params
    for i in range(2):
        for name, g, r in zip(("scales", "means", "weights"), got[k][i],
                              ref[k][i]):
            assert g.shape == (2 * 8 * 4 * GROUPS[k], K)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=ATOL, err_msg=f"pass {i} {name}")


def test_symbols_against_jax(models):
    """The symbols both packages quantize from g_a on the same image. g_a
    sums in another order than XLA's convs, so a latent near a rounding
    boundary may round the other way: measured (torch 2.13 CPU, jax 0.9)
    0 of the 2048 symbols differ; bound 20 (1 %), one step at most."""
    jm, tm = models
    x = _images(2, 4)
    codec = _codec(tm)
    with torch.no_grad():
        _, syms, y_hat = codec._encode(torch.from_numpy(x), 1)
    assert len(syms) == 10
    ref = np.round(np.clip(np.asarray(jm.g_a(jnp.asarray(x))), -47, 47))
    flips = int((y_hat.numpy() != ref).sum())
    assert flips <= 20, flips
    assert float(np.abs(y_hat.numpy() - ref).max()) <= 1


@pytest.mark.parametrize("batch", [1, 2])
def test_port_roundtrip_exact(models, batch):
    _, tm = models
    codec = _codec(tm)
    x = torch.from_numpy(_images(batch, 10 + batch))
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    assert y_shape == (batch, 4, 4, M) and len(out["streams"]) == 11
    assert len(data) == codec.num_bytes(out) + 4 * 11
    streams = codec.from_bytes(data, y_shape)
    assert len(streams) == 11
    y_dec = codec.decode_y_hat(streams, y_shape)
    assert torch.equal(y_dec, out["y_hat"])
    x_hat = codec.decode_bytes(data, y_shape)
    ref = torch.clamp(codec._transform(codec._g_s, out["y_hat"]), 0, 1)
    assert x_hat.shape == x.shape and torch.equal(x_hat, ref)


def test_capped_encode_falls_back_on_overflow(models):
    """Random pixels through an untrained model code near 16 bits a
    symbol, far over a 1/8 cap: to_bytes raises, encode_to_bytes encodes
    uncapped, and the overflow bytes decode exactly, unpacked."""
    _, tm = models
    codec = _codec(tm, cap_divisor=8)
    x = torch.from_numpy(_images(1, 3))
    with pytest.raises(StreamOverflow):
        codec.to_bytes(codec.encode(x))
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    _, caps = codec.pack(data, y_shape)
    assert list(caps) != codec.stream_capacities(y_shape)
    assert torch.equal(codec.decode_y_hat(codec.from_bytes(data, y_shape),
                                          y_shape), out["y_hat"])
    assert torch.equal(codec.decode_bytes(data, y_shape),
                       codec.decode(codec.from_bytes(data, y_shape), y_shape))


@pytest.mark.parametrize("cap_divisor", [1, 8])
def test_stream_capacities_equal_jax(models, cap_divisor):
    jm, tm = models
    jc = JCodec(jm, lanes=LANES, cap_divisor=cap_divisor)
    codec = _codec(tm, cap_divisor=cap_divisor)
    for y_shape in ((4, 4, M), (2, 4, 4, M), (3, 8, 12, M)):
        assert codec.stream_capacities(y_shape) == jc.stream_capacities(y_shape)


@pytest.fixture(scope="module")
def port_bytes(models):
    _, tm = models
    codec = _codec(tm)
    data, out = codec.encode_to_bytes(torch.from_numpy(_images(2, 21)))
    return codec, data, out


def test_jax_reads_the_port_bytes(models, port_bytes):
    jm, _ = models
    codec, data, out = port_bytes
    y_shape = tuple(out["y_hat"].shape)
    jc = JCodec(jm, lanes=LANES)
    j_streams = jc.from_bytes(data, y_shape)
    assert len(j_streams) == 11
    for p, q in zip(out["streams"], j_streams):
        n = int(p.n_words)
        assert int(q.n_words) == n
        np.testing.assert_array_equal(np.asarray(q.states),
                                      p.states.numpy().astype(np.uint32))
        np.testing.assert_array_equal(np.asarray(q.stream)[:n],
                                      p.stream[:n].numpy().astype(np.uint16))


def test_jax_writes_the_port_bytes(models, port_bytes):
    """JAX's serializer over the port's passes gives the port's bytes, and
    the port parses them back."""
    jm, _ = models
    codec, data, out = port_bytes
    jc = JCodec(jm, lanes=LANES)
    j_out = {"streams": [JPassStream(p.states.numpy().astype(np.uint32),
                                     p.stream.numpy().astype(np.uint16),
                                     np.int32(int(p.n_words)))
                         for p in out["streams"]]}
    assert jc.to_bytes(j_out) == data
    y_shape = tuple(out["y_hat"].shape)
    assert torch.equal(codec.decode_y_hat(codec.from_bytes(data, y_shape),
                                          y_shape), out["y_hat"])


def _certified(codec, x):
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        return codec.encode_certified(x)


@pytest.fixture(scope="module")
def latency(models):
    _, tm = models
    return FastLatencyElicCodec(tm, lanes=LANES, bf16_transforms=False)


def test_latency_certified_roundtrip(latency):
    x = torch.from_numpy(_images(1, 9))
    data, y_shape = _certified(latency, x)
    assert not latency._fallback_digests and y_shape == (1, 4, 4, M)
    _, _, y_hat, _ = latency._encode_packed(x)
    y_dec = latency._decode_y(latency._passes(latency.from_bytes(data, y_shape)),
                              y_shape)
    assert torch.equal(y_dec, y_hat) and int(latency._err) == 0
    x_hat = latency.decode_bytes(data, y_shape)
    assert x_hat.shape == x.shape and bool(torch.isfinite(x_hat).all())


def test_latency_bytes_equal_the_batched_codec(models, latency):
    _, tm = models
    x = torch.from_numpy(_images(1, 13))
    data, y_shape = _certified(latency, x)
    b_data, out = _codec(tm).encode_to_bytes(x)
    assert b_data == data and tuple(out["y_hat"].shape) == y_shape
    assert torch.equal(latency.decode_bytes(data, y_shape),
                       _codec(tm).decode_bytes(data, y_shape))


def test_latency_eager_entry_points_as_jax(models, latency):
    """The entry points the JAX class inherits from FastElicGmmCodec:
    ``encode`` gives the batched codec's streams and y_hat, ``to_bytes``
    its bytes (which JAX's FastLatencyElicCodec reads back pass for pass,
    and whose ``num_bytes`` equals JAX's over them), ``decode_y_hat`` the
    encoder's y_hat."""
    from flashgmm_tpu.runtime import FastLatencyElicCodec as JLatency

    jm, tm = models
    x = torch.from_numpy(_images(2, 23))
    out = latency.encode(x)
    data = latency.to_bytes(out)
    b_data, b_out = _codec(tm).encode_to_bytes(x)
    assert data == b_data and torch.equal(out["y_hat"], b_out["y_hat"])
    assert latency.num_bytes(out) == _codec(tm).num_bytes(b_out)
    y_shape = tuple(out["y_hat"].shape)
    assert torch.equal(latency.decode_y_hat(out["streams"], y_shape),
                       out["y_hat"])
    jlat = JLatency(jm, lanes=LANES, bf16_transforms=False)
    j_streams = jlat.from_bytes(data, y_shape)
    assert jlat.num_bytes({"streams": j_streams}) == latency.num_bytes(out)
    for p, q in zip(out["streams"], j_streams):
        n = int(p.n_words)
        assert int(q.n_words) == n
        np.testing.assert_array_equal(np.asarray(q.stream)[:n],
                                      p.stream[:n].numpy().astype(np.uint16))


def test_latency_forced_failure_takes_the_fallback(latency):
    """A certificate that fails once takes the batched codec's bytes,
    cross-certified; failing both ways, their digest routes the decode
    through the batched codec's decoder, with a RuntimeWarning."""
    import hashlib

    x = torch.from_numpy(_images(1, 17))
    data, y_shape = _certified(latency, x)
    calls = []

    def fails_once(a, b):
        calls.append(1)
        ok = (a == b).all()
        return ok & (len(calls) > 1)

    latency._cmp = fails_once
    try:
        data1, _ = _certified(latency, x)
        assert len(calls) == 2 and data1 == data
        assert not latency._fallback_digests
        latency._cmp = lambda a, b: torch.zeros((), dtype=torch.bool)
        with pytest.warns(RuntimeWarning, match="FastElicGmmCodec"):
            data2, _ = latency.encode_certified(x)
        assert latency._fallback_digests == {hashlib.sha256(data2).hexdigest()}
    finally:
        del latency._cmp
    assert torch.equal(latency.decode_bytes(data2, y_shape),
                       latency._batched.decode_bytes(data2, y_shape))
    latency._fallback_digests.clear()

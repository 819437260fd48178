"""The packed single-transfer decode path (port of
flashgmm_tpu/runtime/fast_codec.py:583-635) on the CPU, at N=32, K=2,
lanes=64, 64x64 images made by numpy from a seed.

- ``decode_bytes`` (the three passes packed into one buffer, one copy,
  unpacked on the device) gives the same y_hat and x_hat, bit for bit, as
  ``decode(from_bytes(...))``, at batch 1 and 2; an overflow file takes the
  unpacked path and decodes exactly;
- the packed layout's offsets equal the JAX package's ``_packed_layout``,
  and the JAX package's ``_unpack_jit`` reads the port's packed buffer to
  the port's own unpacked streams;
- the encoder's streams packed on the device (``pack_device``, what the
  latency codec's certificate replays) equal the bytes' packing word for
  word;
- the latency codec decodes and certifies through the packed layout only
  (never ``from_bytes``) and reproduces the batched codec's bytes and
  y_hat.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.runtime import FastCheckerboardGmmCodec as JCodec
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec as TCodec
from flashgmm_tpu_torch.runtime import FastLatencyGmmCodec as TLatency
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
    jm.update()
    tm = TModel(N=N, K=K, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update()
    return jm, tm


def _images(b, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32))


def _counting(obj, name, calls):
    fn = getattr(obj, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    setattr(obj, name, counted)


@pytest.mark.parametrize("batch", [1, 2])
def test_packed_decode_bytes_equals_unpacked(models, batch):
    _, tm = models
    codec = TCodec(tm, lanes=LANES, cap_divisor=1)  # no pass overflows
    x = _images(batch, 20 + batch)
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    calls = []
    _counting(codec, "from_bytes", calls)
    _counting(codec, "copy_staged", calls)
    x_packed = codec.decode_bytes(data, y_shape)
    assert calls == ["copy_staged"]  # one transfer, nothing unpacked
    host, caps = codec.pack(data, y_shape)
    y_packed = codec.decode_y_hat(codec.unpack(codec.copy_staged(host), caps),
                                  y_shape)
    streams = codec.from_bytes(data, y_shape)
    y_ref = codec.decode_y_hat(streams, y_shape)
    assert torch.equal(y_packed, y_ref) and torch.equal(y_ref, out["y_hat"])
    assert torch.equal(x_packed, codec.decode(streams, y_shape))
    unpacked = codec.unpack(codec.copy_staged(host), caps)
    for name in ("z", "y0", "y1"):
        for got, ref in zip(unpacked[name], streams[name]):
            assert got.dtype == ref.dtype and torch.equal(got, ref)


def test_overflow_file_takes_the_unpacked_path(models):
    """Random pixels through an untrained model code near 16 bits a symbol,
    far over a 1/8 cap: the bytes come from the uncapped encode, whose
    passes are longer than ``from_bytes``' capped length."""
    _, tm = models
    codec = TCodec(tm, lanes=LANES, cap_divisor=8)
    x = _images(1, 3)
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    cap_y = codec.stream_capacities(y_shape)[1]
    streams = codec.from_bytes(data, y_shape)
    assert streams["y0"].stream.shape[0] > cap_y  # an overflow file
    calls = []
    _counting(codec, "copy_staged", calls)
    x_hat = codec.decode_bytes(data, y_shape)
    assert calls == []
    assert torch.equal(x_hat, codec.decode(streams, y_shape))
    assert torch.equal(codec.decode_y_hat(streams, y_shape), out["y_hat"])
    # its own packed layout (the latency codec's) reads the same streams
    host, caps = codec.pack(data, y_shape)
    assert caps[1] == streams["y0"].stream.shape[0]
    for name, ps in codec.unpack(host.clone(), caps).items():
        assert all(torch.equal(a, b) for a, b in zip(ps, streams[name]))


@pytest.mark.parametrize("lanes,cap_divisor", [(64, 4), (128, 1), (1024, 4)])
def test_packed_layout_equals_jax(models, lanes, cap_divisor):
    jm, tm = models
    jc = JCodec(jm, lanes=lanes, cap_divisor=cap_divisor)
    tc = TCodec(tm, lanes=lanes, cap_divisor=cap_divisor)
    for y_shape in ((1, 4, 4, N), (2, 4, 4, N), (1, 48, 32, N),
                    (3, 8, 12, N)):
        offs, sizes, caps = jc._packed_layout(y_shape)
        cap_z, cap_y = tc.stream_capacities(y_shape)
        assert tuple(caps) == (cap_z, cap_y, cap_y)
        assert tc.packed_layout(caps) == (list(offs), list(sizes))


def test_jax_unpacks_the_ports_packed_buffer(models):
    jm, tm = models
    jc = JCodec(jm, lanes=LANES, cap_divisor=1)
    tc = TCodec(tm, lanes=LANES, cap_divisor=1)
    data, out = tc.encode_to_bytes(_images(2, 5))
    y_shape = tuple(out["y_hat"].shape)
    host, caps = tc.pack(data, y_shape)
    j_streams = jc._unpack_jit(jnp.asarray(host.numpy().view(np.uint32)),
                               y_shape)
    t_streams = tc.unpack(host.clone(), caps)
    for name, jp in zip(("z", "y0", "y1"), j_streams):
        tp = t_streams[name]
        np.testing.assert_array_equal(tp.states.numpy(),
                                      np.asarray(jp.states).astype(np.int64))
        np.testing.assert_array_equal(tp.stream.numpy(),
                                      np.asarray(jp.stream).astype(np.int32))
        assert int(tp.n_words) == int(jp.n_words)


def test_device_packing_equals_the_bytes_packing(models):
    _, tm = models
    codec = TCodec(tm, lanes=LANES, cap_divisor=1)
    with torch.inference_mode():
        ps_z, ps0, ps1, *_ = codec._encode(_images(1, 6), codec.cap_divisor)
    passes = {"z": ps_z, "y0": ps0, "y1": ps1}
    data = codec.to_bytes(passes)
    y_shape = (1, 4, 4, N)
    host, caps = codec.pack(data, y_shape)
    assert caps == tuple(p.stream.shape[0] for p in passes.values())
    assert torch.equal(codec.pack_device(tuple(passes.values())), host)
    # states above 2^31 keep their 32 bits through the int32 buffer
    assert int(torch.cat([p.states for p in passes.values()]).max()) >= 1 << 31


def test_latency_codec_reads_the_packed_layout(models):
    _, tm = models
    lat = TLatency(tm, lanes=LANES, cap_divisor=1)
    batched = TCodec(tm, lanes=LANES, cap_divisor=1)
    x = _images(1, 7)
    calls = []
    for name in ("from_bytes", "pack", "pack_device", "copy_staged"):
        _counting(lat._batched, name, calls)
    data, y_shape = lat.encode_certified(x)
    # the certificate: the encoder's streams packed on the device, into
    # the decode-y function that decode runs
    assert calls == ["pack_device"] and not lat._fallback_digests
    b_data, out = batched.encode_to_bytes(x)
    assert data == b_data
    del calls[:]
    x_hat = lat.decode(data, y_shape)
    assert calls == ["pack"]  # on the CPU the staged buffer is read in place
    assert torch.equal(x_hat, batched.decode_bytes(data, y_shape))
    assert torch.equal(lat._decode_y(lat._passes(lat.from_bytes(data, y_shape)),
                                     y_shape), out["y_hat"])

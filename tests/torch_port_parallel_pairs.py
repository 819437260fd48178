"""What the two files of the mesh tests share
(tests/test_torch_port_parallel.py, tests/test_torch_port_parallel_elic.py):
the JAX twins of the port's models, built without running their
constructors, and one batch coded on one device, on the mesh and by JAX's
``use_mesh``, with the checks each codec's tests make of it."""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from flashgmm_tpu import parallel as jpar
from flashgmm_tpu_torch.zoo import load_npz, save_npz_weights

LANES = 64
ATOL_JAX = 2e-4  # the forward parity tests' (test_torch_port_forward.py)


def images(b, h, w, seed):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def jax_twin(ctor, tm, path):
    """The JAX model of ``ctor``'s structure carrying ``tm``'s weights
    (rounded to float16 in both, as the .npz stores them): ``nnx.eval_shape``
    gives the structure (running a JAX constructor costs 20-50 s of eager
    compiles here), the port's weights written as the repository's .npz
    fill its parameters, the masks and targets come from the port's
    buffers, the tables ``update()`` fills stay empty."""
    save_npz_weights(tm, path)
    load_npz(tm, path)
    data = np.load(path)
    graphdef, state = nnx.split(nnx.eval_shape(ctor))
    flat = nnx.to_flat_state(state)
    for p, v in flat:
        key = "/".join(str(k) for k in p)
        value = v.get_value()
        if key in data:
            v.set_value(jnp.asarray(data[key].astype(np.float32)))
        elif p[-1] in ("mask", "target"):
            buf = tm.get_buffer(".".join(str(k) for k in p)).numpy()
            if p[-1] == "mask":  # OIHW [1, 1, kh, kw] -> [kh, kw, 1, 1]
                buf = buf[0, 0][:, :, None, None]
            v.set_value(jnp.asarray(buf.astype(value.dtype)))
        else:
            assert 0 in value.shape, key
            v.set_value(jnp.zeros(value.shape, value.dtype))
    return nnx.merge(graphdef, nnx.from_flat_state(flat))


def updated(jm, tm):
    """tm's ``update(update_quantiles=True)`` (the port's tables equal
    JAX's own: tests/test_torch_port_codec.py), and its EntropyBottleneck's
    quantiles and tables given to jm's: (jm, tm)."""
    tm.update(update_quantiles=True)
    teb = tm.latent_codec.latent_codec["hyper"].entropy_bottleneck
    jeb = jm.latent_codec["hyper"].entropy_bottleneck
    jeb.quantiles.set_value(jnp.asarray(teb.quantiles.detach().numpy()))
    for name in ("offset", "quantized_cdf", "cdf_length"):
        getattr(jeb, f"_{name}").set_value(jnp.asarray(
            getattr(teb, name).numpy().astype(np.int32)))
    return jm, tm


def flagship_pair(path):
    """(JAX, port) flagship at N=64, K=4, updated."""
    from flashgmm_tpu.models.ckbd_gmm import \
        Cheng2020AnchorCheckerboardGMMv2 as JModel
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2

    tm = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, device="cpu")
    return updated(jax_twin(lambda: JModel(N=64, K=4, rngs=nnx.Rngs(0)),
                            tm, path), tm)


def codec_pair(kind, path, flagship=None):
    """(port model, JAX model, port codec class, JAX codec class) of
    ``kind``: "gmm" (the flagship pair given), "gsm" (N=32) or "elic"."""
    from flashgmm_tpu import runtime as jrt
    from flashgmm_tpu_torch import runtime as trt

    if kind == "gmm":
        jm, tm = flagship
        return (tm, jm, trt.FastCheckerboardGmmCodec,
                jrt.FastCheckerboardGmmCodec)
    if kind == "gsm":
        from flashgmm_tpu.models.sensetime import \
            Cheng2020AnchorCheckerboard as JModel
        from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboard

        tm = Cheng2020AnchorCheckerboard(N=32, device="cpu")
        jm, tm = updated(jax_twin(lambda: JModel(N=32, rngs=nnx.Rngs(0)),
                                  tm, path), tm)
        return (tm, jm, trt.FastCheckerboardGsmCodec,
                jrt.FastCheckerboardGsmCodec)
    from flashgmm_tpu.models.elic_gmm import Elic2022GMM as JElic
    from flashgmm_tpu_torch.models import Elic2022GMM

    groups = [8, 8, 16, 16, 16]
    tm = Elic2022GMM(N=32, M=64, K=2, groups=groups, device="cpu")
    jm, tm = updated(jax_twin(lambda: JElic(N=32, M=64, K=2, groups=groups,
                                            rngs=nnx.Rngs(0)), tm, path), tm)
    return tm, jm, trt.FastElicGmmCodec, jrt.FastElicGmmCodec


def code_batch(pair, cpu_mesh):
    """Eight 64x64 images coded on one device, on the 8-slot mesh and on
    it with portable=False, and by JAX's codec on its 8-device mesh."""
    tm, jm, codec_cls, jcodec_cls = pair
    x = images(8, 64, 64, 3)
    codec = codec_cls(tm, lanes=LANES, cap_divisor=1, bf16_transforms=False)
    one = codec.encode_to_bytes(torch.from_numpy(x))
    codec.use_mesh(cpu_mesh)
    mesh = codec.encode_to_bytes(torch.from_numpy(x))
    spmd = codec_cls(tm, lanes=LANES, cap_divisor=1, bf16_transforms=False)
    spmd.use_mesh(cpu_mesh, portable=False)
    jcodec = jcodec_cls(jm, lanes=LANES, cap_divisor=1, bf16_transforms=False)
    jcodec.use_mesh(jpar.make_mesh(8))
    return {"codec": codec, "spmd": spmd, "cpu_mesh": cpu_mesh,
            "one": one, "mesh": mesh,
            "nonportable": spmd.encode_to_bytes(torch.from_numpy(x)),
            "jax_y_hat": np.asarray(jcodec.encode(jnp.asarray(x))["y_hat"])}


def _y_shape(out):
    return tuple(out["y_hat"].shape)


def _z_stream(out):
    return out["streams"][0] if "streams" in out else out["z"]


def check_mesh_encode_equals_one_device(coded):
    """The mesh's bytes are the one device's: y_hat and the z stream too."""
    (d1, o1), (dm, om) = coded["one"], coded["mesh"]
    assert torch.equal(om["y_hat"], o1["y_hat"])
    z1, zm = _z_stream(o1), _z_stream(om)
    assert int(zm.n_words) == int(z1.n_words)
    assert torch.equal(zm.stream, z1.stream)
    assert dm == d1


def check_mesh_round_trip_exact(coded):
    """The mesh's bytes decode on the mesh to the encoder's y_hat; the
    images are g_s of each slot's share (one image here), bit for bit,
    within float32 ulps of the whole batch's g_s (the library's convs sum
    in another order at batch 8: measured at most 1.7e-5 apart, torch 2.13
    CPU; bound 1e-4)."""
    codec, (dm, om) = coded["codec"], coded["mesh"]
    y_shape = _y_shape(om)
    y_dec = codec.decode_y_hat(codec.from_bytes(dm, y_shape), y_shape)
    assert torch.equal(y_dec, om["y_hat"])
    x_hat = codec.decode_bytes(dm, y_shape)
    ref = torch.cat([torch.clamp(codec._transform(codec._g_s, y[None]), 0, 1)
                     for y in om["y_hat"]])
    assert x_hat.shape == (8, 64, 64, 3) and torch.equal(x_hat, ref)
    whole = torch.clamp(codec._transform(codec._g_s, om["y_hat"]), 0, 1)
    torch.testing.assert_close(x_hat, whole, rtol=0, atol=1e-4)


def check_streams_cross_topologies(coded):
    """A one-device stream decodes on the mesh; the mesh's stream decodes
    on one device (the codec off the mesh again)."""
    codec = coded["codec"]
    (d1, o1), (dm, om) = coded["one"], coded["mesh"]
    y_shape = _y_shape(o1)
    assert torch.equal(codec.decode_y_hat(codec.from_bytes(d1, y_shape),
                                          y_shape), o1["y_hat"])
    codec.use_mesh(None)
    try:
        assert torch.equal(codec.decode_y_hat(codec.from_bytes(dm, y_shape),
                                              y_shape), om["y_hat"])
    finally:
        codec.use_mesh(coded["cpu_mesh"])


def check_nonportable_round_trip_exact(coded):
    """portable=False round-trips on its mesh; its bytes are the one
    device's too (the f32 rows-chain conv is batch-invariant)."""
    spmd, (dn, on) = coded["spmd"], coded["nonportable"]
    y_shape = _y_shape(on)
    assert torch.equal(spmd.decode_y_hat(spmd.from_bytes(dn, y_shape),
                                         y_shape), on["y_hat"])
    assert dn == coded["one"][0]


def check_mesh_y_hat_against_jax(coded):
    """y_hat of the port's mesh encode against JAX's use_mesh on the same
    images: g_a sums in another order than XLA's convs, so a latent near a
    rounding boundary may round the other way (GSM's symbols are
    mean-centred, its y_hat elsewhere off by the means' float32 ulps).
    Bound: the single-device parity tests' 1 % of symbols, one step at
    most (ROADMAP C2)."""
    got = coded["mesh"][1]["y_hat"].numpy()
    d = np.abs(got - coded["jax_y_hat"])
    assert int((d > 0.5).sum()) <= 0.01 * d.size, int((d > 0.5).sum())
    assert float(d.max()) <= 1 + ATOL_JAX
    assert float(d[d <= 0.5].max(initial=0)) <= ATOL_JAX

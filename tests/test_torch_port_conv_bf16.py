"""The bf16 route of the conv kernel, and the transforms that take it,
against the JAX package on the CPU.

- Kernel module: ``conv2d_nhwc_bf16_plain`` and the wrapper on CPU tensors
  (which runs that plain version) against the TPU kernel's bf16 route,
  ``conv2d_nhwc_pallas(..., interpret=True, compute_dtype=jnp.bfloat16)``,
  on the same numpy inputs. Both round x and w to bf16 and accumulate in
  float32 in different orders, so a bf16 result may differ by one bf16
  ulp: |port - jax| <= 2**-7 * |jax| + 1e-3 * max|jax|; an f32 result
  within 1e-5 of max|jax| (the JAX package's own bound for its kernel,
  tests/test_pallas_conv.py).
- Slice, N=64, K=4 (the narrowest width the channel rule routes), 64x64
  images: the codec's bf16 snapshots of g_a, h_a and g_s with
  ``kernel_transforms=True`` against JAX's ``apply_transform(mod, x,
  bf16=True)`` under jit, as the reference codec runs it, on the same
  weights (the port's, from its seed). The port fuses LeakyReLU and the
  residual add into the conv's epilogue and rounds once where the
  reference rounds after each op, so the two differ by bf16 roundings:
  their gap (max and mean |d|) is held to at most 1.5x the gap between
  JAX's own bf16 and f32 transforms on the same input.
- The codec round trip with ``kernel_transforms=True`` keeps y_hat exact
  and routes 26 convs per encode + decode.
- chip_smoke.py's spill check reads each function's spill counts from the
  ``-Xptxas -v`` lines the build keeps.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.ops.pallas_conv import conv2d_nhwc_pallas
from flashgmm_tpu.runtime.fast_codec import apply_transform
from flashgmm_tpu_torch.layers import route_bf16_kernel
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.ops import conv_kernel
from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec as TCodec

torch.set_num_threads(2)

BF16_RTOL, BF16_ATOL, F32_REL = 2.0 ** -7, 1e-3, 1e-5
N, K = 64, 4


def _close(port, ref, out_dtype):
    """Tolerance of the bf16 route (module docstring); returns the share
    of outputs that differ at all."""
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    d = np.abs(port - ref)
    top = float(np.abs(ref).max())
    if out_dtype == torch.bfloat16:
        assert (d <= BF16_ATOL * top + BF16_RTOL * np.abs(ref)).all(), \
            float(d.max())
    else:
        assert float(d.max()) < F32_REL * top, float(d.max()) / top
    return float((d > 0).mean())


def _case(n, h, w, c_in, c_out, k, res, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, c_in).astype(np.float32)
    wt = (rs.randn(k, k, c_in, c_out) * 0.05).astype(np.float32)
    b = rs.randn(c_out).astype(np.float32)
    r = rs.randn(n, h, w, c_out).astype(np.float32) if res else None
    return x, wt, b, r


# (c_in, c_out, k, leaky, residual, out dtype): each epilogue, both outputs,
# C 64 and 128, K 1, 3 and 5, and one C_out = 8 * C_in (the fused subpel conv)
@pytest.mark.parametrize("c_in,c_out,k,leaky,res,out_dtype", [
    (64, 64, 3, False, False, torch.bfloat16),
    (64, 64, 1, True, False, torch.bfloat16),
    (64, 128, 5, True, True, torch.bfloat16),
    (128, 64, 3, True, True, torch.float32),
    (128, 128, 1, False, False, torch.float32),
    (128, 64, 5, True, False, torch.bfloat16),
    (64, 512, 3, False, False, torch.bfloat16),
])
def test_bf16_route_matches_the_tpu_kernel(c_in, c_out, k, leaky, res,
                                           out_dtype):
    x, wt, b, r = _case(2, 8, 8, c_in, c_out, k, res, seed=c_in + c_out + k)
    # the residual reaches the kernels in bf16, as a block's identity does
    r16 = None if r is None else torch.from_numpy(r).to(torch.bfloat16)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[out_dtype]
    ref = conv2d_nhwc_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
        activation="leaky_relu" if leaky else None,
        residual=None if r16 is None else jnp.asarray(
            r16.float().numpy()).astype(jnp.bfloat16),
        out_dtype=jdt, interpret=True, compute_dtype=jnp.bfloat16)
    kw = dict(negative_slope=0.01 if leaky else None, residual=r16,
              out_dtype=out_dtype)
    args = (torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b))
    plain = conv_kernel.conv2d_nhwc_bf16_plain(*args, **kw)
    before = conv_kernel.conv2d_nhwc_bf16.launches
    got = conv_kernel.conv2d_nhwc_bf16(*args, **kw)
    assert conv_kernel.conv2d_nhwc_bf16.launches == before  # no launch on CPU
    assert got.dtype == out_dtype and torch.equal(got, plain)
    _close(plain.float().numpy(), np.asarray(ref.astype(jnp.float32)),
           out_dtype)


def test_bf16_plain_rounds_its_inputs_to_bf16():
    """float32 x and w are rounded to bf16 first (the TPU kernel's cast to
    its compute dtype): the same result as bf16 inputs."""
    x, wt, b, _ = _case(1, 5, 7, 64, 64, 3, False, seed=3)
    x, wt, b = map(torch.from_numpy, (x, wt, b))
    a = conv_kernel.conv2d_nhwc_bf16(x, wt, b)
    c = conv_kernel.conv2d_nhwc_bf16(x.bfloat16(), wt.bfloat16(), b)
    assert torch.equal(a, c)


@pytest.mark.parametrize("bad", ["c_in", "c_out", "even_k", "big_k",
                                 "mismatch", "bias", "residual", "rank"])
def test_bf16_wrapper_refuses_bad_shapes(bad):
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    kw = {}
    if bad == "c_in":
        x, w = x[..., :60], w[:, :, :60]
    elif bad == "c_out":
        w = w[..., :60]
    elif bad == "even_k":
        w = torch.zeros(2, 2, 64, 64, dtype=torch.bfloat16)
    elif bad == "big_k":
        w = torch.zeros(9, 9, 64, 64, dtype=torch.bfloat16)
    elif bad == "mismatch":
        w = torch.zeros(3, 3, 72, 64, dtype=torch.bfloat16)
    elif bad == "bias":
        kw["b"] = torch.zeros(63)
    elif bad == "residual":
        kw["residual"] = torch.zeros(1, 4, 5, 64)
    else:
        x = x[0]
    with pytest.raises(ValueError):
        conv_kernel.conv2d_nhwc_bf16(x, w, **kw)


@pytest.mark.parametrize("bad", ["x", "w", "residual", "bias", "out"])
def test_bf16_wrapper_refuses_bad_dtypes(bad):
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    kw = {}
    if bad == "x":
        x = x.half()
    elif bad == "w":
        w = w.double()
    elif bad == "residual":
        kw["residual"] = torch.zeros(1, 4, 4, 64, dtype=torch.int32)
    elif bad == "bias":
        kw["b"] = torch.zeros(64, dtype=torch.int64)
    else:
        kw["out_dtype"] = torch.float16
    with pytest.raises(TypeError):
        conv_kernel.conv2d_nhwc_bf16(x, w, **kw)


# (K, C_in, C_out): the kernel's tap counts, C_in of 8 and not a multiple
# of 64, C_out below, at and above one 192-wide n-tile
@pytest.mark.parametrize("k,c_in,c_out", [
    (1, 64, 8), (3, 192, 192), (3, 192, 1536), (5, 72, 136), (7, 8, 64)])
def test_packed_weights_unpack_to_hwio_and_compute_the_same(k, c_in, c_out):
    """pack_bf16_weight puts HWIO weights in the kernel's [K*K, C_out, C_in]
    layout: .hwio() gives the bf16 weights back exactly, every entry sits
    where the kernel reads it, and the wrapper (the plain version here)
    computes the same bits from either form."""
    x, wt, b, r = _case(1, 5, 9, c_in, c_out, k, True, seed=k + c_in + c_out)
    w = torch.from_numpy(wt)
    packed = conv_kernel.pack_bf16_weight(w)
    kio = packed.kio
    assert kio.shape == (k * k, c_out, c_in) and kio.is_contiguous()
    assert kio.dtype == torch.bfloat16
    assert (packed.k, packed.c_in, packed.c_out) == (k, c_in, c_out)
    assert packed.shape == w.shape
    assert torch.equal(packed.hwio(), w.to(torch.bfloat16))
    rs = np.random.RandomState(k)
    for _ in range(20):
        dy, dx, ci, co = (rs.randint(k), rs.randint(k), rs.randint(c_in),
                          rs.randint(c_out))
        assert kio[dy * k + dx, co, ci] == w[dy, dx, ci, co].to(torch.bfloat16)
    # packing bf16 weights or their float32 originals gives the same bits
    assert torch.equal(conv_kernel.pack_bf16_weight(w.bfloat16()).kio, kio)
    kw = dict(negative_slope=0.01,
              residual=torch.from_numpy(r).to(torch.bfloat16))
    args = (torch.from_numpy(x), torch.from_numpy(b))
    want = conv_kernel.conv2d_nhwc_bf16_plain(args[0], w, args[1], **kw)
    assert torch.equal(conv_kernel.conv2d_nhwc_bf16(args[0], packed, args[1],
                                                    **kw), want)
    assert torch.equal(conv_kernel.conv2d_nhwc_bf16(args[0], w, args[1], **kw),
                       want)
    assert torch.equal(conv_kernel.conv2d_nhwc_bf16_plain(
        args[0], packed, args[1], **kw), want)


@pytest.mark.parametrize("bad", ["f32_kio", "taps", "c_in", "rank", "list",
                                 "pack_rank", "pack_square"])
def test_bf16_wrapper_refuses_bad_packed_weights(bad):
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    packed = conv_kernel.pack_bf16_weight(w)
    error = ValueError
    if bad == "f32_kio":  # the kernel reads bf16 only
        arg = conv_kernel.PackedBf16Weight(packed.kio.float())
        error = TypeError
    elif bad == "taps":  # 8 taps are no square K
        arg = conv_kernel.PackedBf16Weight(packed.kio[:8])
    elif bad == "c_in":  # C_in of the weights is not x's
        arg = conv_kernel.pack_bf16_weight(w[:, :, :56])
    elif bad == "rank":
        arg = conv_kernel.PackedBf16Weight(packed.kio[0])
    elif bad == "list":
        arg = w.tolist()
    elif bad == "pack_rank":
        with pytest.raises(ValueError):
            conv_kernel.pack_bf16_weight(w[0])
        return
    else:
        with pytest.raises(ValueError):
            conv_kernel.pack_bf16_weight(w[:2])
        return
    with pytest.raises(error):
        conv_kernel.conv2d_nhwc_bf16(x, arg)


def test_bf16_route_rule():
    """The reference's channel rule and the kernel's shape rule: what the
    N=192 transforms route, and what stays on the library."""
    takes = conv_kernel.bf16_route_takes
    assert takes(192, 192, (3, 3), (1, 1), (1, 1))  # 3x3 192 -> 192
    assert takes(192, 1536, (3, 3), (1, 1), (1, 1))  # g_s's fused subpel conv
    assert not takes(192, 192, (3, 3), (2, 2), (1, 1))  # stride 2
    assert not takes(3, 192, (3, 3), (1, 1), (1, 1))  # g_a's first conv
    assert not takes(192, 12, (3, 3), (1, 1), (1, 1))  # g_s's last subpel conv
    assert not takes(192, 192, (1, 1), (2, 2), (0, 0))  # the 1x1 skips
    assert not takes(192, 192, (3, 3), (1, 1), (0, 0))  # not "same"
    assert not takes(192, 192, (4, 4), (1, 1), (2, 2))  # even K
    assert not takes(192, 192, (9, 9), (1, 1), (4, 4))  # K above 7
    assert not takes(100, 192, (3, 3), (1, 1), (1, 1))  # C_in not a multiple of 8
    assert takes(64, 64, (1, 1), (1, 1), (0, 0))


@pytest.fixture(scope="module")
def models():
    """The port's model from its own seed, and the JAX model carrying the
    same transform weights (built abstractly: only the transforms are
    filled in, which is all these tests run of it)."""
    tm = TModel(N=N, K=K, seed=0, device="cpu")
    tm.update()
    values = {}
    for key, v in tm.state_dict().items():
        parts, a = key.split("."), v.detach().numpy()
        if parts[-1] == "weight" and a.ndim == 4:
            parts[-1], a = "kernel", a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        values["/".join(parts)] = a
    graphdef, state = nnx.split(nnx.eval_shape(
        lambda: JModel(N=N, K=K, rngs=nnx.Rngs(0))))
    for path, leaf in nnx.to_flat_state(state):
        key = "/".join(map(str, path))
        if key.split("/")[0] in ("g_a", "g_s") or "/h_a/" in key:
            leaf.set_value(jnp.asarray(values[key]))
    return nnx.merge(graphdef, state), tm


def _jax_transform(mod, x, bf16):
    """JAX's transform as the reference codec runs it: inside a jit."""
    return np.asarray(jax.jit(lambda v: apply_transform(mod, v, bf16))(
        jnp.asarray(x)))


def _gap(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(d.mean())


def test_routed_transforms_match_jax_bf16(models, monkeypatch):
    """g_a, h_a and g_s of the kernel route against JAX's bf16 transforms,
    within 1.5x JAX's own bf16-vs-f32 gap; each routes the convs it must."""
    jm, tm = models
    codec = TCodec(tm, lanes=64, cap_divisor=1, kernel_transforms=True)
    counts = []
    orig = conv_kernel.conv2d_nhwc_bf16

    def counting(*args, **kwargs):
        counts[-1] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(conv_kernel, "conv2d_nhwc_bf16", counting)
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    y32 = _jax_transform(jm.g_a, x, bf16=False)
    y_hat = np.round(y32)
    h_a = jm.latent_codec["hyper"].h_a
    cases = [("g_a", jm.g_a, codec._g_a, x, 9),
             ("h_a", h_a, codec._h_a, y32, 3),
             ("g_s", jm.g_s, codec._g_s, y_hat, 14)]
    for name, jmod, tmod, inp, n_routed in cases:
        j16 = _jax_transform(jmod, inp, bf16=True)
        j32 = _jax_transform(jmod, inp, bf16=False)
        counts.append(0)
        with torch.no_grad():
            port = codec._transform(tmod, torch.from_numpy(inp.copy())).numpy()
        assert counts[-1] == n_routed, (name, counts[-1])
        assert port.shape == j16.shape and np.isfinite(port).all()
        own, port_gap = _gap(j16, j32), _gap(port, j16)
        assert port_gap[0] <= 1.5 * own[0], (name, port_gap, own)
        assert port_gap[1] <= 1.5 * own[1], (name, port_gap, own)


def test_route_marks_only_what_the_rule_takes(models, monkeypatch):
    """route_bf16_kernel on a float32 transform: the rule's convs are
    marked, and a marked conv takes the kernel whatever its input's float
    type (float32 is rounded to bf16, as the TPU kernel casts to its
    compute dtype; the result is bf16); unmarked convs keep the library."""
    _, tm = models
    import copy

    g_s = route_bf16_kernel(copy.deepcopy(tm.g_s))
    rb, rbu = g_s.layers[0], g_s.layers[1]
    assert rb.conv1.kernel_route and rb.conv2.kernel_route
    assert rbu.kernel_route and rbu.conv.kernel_route
    # the routed convs hold their weights packed once, in the kernel's layout
    assert isinstance(rb.conv1._kernel_w, conv_kernel.PackedBf16Weight)
    assert torch.equal(rb.conv1._kernel_w.hwio(),
                       rb.conv1.kernel_hwio().to(torch.bfloat16))
    c1, c2 = rbu.subpel_conv.layers[0], rbu.upsample.layers[0]
    assert torch.equal(rbu._kernel_w.hwio(), torch.cat(
        [c1.kernel_hwio(), c2.kernel_hwio()], -1).to(torch.bfloat16))
    last = g_s.layers[-1].layers[0]
    assert not last.kernel_route  # C_out = 12
    calls = []
    orig = conv_kernel.conv2d_nhwc_bf16

    def counting(*args, **kwargs):
        calls.append(args[0].dtype)
        return orig(*args, **kwargs)

    monkeypatch.setattr(conv_kernel, "conv2d_nhwc_bf16", counting)
    y = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 4, N)
                         .astype(np.float32))
    plain = conv_kernel.conv2d_nhwc_bf16_plain
    with torch.no_grad():
        got = rb(y)
        want = plain(plain(y, rb.conv1._kernel_w, rb.conv1._kernel_b,
                           negative_slope=0.01),
                     rb.conv2._kernel_w, rb.conv2._kernel_b,
                     negative_slope=0.01, residual=y)
        assert calls == [torch.float32, torch.bfloat16]
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        torch.testing.assert_close(last(y), tm.g_s.layers[-1].layers[0](y),
                                   rtol=0, atol=0)
        assert len(calls) == 2
    with pytest.raises(ValueError):
        TCodec(tm, bf16_transforms=False, kernel_transforms=True)


def test_codec_roundtrip_with_kernel_transforms(models, monkeypatch):
    _, tm = models
    codec = TCodec(tm, lanes=64, cap_divisor=1, kernel_transforms=True)
    calls = []
    orig = conv_kernel.conv2d_nhwc_bf16

    def recording(*args, **kwargs):
        calls.append(tuple(args[1].shape))
        return orig(*args, **kwargs)

    monkeypatch.setattr(conv_kernel, "conv2d_nhwc_bf16", recording)
    x = torch.from_numpy(np.random.RandomState(4).rand(1, 64, 64, 3)
                         .astype(np.float32))
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    y_dec = codec.decode_y_hat(codec.from_bytes(data, y_shape), y_shape)
    torch.testing.assert_close(y_dec, out["y_hat"], rtol=0, atol=0)
    x_hat = codec.decode_bytes(data, y_shape)
    assert x_hat.shape == x.shape and bool(torch.isfinite(x_hat).all())
    # g_a 9 + h_a 3 + g_s 11 convs 3x3 64 -> 64, and g_s's 3 fused subpel
    # convs 64 -> 512
    assert len(calls) == 26
    assert calls.count((3, 3, N, N)) == 23
    assert calls.count((3, 3, N, 8 * N)) == 3


def test_smoke_reads_each_functions_spills_from_ptxas_lines():
    """ptxas prints a function's spill counts on the line after its
    "Function properties" line, a line without "ptxas" in it."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lines = [
        "ptxas info    : Compiling entry function '_Zbf16' for 'sm_90a'",
        "ptxas info    : Function properties for _Zbf16",
        "40 bytes stack frame, 40 bytes spill stores, 488 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Function properties for _Zf32",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Function properties for _Znone",
        "ptxas info    : Used 32 registers, used 0 barriers",
    ]
    assert smoke.ptxas_spills(lines) == {"_Zbf16": (40, 488),
                                         "_Zf32": (0, 0)}

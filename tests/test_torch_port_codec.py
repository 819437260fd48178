"""The port's batched checkerboard-GMM codec against the JAX package's, at
N=32, K=2 (the flagship model cut to narrow widths), on the CPU.

What is exact and what is held to a tolerance:
- EntropyBottleneck integer tables (quantized_cdf, offset, cdf_length):
  EXACT when the port is fed JAX's quantiles, and the port's own quantile
  bisection lands on JAX's quantiles exactly too (the density MLP is XLA's
  CPU arithmetic written out, see flashgmm_tpu_torch/entropy_models/
  xla_math.py).
- The port's own encode -> bytes -> decode: y_hat EXACT, batch 1 and 2.
- The y passes' per-symbol bounds and on-demand decoder give the same
  bytes and symbols as the full-rows path (rows, gather, rows decoder).
- Handed JAX's rows, the port's decoder reads JAX's streams to JAX's
  symbols EXACTLY (same coder, same format).
- Float transforms: g_a, h_s (rows-chain path) and g_s against JAX within
  atol 2e-4 (float32 conv chains summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.runtime import FastCheckerboardGmmCodec as JCodec
from flashgmm_tpu_torch.layers import run_canonical
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec as TCodec
from flashgmm_tpu_torch.runtime import StreamOverflow
from flashgmm_tpu_torch.runtime.fast_codec import (PassStream, _decode_pass,
                                                   _encode_pass)
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

N, K, LANES = 32, 2, 64
ATOL = 2e-4


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


@pytest.fixture(scope="module")
def models():
    jm = JModel(N=N, K=K, rngs=nnx.Rngs(0))
    pre = jax_params(jm)
    jm.update(update_quantiles=True)
    tm = TModel(N=N, K=K, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update()
    return jm, pre, tm


def _eb(tm):
    return tm.latent_codec.latent_codec["hyper"].entropy_bottleneck


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def test_eb_tables_exact_from_jax_quantiles(models):
    jm, _, tm = models
    jeb = jm.latent_codec["hyper"].entropy_bottleneck
    teb = _eb(tm)
    for name in ("quantized_cdf", "offset", "cdf_length"):
        np.testing.assert_array_equal(getattr(teb, name).numpy(),
                                      np.asarray(getattr(jeb, name)))


def test_eb_own_quantile_bisection_matches_jax(models):
    jm, pre, _ = models
    tm = TModel(N=N, K=K, device="cpu")
    tm.load_state_dict(load_jax_params(pre, tm), strict=True)
    tm.update(update_quantiles=True)
    jeb = jm.latent_codec["hyper"].entropy_bottleneck
    np.testing.assert_array_equal(_eb(tm).quantiles.detach().numpy(),
                                  np.asarray(jeb.quantiles.get_value()))
    np.testing.assert_array_equal(_eb(tm).quantized_cdf.numpy(),
                                  np.asarray(jeb.quantized_cdf))


def test_npz_loader_reads_the_repo_format(models, tmp_path):
    """weights/*.npz store the JAX parameters as float16 under nnx paths."""
    from flashgmm_tpu_torch.zoo import load_npz

    jm, _, _ = models
    path = tmp_path / "w.npz"
    np.savez(path, **{k: v.astype(np.float16) for k, v in jax_params(jm).items()})
    tm = TModel(N=N, K=K, device="cpu")
    n = load_npz(tm, path)
    assert n == len(jax_params(jm))
    w = tm.g_a.layers[0].conv1.weight.detach().numpy()
    ref = jax_params(jm)["g_a/layers/0/conv1/kernel"].astype(np.float16)
    np.testing.assert_array_equal(w, ref.astype(np.float32).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("batch", [1, 2])
def test_port_roundtrip_exact(models, batch):
    _, _, tm = models
    codec = TCodec(tm, lanes=LANES, cap_divisor=1, bf16_transforms=False)
    x = torch.from_numpy(_images(batch, 10 + batch))
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    assert len(data) == codec.num_bytes(out) + 12
    y_dec = codec.decode_y_hat(codec.from_bytes(data, y_shape), y_shape)
    torch.testing.assert_close(y_dec, out["y_hat"], rtol=0, atol=0)
    x_hat = codec.decode_bytes(data, y_shape)
    assert x_hat.shape == x.shape and bool(torch.isfinite(x_hat).all())
    ref = torch.clamp(codec._transform(codec._g_s, out["y_hat"]), 0, 1)
    torch.testing.assert_close(x_hat, ref, rtol=0, atol=0)


def test_bounds_path_equals_full_rows_path(models):
    """The codec's y passes never build rows. Encoding each pass from a
    gather of the full rows instead, and decoding it over those rows, must
    give the same stream and the same symbols."""
    from flashgmm_tpu_torch.ans.gaussian_cdf import gmm_guarded_rows

    _, _, tm = models
    codec = TCodec(tm, lanes=LANES, cap_divisor=1, bf16_transforms=False)
    x = torch.from_numpy(_images(2, 21))
    with torch.no_grad():
        out = codec.encode(x)
        y = codec._transform(codec._g_a, x)
        sym = torch.clamp(torch.round(codec._ckbd.unembed(y)).to(torch.int32),
                          -codec.max_abs, codec.max_abs)
        z = codec._transform(codec._h_a, y)
        z_bin = torch.round(z - codec._med).to(torch.int32) - codec._z_off
        z_bin = torch.minimum(torch.clamp_min(z_bin, 0), codec._z_maxbin)
        side = codec._side(z_bin)
        lo, num_bins = codec._lo_bins()
        passes = (("y0", codec._params0(side[0]), sym[0]),
                  ("y1", codec._params1(side[1], sym[0]), sym[1]))
        for name, params, s in passes:
            rows = gmm_guarded_rows(*params, lo, num_bins, codec.mode)
            j = (s.reshape(-1).long() - lo)[:, None]
            start = rows.gather(1, j)[:, 0]
            freq = rows.gather(1, j + 1)[:, 0] - start
            ps = _encode_pass(start, freq, LANES, 1)
            got = out[name]
            assert torch.equal(ps.states, got.states)
            assert int(ps.n_words) == int(got.n_words)
            assert torch.equal(ps.stream, got.stream)
            n = s.numel()
            by_rows = _decode_pass(got, rows, n, lo, LANES)
            assert torch.equal(codec._decpass(got, params, n), by_rows)
            assert torch.equal(by_rows, s.reshape(-1))


def test_capped_encode_falls_back_on_overflow(models):
    """Random pixels through an untrained model code near 16 bits/symbol,
    far over a 1/8 cap: to_bytes raises and encode_to_bytes re-encodes
    uncapped; the overflow bytes still decode exactly."""
    _, _, tm = models
    codec = TCodec(tm, lanes=LANES, cap_divisor=8, bf16_transforms=False)
    x = torch.from_numpy(_images(1, 3))
    with pytest.raises(StreamOverflow):
        codec.to_bytes(codec.encode(x))
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    y_dec = codec.decode_y_hat(codec.from_bytes(data, y_shape), y_shape)
    torch.testing.assert_close(y_dec, out["y_hat"], rtol=0, atol=0)


def test_port_decoder_reads_jax_streams_with_jax_rows(models):
    jm, _, _ = models
    jc = JCodec(jm, lanes=LANES, cap_divisor=1)
    x = jnp.asarray(_images(2, 5))
    ps_z, z_bin, sym0, sym1, _ = jc._analyze_jit(jc._state, x, 1)
    side = jc._side_jit(jc._state, z_bin)
    rows0 = jc._rows0_jit(jc._state, side[0])
    rows1 = jc._rows1_jit(jc._state, side[1], sym0)
    ps0 = jc._encpass_jit(rows0, sym0.reshape(-1), 1)
    ps1 = jc._encpass_jit(rows1, sym1.reshape(-1), 1)

    def port(ps):
        return PassStream(torch.from_numpy(np.asarray(ps.states).astype(np.int64)),
                          torch.from_numpy(np.asarray(ps.stream).astype(np.int32)),
                          torch.tensor(int(ps.n_words)))

    eb = jm.latent_codec["hyper"].entropy_bottleneck
    z_rows, _, _ = jc._z_tables(eb)
    n_z = int(np.prod(z_bin.shape))
    rows_z = np.asarray(jc._z_rows_per_sym(z_rows, n_z // z_bin.shape[-1]))
    got_z = _decode_pass(port(ps_z), torch.from_numpy(rows_z), n_z, 0, LANES)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(z_bin).reshape(-1))
    for ps, rows, sym in ((ps0, rows0, sym0), (ps1, rows1, sym1)):
        n = int(np.prod(sym.shape))
        got = _decode_pass(port(ps), torch.from_numpy(np.array(rows)), n, -48,
                           LANES)
        np.testing.assert_array_equal(got.numpy(), np.asarray(sym).reshape(-1))


def test_transforms_match_jax(models):
    """The slice's float stages on the same weights: g_a, the rows-chain h_s
    (conv kernel path; its plain version here) and g_s."""
    jm, _, tm = models
    x = _images(2, 7)
    with torch.no_grad():
        y = tm.g_a(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y, np.asarray(jm.g_a(jnp.asarray(x))),
                                   rtol=0, atol=ATOL)
        z_hat = np.round(np.random.RandomState(8).randn(2, 4, 4, N) * 3)
        z_hat = z_hat.astype(np.float32)
        h_s = tm.latent_codec.latent_codec["hyper"].h_s
        side = run_canonical(h_s, torch.from_numpy(z_hat)).numpy()
        ref = np.asarray(jm.latent_codec["hyper"].h_s(jnp.asarray(z_hat)))
        np.testing.assert_allclose(side, ref, rtol=0, atol=ATOL)
        y_hat = np.round(y)
        x_hat = tm.g_s(torch.from_numpy(y_hat)).numpy()
        np.testing.assert_allclose(x_hat, np.asarray(jm.g_s(jnp.asarray(y_hat))),
                                   rtol=0, atol=ATOL)


def test_port_decodes_golden_jax_bytes_with_its_own_tables(models):
    """The JAX package's frozen fast-format stream
    (tests/expected/fast_format_ckbd_n32k2.bin: these N=32, K=2 weights,
    lanes=64, a 64x64 input) decoded by the port with ITS OWN tables and
    rows. z: EXACT (the EntropyBottleneck tables are bit-exact). y: a
    measured parity gap, held under a bound. The rows FUNCTION is exact
    (test_torch_port_rows.py: gmm_guarded_rows equals JAX's bit for bit on
    the same parameters), so the gap comes from its inputs: the float32
    conv chain h_s -> context -> entropy parameters sums in another order
    than XLA's convs (ROADMAP C2), a parameter an ulp off moves a row
    entry, and one differing entry desynchronises the rest of its lane's
    chain. Measured (torch 2.13 CPU, jax 0.9): 108 of 512 y symbols
    differ with the conv's plain version as the kernel's fmaf chain (133
    with F.conv2d). Bound: 266."""
    from pathlib import Path

    jm, _, tm = models
    data = (Path(__file__).parent / "expected" / "fast_format_ckbd_n32k2.bin"
            ).read_bytes()
    y_shape = (4, 4, N)
    jc = JCodec(jm, lanes=LANES, cap_divisor=1)
    j_streams = jc.from_bytes(data, y_shape)
    ref_z = np.asarray(jc._zdec_jit(jc._state, j_streams["z"], (1, 1, 1, N)))
    ref_y = np.asarray(jc.decode_y_hat(j_streams, y_shape))

    codec = TCodec(tm, lanes=LANES, cap_divisor=1, bf16_transforms=False)
    streams = codec.from_bytes(data, y_shape)
    rows_z = codec._z_rows  # one z symbol per channel at this size
    got_z = _decode_pass(streams["z"], rows_z, N, 0, LANES)
    np.testing.assert_array_equal(got_z.numpy(), ref_z.reshape(-1))
    got_y = codec.decode_y_hat(streams, y_shape).numpy()
    assert got_y.shape == ref_y.shape == (1, 4, 4, N)
    assert int((got_y != ref_y).sum()) <= 266


def test_which_stage_moves_a_row_entry(models):
    """ROADMAP C2's step: the rows chain h_s -> context -> entropy
    parameters -> GMM rows, with the port handed JAX's output of one stage
    after another, counting the row entries that differ from JAX's rows
    (its codec's own jitted stages) on seeded z bins and anchor symbols.

    Handed JAX's entropy parameters, the port's rows are EXACT in both
    passes. Handed JAX's side (and, in the non-anchor pass, JAX's context
    output too), most of the gap stays: the 1x1 entropy-parameter convs
    alone move entries, being float32 sums in another order than XLA's.
    Measured (torch 2.13 CPU, jax 0.9, of 200,704 entries a pass): anchor
    pass 15,726 differ with the port's own side, 12,929 with JAX's side;
    non-anchor pass 16,598 own, 13,675 with JAX's side, 12,465 with JAX's
    side and context; 0 with JAX's parameters. Bounds: 2x those counts."""
    from flashgmm_tpu_torch.ans.gaussian_cdf import gmm_guarded_rows

    jm, _, tm = models
    jc = JCodec(jm, lanes=LANES, cap_divisor=1)
    codec = TCodec(tm, lanes=LANES, cap_divisor=1, bf16_transforms=False)
    rs = np.random.RandomState(5)
    b, h, w = 2, 8, 8  # y latent 8x8 from z 2x2
    z_max = np.asarray(codec._z_maxbin)
    z_bin = np.stack([rs.randint(0, z_max + 1) for _ in range(b * 4)]
                     ).reshape(b, h // 4, w // 4, N).astype(np.int32)
    sym0 = rs.randint(-4, 5, (b, h, w // 2, N)).astype(np.int32)
    lo, num_bins = codec._lo_bins()

    side_j = jc._side_jit(jc._state, jnp.asarray(z_bin))
    rows_j = [np.asarray(jc._rows0_jit(jc._state, side_j[0])),
              np.asarray(jc._rows1_jit(jc._state, side_j[1],
                                       jnp.asarray(sym0)))]

    def ctx_impl(state, s0):  # the context stage of _rows1_impl
        _, ckbd, _, _ = jc._modules(state)
        y_ = jnp.stack([s0.astype(jnp.float32),
                        jnp.zeros_like(s0, jnp.float32)])
        return ckbd.unembed(ckbd.context_prediction(ckbd.embed(y_)))[1]

    def params_impl(state, ctx, side):  # the entropy-parameter stage
        _, ckbd, _, gmm_lc = jc._modules(state)
        return jc._gmm_pass_params(ckbd, gmm_lc, ctx, side)

    ctx_j = jax.jit(ctx_impl)(jc._state, jnp.asarray(sym0))
    params_j = [jax.jit(params_impl)(jc._state, jnp.zeros_like(side_j[0]),
                                     side_j[0]),
                jax.jit(params_impl)(jc._state, ctx_j, side_j[1])]

    def t(a):
        return torch.from_numpy(np.array(a))

    def moved(params, p):
        rows = gmm_guarded_rows(*params, lo, num_bins, codec.mode).numpy()
        assert rows.shape == rows_j[p].shape
        return int((rows != rows_j[p]).sum())

    with torch.no_grad():
        side_p = codec._side(t(z_bin))
        counts = {
            "anchor, own side": moved(codec._params0(side_p[0]), 0),
            "anchor, JAX side": moved(codec._params0(t(side_j[0])), 0),
            "anchor, JAX parameters": moved([t(v) for v in params_j[0]], 0),
            "non-anchor, own side": moved(
                codec._params1(side_p[1], t(sym0)), 1),
            "non-anchor, JAX side": moved(
                codec._params1(t(side_j[1]), t(sym0)), 1),
            "non-anchor, JAX side and context": moved(
                codec._gmm_pass_params(t(ctx_j), t(side_j[1])), 1),
            "non-anchor, JAX parameters": moved(
                [t(v) for v in params_j[1]], 1),
        }
    measured = [15726, 12929, 0, 16598, 13675, 12465, 0]
    for (stage, count), bound in zip(counts.items(), measured):
        assert count <= 2 * bound, (stage, count, counts)

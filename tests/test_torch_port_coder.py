"""The port's plain interleaved rANS coder against the JAX package's.

flashgmm_tpu_torch.ans.interleaved (the plain versions of the CUDA rANS
kernels; what the kernel wrappers run on CPU tensors) must be BIT-EXACT
against flashgmm_tpu.ans.interleaved: byte-identical states, streams and
word counts from the encoder, identical symbols from the decoder. Exact
equality, no tolerance: the coder is integer math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashgmm_tpu.ans import interleaved as jil
from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_rows as j_rows
from flashgmm_tpu_torch.ans import interleaved as til
from flashgmm_tpu_torch.ans import rans_kernels

torch.set_num_threads(1)

LO, NUM_BINS = -16, 33


def _case(n, seed):
    """GMM rows [n, L] int32 (from the JAX package), symbols in range, and
    each symbol's (start, freq)."""
    rs = np.random.RandomState(seed)
    k = 3
    scales = rs.uniform(0.2, 6.0, (n, k)).astype(np.float32)
    means = rs.normal(0, 2, (n, k)).astype(np.float32)
    w = rs.uniform(0.1, 1.0, (n, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    rows = np.asarray(j_rows(jnp.asarray(scales), jnp.asarray(means),
                             jnp.asarray(w), jnp.int32(LO), NUM_BINS))
    values = np.clip(np.round(rs.normal(0, 4, n)), LO, LO + NUM_BINS - 1)
    values = values.astype(np.int32)
    j = values - LO
    start = rows[np.arange(n), j]
    freq = rows[np.arange(n), j + 1] - start
    return rows, values, start.astype(np.int32), freq.astype(np.int32)


def _jax_encode(start, freq, n, w):
    t, _ = jil.layout(n, w)
    args = (jil.to_lanes(jnp.asarray(start, jnp.uint32), w),
            jil.to_lanes(jnp.asarray(freq, jnp.uint32), w),
            jil.active_mask(n, t, w))
    return args


def _port_encode_args(start, freq, n, w):
    t, _ = til.layout(n, w)
    return (til.to_lanes(torch.from_numpy(start), w),
            til.to_lanes(torch.from_numpy(freq), w),
            til.active_mask(n, t, w))


# T tail: the last step is partly inactive in every case
@pytest.mark.parametrize("w,n", [(128, 5 * 128 - 37), (512, 3 * 512 - 100),
                                 (4096, 3 * 4096 - 1000)])
def test_encode_and_pack_bit_exact(w, n):
    rows, values, start, freq = _case(n, seed=w)
    j_states, j_words, j_emits = jil.encode_scan(*_jax_encode(start, freq, n, w))
    j_stream, j_n = jil.pack_words(j_words, j_emits)

    p_states, p_words, p_emits = rans_kernels.encode_scan(
        *_port_encode_args(start, freq, n, w))
    p_stream, p_n = til.pack_words(p_words, p_emits)

    assert int(p_n) == int(j_n)
    np.testing.assert_array_equal(p_states.numpy(),
                                  np.asarray(j_states).astype(np.int64))
    np.testing.assert_array_equal(p_emits.numpy(), np.asarray(j_emits))
    np.testing.assert_array_equal(p_stream.numpy()[: int(p_n)],
                                  np.asarray(j_stream)[: int(j_n)])


@pytest.mark.parametrize("w,n", [(128, 5 * 128 - 37), (512, 3 * 512 - 100),
                                 (4096, 3 * 4096 - 1000)])
def test_decode_bit_exact(w, n):
    rows, values, start, freq = _case(n, seed=w + 1)
    t, _ = jil.layout(n, w)
    j_states, j_words, j_emits = jil.encode_scan(*_jax_encode(start, freq, n, w))
    j_stream, _ = jil.pack_words(j_words, j_emits)
    # inactive tail rows: the codec's valid dummy rows (fast_codec.py:182-186)
    dummy = np.clip(np.arange(NUM_BINS + 1) * (65536 // NUM_BINS), 0, 65536)
    rows_full = np.concatenate(
        [rows, np.broadcast_to(dummy, (t * w - n, NUM_BINS + 1))]).astype(np.int32)
    rows_l = rows_full.reshape(t, w, -1)
    active = np.array(jil.active_mask(n, t, w))
    j_sym = np.asarray(jil.decode_scan(j_states, j_stream, jnp.asarray(rows_l),
                                       jnp.asarray(active), jnp.int32(LO)))

    p_sym = rans_kernels.decode_scan(
        torch.from_numpy(np.asarray(j_states).astype(np.int64)),
        torch.from_numpy(np.asarray(j_stream).astype(np.int32)),
        torch.from_numpy(rows_l), torch.from_numpy(active), LO)
    np.testing.assert_array_equal(p_sym.numpy(), j_sym)
    np.testing.assert_array_equal(til.from_lanes(p_sym, n).numpy(), values)


def test_against_pallas_kernels_interpret_mode():
    """The plain versions also equal the Pallas TPU kernels themselves, run
    as the JAX package's tests run them on the CPU (interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu

    from flashgmm_tpu.ans.pallas_coder import decode_scan_pallas, encode_scan_pallas

    w, n = 128, 7 * 128 - 50
    rows, values, start, freq = _case(n, seed=3)
    t, _ = jil.layout(n, w)
    jargs = _jax_encode(start, freq, n, w)
    # the Pallas encoder reads freq >= 1 on padding lanes too
    jargs = (jargs[0], jnp.maximum(jargs[1], 1), jargs[2])
    with pltpu.force_tpu_interpret_mode():
        k_states, k_words, k_emits = encode_scan_pallas(*jargs)
    k_stream, k_n = jil.pack_words(k_words, k_emits)

    p_states, p_words, p_emits = rans_kernels.encode_scan(
        torch.from_numpy(np.asarray(jargs[0]).astype(np.int64)),
        torch.from_numpy(np.asarray(jargs[1]).astype(np.int64)),
        torch.from_numpy(np.asarray(jargs[2])))
    p_stream, p_n = til.pack_words(p_words, p_emits)
    assert int(p_n) == int(k_n)
    np.testing.assert_array_equal(p_states.numpy(), np.asarray(k_states))
    np.testing.assert_array_equal(p_stream.numpy()[: int(p_n)],
                                  np.asarray(k_stream)[: int(k_n)])

    rows_l = np.concatenate(
        [rows, np.repeat(rows[-1:], t * w - n, 0)]).reshape(t, w, -1)
    with pltpu.force_tpu_interpret_mode():
        k_sym = decode_scan_pallas(k_states, k_stream, jnp.asarray(rows_l),
                                   jargs[2], jnp.int32(LO))
    p_sym = rans_kernels.decode_scan(p_states, p_stream,
                                     torch.from_numpy(rows_l),
                                     torch.from_numpy(np.asarray(jargs[2])), LO)
    np.testing.assert_array_equal(p_sym.numpy(), np.asarray(k_sym))
    np.testing.assert_array_equal(til.from_lanes(p_sym, n).numpy(), values)


def test_divmod_rans_exact():
    from flashgmm_tpu.ans.interleaved import divmod_u32_u16

    rs = np.random.RandomState(7)
    f = np.concatenate([[1, 2, 3, 65534, 65535],
                        rs.randint(1, 65536, 5000)]).astype(np.uint32)
    a = ((f.astype(np.uint64) << 16) - 1 - rs.randint(0, 1 << 16, f.shape[0])
         .astype(np.uint64) % (f.astype(np.uint64) << 16)).astype(np.uint32)
    jq, jr = divmod_u32_u16(jnp.asarray(a), jnp.asarray(f))
    pq, pr = til.divmod_rans(torch.from_numpy(a.astype(np.int64)),
                             torch.from_numpy(f.astype(np.int64)))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


def test_layout_helpers_match():
    for n, w in [(1, 64), (64, 64), (65, 64), (1000, 128)]:
        assert til.layout(n, w) == jil.layout(n, w)
        t, _ = til.layout(n, w)
        np.testing.assert_array_equal(til.active_mask(n, t, w).numpy(),
                                      np.asarray(jil.active_mask(n, t, w)))
        x = np.arange(n, dtype=np.int32)
        lanes = til.to_lanes(torch.from_numpy(x), w, fill=-1)
        np.testing.assert_array_equal(
            lanes.numpy(), np.asarray(jil.to_lanes(jnp.asarray(x), w, fill=-1)))
        np.testing.assert_array_equal(til.from_lanes(lanes, n).numpy(), x)

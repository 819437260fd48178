"""The per-symbol bounds and the on-demand GMM decoder against the JAX
package, on the CPU.

- ``gmm_guarded_bounds`` (the encoder's (start, freq) of each symbol's bin,
  without the rest of the row) equals JAX's ``gmm_guarded_bounds`` BIT FOR
  BIT in all three approximation modes, at K=2 and K=4, with the edge
  parameters of the rows tests and symbols at both ends of the range; and
  equals the gather of the same two entries from the full rows.
- ``decode_scan_gmm`` (the decoder that evaluates the rows' entries at its
  probes; on CPU tensors its plain version) reads a JAX-encoded stream to
  the same symbols as the JAX decoder on JAX's rows.
- The port's fast codec is built with the JAX package's default lanes: W
  is not in the bytes, so default-built codecs of the two packages must
  agree on it.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashgmm_tpu.ans import interleaved as jil
from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_bounds as j_bounds
from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_rows as j_rows
from flashgmm_tpu_torch.ans import gaussian_cdf as tg
from flashgmm_tpu_torch.ans import interleaved as til
from flashgmm_tpu_torch.ans import rans_kernels

torch.set_num_threads(1)

LO, NUM_BINS = -48, 97


def _params(n, k, seed):
    rs = np.random.RandomState(seed)
    s = rs.uniform(0.11, 20.0, (n, k)).astype(np.float32)
    m = rs.normal(0, 5, (n, k)).astype(np.float32)
    w = rs.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    return s, m, w / w.sum(1, keepdims=True)


def _edge_params(n, k, seed):
    """Scales at the clamps, means far outside the range, subnormal
    weights (as tests/test_torch_port_rows.py)."""
    rs = np.random.RandomState(seed)
    s = rs.choice(np.float32([0.11, 256.0, 1.0, 3.7]), (n, k))
    s = np.where(rs.rand(n, k) < 0.3, rs.uniform(0.11, 256, (n, k)), s)
    m = rs.choice(np.float32([-1e3, -200, -60, -48.5, 0, 47.5, 60, 200, 1e4]),
                  (n, k))
    m = np.where(rs.rand(n, k) < 0.3, rs.normal(0, 30, (n, k)), m)
    w = rs.uniform(0.05, 1, (n, k))
    w /= w.sum(1, keepdims=True)
    tiny = rs.choice(np.float32([1e-45, 1e-39, 1.1754944e-38, 2e-38, 3e-37,
                                 1e-36, 1e-30]), (n, k))
    w = np.where(rs.rand(n, k) < 0.4, tiny, w)
    return s.astype(np.float32), m.astype(np.float32), w.astype(np.float32)


def _values(n, seed):
    """Symbols over the whole range, both ends included."""
    v = np.random.RandomState(seed).randint(LO, LO + NUM_BINS, n)
    v[:64] = LO
    v[64:128] = LO + NUM_BINS - 1
    return v.astype(np.int32)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bounds_equal_jax(mode, k, edge):
    n = 3000
    s, m, w = (_edge_params if edge else _params)(n, k, 10 * mode + k)
    v = _values(n, mode + k)
    ref_start, ref_freq = j_bounds(jnp.asarray(v), jnp.asarray(s),
                                   jnp.asarray(m), jnp.asarray(w),
                                   jnp.int32(LO), NUM_BINS, mode)
    start, freq = tg.gmm_guarded_bounds(
        torch.from_numpy(v), *map(torch.from_numpy, (s, m, w)), LO, NUM_BINS,
        mode)
    assert start.dtype == freq.dtype == torch.int32
    assert int((start.numpy() != np.asarray(ref_start).astype(np.int64)).sum()) == 0
    assert int((freq.numpy() != np.asarray(ref_freq).astype(np.int64)).sum()) == 0
    assert int(freq.min()) >= 1  # every bin is codable


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bounds_equal_a_gather_from_the_rows(mode):
    n = 2000
    s, m, w = (torch.from_numpy(a) for a in _edge_params(n, 4, 7 + mode))
    v = torch.from_numpy(_values(n, mode))
    rows = tg.gmm_guarded_rows_plain(s, m, w, LO, NUM_BINS, mode)
    j = (v.long() - LO)[:, None]
    start, freq = tg.gmm_guarded_bounds_plain(v, s, m, w, LO, NUM_BINS, mode)
    assert torch.equal(start, rows.gather(1, j)[:, 0])
    assert torch.equal(freq, rows.gather(1, j + 1)[:, 0] - start)


@pytest.mark.parametrize("w,n,mode", [(64, 5 * 64 - 13, 0), (128, 3 * 128, 1),
                                      (200, 4 * 200 - 150, 2)])
def test_decode_scan_gmm_reads_jax_streams(w, n, mode):
    """JAX encodes with its own bounds; the port decodes with the rows
    evaluated from the parameters alone (padding lanes carry none)."""
    s, m, wt = _params(n, 4, w)
    v = _values(n, w)
    start, freq = j_bounds(jnp.asarray(v), jnp.asarray(s), jnp.asarray(m),
                           jnp.asarray(wt), jnp.int32(LO), NUM_BINS, mode)
    t, pad = jil.layout(n, w)
    active = jil.active_mask(n, t, w)
    states, words, emits = jil.encode_scan(
        jil.to_lanes(start, w), jil.to_lanes(jnp.maximum(freq, 1), w), active)
    stream, _ = jil.pack_words(words, emits)
    rows = np.asarray(j_rows(jnp.asarray(s), jnp.asarray(m), jnp.asarray(wt),
                             jnp.int32(LO), NUM_BINS, mode))
    rows = np.concatenate([rows, np.repeat(rows[-1:], pad, 0)])
    ref = np.asarray(jil.decode_scan(states, stream,
                                     jnp.asarray(rows.reshape(t, w, -1)),
                                     active, jnp.int32(LO)))

    got = rans_kernels.decode_scan_gmm(
        torch.from_numpy(np.asarray(states).astype(np.int64)),
        torch.from_numpy(np.asarray(stream).astype(np.int32)),
        *map(torch.from_numpy, (s, m, wt)), torch.from_numpy(np.asarray(active)),
        LO, NUM_BINS, mode)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(til.from_lanes(got, n).numpy(), v)


def test_default_lanes_equal_the_reference():
    from flashgmm_tpu.runtime import FastCheckerboardGmmCodec as JCodec
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec as TCodec

    def lanes(cls):
        return inspect.signature(cls.__init__).parameters["lanes"].default

    assert lanes(TCodec) == lanes(JCodec) == 128

"""The GMM rANS encoder (``rans_kernels.encode_scan_gmm``, each symbol's
(start, freq) evaluated inside the encoder from its mixture parameters)
against the JAX package, on the CPU.

- On CPU tensors the wrapper runs its plain version, which must equal the
  JAX package's ``gmm_guarded_bounds`` -> ``encode_scan`` -> ``pack_words``
  BIT FOR BIT: states, word counts and packed streams, in all three
  approximation modes, at K = 1, 3 and 4, at W = 128 and 4096, with a last
  step that is partly inactive.
- The same against the Pallas TPU encoder run in interpret mode.
- The kernel's chain divides by a reciprocal precomputed for each symbol
  (Granlund-Montgomery); its int64 twin (``rans_kernels.divmod_reciprocal``)
  equals ``interleaved.divmod_rans`` for every freq in 1..65536 at the edge
  dividends.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashgmm_tpu.ans import interleaved as jil
from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_bounds as j_bounds
from flashgmm_tpu_torch.ans import interleaved as til
from flashgmm_tpu_torch.ans import rans_kernels

torch.set_num_threads(1)

LO, NUM_BINS = -48, 97


def _case(n, k, seed):
    """Seeded float32 [n, K] scales, means and weights, and int32 [n]
    symbols over the whole range, both ends included."""
    rs = np.random.RandomState(seed)
    s = rs.uniform(0.11, 20.0, (n, k)).astype(np.float32)
    m = rs.normal(0, 5, (n, k)).astype(np.float32)
    w = rs.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    v = np.clip(np.round(rs.normal(0, 6, n)), LO, LO + NUM_BINS - 1)
    v[:16], v[16:32] = LO, LO + NUM_BINS - 1
    return v.astype(np.int32), s, m, w


def _jax_stream(v, s, m, w, mode, lanes, encode=jil.encode_scan):
    """JAX's bounds laid over the lanes, encoded and packed: (states,
    stream, n_words) as numpy."""
    n = v.shape[0]
    start, freq = j_bounds(jnp.asarray(v), jnp.asarray(s), jnp.asarray(m),
                           jnp.asarray(w), jnp.int32(LO), NUM_BINS, mode)
    t, _ = jil.layout(n, lanes)
    # padding lanes are inactive; freq >= 1 there for the encoders' divisions
    states, words, emits = encode(
        jil.to_lanes(start, lanes), jil.to_lanes(jnp.maximum(freq, 1), lanes),
        jil.active_mask(n, t, lanes))
    stream, n_words = jil.pack_words(words, emits)
    n_words = int(n_words)
    return (np.asarray(states).astype(np.int64),
            np.asarray(stream)[:n_words].astype(np.int64), n_words)


def _port_stream(v, s, m, w, mode, lanes):
    before = rans_kernels.encode_scan_gmm.launches
    states, words, emits = rans_kernels.encode_scan_gmm(
        torch.from_numpy(v), *map(torch.from_numpy, (s, m, w)), LO, NUM_BINS,
        mode, lanes)
    assert rans_kernels.encode_scan_gmm.launches == before  # CPU: no kernel
    t, _ = til.layout(v.shape[0], lanes)
    assert states.shape == (lanes,) and words.shape == emits.shape == (t, lanes)
    stream, n_words = til.pack_words(words, emits)
    n_words = int(n_words)
    return states.numpy(), stream[:n_words].numpy().astype(np.int64), n_words


# T tail: the last step is partly inactive in every case
@pytest.mark.parametrize("lanes,n", [(128, 5 * 128 - 37), (4096, 2 * 4096 - 1000)])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_encode_scan_gmm_equals_jax_bounds_encode_pack(mode, k, lanes, n):
    v, s, m, w = _case(n, k, 100 * mode + 10 * k + lanes % 7)
    j_states, j_stream, j_n = _jax_stream(v, s, m, w, mode, lanes)
    p_states, p_stream, p_n = _port_stream(v, s, m, w, mode, lanes)
    assert p_n == j_n
    np.testing.assert_array_equal(p_states, j_states)
    np.testing.assert_array_equal(p_stream, j_stream)


def test_encode_scan_gmm_equals_the_pallas_encoder_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    from flashgmm_tpu.ans.pallas_coder import encode_scan_pallas

    lanes, n, mode = 128, 7 * 128 - 50, 0
    v, s, m, w = _case(n, 4, 5)
    with pltpu.force_tpu_interpret_mode():
        k_states, k_stream, k_n = _jax_stream(v, s, m, w, mode, lanes,
                                              encode_scan_pallas)
    p_states, p_stream, p_n = _port_stream(v, s, m, w, mode, lanes)
    assert p_n == k_n
    np.testing.assert_array_equal(p_states, k_states)
    np.testing.assert_array_equal(p_stream, k_stream)


def test_reciprocal_division_equals_divmod_rans_for_every_freq():
    f = torch.arange(1, 65537, dtype=torch.int64)
    top = (1 << 32) - 1
    k_max = top // f  # the largest multiple of f below 2^32
    cand = [torch.zeros_like(f), f - 1, f, (f << 16) - 1,
            torch.full_like(f, top)]
    for k in (torch.full_like(f, 2), torch.full_like(f, 7),
              torch.full_like(f, 1000), torch.full_like(f, 65535), k_max):
        cand += [k * f - 1, k * f, k * f + 1]
    x = torch.stack(cand, 1)  # [65536, 20] dividends
    fx = f[:, None].expand_as(x)
    ok = (x >= 0) & (x <= top)
    x, fx = x[ok], fx[ok]
    q, r = rans_kernels.divmod_reciprocal(x, fx)
    q_ref, r_ref = til.divmod_rans(x, fx)
    assert torch.equal(q, q_ref) and torch.equal(r, r_ref)
    assert x.numel() > 19 * 65536 and int(fx.min()) == 1 and int(fx.max()) == 65536

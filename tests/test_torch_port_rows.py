"""The port's GMM CDF rows against the JAX package's: bit for bit.

``gmm_guarded_rows`` is plain float math in both packages (XLA there, torch
here, and the fused CUDA kernel on the card). The port's plain version
writes out XLA's CPU arithmetic for it (flashgmm_tpu_torch/ans/
gaussian_cdf.py: XLA's exp and logistic, its FMA contraction, flush to
zero, a correctly rounded sqrt), so the integer rows are EQUAL to JAX's on
the CPU in all three approximation modes, at K=4 (the flagship) and K=2
(the golden stream's), also at edge parameters: scales at the clamps 0.11
and 256, means far outside [lo, lo + L] (CDF near 0 or 1) and weights that
are subnormal or make subnormal terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_rows as j_rows
from flashgmm_tpu_torch.ans import gaussian_cdf as tg

torch.set_num_threads(1)


def _params(n=4096, k=4, seed=0):
    rs = np.random.RandomState(seed)
    s = rs.uniform(0.11, 20.0, (n, k)).astype(np.float32)
    m = rs.normal(0, 5, (n, k)).astype(np.float32)
    w = rs.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    return s, m, w / w.sum(1, keepdims=True)


def _edge_params(n=2048, k=4, seed=1):
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


def _assert_rows_equal_jax(s, m, w, mode):
    ref = np.asarray(j_rows(jnp.asarray(s), jnp.asarray(m), jnp.asarray(w),
                            jnp.int32(-48), 97, mode))
    out = tg.gmm_guarded_rows(torch.from_numpy(s), torch.from_numpy(m),
                              torch.from_numpy(w), -48, 97, mode).numpy()
    assert out.dtype == np.int32 and out.shape == ref.shape == (len(s), 98)
    n_diff = int((out != ref).sum())
    assert n_diff == 0, f"{n_diff} of {out.size} entries differ"
    # the rows are valid coder tables
    assert np.all(np.diff(out, axis=1) >= 1)
    assert np.all(out[:, -1] == 65536) and np.all(out[:, 0] >= 0)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_rows_match_jax_within_measured_bound(mode):
    """K=4, 4096 x 98 entries: the measured gap is now zero entries (it was
    0.08-0.10 % with torch's own exp/sqrt/sigmoid and no FMA)."""
    _assert_rows_equal_jax(*_params(), mode)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_rows_equal_jax_at_k2(mode):
    _assert_rows_equal_jax(*_params(k=2, seed=3), mode)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_rows_equal_jax_at_edge_params(mode, k):
    _assert_rows_equal_jax(*_edge_params(k=k, seed=k), mode)


def test_fma_and_sqrt_round_once():
    """The float64 emulations round as a hardware FMA and an IEEE sqrt do,
    also where a naive float64 sum double-rounds (a float32 tie broken by a
    term far below float64's last bit) and where torch's float32 sqrt
    misrounds a near-tie."""
    from flashgmm_tpu_torch.entropy_models.xla_math import _fma

    a = torch.tensor([1 + 2.0 ** -12] * 2, dtype=torch.float32)
    c = torch.tensor([2.0 ** -60, -2.0 ** -60], dtype=torch.float32)
    got = _fma(a, 1 + 2.0 ** -12, c).numpy().view(np.int32)
    one_up = np.float32(1 + 2.0 ** -11).view(np.int32)  # the exact product's floor
    assert got.tolist() == [one_up + 1, one_up]
    assert tg._sqrt(torch.tensor([0.95874435])).item() == np.sqrt(
        np.float32(0.95874435))
    x = np.random.RandomState(0).uniform(0, 4, 200000).astype(np.float32)
    assert np.array_equal(tg._sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cdf_approximations_close_to_jax(mode):
    """The three CDF approximations agree with JAX's to float32 accuracy
    (absolute, since they are probabilities in [0, 1])."""
    from flashgmm_tpu.ans import gaussian_cdf as jg

    x = np.linspace(-8, 8, 4001).astype(np.float32)
    ref = np.asarray(jg.gaussian_cdf(jnp.asarray(x), mode))
    out = tg._CDF_FNS[mode](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


def test_approx_mode_from_env(monkeypatch):
    monkeypatch.setenv("APPROX_MODE", "2")
    assert tg.get_approx_mode() == 2
    monkeypatch.setenv("APPROX_MODE", "7")
    assert tg.get_approx_mode() == 0


@pytest.mark.parametrize("name", ["exp", "log1p", "tanh", "logistic", "softplus"])
def test_xla_math_is_bitwise_xla_cpu(name):
    """flashgmm_tpu_torch/entropy_models/xla_math.py reproduces XLA's CPU
    float32 functions bit for bit (what makes the EntropyBottleneck tables
    exact), over normal, large, tiny and underflowing inputs."""
    import jax

    from flashgmm_tpu_torch.entropy_models import xla_math

    rs = np.random.RandomState(1)
    x = np.concatenate([rs.randn(50000) * 4, rs.randn(20000) * 40,
                        rs.randn(20000) * 1e-3, rs.uniform(-100, 100, 20000),
                        [0.0, -0.0, 20.0, -20.0, 7.9, 8.5, 0.4142, -87.5, 88.7]])
    if name == "log1p":
        x = np.abs(x) - 0.9
    x = x.astype(np.float32)
    jf = {"exp": jnp.exp, "log1p": jnp.log1p, "tanh": jnp.tanh,
          "logistic": jax.nn.sigmoid, "softplus": jax.nn.softplus}[name]
    ref = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    out = getattr(xla_math, name)(torch.from_numpy(x)).numpy()
    same = (out.view(np.int32) == ref.view(np.int32)) | (np.isnan(out) & np.isnan(ref))
    assert same.all(), (x[~same][:5], ref[~same][:5], out[~same][:5])

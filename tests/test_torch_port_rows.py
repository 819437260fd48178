"""The port's GMM CDF rows against the JAX package's.

``gmm_guarded_rows`` is plain float math in both packages (XLA there, torch
here), and the two libraries' exp/sqrt/sigmoid differ in the last ulp. A
row entry is floor(cdf * (2^16 - L)) + j, so an ulp can move an entry that
sits on a floor boundary by one; in Pólya mode sqrt(1 - exp(-2x^2/pi))
amplifies an ulp of exp near x = 0, so entries there move by a few units.
The mismatch is MEASURED here and held under a bound, not assumed zero:
measured on 4096 x 98 entries (torch 2.13 CPU vs jax 0.9 CPU): mode 0 319
entries differ (0.08 %), max |d| 4; mode 1 395 (0.10 %), max 1; mode 2 323
(0.08 %), max 1. Bounds: at most 0.3 % of entries, |d| <= 8 in mode 0 and
<= 2 otherwise. Within one package, encoder and decoder share the function,
so this mismatch never desyncs the port's own streams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashgmm_tpu.ans.gaussian_cdf import gmm_guarded_rows as j_rows
from flashgmm_tpu_torch.ans import gaussian_cdf as tg

torch.set_num_threads(1)

MAX_FRACTION = 3e-3
MAX_DELTA = {0: 8, 1: 2, 2: 2}


def _params(n=4096, k=4, seed=0):
    rs = np.random.RandomState(seed)
    s = rs.uniform(0.11, 20.0, (n, k)).astype(np.float32)
    m = rs.normal(0, 5, (n, k)).astype(np.float32)
    w = rs.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    return s, m, w / w.sum(1, keepdims=True)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_rows_match_jax_within_measured_bound(mode):
    s, m, w = _params()
    ref = np.asarray(j_rows(jnp.asarray(s), jnp.asarray(m), jnp.asarray(w),
                            jnp.int32(-48), 97, mode))
    out = tg.gmm_guarded_rows(torch.from_numpy(s), torch.from_numpy(m),
                              torch.from_numpy(w), -48, 97, mode).numpy()
    assert out.dtype == np.int32 and out.shape == ref.shape == (4096, 98)
    diff = out.astype(np.int64) - ref
    fraction = float(np.mean(diff != 0))
    assert fraction <= MAX_FRACTION, fraction
    assert int(np.abs(diff).max()) <= MAX_DELTA[mode]
    # the port's rows are valid coder tables on their own
    assert np.all(np.diff(out, axis=1) >= 1)
    assert np.all(out[:, -1] == 65536) and np.all(out[:, 0] >= 0)


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

"""The port's mesh (``parallel/mesh.py``), sharded forwards
(``parallel/inference.py``) and batch-data-parallel coding (``use_mesh``)
on the CPU, against the port on one device and against the JAX package on
its 8 virtual CPU devices (tests/conftest.py), at ``tests/test_parallel.py``'s
sizes: FactorizedPrior 16/24, the flagship at N=64, K=4, ELIC at N=32,
M=64, K=2, groups [8, 8, 16, 16, 16]; GSM at N=32 (the GSM codec tests'
width); eight 64x64 images made by numpy from a seed; a port mesh of 8 CPU
slots (``make_mesh(8, device="cpu")``).

Exact: each codec's mesh encode gives the one-device bytes (portable mode:
the z bins and symbols are gathered, the rows chain and the coder run on
the first device), so y_hat and the z stream too; the mesh's bytes
round-trip exactly, a one-device stream decodes on the mesh and the other
way round, and ``portable=False`` round-trips on its mesh (its bytes are
the one-device bytes too: the f32 rows-chain conv is batch-invariant).
Within a tolerance: the sharded forward within 1e-5 of the unsharded; the
height-sharded g_a within 1e-5 of the unsharded, and within the forward
parity tests' 2e-4 of JAX's sharded g_a; the flagship's height-sharded
forward at most 2 % of pixels beyond 2e-5 and its bits within 1e-3 of the
unsharded (JAX's bounds, tests/test_parallel.py:189-215); each codec's mesh
y_hat against JAX's ``use_mesh`` within the single-device parity tests'
flip bound (ROADMAP C2: 1 % of symbols, one step at most).

The flagship's and GSM's codecs here; ELIC's in
test_torch_port_parallel_elic.py (its rows chain runs its plain convs once
a slot with ``portable=False``: ~60 s of its own). The JAX twins and the
checks: tests/torch_port_parallel_pairs.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu import parallel as jpar
from flashgmm_tpu.parallel import inference as jinf
from flashgmm_tpu_torch import parallel as tpar

import torch_port_parallel_pairs as pp
from torch_port_parallel_pairs import ATOL_JAX, images as _images

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cpu_mesh():
    return tpar.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def factorized(tmp_path_factory):
    from flashgmm_tpu.models import FactorizedPrior as JFactorized
    from flashgmm_tpu_torch.models import FactorizedPrior

    tm = FactorizedPrior(16, 24, device="cpu")
    jm = pp.jax_twin(lambda: JFactorized(16, 24, rngs=nnx.Rngs(0)), tm,
                     tmp_path_factory.mktemp("fp") / "w.npz")
    return jm, tm


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    return pp.flagship_pair(tmp_path_factory.mktemp("gmm") / "w.npz")


# -- the mesh -----------------------------------------------------------------


def test_make_mesh_errors_as_jax():
    """Too many devices: RuntimeError on both sides (the port has no card
    here, and never takes fewer than asked); data x spatial not the device
    count: the same AssertionError."""
    with pytest.raises(RuntimeError, match="requested 9 devices"):
        jpar.make_mesh(9)
    with pytest.raises(RuntimeError, match="requested 1 devices"):
        tpar.make_mesh(1)
    with pytest.raises(RuntimeError, match="requested 9 devices"):
        tpar.make_mesh(9)
    for make in (jpar.make_mesh, lambda *a, **k: tpar.make_mesh(
            *a, device="cpu", **k)):
        with pytest.raises(AssertionError):
            make(8, data=3)
    j, t = jpar.make_mesh(8, spatial=4), tpar.make_mesh(8, spatial=4,
                                                        device="cpu")
    assert dict(j.shape) == t.shape == {"data": 2, "spatial": 4}
    assert t.axis_names == tuple(j.axis_names)
    assert len(t.axis_devices("data")) == 2
    assert len(t.axis_devices("spatial")) == 4


def test_shard_batch_and_replicate_as_jax(factorized):
    """shard_batch: the same [data][spatial] blocks as JAX's shards, on
    their slots' devices; replicate: one snapshot of the module a slot."""
    x = _images(4, 16, 8, 0)
    jmesh = jpar.make_mesh(8, data=2, spatial=4)
    tmesh = tpar.make_mesh(8, data=2, spatial=4, device="cpu")
    got = tpar.shard_batch(tmesh, torch.from_numpy(x))
    shards = jpar.shard_batch(jmesh, jnp.asarray(x)).addressable_shards
    want = {tuple(s.index): np.asarray(s.data) for s in shards}
    assert len(got) == 2 and all(len(row) == 4 for row in got)
    for i, row in enumerate(got):
        for j, shard in enumerate(row):
            idx = (slice(2 * i, 2 * i + 2), slice(4 * j, 4 * j + 4),
                   slice(None), slice(None))
            ref = next(v for k, v in want.items()
                       if (k[0].start or 0, k[1].start or 0) == (2 * i, 4 * j))
            np.testing.assert_array_equal(shard.numpy(), ref)
            np.testing.assert_array_equal(shard.numpy(), x[idx])
    _, tm = factorized
    reps = tpar.replicate(tmesh, tm)
    assert len(reps) == 8 and all(r is not tm for r in reps)
    for r in reps:
        for (k, a), (_, b) in zip(r.state_dict().items(),
                                  tm.state_dict().items()):
            assert torch.equal(a, b), k
    assert len(tpar.replicate(tmesh, torch.ones(3))) == 8


# -- the sharded forwards -----------------------------------------------------


def test_sharded_forward_matches_unsharded(factorized, cpu_mesh):
    _, tm = factorized
    x = torch.from_numpy(_images(8, 32, 32, 1))
    got = tpar.make_sharded_forward(tm, cpu_mesh)(x)
    with torch.no_grad():
        ref = tm(x, training=False)
    torch.testing.assert_close(got["x_hat"], ref["x_hat"], rtol=0, atol=1e-5)
    for k in ref["likelihoods"]:
        torch.testing.assert_close(got["likelihoods"][k],
                                   ref["likelihoods"][k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows,slots", [(256, 8), (160, 4)],
                         ids=["8x32rows", "bands3-3-2-2"])
def test_spatial_g_a_matches_unsharded_and_jax(factorized, rows, slots):
    """g_a over height bands of whole 16-row units (256 rows: 2 units a
    slot; 160 rows over 4 slots: 3, 3, 2 and 2 units) within 1e-5 of the
    unsharded g_a, and of JAX's sharded g_a within the parity tests'
    2e-4."""
    jm, tm = factorized
    x = _images(1, rows, 64, 2)
    mesh = tpar.make_mesh(slots, data=1, spatial=slots, device="cpu")
    got = tpar.make_spatial_sharded_transform(tm, mesh)(torch.from_numpy(x))
    with torch.no_grad():
        ref = tm.g_a(torch.from_numpy(x))
    assert got.shape == (1, rows // 16, 4, 24)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    if rows % 8 == 0 and slots == 8:
        j = jinf.make_spatial_sharded_transform(
            jm, jpar.make_mesh(8, data=1, spatial=8))(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL_JAX)


def test_spatial_bands_under_thread_switches(factorized):
    """16 bands (one 16-row unit each, twice the cores a driver's worker
    has) under a 1 us thread switch interval: every band's posts and
    reads of the halo exchange land, so g_a equals the unsharded one
    within 1e-5, in a bounded time."""
    import sys
    import time

    _, tm = factorized
    x = torch.from_numpy(_images(1, 256, 64, 4))
    mesh = tpar.make_mesh(16, data=1, spatial=16, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        got = tpar.make_spatial_sharded_transform(tm, mesh)(x)
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(interval)
    with torch.no_grad():
        torch.testing.assert_close(got, tm.g_a(x), rtol=0, atol=1e-5)


def test_spatial_halo_beyond_the_next_band_raises():
    """A 9x9 conv (a halo of 4 rows) over bands of one row."""
    from flashgmm_tpu_torch.layers import Conv2d, Sequential

    class Deep(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.g_a = Sequential(Conv2d(3, 4, 9, padding=4))

    mesh = tpar.make_mesh(8, data=1, spatial=8, device="cpu")
    run = tpar.make_spatial_sharded_transform(Deep(), mesh)
    with pytest.raises(ValueError, match="beyond the next card"):
        run(torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError, match="whole units"):
        run(torch.zeros(1, 7, 8, 3))


def test_spatial_factorized_forward(factorized):
    """The factorized prior's whole forward over 8 height bands of two
    16-row units: its g_s's transposed convs take their halos too (the
    flagship's g_s and h_s upsample by subpel convs). Within 1e-5 of the
    unsharded forward."""
    _, tm = factorized
    mesh = tpar.make_mesh(8, data=1, spatial=8, device="cpu")
    x = torch.from_numpy(_images(1, 256, 64, 6))
    got = tpar.make_spatial_sharded_forward(tm, mesh)(x)
    with torch.no_grad():
        ref = tm(x, training=False)
    torch.testing.assert_close(got["x_hat"], ref["x_hat"], rtol=0, atol=1e-5)
    torch.testing.assert_close(got["likelihoods"]["y"],
                               ref["likelihoods"]["y"], rtol=0, atol=1e-5)


def test_spatial_flagship_forward(flagship):
    """The whole flagship forward over 8 height bands of one 64-row unit
    (a 1-row z band, a 4-row y band under the 5x5 context): JAX's bounds
    against the unsharded forward."""
    _, tm = flagship
    mesh = tpar.make_mesh(8, data=1, spatial=8, device="cpu")
    x = torch.from_numpy(_images(1, 512, 64, 5))
    got = tpar.make_spatial_sharded_forward(tm, mesh)(x)
    with torch.no_grad():
        ref = tm(x, training=False)
    assert got["x_hat"].shape == ref["x_hat"].shape
    mismatch = float(((got["x_hat"] - ref["x_hat"]).abs() > 2e-5)
                     .float().mean())
    assert mismatch < 0.02, mismatch

    def bits(out):
        return sum(float(-torch.log2(v).sum())
                   for v in out["likelihoods"].values())

    assert abs(bits(got) - bits(ref)) / bits(ref) < 1e-3


# -- batch-data-parallel coding (ELIC's: test_torch_port_parallel_elic.py) ----


@pytest.fixture(scope="module", params=["gmm", "gsm"])
def coded(request, tmp_path_factory, flagship, cpu_mesh):
    return pp.code_batch(pp.codec_pair(
        request.param, tmp_path_factory.mktemp(request.param) / "w.npz",
        flagship), cpu_mesh)


def test_mesh_encode_equals_one_device(coded):
    pp.check_mesh_encode_equals_one_device(coded)


def test_mesh_round_trip_exact(coded):
    pp.check_mesh_round_trip_exact(coded)


def test_streams_cross_topologies(coded):
    pp.check_streams_cross_topologies(coded)


def test_nonportable_round_trip_exact(coded):
    pp.check_nonportable_round_trip_exact(coded)


def test_mesh_y_hat_against_jax_use_mesh(coded):
    pp.check_mesh_y_hat_against_jax(coded)

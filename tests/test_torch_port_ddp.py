"""The port's training across processes (``data_parallel_train_step`` over
``torch.distributed``, ``parallel/distributed.py``, the trainer under
torchrun) on the CPU over gloo, against one process's ``train_step`` on
the whole batch and against the JAX package's step on a 4-device CPU mesh.

Ranks are spawned processes (tests/torch_port_ddp_ranks.py, one thread
each, a free port a group, every collective bounded by 60 s and every run
by 120 s). The flagship at N=32, K=2, seed 0 (rank r > 0 builds seed r and
takes rank 0's parameters by ``broadcast_parameters``), the trainer's
optimizers (lr 1e-4, aux lr 1e-3, clip 1), the generator of seed 0, global
batches of 8 64x64 images (the flagship's smallest side) from
``np.random.RandomState``.

Held, for 4 ranks against one process, over 3 steps:
- every returned term (the global means) within rtol 1e-5;
- the reduced flat gradient within 1e-5 of its largest entry. One process
  on batch 8 and on four batches of 2 averaged in float64 already differ by
  2.0-3.0e-6 of it (float32 summation order in the convs' backward, no
  reduction involved);
- the parameters within 1e-6 wherever every step's gradient is at least
  1e-4 of its largest entry (56 % of the entries, measured at most 3e-8
  apart), elsewhere within 2 lr a step (Adam divides each update by its
  gradient's size: where the gradient is within float32 error of zero, its
  sign is that error's);
- the replicas bitwise equal after every step (an all-gather).

Also: a world of 1 and no group are ``train_step`` bit for bit; a NaN in
one rank's rows zeroes the step on every rank (zero gradients, finite and
equal parameters, both optimizers' step counts advanced); a global batch
that does not divide over the ranks raises; ``vbr_train_step`` on 2 ranks
against one process (mbt2018-mean-vbr, N=32, M=48); against JAX's
``data_parallel_train_step`` on a 4-device mesh with the noise made equal
in both packages (one numpy array per global shape, each rank taking its
rows), 3 steps' terms within rtol 1e-3 (test_torch_port_train.py's bound);
the trainer under ``torch.distributed.run`` on 2 ranks writes one log line
(the first rank's) and ends where the one-process trainer does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax import nnx
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from flashgmm_tpu.models.ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.parallel import make_mesh
from flashgmm_tpu.parallel.train import data_parallel_train_step as j_step
from flashgmm_tpu.parallel.train import make_train_state as j_make_train_state
from flashgmm_tpu_torch.datasets import save_image, textured_leaves
from flashgmm_tpu_torch.examples.train import main as train_main
from flashgmm_tpu_torch.parallel import (data_parallel_train_step,
                                         local_rows, make_train_state,
                                         train_step)

import torch_port_ddp_ranks as ranks
from torch_port_parallel_pairs import jax_twin

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STEPS = 3


@pytest.fixture(scope="module")
def four_ranks():
    """4 ranks and one process: 3 steps, then a step whose batch holds a
    NaN in the last rank's rows."""
    return (ranks.run_ranks(4, ranks.flagship_job, STEPS + 1, 64, True),
            ranks.one_process("cpu", STEPS + 1, 4, nan_last=True))


def test_four_ranks_equal_one_process(four_ranks):
    got, ref = four_ranks
    for step in range(STEPS):
        for rank in got:
            assert rank["terms"][step].keys() == ref["terms"][step].keys()
            for k, v in ref["terms"][step].items():
                np.testing.assert_allclose(rank["terms"][step][k], v,
                                           rtol=1e-5, err_msg=f"{step}: {k}")
            g, r = rank["grads"][step], ref["grads"][step]
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max())
        sure = ranks.check_params(got[0]["params"][step],
                                  ref["params"][step], ref["grads"], step + 1)
        assert sure > 0.5 * ref["grads"][0].size


def test_replicas_bitwise_equal_after_every_step(four_ranks):
    got, _ = four_ranks
    assert [rank["equal"] for rank in got] == [[True] * (STEPS + 1)] * 4


def test_nan_in_one_rank_zeroes_the_step_on_every_rank(four_ranks):
    got, ref = four_ranks
    for rank in got:
        assert np.isnan(rank["terms"][STEPS]["loss"])
        assert not rank["grads"][STEPS].any()
        assert rank["finite"]
        assert rank["counts"] == [[STEPS + 1], [STEPS + 1]]
    assert not ref["grads"][STEPS].any()
    # the zeroed step moves the parameters by Adam's momentum alone
    ranks.check_params(got[0]["params"][STEPS], ref["params"][STEPS],
                       ref["grads"], STEPS)


def test_global_batch_must_divide_over_the_ranks(four_ranks):
    got, _ = four_ranks
    assert all(rank["refused"] for rank in got)
    batch = np.zeros((5, 1))
    assert local_rows(batch) is batch  # one process: the whole batch


def _two_steps(step, **kw):
    model = ranks.flagship("cpu")
    opts = make_train_state(model)
    gen = torch.Generator().manual_seed(0)
    terms = [step(model, *opts, torch.from_numpy(ranks.images(8, 64, 100 + i)),
                  gen, ranks.LMBDA, **kw) for i in range(2)]
    return terms, ranks.flat_params(opts)


def test_world_of_one_is_train_step_bitwise():
    ref_terms, ref = _two_steps(train_step)
    runs = [_two_steps(data_parallel_train_step)]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            f"{ranks.free_port()}", rank=0, world_size=1,
                            timeout=ranks.RANK_TIMEOUT)
    try:
        runs.append(_two_steps(data_parallel_train_step))
        runs.append(_two_steps(data_parallel_train_step,
                               group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    for terms, params in runs:
        assert torch.equal(params, ref)
        for t, r in zip(terms, ref_terms):
            assert {k: float(v) for k, v in t.items()} \
                == {k: float(v) for k, v in r.items()}


def test_vbr_train_step_on_two_ranks_equals_one_process():
    got = ranks.run_ranks(2, ranks.vbr_job)
    ref = ranks.vbr_steps("cpu", group_step=False)
    for rank in got:
        for t, r in zip(rank["terms"], ref["terms"]):
            assert t.keys() == r.keys()
            for k in r:
                np.testing.assert_allclose(t[k], r[k], rtol=1e-5, err_msg=k)
        for g, r in zip(rank["grads"], ref["grads"]):
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max())
    ranks.check_params(got[0]["params"], ref["params"], ref["grads"],
                       len(ranks.VBR_LEVELS))


def test_four_ranks_match_jax_mesh_step(tmp_path, monkeypatch):
    """The port's weights through the repository's .npz (rounded to float16
    in both packages); JAX's step on the mesh with the batch sharded over
    its data axis, its noise patched to the same arrays."""
    weights = tmp_path / "w.npz"
    jm = jax_twin(lambda: JModel(N=ranks.N, K=ranks.K, rngs=nnx.Rngs(0)),
                  ranks.flagship("cpu"), weights)
    got = ranks.run_ranks(4, ranks.table_noise_job, str(weights), STEPS)

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        assert (minval, maxval) == (-0.5, 0.5)
        return jnp.asarray(ranks.table_noise(shape), dtype)

    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    jax.clear_caches()
    try:
        j_net, j_aux = j_make_train_state(jm, 1e-4, 1e-3, 1.0)
        sharding = NamedSharding(make_mesh(4), P("data", None, None, None))
        ref = []
        for step in range(STEPS):
            x = jax.device_put(jnp.asarray(ranks.images(8, 64, 30 + step)),
                               sharding)
            out = j_step(jm, j_net, j_aux, x, jax.random.key(step),
                         ranks.LMBDA)
            ref.append({k: float(v) for k, v in out.items()})
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    for rank in got:
        for t, r in zip(rank, ref):
            assert t.keys() == r.keys()
            for k in r:
                np.testing.assert_allclose(t[k], r[k], rtol=1e-3, err_msg=k)
    assert ref[-1]["loss"] < ref[0]["loss"]


def _ppm_folder(root):
    for split, n in (("train", 8), ("test", 2)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            seed = 100 * (split == "test") + i
            save_image(root / split / f"{i}.ppm",
                       textured_leaves(64, 64, seed=seed))
    return root


def _cli_args(data, ck):
    return ["-d", str(data), "-n", "16", "-K", "2", "--epochs", "1",
            "--batch-size", "4", "--patch-size", "64", "--num-workers", "1",
            "--checkpoint-dir", str(ck), "--device", "cpu"]


def test_trainer_under_torchrun_matches_one_process(tmp_path, monkeypatch):
    """2 ranks over 8 PPMs: 2 steps of global batch 4. The ranks' run
    imports no TensorBoard (a package on their path that refuses to
    import), as the one-process run here (``sys.modules``)."""
    data = _ppm_folder(tmp_path / "data")
    shim = tmp_path / "shim" / "tensorboard"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text(
        "raise ImportError('TensorBoard is not used here')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(shim.parent), str(REPO)]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
         "--master-port", str(ranks.free_port()), "-m",
         "flashgmm_tpu_torch.examples.train",
         *_cli_args(data, tmp_path / "two")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train_main(_cli_args(data, tmp_path / "one")) == 0

    logs = [[json.loads(line) for line in
             (tmp_path / run / "train_log.jsonl").read_text().splitlines()]
            for run in ("two", "one")]
    assert len(logs[0]) == len(logs[1]) == 1
    assert proc.stdout.count('"epoch": 0') == 1  # the first rank's alone
    two, one = logs[0][0], logs[1][0]
    assert two["steps"] == one["steps"] == 2
    for k in ("loss", "bpp_loss", "mse_loss", "aux_loss", "test_loss"):
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, err_msg=k)
    states = [torch.load(tmp_path / run / "latest", weights_only=True)["model"]
              for run in ("two", "one")]
    assert states[0].keys() == states[1].keys()
    d = max(float((states[0][k] - states[1][k]).abs().max())
            for k in states[1] if states[1][k].is_floating_point())
    assert d <= 2 * 1e-4 * 2, d  # Adam's bound: see the module's docstring
    close = sum(int(((states[0][k] - states[1][k]).abs() <= 1e-6).sum())
                for k in states[1] if states[1][k].is_floating_point())
    total = sum(v.numel() for v in states[1].values() if v.is_floating_point())
    assert close >= 0.999 * total, (close, total)

"""The rank side of the tests of training across processes
(tests/test_torch_port_ddp.py on the CPU over gloo,
tests/test_torch_port_gpu.py's ``test_train_step_across_cards`` over
NCCL): ``run_ranks`` starts one spawned process a rank, each of which
starts its group through ``parallel.init_from_env`` from torchrun's
variables and runs one job of this module; the jobs and the one-process
references they are held against. Spawned children import this module by
name, so it stays importable and imports no JAX.

The flagship is cut to N=32, K=2 (test_torch_port_train.py's widths), on
global batches of 8 made by ``np.random.RandomState``."""

import datetime
import os
import socket
import time
import traceback
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N, K = 32, 2
LMBDA = 0.01
GLOBAL_BATCH = 8
RANK_TIMEOUT = datetime.timedelta(seconds=60)  # each collective's


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def images(b, hw, seed):
    return np.random.RandomState(seed).rand(b, hw, hw, 3).astype(np.float32)


def table_noise(shape):
    """One numpy array of U[-0.5, 0.5) per shape (test_torch_port_train.py's
    ``equal_noise``): the noise both packages are given where they are
    compared."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


def _rank_main(rank, world, port, device, job, args, results):
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False  # float32 results compared
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        from flashgmm_tpu_torch.parallel import init_from_env

        dev = init_from_env(device, timeout=RANK_TIMEOUT)
        try:
            results.put((rank, True, job(dev, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(world, job, *args, device="cpu", timeout=120):
    """[job(device, *args) of each rank] from ``world`` spawned processes,
    one group over them; fails when a rank raises or the ranks are not all
    done within ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, port, device, job, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    done = {}
    try:
        while len(done) < world:
            rank, ok, value = results.get(
                timeout=max(1.0, deadline - time.monotonic()))
            assert ok, f"rank {rank} of {world} failed:\n{value}"
            done[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return [done[r] for r in range(world)]


def flagship(device, seed=0):
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2

    return Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=seed,
                                            device=device)


def flat_params(opts):
    """The parameters of both optimizers, net then aux, as one tensor (the
    net part in the order of the recorded gradients)."""
    return torch.cat([p.detach().reshape(-1) for o in opts
                      for g in o.param_groups for p in g["params"]])


def record_grads(opt):
    """Every ``opt.step`` first appends the flat gradient it is given."""
    seen, step = [], opt.step

    def recorded(*args, **kwargs):
        seen.append(torch.cat([p.grad.reshape(-1) for g in opt.param_groups
                               for p in g["params"]]).cpu().numpy())
        return step(*args, **kwargs)

    opt.step = recorded
    return seen


def step_counts(opt):
    return sorted({int(st["step"]) for st in opt.state.values()})


def nan_batch(step, world, hw):
    """The global batch of ``step`` with one NaN in the last rank's rows."""
    x = images(GLOBAL_BATCH, hw, 100 + step)
    x[(world - 1) * (GLOBAL_BATCH // world), 5, 7, 1] = np.nan
    return x


def batches(steps, world, hw, nan_last):
    return [nan_batch(i, world, hw) if nan_last and i == steps - 1
            else images(GLOBAL_BATCH, hw, 100 + i) for i in range(steps)]


def _terms(out):
    return {k: float(v) for k, v in out.items()}


def one_process(device, steps, world, hw=64, nan_last=False):
    """The reference: ``train_step`` on each whole global batch, the
    flagship of seed 0, the generator of seed 0: {"terms", "grads",
    "params"}, each a list over the steps (the flat gradient each net Adam
    step was given, the parameters after each step)."""
    from flashgmm_tpu_torch.parallel import make_train_state, train_step

    model = flagship(device)
    opts = make_train_state(model)
    grads = record_grads(opts[0])
    gen = torch.Generator(device=device).manual_seed(0)
    terms, params = [], []
    for x in batches(steps, world, hw, nan_last):
        terms.append(_terms(train_step(
            model, *opts, torch.from_numpy(x).to(device), gen, LMBDA)))
        params.append(flat_params(opts).cpu().numpy())
    return {"terms": terms, "grads": grads, "params": params}


def flagship_job(device, steps, hw=64, nan_last=False):
    """``data_parallel_train_step`` over the group on this rank's rows of
    the reference's batches. Every rank but the first builds its model
    from another seed: ``broadcast_parameters`` gives it the first rank's.
    Returns the reference's fields (the global means of the terms) and,
    after each step, whether the replicas are bitwise equal (an all-gather
    of the flat parameters), then whether every parameter is finite, both
    optimizers' step counts, and whether ``local_rows`` refuses a global
    batch that does not divide over the ranks."""
    from flashgmm_tpu_torch.parallel import (broadcast_parameters,
                                             data_parallel_train_step,
                                             local_rows, make_train_state)

    world, rank = dist.get_world_size(), dist.get_rank()
    model = flagship(device, seed=rank)
    broadcast_parameters(model)
    opts = make_train_state(model)
    grads = record_grads(opts[0])
    gen = torch.Generator(device=device).manual_seed(0)
    terms, params, equal = [], [], []
    for x in batches(steps, world, hw, nan_last):
        rows = torch.from_numpy(local_rows(x)).to(device)
        terms.append(_terms(data_parallel_train_step(model, *opts, rows, gen,
                                                     LMBDA)))
        flat = flat_params(opts)
        replicas = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(replicas, flat)
        equal.append(all(torch.equal(r, flat) for r in replicas))
        if rank == 0:
            params.append(flat.cpu().numpy())
    try:
        local_rows(np.zeros((world * 2 + 1, 1)))
        refused = False
    except ValueError:
        refused = True
    return {"terms": terms, "grads": grads, "params": params, "equal": equal,
            "finite": bool(torch.isfinite(flat).all()),
            "counts": [step_counts(o) for o in opts], "refused": refused}


def patch_table_noise():
    """The port's training noise from ``table_noise``: a rank's rows of the
    global shape's array (where the step hands the forward a RankNoise)."""
    from flashgmm_tpu_torch.entropy_models import entropy_models
    from flashgmm_tpu_torch.entropy_models.entropy_models import RankNoise
    from flashgmm_tpu_torch.latent_codecs import checkerboard

    def uniform(shape, generator, like):
        if isinstance(generator, RankNoise):
            return generator.rows(uniform(generator.global_shape(shape), None,
                                          like))
        return torch.from_numpy(table_noise(shape)).to(like.dtype)

    entropy_models.uniform_noise = uniform
    checkerboard.uniform_noise = uniform


def table_noise_job(device, weights, steps):
    """``data_parallel_train_step`` from the weights in the .npz
    ``weights`` under ``patch_table_noise``, on the rows of
    ``images(8, 64, 30 + step)``: each step's global terms."""
    from flashgmm_tpu_torch.parallel import (data_parallel_train_step,
                                             local_rows, make_train_state)
    from flashgmm_tpu_torch.zoo import load_npz

    patch_table_noise()
    model = flagship(device)
    load_npz(model, weights)
    opts = make_train_state(model, 1e-4, 1e-3, 1.0)
    gen = torch.Generator(device=device).manual_seed(0)
    return [_terms(data_parallel_train_step(
        model, *opts, torch.from_numpy(local_rows(
            images(GLOBAL_BATCH, 64, 30 + step))).to(device), gen, LMBDA))
        for step in range(steps)]


VBR_LEVELS = (0, 7)  # a step at each gain level, as the VBR train tests


def vbr_steps(device, group_step):
    """Two steps of mbt2018-mean-vbr with the variable-step bottleneck at
    N=32, M=48 (test_torch_port_vbr_train.py's widths), seed 0, on global
    batches of 4 64x64 images, over the default group where
    ``group_step``: {"terms", "grads", "params" (after the last step)}."""
    from flashgmm_tpu_torch.models.vbr import (VBR_LMBDAS,
                                               MeanScaleHyperpriorVbr)
    from flashgmm_tpu_torch.parallel import (local_rows, make_train_state,
                                             vbr_train_step)

    model = MeanScaleHyperpriorVbr(32, 48, vr_entbttlnck=True, seed=0,
                                   device=device)
    opts = make_train_state(model)
    grads = record_grads(opts[0])
    gen = torch.Generator(device=device).manual_seed(0)
    terms = []
    for step, s in enumerate(VBR_LEVELS):
        x = images(4, 64, 60 + step)
        if group_step:
            x = local_rows(x)
        out = vbr_train_step(model, *opts, torch.from_numpy(x).to(device),
                             gen, s, VBR_LMBDAS[s])
        terms.append(_terms(out))
    flat = flat_params(opts)
    if group_step:
        replicas = [torch.empty_like(flat)
                    for _ in range(dist.get_world_size())]
        dist.all_gather(replicas, flat)
        assert all(torch.equal(r, flat) for r in replicas)
    return {"terms": terms, "grads": grads, "params": flat.cpu().numpy()}


def vbr_job(device):
    return vbr_steps(device, group_step=True)


def check_params(got, ref, grads, steps, lr=1e-4):
    """The parameters of a run across ranks against the one process's
    (both ``flat_params``): within 1e-6 wherever each of the reference's
    net gradients so far is at least 1e-4 of its largest entry in size, and
    in the aux part; elsewhere within ``2 * lr * steps``. Adam divides each
    update by its gradient's size, so an entry whose gradient is within
    float32 summation error of zero moves by up to ``lr`` a step in a
    direction that error decides."""
    net = grads[0].size
    sure = np.ones(net, bool)
    for g in grads[:steps]:
        top = np.abs(g).max()
        if top > 0:
            sure &= np.abs(g) >= 1e-4 * top
    d = np.abs(got - ref)
    assert d[:net][sure].max(initial=0) <= 1e-6, d[:net][sure].max()
    assert d[net:].max(initial=0) <= 1e-6, d[net:].max()
    assert d.max() <= 2 * lr * steps, d.max()
    return int(sure.sum())

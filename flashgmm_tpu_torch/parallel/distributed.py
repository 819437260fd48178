"""The process group of a run across cards: one process a card on one
host, started by torchrun (``python -m torch.distributed.run
--nproc-per-node W -m ...``).

``init_from_env`` starts the default group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) at the explicit address ``tcp://MASTER_ADDR:MASTER_PORT``,
with no cluster discovery: on the card NCCL, each rank on
``cuda:LOCAL_RANK`` (made the current device first); with
``device="cpu"`` gloo. Nothing falls back: more ranks than cards raise
(NCCL refuses two ranks on one card, as ``make_mesh`` refuses two slots on
one), a failed NCCL start raises, and nothing runs on the CPU unless the
caller asked for it. Every collective waits at most ``timeout``, so a hung
rank raises instead of holding the others forever.
"""

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether torchrun started this process (its ``WORLD_SIZE`` is set)."""
    return "WORLD_SIZE" in os.environ


def init_from_env(device="cuda", timeout=TIMEOUT):
    """Starts the default process group from torchrun's environment;
    returns this rank's device: ``cuda:LOCAL_RANK`` (NCCL), or the CPU
    (gloo) when ``device`` is a CPU device."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"not started by torchrun: {missing} unset")
    rank, world, local = (int(os.environ[k]) for k in ENV[:3])
    if torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(f"{world} ranks on {cards} cards: NCCL takes "
                               "one process a card")
        backend, dev = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", rank=rank, world_size=world,
        timeout=timeout)
    return dev


def active_group(group=None):
    """``group`` (None: the default group, where one exists), or None where
    the caller runs on one process: no group, or a world of 1."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None
        group = dist.group.WORLD
    return group if dist.get_world_size(group) > 1 else None


@torch.no_grad()
def broadcast_parameters(model, group=None):
    """The first rank's parameters on every rank of ``group`` (None: the
    default group), by one broadcast of the flat parameters; nothing on
    one process. Once after the model is built or a checkpoint loaded:
    from then on every step's equal reduction keeps the replicas equal bit
    for bit."""
    group = active_group(group)
    if group is None:
        return
    params = list(model.parameters())
    flat = torch.cat([p.reshape(-1) for p in params])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    for p, v in zip(params, flat.split([p.numel() for p in params])):
        p.copy_(v.view_as(p))

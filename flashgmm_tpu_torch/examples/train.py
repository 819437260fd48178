"""Training entry point (port of examples/train.py; the reference's
train_ckbd_gmm.py / train_elic_gmm.py), on the card unless ``--device cpu``
is given: on one card, or under torchrun on several, one process a card.

Under torchrun (``python -m torch.distributed.run --nproc-per-node W -m
flashgmm_tpu_torch.examples.train ...``) the ranks start one process group
(``parallel/distributed.py``: NCCL, each rank on ``cuda:LOCAL_RANK``; gloo
with ``--device cpu``) and take the parameters of the first rank.
``--batch-size`` is the global batch and must divide by W. The first rank
alone runs the loader and broadcasts each global batch (the crops come
from Python's ``random``, which the loader's threads call in no fixed
order, so two processes' loaders would not agree on a batch); every rank
takes its rows and steps through ``data_parallel_train_step`` from the same
generator seed, so the step is the one-process step on the whole batch,
and the logged terms are the global means. The first rank alone evaluates,
probes and writes the log, TensorBoard and the checkpoints, and the others
wait for it at a barrier; on resume every rank loads the checkpoint. Without
torchrun the trainer runs on one process as before.

The net/aux optimizer split, the non-finite guard, gradient clipping,
MultiStepLR decay, periodic evaluation and latest/best/epoch_{n}
checkpoints follow the reference's training recipe (train_ckbd_gmm.py:
143-275, 474-597). The JAX package's three root scripts are model names
here: ``--model cheng2020-anchor-checkerboard-gmm`` (train_ckbd_gmm.py),
``elic2022-official`` (train_elic_gmm.py) and
``cheng2020-anchor-checkerboard`` (train_ckbd_gsm.py).

The learning-rate decay is ``torch.optim.lr_scheduler.MultiStepLR``
(gamma 0.1) on the net optimizer, and its state goes into the checkpoint.
The JAX loop rebuilds both optimizers at a milestone instead, which resets
Adam's moments, and a resumed run of it restarts at the full rate.

Library settings: the trainer sets ``torch.backends.cudnn.benchmark =
True`` (the patch shape is fixed) and leaves TF32 at PyTorch's defaults
(cuDNN's convs on TF32). Under the coding path's pinned settings (TF32 off,
no autotuning) cuDNN takes a gemv/FFT algorithm for the flagship's float32
3x3 convs at 192 channels, and one 768x512 training forward took 1198 ms
on an NVIDIA H100 80GB HBM3 at 700 W. No bytes depend on a train step, so
nothing is pinned; the codecs keep their own pinned settings.

Usage:
    python -m flashgmm_tpu_torch.examples.train \
        --model cheng2020-anchor-checkerboard-gmm \
        --dataset /path/to/imagefolder -n 192 -K 4 --lambda 0.01 --epochs 200
    python -m torch.distributed.run --nproc-per-node 4 \
        -m flashgmm_tpu_torch.examples.train --dataset /path/to/imagefolder \
        --batch-size 32
"""

import argparse
import inspect
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="cheng2020-anchor-checkerboard-gmm")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("-n", "--num-channels", type=int, default=192)
    p.add_argument("-m", "--latent-channels", type=int, default=320)
    p.add_argument("-K", "--mixtures", type=int, default=4)
    p.add_argument("-e", "--epochs", type=int, default=200)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--lambda", dest="lmbda", type=float, default=1e-2)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--lr-milestones", type=int, nargs="*", default=[150, 180])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint-dir", type=str, default="./checkpoints")
    p.add_argument("--checkpoint", type=str, help="resume from checkpoint")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--probe-dir", type=str, default=None,
                   help="directory of full-size images for the periodic RD "
                        "probe (the reference's per-epoch Kodak eval)")
    p.add_argument("--probe-every", type=int, default=1)
    p.add_argument("--logdir", type=str, default=None,
                   help="TensorBoard/scalars dir (default: checkpoint-dir/tb)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu only when asked)")
    return p.parse_args(argv)


def build_model(args, device=None):
    """``MODELS[args.model]`` with the N, M and K its constructor takes,
    seeded with ``args.seed``, on ``device`` (default ``args.device``)."""
    import flashgmm_tpu_torch.models  # noqa: F401  (registers the models)
    from flashgmm_tpu_torch.registry import MODELS

    model_cls = MODELS[args.model]
    sig = inspect.signature(model_cls.__init__)
    kwargs = {}
    for name, value in (("N", args.num_channels), ("M", args.latent_channels),
                        ("K", args.mixtures)):
        if name in sig.parameters:
            kwargs[name] = value
    return model_cls(**kwargs, seed=args.seed,
                     device=args.device if device is None else device)


def main(argv=None):
    args = parse_args(argv)

    import torch.distributed as dist

    from flashgmm_tpu_torch.datasets import BatchLoader, ImageFolder
    from flashgmm_tpu_torch.datasets.image import IMG_EXTENSIONS, load_image
    from flashgmm_tpu_torch.parallel import (broadcast_parameters,
                                             data_parallel_train_step,
                                             init_from_env, launched,
                                             local_rows, make_train_state)
    from flashgmm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    from flashgmm_tpu_torch.utils.logging import ScalarWriter, rd_probe

    np.random.seed(args.seed)
    random.seed(args.seed)  # the crops
    if launched():
        device = init_from_env(args.device)
    else:
        device = torch.device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    first = not dist.is_initialized() or dist.get_rank() == 0
    writer = None
    try:
        if args.batch_size % world:
            raise ValueError(f"--batch-size {args.batch_size} does not "
                             f"divide over {world} ranks")
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True

        model = build_model(args, device)
        opt_net, opt_aux = make_train_state(
            model, args.learning_rate, args.aux_learning_rate,
            args.clip_max_norm)
        scheduler = torch.optim.lr_scheduler.MultiStepLR(
            opt_net, milestones=args.lr_milestones, gamma=0.1)

        start_epoch = 0
        best_loss = float("inf")
        if args.checkpoint:
            meta = load_checkpoint(args.checkpoint, model, opt_net, opt_aux,
                                   scheduler)
            start_epoch = meta.get("epoch", 0) + 1
            best_loss = meta.get("best_loss", best_loss)
        broadcast_parameters(model)

        train_ds = ImageFolder(args.dataset, patch_size=args.patch_size,
                               split="train")
        test_ds = ImageFolder(args.dataset, patch_size=args.patch_size,
                              split="test")
        loader = BatchLoader(train_ds, args.batch_size,
                             num_workers=args.num_workers, seed=args.seed)

        ckpt_dir = Path(args.checkpoint_dir)
        log_path = ckpt_dir / "train_log.jsonl"
        probe_images = None
        if first:
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            writer = ScalarWriter(args.logdir or ckpt_dir / "tb")
            if args.probe_dir:
                probe_images = [
                    load_image(f)
                    for f in sorted(Path(args.probe_dir).iterdir())
                    if f.suffix.lower() in IMG_EXTENSIONS
                ]

        generator = torch.Generator(device=device).manual_seed(args.seed)
        shape = (args.batch_size, args.patch_size, args.patch_size, 3)

        def batches():
            source = iter(loader) if first else None
            for _ in range(len(loader)):
                x = torch.from_numpy(next(source)).to(device) if first \
                    else torch.empty(shape, device=device)
                if world > 1:
                    dist.broadcast(x, src=0)
                yield local_rows(x)

        for epoch in range(start_epoch, args.epochs):
            lr = opt_net.param_groups[0]["lr"]
            t0 = time.time()
            n_steps = 0
            agg = {}
            for x in batches():
                out = data_parallel_train_step(model, opt_net, opt_aux, x,
                                               generator, args.lmbda)
                loss = float(out["loss"])  # the global mean
                if not np.isfinite(loss):  # log only: the step zeroed the update
                    continue
                n_steps += 1
                for k, v in out.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
            scheduler.step()
            if not first:
                dist.barrier()  # the first rank's evaluation and checkpoints
                continue

            metrics = {k: v / max(n_steps, 1) for k, v in agg.items()}
            metrics.update(epoch=epoch, steps=n_steps,
                           seconds=time.time() - t0)

            if epoch % args.eval_every == 0:
                metrics["test_loss"] = evaluate(model, test_ds, args)

            if probe_images and epoch % args.probe_every == 0:
                metrics.update(rd_probe(model, probe_images, args.lmbda))

            metrics["lr"] = lr
            writer.add_scalars(metrics, epoch, prefix="train/")
            writer.flush()
            with open(log_path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
            print(json.dumps(metrics), flush=True)

            def save(name):
                save_checkpoint(ckpt_dir / name, model, opt_net, opt_aux,
                                {"epoch": epoch, "best_loss": best_loss},
                                scheduler)

            save("latest")
            loss_now = metrics.get("test_loss", metrics.get("loss", np.inf))
            if loss_now < best_loss:
                best_loss = loss_now
                save("best")
            if epoch % 20 == 0:
                save(f"epoch_{epoch}")
            if world > 1:
                dist.barrier()
    finally:
        if writer is not None:
            writer.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


@torch.no_grad()
def evaluate(model, dataset, args):
    """Mean RD loss of the eval forward over the first 16 test images (each
    a random crop of the patch size), one image a forward."""
    from flashgmm_tpu_torch.losses import rate_distortion_loss

    dev = next(model.parameters()).device
    model.eval()
    total = 0.0
    n = min(len(dataset), 16)
    for i in range(n):
        x = torch.from_numpy(dataset[i][None]).to(dev)
        out = model(x, training=False)
        total += float(rate_distortion_loss(out, x, args.lmbda)["loss"])
    return total / max(n, 1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

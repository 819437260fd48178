"""Video training entry point, ssf2020 scale-space flow (port of
examples/train_video.py; the reference's examples/train_video.py:300-475),
on one CUDA device unless ``--device cpu`` is given.

Vimeo90k tuplets (``Vimeo90kDataset``), the multi-frame RD loss (the mean
frame distortion plus the total rate, ``video_train_step``), the net/aux
optimizer split, the non-finite guard, clipping and checkpoints, as the
JAX trainer. The checkpoint and scheduler conventions are the port
trainer's (``examples/train.py``): one ``torch.save`` file each for
``latest`` and ``best`` with a ``.meta.json`` beside it, the net learning
rate decayed by ``MultiStepLR`` (gamma 0.1) at ``--lr-milestones`` (none
by default: the JAX video trainer does not decay it) and the scheduler's
state in the checkpoint.

Usage:
    python -m flashgmm_tpu_torch.examples.train_video -d /path/to/vimeo90k \\
        --tuplet 3 --lambda 1e-2 --epochs 20
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="vimeo90k root (sequences/ + sep_trainlist.txt)")
    p.add_argument("--tuplet", type=int, default=3, help="frames per sample")
    p.add_argument("-e", "--epochs", type=int, default=20)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--lambda", dest="lmbda", type=float, default=1e-2)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--lr-milestones", type=int, nargs="*", default=[])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint-dir", type=str,
                   default="./checkpoints_video")
    p.add_argument("--checkpoint", type=str, help="resume from checkpoint")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="cap steps per epoch (debug)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu only when asked)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from flashgmm_tpu_torch.datasets import BatchLoader, Vimeo90kDataset
    from flashgmm_tpu_torch.models.video import ScaleSpaceFlow
    from flashgmm_tpu_torch.parallel import make_train_state, video_train_step
    from flashgmm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    np.random.seed(args.seed)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True

    model = ScaleSpaceFlow(seed=args.seed, device=device)
    opt_net, opt_aux = make_train_state(
        model, args.learning_rate, args.aux_learning_rate, args.clip_max_norm)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        opt_net, milestones=args.lr_milestones, gamma=0.1)
    start_epoch = 0
    best = float("inf")
    if args.checkpoint:
        meta = load_checkpoint(args.checkpoint, model, opt_net, opt_aux,
                               scheduler)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best = meta.get("best_loss", best)
        print(f"resumed from {args.checkpoint} at epoch {start_epoch}")

    dataset = Vimeo90kDataset(args.dataset, split="train", tuplet=args.tuplet,
                              patch_size=args.patch_size)
    loader = BatchLoader(dataset, args.batch_size, shuffle=True,
                         num_workers=args.num_workers, seed=args.seed)

    ckdir = Path(args.checkpoint_dir)
    ckdir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        losses = []
        for step, batch in enumerate(loader):  # [B, T, H, W, 3]
            if args.steps_per_epoch and step >= args.steps_per_epoch:
                break
            x = torch.from_numpy(batch).to(device)
            frames = [x[:, t] for t in range(x.shape[1])]
            out = video_train_step(model, opt_net, opt_aux, frames,
                                   generator, lmbda=args.lmbda)
            loss = float(out["loss"])
            if not np.isfinite(loss):  # log only: the step zeroed the update
                print(f"  step {step}: non-finite loss, skipped")
                continue
            losses.append(loss)
            if step % 50 == 0:
                print(f"  epoch {epoch} step {step}: loss {loss:.4f} "
                      f"(bpp {float(out['bpp_loss']):.4f}, "
                      f"mse {float(out['mse_loss']):.6f})", flush=True)
        scheduler.step()
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        print(f"epoch {epoch}: loss {mean_loss:.4f} in "
              f"{time.time() - t0:.0f}s", flush=True)
        if mean_loss < best:
            best = mean_loss
            save_checkpoint(ckdir / "best", model, opt_net, opt_aux,
                            {"epoch": epoch, "loss": mean_loss,
                             "best_loss": best}, scheduler)
        save_checkpoint(ckdir / "latest", model, opt_net, opt_aux,
                        {"epoch": epoch, "loss": mean_loss, "best_loss": best},
                        scheduler)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

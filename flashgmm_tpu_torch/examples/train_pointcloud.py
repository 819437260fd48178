"""Point-cloud compression training entry point (port of
examples/train_pointcloud.py; the reference's examples/
train_pointcloud.py:240-373), on one CUDA device unless ``--device cpu``
is given.

A point-cloud dataset (folder / shapenet / modelnet / s3dis /
semantic-kitti, positions only), a registered point-cloud codec, the
chamfer or the density-preserving (hrtzxf2022) RD loss
(``pointcloud_train_step``), the net/aux optimizer split, the non-finite
guard, clipping and checkpoints, as the JAX trainer. The checkpoint and
scheduler conventions are the port trainer's (``examples/train.py``): one
``torch.save`` file each for ``latest`` and ``best`` with a ``.meta.json``
beside it, the net learning rate decayed by ``MultiStepLR`` (gamma 0.1) at
``--lr-milestones`` (none by default: the JAX trainer does not decay it)
and the scheduler's state in the checkpoint.

Usage:
    python -m flashgmm_tpu_torch.examples.train_pointcloud \\
        -d /path/to/clouds --model sfu-pcc-rec-pointnet --num-points 1024 \\
        --lambda 1.0
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

DATASETS = {
    "folder": "PointCloudFolder",
    "shapenet": "ShapeNetCorePartDataset",
    "modelnet": "ModelNetDataset",
    "s3dis": "S3disDataset",
    "semantic-kitti": "SemanticKittiDataset",
}


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--dataset-type", choices=sorted(DATASETS),
                   default="folder")
    p.add_argument("--model", default="sfu-pcc-rec-pointnet")
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--loss", choices=("chamfer", "hrtzxf2022"), default=None,
                   help="default: hrtzxf2022 for the hrtzxf models, else "
                   "chamfer")
    p.add_argument("-e", "--epochs", type=int, default=50)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--lambda", dest="lmbda", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--lr-milestones", type=int, nargs="*", default=[])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint-dir", type=str, default="./checkpoints_pcc")
    p.add_argument("--checkpoint", type=str, help="resume from checkpoint")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu only when asked)")
    return p.parse_args(argv)


class _PosOnly:
    """Dict-yielding datasets (shapenet/s3dis/kitti) carry positions under
    "pos"; the codecs train on positions alone."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        item = self.base[i]
        return item["pos"] if isinstance(item, dict) else item


def main(argv=None):
    args = parse_args(argv)

    from flashgmm_tpu_torch import datasets as ds
    from flashgmm_tpu_torch import models  # noqa: F401  (fills the registry)
    from flashgmm_tpu_torch.datasets import BatchLoader
    from flashgmm_tpu_torch.parallel import (make_train_state,
                                             pointcloud_train_step)
    from flashgmm_tpu_torch.registry import MODELS
    from flashgmm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    np.random.seed(args.seed)
    device = torch.device(args.device)
    model = MODELS[args.model](num_points=args.num_points, seed=args.seed,
                               device=device)
    loss_type = args.loss or (
        "hrtzxf2022" if "hrtzxf" in args.model else "chamfer")
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

    ds_cls = getattr(ds, DATASETS[args.dataset_type])
    dataset = _PosOnly(ds_cls(args.dataset, split="train",
                              num_points=args.num_points, seed=args.seed))
    loader = BatchLoader(dataset, args.batch_size, shuffle=True,
                         num_workers=args.num_workers, seed=args.seed)

    ckdir = Path(args.checkpoint_dir)
    ckdir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        losses = []
        for step, batch in enumerate(loader):
            if args.steps_per_epoch and step >= args.steps_per_epoch:
                break
            pts = torch.from_numpy(np.asarray(batch, np.float32)).to(device)
            out = pointcloud_train_step(model, opt_net, opt_aux, pts,
                                        generator, loss_type=loss_type,
                                        lmbda=args.lmbda)
            loss = float(out["loss"])
            if not np.isfinite(loss):  # log only: the step zeroed the update
                print(f"  step {step}: non-finite loss, skipped")
                continue
            losses.append(loss)
            if step % 50 == 0:
                extras = ", ".join(f"{k} {float(v):.4f}"
                                   for k, v in out.items() if k != "loss")
                print(f"  epoch {epoch} step {step}: loss {loss:.4f} "
                      f"({extras})", flush=True)
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

"""Training observability (port of flashgmm_tpu/utils/logging.py; the
reference's train_ckbd_gmm.py:66-114, 198-211, 487): TensorBoard scalars
and a periodic full-image RD probe, the reference's per-epoch Kodak
evaluation."""

import json
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from flashgmm_tpu_torch.ops import compute_padding

__all__ = ["ScalarWriter", "rd_probe"]


class ScalarWriter:
    """TensorBoard's SummaryWriter where it imports, always mirrored to
    ``scalars.jsonl`` in ``logdir`` (machine-readable, no dependency)."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "scalars.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=str(self.logdir))
        except ImportError:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)})
            + "\n"
        )

    def add_scalars(self, scalars: dict, step: int, prefix: str = ""):
        """Every entry that converts to a float; others are left out."""
        for k, v in scalars.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self.add_scalar(f"{prefix}{k}", value, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@torch.no_grad()
def rd_probe(model, images, lmbda: float, max_images: int = 8):
    """Entropy-estimation RD on held-out full images (the reference's
    test_kodak, train_ckbd_gmm.py:66-114): each image zero-padded to a
    multiple of 64, the eval forward, bpp from the likelihoods, PSNR on
    [0, 1] over the unpadded area.

    ``images``: iterable of [H, W, 3] float arrays. Returns the means
    {"probe_bpp", "probe_psnr", "probe_rd_loss"} and "probe_images"."""
    dev = next(model.parameters()).device
    model.eval()
    bpps, psnrs, losses = [], [], []
    for i, img in enumerate(images):
        if i >= max_images:
            break
        x = torch.as_tensor(img, dtype=torch.float32, device=dev)[None]
        h, w = x.shape[1:3]
        left, right, top, bottom = compute_padding(h, w, min_div=64)[0]
        x_pad = F.pad(x, (0, 0, left, right, top, bottom))
        out = model(x_pad, training=False)
        num_pixels = h * w
        bpp = sum(float(torch.sum(-torch.log2(lk)))
                  for lk in out["likelihoods"].values()) / num_pixels
        x_hat = out["x_hat"][:, top: top + h, left: left + w]
        mse = float(torch.mean((x_hat - x) ** 2))
        psnr = -10.0 * math.log10(max(mse, 1e-12))
        bpps.append(bpp)
        psnrs.append(psnr)
        losses.append(lmbda * 255.0**2 * mse + bpp)
    n = max(len(bpps), 1)
    return {
        "probe_bpp": sum(bpps) / n,
        "probe_psnr": sum(psnrs) / n,
        "probe_rd_loss": sum(losses) / n,
        "probe_images": len(bpps),
    }

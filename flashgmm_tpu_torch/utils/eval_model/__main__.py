"""Evaluate a model on a directory of images (port of
flashgmm_tpu/utils/eval_model/__main__.py; CompressAI's
``python -m compressai.utils.eval_model``, utils/eval_model/__main__.py:
106-513): pads each image to a multiple of 64, times real
compress/decompress (``--real``) or runs the entropy-estimation forward,
and prints the mean bpp/PSNR/MS-SSIM as one JSON report.

The model runs on ``--device`` (default ``cuda``; ``cpu`` on request), and
every timed region ends in ``torch.cuda.synchronize()`` on the card. The
flagship and ELIC scripts of the JAX package's root (``eval_ckbd.py``,
``eval_elic.py``) are the model names ``cheng2020-anchor-checkerboard-gmm``
and ``elic2022-official`` here.

Usage:
    python -m flashgmm_tpu_torch.utils.eval_model checkpoint <image_dir> \\
        -a mbt2018-mean -N 128 -M 192 -p ckpt_file [--real]
    python -m flashgmm_tpu_torch.utils.eval_model torch <image_dir> \\
        -a bmshj2018-hyperprior -p compressai_state_dict.pth
    python -m flashgmm_tpu_torch.utils.eval_model random <image_dir> \\
        -a bmshj2018-factorized --device cpu  # randomly initialized
"""

import argparse
import inspect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


def setup_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source", choices=["checkpoint", "torch", "random"],
                   help="weight source")
    p.add_argument("dataset", type=str, help="image directory")
    p.add_argument("-a", "--architecture", required=True)
    p.add_argument("-p", "--path", type=str, help="checkpoint path")
    p.add_argument("-N", type=int, default=192)
    p.add_argument("-M", type=int, default=320)
    p.add_argument("-K", type=int, default=4)
    p.add_argument("--real", action="store_true",
                   help="real entropy coding (default: entropy estimation)")
    p.add_argument("--entropy-estimation", dest="real", action="store_false")
    p.add_argument("--min-div", type=int, default=64)
    p.add_argument("-o", "--output", type=str)
    p.add_argument("--half", action="store_true", help="(unused)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on (default: cuda)")
    return p.parse_args(argv)


def build_model(args):
    """The architecture at -N/-M/-K (those its constructor takes) on
    ``--device``, its weights from ``--path`` (a port checkpoint, or a
    CompressAI state dict for the ``torch`` source), then ``update()``."""
    from flashgmm_tpu_torch import models  # noqa: F401  (fills the registry)
    from flashgmm_tpu_torch.registry import MODELS

    cls = MODELS[args.architecture]
    params = inspect.signature(cls.__init__).parameters
    kwargs = {k: getattr(args, k) for k in ("N", "M", "K") if k in params}
    model = cls(**kwargs, device=args.device)

    if args.source == "checkpoint" and args.path:
        from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint

        load_checkpoint(args.path, model)
    elif args.source == "torch" and args.path:
        from flashgmm_tpu_torch.zoo.torch_convert import load_checkpoint_file

        load_checkpoint_file(model, args.path, strict=False)
    model.update(update_quantiles=(args.source == "random"), force=True)
    return model.eval()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def inference(model, x):
    from flashgmm_tpu_torch.ops import compute_padding, pad_image, unpad_image
    from flashgmm_tpu_torch.utils.metrics import ms_ssim, psnr

    h, w = x.shape[1:3]
    pad, unpad = compute_padding(h, w, min_div=64)
    x_padded = pad_image(x, pad)

    _sync(x.device)
    start = time.time()
    out_enc = model.compress(x_padded)
    _sync(x.device)
    enc_time = time.time() - start

    start = time.time()
    kwargs = {k: out_enc[k] for k in ("abs_max",) if k in out_enc}
    out_dec = model.decompress(out_enc["strings"], out_enc["shape"], **kwargs)
    _sync(x.device)
    dec_time = time.time() - start

    x_hat = unpad_image(out_dec["x_hat"], unpad)
    num_pixels = x.shape[0] * h * w
    bpp = _count_bytes(out_enc["strings"]) * 8.0 / num_pixels
    return {
        "psnr-rgb": float(psnr(x, x_hat)),
        "ms-ssim-rgb": float(ms_ssim(x, x_hat)),
        "bpp": bpp,
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


@torch.inference_mode()
def inference_entropy_estimation(model, x):
    from flashgmm_tpu_torch.ops import compute_padding, pad_image, unpad_image
    from flashgmm_tpu_torch.utils.metrics import ms_ssim, psnr

    h, w = x.shape[1:3]
    pad, unpad = compute_padding(h, w, min_div=64)
    x_padded = pad_image(x, pad)

    _sync(x.device)
    start = time.time()
    out = model(x_padded, training=False)
    _sync(x.device)
    elapsed = time.time() - start

    x_hat = unpad_image(out["x_hat"], unpad)
    num_pixels = x.shape[0] * h * w
    bpp = sum(float(torch.sum(-torch.log2(lk)))
              for lk in out["likelihoods"].values()) / num_pixels
    return {
        "psnr-rgb": float(psnr(x, x_hat)),
        "ms-ssim-rgb": float(ms_ssim(x, x_hat)),
        "bpp": bpp,
        "encoding_time": elapsed / 2,
        "decoding_time": elapsed / 2,
    }


def _count_bytes(strings):
    """Bytes of the strings, nested lists included; integers and tensors
    are side information and count nothing, as in the JAX package."""
    n = 0
    if isinstance(strings, bytes):
        return len(strings)
    if isinstance(strings, (list, tuple)):
        for s in strings:
            if isinstance(s, int):
                continue
            n += _count_bytes(s)
    elif hasattr(strings, "shape"):
        return 0
    return n


def main(argv=None):
    args = setup_args(argv)

    from flashgmm_tpu_torch.datasets.image import IMG_EXTENSIONS, load_image

    model = build_model(args)
    device = torch.device(args.device)
    images = sorted(f for f in Path(args.dataset).iterdir()
                    if f.suffix.lower() in IMG_EXTENSIONS)
    if not images:
        raise SystemExit(f"No images found in {args.dataset}")

    results = defaultdict(list)
    for img_path in images:
        x = torch.from_numpy(load_image(img_path))[None].to(device)
        rv = inference(model, x) if args.real \
            else inference_entropy_estimation(model, x)
        for k, v in rv.items():
            results[k].append(v)

    output = {
        "name": args.architecture,
        "description":
            f"Inference ({'ans' if args.real else 'entropy estimation'})",
        "results": {k: float(np.mean(v)) for k, v in results.items()},
    }
    print(json.dumps(output, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(output, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Evaluate a video model on a raw YUV sequence (port of
flashgmm_tpu/utils/video/eval_model/__main__.py; CompressAI's
compressai/utils/video/eval_model/__main__.py:234-588).

Each frame: YUV 4:2:0 -> RGB 4:4:4 -> padded to a multiple of 128 ->
compress/decompress (``--real``) in GOPs whose first frame is the keyframe,
or the entropy-estimation forward -> RGB and YUV PSNR, MS-SSIM and bpp,
with the encode and decode seconds a frame, as one JSON report. The YUV
PSNR is ``(4 Y + U + V) / 6`` over the per-plane PSNRs, the reference's
weighting (its eval_model/__main__.py:149).

The model runs on ``--device`` (default ``cuda``; ``cpu`` on request), and
every timed region ends in ``torch.cuda.synchronize()`` on the card.
``-p`` loads weights into the model: a ``.npz`` of the JAX package, a
CompressAI ``.pth``, or a port checkpoint (``zoo.image.load_weights``;
the JAX package's ``-p`` takes an orbax checkpoint); without it the model
is seed-initialised and its quantiles are updated.

Usage:
    python -m flashgmm_tpu_torch.utils.video.eval_model <seq.yuv> \\
        [-f N] [--gop N] [-p weights] [--real] [--device cpu]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch


def setup_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sequence", type=str, help="raw .yuv video path")
    p.add_argument("-a", "--architecture", default="ssf2020")
    p.add_argument("-f", "--frames", type=int, default=8)
    p.add_argument("--gop", type=int, default=8)
    p.add_argument("-p", "--path", type=str, help="weights path")
    p.add_argument("--real", action="store_true")
    p.add_argument("-o", "--output", type=str)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on (default: cuda)")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_frames(path, n_frames, device):
    """The sequence's first ``n_frames`` as RGB [1, H, W, 3] in [0, 1] on
    ``device``: chroma upsampled bilinearly, BT.601, clipped."""
    from flashgmm_tpu_torch.datasets.rawvideo import RawVideoSequence
    from flashgmm_tpu_torch.transforms import ycbcr2rgb, yuv_420_to_444

    seq = RawVideoSequence(path)
    frames = []
    for i in range(min(n_frames, len(seq))):
        planes = [torch.from_numpy(p)[None, :, :, None].to(device)
                  for p in seq.to_float(seq[i])]
        frames.append(torch.clamp(ycbcr2rgb(yuv_420_to_444(tuple(planes))),
                                  0, 1))
    return frames


def main(argv=None):
    args = setup_args(argv)

    from flashgmm_tpu_torch import models  # noqa: F401  (fills the registry)
    from flashgmm_tpu_torch.ops import compute_padding, pad_image, unpad_image
    from flashgmm_tpu_torch.registry import MODELS
    from flashgmm_tpu_torch.transforms import rgb2ycbcr
    from flashgmm_tpu_torch.utils.metrics import ms_ssim, psnr
    from flashgmm_tpu_torch.zoo.image import load_weights

    device = torch.device(args.device)
    model = MODELS[args.architecture](device=device)
    if args.path:
        load_weights(model, args.path)
    model.update(update_quantiles=(args.path is None), force=True)
    model.eval()

    with torch.inference_mode():
        frames = read_frames(args.sequence, args.frames, device)
        n_frames = len(frames)
        h, w = frames[0].shape[1:3]
        pad, unpad = compute_padding(h, w, min_div=128)
        frames = [pad_image(f, pad) for f in frames]

        results = {"psnr-rgb": [], "psnr-yuv": [], "ms-ssim-rgb": [],
                   "bpp": []}
        enc_time = dec_time = 0.0
        num_pixels = h * w

        def add_quality(ref_pad, dec_pad):
            ref = unpad_image(ref_pad, unpad)
            dec = torch.clamp(unpad_image(dec_pad, unpad), 0, 1)
            results["psnr-rgb"].append(float(psnr(ref, dec)))
            results["ms-ssim-rgb"].append(float(ms_ssim(ref, dec)))
            ref_yuv, dec_yuv = rgb2ycbcr(ref), rgb2ycbcr(dec)
            p_yuv = [float(psnr(ref_yuv[..., i], dec_yuv[..., i]))
                     for i in range(3)]
            results["psnr-yuv"].append((4 * p_yuv[0] + p_yuv[1] + p_yuv[2])
                                       / 6)

        for g0 in range(0, n_frames, args.gop):
            gop = frames[g0: g0 + args.gop]
            if args.real:
                _sync(device)
                t0 = time.time()
                strings, shapes = model.compress(gop)
                _sync(device)
                enc_time += time.time() - t0
                t0 = time.time()
                dec = model.decompress(strings, shapes)
                _sync(device)
                dec_time += time.time() - t0
                nbytes = _count(strings)
                for f, d in zip(gop, dec):
                    add_quality(f, d)
                    results["bpp"].append(nbytes * 8 / (num_pixels * len(gop)))
            else:
                out = model(gop, training=False)
                for f, d, lk in zip(gop, out["x_hat"], out["likelihoods"]):
                    add_quality(f, d)
                    bits = sum(float(torch.sum(-torch.log2(v)))
                               for branch in lk.values()
                               for v in branch.values())
                    results["bpp"].append(bits / num_pixels)

    output = {
        "name": args.architecture,
        "description": f"{args.architecture} "
                       f"{'real coding' if args.real else 'entropy estimation'}",
        "sequence": args.sequence,
        "results": {
            **{k: float(np.mean(v)) for k, v in results.items()},
            "enc_time_per_frame": enc_time / max(n_frames, 1),
            "dec_time_per_frame": dec_time / max(n_frames, 1),
        },
    }
    print(json.dumps(output, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(output, f, indent=2)
    return 0


def _count(obj):
    """Bytes of the strings in nested lists, tuples and dicts."""
    if isinstance(obj, bytes):
        return len(obj)
    if isinstance(obj, dict):
        return sum(_count(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_count(v) for v in obj)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

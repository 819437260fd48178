"""Benchmark classical video codecs (x264/x265 via ffmpeg, VTM lowdelay)
on raw YUV sequences (port of flashgmm_tpu/utils/video/bench/__main__.py;
cf. compressai/utils/video/bench/__main__.py:1-364), on the host.

Full pipeline per rate point: encode the sequence, decode it back to raw
YUV, and compute per-frame PSNR-YUV / PSNR-RGB plus bpp and timing.
Requires the codec binaries; raises a clear error when absent. The RGB
PSNR goes through the port's colour transforms and metrics.

Usage: python -m flashgmm_tpu_torch.utils.video.bench x265 seq.yuv \
    -q 22 27 32 37 -f 32
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def setup_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("codec", choices=["x264", "x265", "vtm"])
    p.add_argument("sequence", type=str, help=".yuv path (name_WxH_fps_420)")
    p.add_argument("-q", "--qps", type=int, nargs="+", default=[22, 27, 32, 37])
    p.add_argument("-f", "--frames", type=int, default=32)
    p.add_argument("--build-dir", default="", help="VTM binaries directory")
    p.add_argument("--config", default="", help="VTM lowdelay config")
    p.add_argument("-o", "--output", type=str)
    return p.parse_args(argv)


def _require(binary):
    if shutil.which(binary) is None and not os.path.isfile(binary):
        raise RuntimeError(f"'{binary}' binary not found")


def _ffmpeg_encode_cmd(lib, seq_path, w, h, fps, qp, frames, out):
    return [
        "ffmpeg", "-y", "-s", f"{w}x{h}", "-pix_fmt", "yuv420p",
        "-framerate", str(fps), "-i", seq_path, "-frames:v", str(frames),
        "-c:v", lib, "-qp", str(qp), "-preset", "medium", str(out),
    ]


def _ffmpeg_decode_cmd(inp, w, h, out_yuv):
    return [
        "ffmpeg", "-y", "-i", str(inp), "-pix_fmt", "yuv420p",
        "-f", "rawvideo", str(out_yuv),
    ]


def _vtm_encode_cmd(build_dir, config, seq_path, w, h, fps, qp, frames, out):
    return [
        os.path.join(build_dir, "EncoderAppStatic"), "-i", seq_path,
        "-c", config, "-q", str(qp), "-o", "/dev/null", "-b", str(out),
        "-wdt", str(w), "-hgt", str(h), "-fr", str(fps), "-f", str(frames),
        "--InputChromaFormat=420", "--InputBitDepth=8",
        "--ConformanceWindowMode=1",
    ]


def _vtm_decode_cmd(build_dir, inp, out_yuv):
    return [
        os.path.join(build_dir, "DecoderAppStatic"),
        "-b", str(inp), "-o", str(out_yuv), "-d", "8",
    ]


def _frame_metrics(orig_yuv_path, rec_yuv_path, w, h, frames):
    """Per-frame PSNR-YUV (reference definition: per-plane PSNRs weighted
    (4*Y + U + V)/6, utils/video/eval_model/__main__.py:149) + RGB PSNR."""
    import torch

    from flashgmm_tpu_torch.transforms import ycbcr2rgb, yuv_420_to_444
    from flashgmm_tpu_torch.utils.metrics import psnr

    frame_bytes = w * h * 3 // 2
    psnr_yuv, psnr_rgb = [], []
    with open(orig_yuv_path, "rb") as fo, open(rec_yuv_path, "rb") as fr:
        for _ in range(frames):
            a = np.frombuffer(fo.read(frame_bytes), np.uint8)
            b = np.frombuffer(fr.read(frame_bytes), np.uint8)
            if a.size < frame_bytes or b.size < frame_bytes:
                break
            af, bf = a.astype(np.float32), b.astype(np.float32)
            n_y = w * h
            planes = ((af[:n_y], bf[:n_y]),
                      (af[n_y:n_y * 5 // 4], bf[n_y:n_y * 5 // 4]),
                      (af[n_y * 5 // 4:], bf[n_y * 5 // 4:]))
            p = [10 * np.log10(255.0**2 / max(np.mean((x - y) ** 2), 1e-10))
                 for x, y in planes]
            psnr_yuv.append((4 * p[0] + p[1] + p[2]) / 6)

            def to_rgb(buf):
                y = buf[: w * h].reshape(h, w).astype(np.float32) / 255
                u = buf[w * h : w * h * 5 // 4].reshape(h // 2, w // 2)
                v = buf[w * h * 5 // 4 :].reshape(h // 2, w // 2)
                u = u.astype(np.float32) / 255
                v = v.astype(np.float32) / 255
                yuv = yuv_420_to_444(tuple(
                    torch.from_numpy(np.ascontiguousarray(p))[None, :, :, None]
                    for p in (y, u, v)))
                return torch.clamp(ycbcr2rgb(yuv), 0, 1)

            psnr_rgb.append(float(psnr(to_rgb(a), to_rgb(b))))
    return float(np.mean(psnr_yuv)), float(np.mean(psnr_rgb))


def run_point(args, qp):
    from flashgmm_tpu_torch.datasets.rawvideo import get_raw_video_file_info

    info = get_raw_video_file_info(args.sequence)
    w, h, fps = info["width"], info["height"], info["fps"]
    with tempfile.TemporaryDirectory() as tmp:
        rec_yuv = Path(tmp) / "rec.yuv"
        if args.codec in ("x264", "x265"):
            _require("ffmpeg")
            lib = {"x264": "libx264", "x265": "libx265"}[args.codec]
            out = Path(tmp) / "out.mkv"
            enc_cmd = _ffmpeg_encode_cmd(
                lib, args.sequence, w, h, fps, qp, args.frames, out
            )
            dec_cmd = _ffmpeg_decode_cmd(out, w, h, rec_yuv)
        else:
            _require(os.path.join(args.build_dir, "EncoderAppStatic"))
            out = Path(tmp) / "out.bin"
            enc_cmd = _vtm_encode_cmd(
                args.build_dir, args.config, args.sequence, w, h, fps, qp,
                args.frames, out,
            )
            dec_cmd = _vtm_decode_cmd(args.build_dir, out, rec_yuv)

        t0 = time.time()
        subprocess.run(enc_cmd, check=True, capture_output=True)
        enc_t = time.time() - t0
        nbytes = out.stat().st_size
        t0 = time.time()
        subprocess.run(dec_cmd, check=True, capture_output=True)
        dec_t = time.time() - t0
        p_yuv, p_rgb = _frame_metrics(args.sequence, rec_yuv, w, h, args.frames)
    return {
        "qp": qp,
        "bpp": nbytes * 8.0 / (w * h * args.frames),
        "psnr-yuv": p_yuv,
        "psnr-rgb": p_rgb,
        "encoding_time": enc_t,
        "decoding_time": dec_t,
    }


def main(argv=None):
    args = setup_args(argv)
    results = {}
    for qp in args.qps:
        rv = run_point(args, qp)
        for k, v in rv.items():
            results.setdefault(k, []).append(v)
    output = {"name": args.codec, "results": results}
    print(json.dumps(output, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(output, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

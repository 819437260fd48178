#!/usr/bin/env python3
"""Where the time goes in the port's batched codec, on one NVIDIA GPU.

    python3 chip_profile.py [--batch 2 24] [--reps 3]

For each batch size: N=192, K=4 flagship with weights/ckbd_gmm_n192_k4_
synthetic.npz, lanes=4096, cap_divisor=4, 768x512 textured-leaves images
(bench.py's seeds). Prints one JSON line per batch with the steady-state
encode and decode times (host clock around work that ends in a
synchronize; median of --reps), ms per image, bpp and PSNR, and the time of
each codec stage (synchronized after each stage, so the stages add up to a
little more than the unsynchronized total). Then one torch.profiler table
of device time by kernel over one encode + decode at the last batch size.
Needs a CUDA device; imports no JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "ckbd_gmm_n192_k4_synthetic.npz"
H, W = 768, 512


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 24])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec
    from flashgmm_tpu_torch.runtime.fast_codec import _decode_pass
    from flashgmm_tpu_torch.zoo import load_npz

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    model = Cheng2020AnchorCheckerboardGMMv2(N=192, K=4, seed=0, device=dev)
    load_npz(model, WEIGHTS)
    model.update(update_quantiles=True)
    codec = FastCheckerboardGmmCodec(model, lanes=4096, cap_divisor=4)
    images = [textured_leaves(H, W, seed=500001 + i) for i in range(max(args.batch))]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def stages(x, data, y_shape):
        """The codec's stages one at a time (its internals, in the order
        encode() and decode() run them), each ending in a synchronize."""
        c = codec
        b, h, w, ch = y_shape
        n = b * h * (w // 2) * ch
        lo, _ = c._lo_bins()
        ms = {}
        with torch.inference_mode():
            y, ms["g_a (bf16, cuDNN)"] = timed(lambda: c._transform(c._g_a, x))
            z, ms["h_a (bf16, cuDNN)"] = timed(lambda: c._transform(c._h_a, y))
            z_bin = torch.round(z - c._med).to(torch.int32) - c._z_off
            z_bin = torch.minimum(torch.clamp_min(z_bin, 0), c._z_maxbin)
            sym = torch.clamp(torch.round(c._ckbd.unembed(y)).to(torch.int32),
                              -c.max_abs, c.max_abs)
            side, ms["h_s (conv kernel)"] = timed(lambda: c._side(z_bin))
            rows0, ms["rows0 (EP convs + CDF rows)"] = timed(
                lambda: c._rows0(side[0]))
            rows1, ms["rows1 (context + EP convs + CDF rows)"] = timed(
                lambda: c._rows1(side[1], sym[0]))
            _, ms["y pass encode (gather + kernel + pack)"] = timed(
                lambda: c._encpass(rows0, sym[0].reshape(-1), c.cap_divisor))
            streams = c.from_bytes(data, y_shape)
            _, ms["y pass decode (dummy rows + kernel)"] = timed(
                lambda: _decode_pass(streams["y0"], rows0, n, lo, c.lanes))
            y_hat = c._ckbd.embed(sym.float())
            _, ms["g_s (bf16, cuDNN)"] = timed(lambda: c._transform(c._g_s, y_hat))
        return ms

    for b in args.batch:
        x = torch.from_numpy(np.stack(images[:b])).to(dev)
        data, out = codec.encode_to_bytes(x)  # warm-up
        y_shape = tuple(out["y_hat"].shape)
        codec.decode_bytes(data, y_shape)
        enc, dec = [], []
        for _ in range(args.reps):
            (data, out), t = timed(lambda: codec.encode_to_bytes(x))
            enc.append(t)
            x_hat, t = timed(lambda: codec.decode_bytes(data, y_shape))
            dec.append(t)
        mse = ((x_hat - x) ** 2).mean(dim=(1, 2, 3)).double().cpu().numpy()
        e, d = statistics.median(enc), statistics.median(dec)
        print(json.dumps({
            "batch": b, "encode_ms": e, "decode_ms": d,
            "ms_per_image": (e + d) / b, "encode_runs_ms": enc,
            "decode_runs_ms": dec, "bytes": len(data),
            "bpp": len(data) * 8 / (b * H * W),
            "psnr_db": float(np.mean(-10 * np.log10(np.maximum(mse, 1e-12)))),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "stages_ms": stages(x, data, y_shape), "card": smi}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        data, out = codec.encode_to_bytes(x)
        codec.decode_bytes(data, y_shape)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25, max_name_column_width=60),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time goes in the port's batched codec, on one NVIDIA GPU.

    python3 chip_profile.py [--batch 2 24] [--reps 3] [--tiles]

For each batch size: N=192, K=4 flagship with weights/ckbd_gmm_n192_k4_
synthetic.npz, lanes=4096, cap_divisor=4, 768x512 textured-leaves images
(bench.py's seeds). Prints one JSON line per batch with the steady-state
encode and decode times (host clock around work that ends in a
synchronize; median of --reps), ms per image, bpp and PSNR, and the time of
each codec stage (synchronized after each stage, so the stages add up to a
little more than the unsynchronized total). Then one torch.profiler table
of device time by kernel over one encode + decode at the last batch size.
``--tiles`` instead times the rows-chain conv kernel at each of its shapes
and batch sizes with every tile shape forced and with its own choice,
beside ``F.conv2d`` in float32 (TF32 off): one JSON line per batch.
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
    ap.add_argument("--tiles", action="store_true")
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
    if args.tiles:
        conv_tiles(args.batch, dev, smi)
        return 0
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


def conv_tiles(batches, dev, smi):
    """Every rows-chain conv shape (N=192, K=4, 768x512 images) timed with
    each tile shape forced, with the kernel's own choice and as F.conv2d."""
    import torch
    import torch.nn.functional as F

    from flashgmm_tpu_torch.ops import conv_kernel

    torch.backends.cudnn.allow_tf32 = False
    n = 192
    layers = [  # (h, w, c_in, c_out, k, launches in one encode + decode)
        (12, 8, n, n, 3, 2), (12, 8, n, 4 * n, 3, 2),
        (24, 16, n, 3 * n // 2, 3, 2), (24, 16, 3 * n // 2, 6 * n, 3, 2),
        (48, 32, 3 * n // 2, 2 * n, 3, 2), (48, 32, n, 2 * n, 5, 2),
        (48, 16, 4 * n, 10 * n // 3, 1, 4),
        (48, 16, 10 * n // 3, 10 * n // 3, 1, 4),
        (48, 16, 10 * n // 3, 12 * n, 1, 4)]

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    with torch.inference_mode():
        for batch in batches:
            rows, total = [], {"auto": 0.0, "best": 0.0, "F.conv2d": 0.0}
            for h, w, c_in, c_out, k, launches in layers:
                x = torch.randn(batch, h, w, c_in, device=dev)
                wt = torch.randn(k, k, c_in, c_out, device=dev) * 0.05
                bias = torch.randn(c_out, device=dev)
                tiles = [ms(lambda: conv_kernel.conv2d_nhwc(x, wt, bias,
                                                            tile=t))
                         for t in range(conv_kernel.TILES)]
                auto = ms(lambda: conv_kernel.conv2d_nhwc(x, wt, bias))
                x_nchw = x.permute(0, 3, 1, 2)
                w_oihw = wt.permute(3, 2, 0, 1).contiguous()
                lib = ms(lambda: F.conv2d(x_nchw, w_oihw, bias, padding=k // 2))
                rows.append({"shape": [batch, h, w, c_in, c_out, k],
                             "tiles_ms": tiles, "auto_ms": auto,
                             "conv2d_ms": lib, "launches": launches})
                total["auto"] += launches * auto
                total["best"] += launches * min(tiles)
                total["F.conv2d"] += launches * lib
            print(json.dumps({"batch": batch, "layers": rows,
                              "sum_ms_over_launches": total, "card": smi}),
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())

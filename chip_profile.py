#!/usr/bin/env python3
"""Where the time goes in the port's batched codec, on one NVIDIA GPU.

    python3 chip_profile.py [--batch 2 24] [--reps 3]
                            [--tiles | --decode | --encode |
                             --kernel-transforms | --latency | --bytes |
                             --forward | --elic | --gsm]

For each batch size: N=192, K=4 flagship with weights/ckbd_gmm_n192_k4_
synthetic.npz, lanes=4096, cap_divisor=4, 768x512 textured-leaves images
(bench.py's seeds). Prints one JSON line per batch with the steady-state
encode and decode times (host clock around work that ends in a
synchronize; median of --reps), ms per image, bpp and PSNR, the peak device
memory of that batch's runs, and the time of each codec stage (synchronized
after each stage, so the stages add up to a little more than the
unsynchronized total). Then one torch.profiler table
of device time by kernel over one encode + decode at the last batch size.
``--tiles`` instead times the rows-chain conv kernel at each of its shapes
and batch sizes with every tile shape forced and with its own choice,
beside ``F.conv2d`` in float32 (TF32 off): one JSON line per batch.
``--decode`` instead times the on-demand GMM decoder on one y pass of
batch 24 (T=864 steps): at W=4096 with its own cluster of 16 CTAs and with
``rans_kernels.MAX_CLUSTER`` lowered to 8 and 1, beside the decoder over
materialized rows; its serial floor, one active lane on each CTA of the
W=4096 cluster, and 16 lanes on one CTA (no cluster barrier); and that
floor at K = 3, which takes the runtime-K code: one JSON line.
``--encode`` instead times one y-pass encode at each batch's shape (T =
36 x batch steps: 72 at batch 2, 864 at 24; W=4096, K=4, L=98) two ways:
the pair the codec ran before the GMM encoder (the bounds kernel, the
lanes laid out, the encoder over them; and that encoder alone, the z
pass's kernel, over all lanes and over lane 0 alone) and the GMM encoder
(bounds evaluated inside it); and the GMM encoder's serial floor (the
same steps over one lane: one CTA, one active lane) at K=4 and at K=3
(runtime K). Each with ms a pass and us a step, back to back ("ms") and
on the device alone ("device_ms": the stream's queue held by a sleep
kernel until every call is queued, so the wrappers' host time is left
out; ``chip_smoke.cuda_ms``), and the SM clock while they run: one JSON
line a batch.
``--kernel-transforms`` instead runs the codec along both transform routes,
the default (cuDNN bf16) and ``kernel_transforms=True`` (the bf16 conv
kernel), in alternating pairs (default, kernel, kernel, default, ...;
--reps pairs) at each batch size: one JSON line per batch with each route's
encode and decode runs, ms per image, g_a, h_a and g_s stage ms, bytes, bpp,
PSNR and peak memory; then one JSON line per batch with the routed convs of
one encode + decode timed shape by shape by CUDA events on the path's own
tensors: the kernel (its epilogue fused), cuDNN's conv as the default route
calls it (OIHW weights), the same with channels-last weights, and the
default route's conv with its separate LeakyReLU and residual add, each
with its TFLOP/s; then, for each route, a torch.profiler table of its
device time by kernel over one encode + decode at the last batch size.
``--latency`` instead runs the single-image codec (FastLatencyGmmCodec:
lanes=1024, cap_divisor=4, bench.py's first image, seed 500001) on both
transform routes, its CUDA graphs and the same functions run eagerly in
alternating runs (graph, eager, eager, graph, ...; --reps runs of each,
at least 20): one JSON line a route with the median host-clock and
CUDA-event ms of the certified encode, the encode alone and the decode in
each mode, the eager run's stage times (a graph has no stages), and, from
torch.profiler over one graph run and one eager run, the device time,
busy and idle share of each direction and the y-pass decoders' share of
the decode direction, with the share of the card's SMs their cluster
holds; then each route's profiler table of device time by kernel.
``--bytes`` instead runs ``chip_smoke.bytes_worker`` in fresh processes
(ROADMAP C9), each setup of ``chip_smoke.BYTES_SETUPS`` on each route,
and prints for each process whether its batch-1 bytes equal the first
one's, the first stage whose digest differs and the first device kernel
whose name differs.
``--forward`` instead times the training forward and its backward on the
first image (TF32 off), with profiler tables by device and by host time.
``--elic`` instead runs ELIC (Elic2022GMM N=192, M=320, K=4, weights/
elic_gmm_n192_m320_k4_synthetic.npz, lanes=512, cap_divisor=1): for batch
1 and 2, one JSON line with the batched codec's encode and decode ms
(median of --reps), bytes, bpp, PSNR and its stages one at a time (g_a,
h_a, the z pass, h_s, each group's channel context and parameters, each
of the ten passes' encode and decode, g_s); then, for each route, one JSON
line of the single-image codec (FastLatencyElicCodec, the first image):
encode_certified and decode medians of at least 20 runs, graph and eager
alternating, and each direction's device ms, busy and idle share and the
y decoders' share on the graph path (torch.profiler); then each route's
table of device time by kernel over one graph encode_certified + decode.
``--gsm`` instead runs the single-Gaussian checkerboard
(Cheng2020AnchorCheckerboard N=128, weights/ckbd_gc_n128_synthetic.npz)
through FastCheckerboardGsmCodec at lanes=4096, cap_divisor=4 on both
transform routes, as ``--kernel-transforms`` runs the flagship's: for each
batch, one JSON line of alternating pairs (encode and decode ms, ms per
image, bytes, bpp, PSNR, g_a, h_a and g_s stage ms) and one of the GSM
codec's own stages one at a time on the default route (h_s, each pass's
parameters, one y pass's encode and decode), the routed bf16 convs, and
each route's table of device time by kernel at the last batch.
Needs a CUDA device; imports no JAX.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import cuda_ms, latency_run

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "ckbd_gmm_n192_k4_synthetic.npz"
H, W = 768, 512


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 24])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--encode", action="store_true")
    ap.add_argument("--kernel-transforms", action="store_true")
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--bytes", action="store_true")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--elic", action="store_true")
    ap.add_argument("--gsm", action="store_true")
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
    from flashgmm_tpu_torch.zoo import load_npz

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.bytes:
        return batch1_bytes(args.reps)
    if args.tiles:
        conv_tiles(args.batch, dev, smi)
        return 0
    if args.decode:
        decode_steps(dev, smi)
        return 0
    if args.encode:
        for b in args.batch:
            encode_steps(dev, smi, steps=36 * b)
        return 0
    if args.elic:
        elic_profile(args.reps, dev, smi)
        return 0
    if args.gsm:
        gsm_profile(args.batch, args.reps, dev, smi)
        return 0
    model = Cheng2020AnchorCheckerboardGMMv2(N=192, K=4, seed=0, device=dev)
    load_npz(model, WEIGHTS)
    model.update(update_quantiles=True)
    images = [textured_leaves(H, W, seed=500001 + i) for i in range(max(args.batch))]
    if args.latency:
        single_image(model, images[0], max(args.reps, 20), dev, smi)
        return 0
    if args.forward:
        forward_steps(model, images[0], max(args.reps, 5), dev, smi)
        return 0
    codec = FastCheckerboardGmmCodec(model, lanes=4096, cap_divisor=4)
    if args.kernel_transforms:
        kcodec = FastCheckerboardGmmCodec(model, lanes=4096, cap_divisor=4,
                                          kernel_transforms=True)
        both_routes({"default": codec, "kernel_transforms": kcodec},
                    images, args.batch, args.reps, dev, smi)
        return 0

    for b in args.batch:
        x = torch.from_numpy(np.stack(images[:b])).to(dev)
        torch.cuda.reset_peak_memory_stats()
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
            "stages_ms": stages(codec, x, data, y_shape), "card": smi}),
              flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        data, out = codec.encode_to_bytes(x)
        codec.decode_bytes(data, y_shape)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25, max_name_column_width=60),
          flush=True)
    return 0


def batch1_bytes(reps):
    """ROADMAP C9: the batch-1 bytes of ``chip_smoke.bytes_worker`` from
    fresh processes, each setup on each route, ``reps`` processes a setup
    (at least 1), each with its stage digests. For every process, prints
    whether its bytes equal the first process's of its route, the first
    stage whose output differs (with the sums and max|v| of both) and the
    first device kernel of g_a and h_a whose name differs: one JSON line
    a process, then one a route."""
    from chip_smoke import BYTES_SETUPS

    for route in ("default", "kernel"):
        runs = []
        for setup in BYTES_SETUPS:
            for _ in range(max(reps, 1)):
                p = subprocess.run(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--bytes-worker", route, setup, "1"],
                    capture_output=True, text=True, timeout=600)
                if p.returncode != 0:
                    print(p.stderr[-3000:], flush=True)
                    return 1
                runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        first = runs[0]
        for run in runs:
            a, b = first["stages"], run["stages"]
            stage = next((k for k in a if a[k][0] != b.get(k, [None])[0]),
                         None)
            ka, kb = first["kernels"], run["kernels"]
            i = next((i for i, (p_, q) in enumerate(zip(ka, kb)) if p_ != q),
                     None if len(ka) == len(kb) else min(len(ka), len(kb)))
            print(json.dumps({
                "route": route, "setup": run["setup"], "bytes": run["bytes"],
                "sha256": run["sha256"][:16],
                "same_bytes_as_first": run["sha256"] == first["sha256"],
                "first_differing_stage": stage,
                "stage": None if stage is None else {"first": a[stage],
                                                     "this": b.get(stage)},
                "kernels": len(kb), "first_differing_kernel": None if i is None
                else {"index": i, "first": ka[i:i + 3], "this": kb[i:i + 3]}}),
                flush=True)
        print(json.dumps({"route": route, "distinct_bytes": sorted(
            {(r["bytes"], r["sha256"][:16]) for r in runs})}), flush=True)
    return 0

def timed(fn):
    """(fn(), host ms) around work that ends in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def stages(c, x, data, y_shape):
    """Batched codec c's stages one at a time (its internals, in the order
    encode() and decode() run them), each ending in a synchronize."""
    import torch

    b, h, w, ch = y_shape
    n = b * h * (w // 2) * ch
    route = ("bf16 kernel" if any(getattr(m, "kernel_route", False)
                                  for m in c._g_a.modules())
             else "bf16, cuDNN")
    ms = {}
    with torch.inference_mode():
        y, ms[f"g_a ({route})"] = timed(lambda: c._transform(c._g_a, x))
        z, ms[f"h_a ({route})"] = timed(lambda: c._transform(c._h_a, y))
        z_bin = torch.round(z - c._med).to(torch.int32) - c._z_off
        z_bin = torch.minimum(torch.clamp_min(z_bin, 0), c._z_maxbin)
        sym = torch.clamp(torch.round(c._ckbd.unembed(y)).to(torch.int32),
                          -c.max_abs, c.max_abs)
        side, ms["h_s (conv kernel)"] = timed(lambda: c._side(z_bin))
        params0, ms["params0 (EP convs)"] = timed(
            lambda: c._params0(side[0]))
        _, ms["params1 (context + EP convs)"] = timed(
            lambda: c._params1(side[1], sym[0]))
        _, ms["y pass encode (GMM encoder + pack)"] = timed(
            lambda: c._encpass(params0, sym[0].reshape(-1), c.cap_divisor))
        streams = c.from_bytes(data, y_shape)
        _, ms["y pass decode (GMM rows on demand)"] = timed(
            lambda: c._decpass(streams["y0"], params0, n))
        y_hat = c._ckbd.embed(sym.float())
        _, ms[f"g_s ({route})"] = timed(lambda: c._transform(c._g_s, y_hat))
    return ms


def elic_stages(c, x, data, y_shape):
    """FastElicGmmCodec c's stages one at a time (its internals, in the
    order encode() and decode() run them), each ending in a synchronize."""
    import torch

    b, h, w, _ = y_shape
    ms = {}
    with torch.inference_mode():
        y, ms["g_a"] = timed(lambda: c._transform(c._g_a, x))
        z, ms["h_a"] = timed(lambda: c._transform(c._h_a, y))
        (z_bin, _), ms["z quantize + pass encode"] = timed(
            lambda: c._encode_z(z))
        syms = []
        for ckbd, yk in zip(c._ckbds, c._cg._split(y)):
            sym = torch.clamp(torch.round(ckbd.unembed(yk)).to(torch.int32),
                              -c.max_abs, c.max_abs)
            syms += [sym[0], sym[1]]
        side_all, ms["h_s (conv kernel)"] = timed(lambda: c._side(z_bin))
        streams = c.from_bytes(data, y_shape)
        for k, ckbd in enumerate(c._ckbds):
            side, t_ctx = timed(lambda: ckbd.unembed(
                c._ctxparams(side_all, syms[:2 * k], k)))
            p0, t0 = timed(lambda: c._pass_params(k, side[0]))
            p1, t1 = timed(lambda: c._pass_params(k, side[1], syms[2 * k]))
            ms[f"group {k} channel context + parameters"] = t_ctx + t0 + t1
            n = b * h * (w // 2) * c.groups[k]
            for i, (p, s_) in enumerate(((p0, syms[2 * k]),
                                         (p1, syms[2 * k + 1]))):
                _, ms[f"pass {k}.{i} encode"] = timed(
                    lambda: c._encpass(p, s_.reshape(-1), c.cap_divisor))
                _, ms[f"pass {k}.{i} decode"] = timed(
                    lambda: c._decpass(streams[1 + 2 * k + i], p, n))
        y_hat = c._embed_full(syms)
        _, ms["g_s"] = timed(lambda: c._transform(c._g_s, y_hat))
    return ms


def gsm_stages(c, x, data, y_shape):
    """FastCheckerboardGsmCodec c's rows-chain and coder stages one at a
    time, each ending in a synchronize (g_a, h_a and g_s: both_routes)."""
    import torch

    b, h, w, ch = y_shape
    n = b * h * (w // 2) * ch
    ms = {}
    with torch.inference_mode():
        y = c._transform(c._g_a, x)
        z_bin, _ = c._encode_z(c._transform(c._h_a, y))
        y_ = c._ckbd.unembed(y)
        side, ms["h_s (conv kernel)"] = timed(lambda: c._side(z_bin))
        (p0, mu0), ms["params0 (EP convs)"] = timed(
            lambda: c._params0(side[0]))
        sym0 = c._quantize(y_[0], mu0)
        _, ms["params1 (context + EP convs)"] = timed(
            lambda: c._params1(side[1], sym0, mu0))
        _, ms["y pass encode (K=1 encoder + pack)"] = timed(
            lambda: c._encpass(p0, sym0.reshape(-1), c.cap_divisor))
        streams = c.from_bytes(data, y_shape)
        _, ms["y pass decode (K=1 rows on demand)"] = timed(
            lambda: c._decpass(streams["y0"], p0, n))
    return ms


def gsm_profile(batches, reps, dev, smi):
    """The GSM codec on both routes (see the module docstring)."""
    import numpy as np
    import torch

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboard
    from flashgmm_tpu_torch.runtime import FastCheckerboardGsmCodec
    from flashgmm_tpu_torch.zoo import load_npz

    model = Cheng2020AnchorCheckerboard(N=128, seed=0, device=dev)
    load_npz(model, ROOT / "weights" / "ckbd_gc_n128_synthetic.npz")
    model.update(update_quantiles=True)
    codecs = {name: FastCheckerboardGsmCodec(
        model, lanes=4096, cap_divisor=4,
        kernel_transforms=name == "kernel_transforms")
        for name in ("default", "kernel_transforms")}
    images = [textured_leaves(H, W, seed=500001 + i) for i in range(max(batches))]
    for b in batches:
        x = torch.from_numpy(np.stack(images[:b])).to(dev)
        c = codecs["default"]
        with torch.inference_mode():
            data, out = c.encode_to_bytes(x)
        print(json.dumps({"gsm_batch": b, "stages_ms": gsm_stages(
            c, x, data, tuple(out["y_hat"].shape)), "card": smi}), flush=True)
    both_routes(codecs, images, batches, reps, dev, smi)


def elic_profile(reps, dev, smi):
    """ELIC's batched codec at batch 1 and 2 and its single-image codec on
    both routes (see the module docstring)."""
    import warnings

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Elic2022GMM
    from flashgmm_tpu_torch.runtime import (FastElicGmmCodec,
                                            FastLatencyElicCodec)
    from flashgmm_tpu_torch.zoo import load_npz

    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Elic2022GMM(N=192, M=320, K=4, seed=0, device=dev)
    load_npz(model, ROOT / "weights" / "elic_gmm_n192_m320_k4_synthetic.npz")
    model.update(update_quantiles=True)
    images = np.stack([textured_leaves(H, W, seed=500001 + i)
                       for i in range(2)])
    codec = FastElicGmmCodec(model)
    with torch.inference_mode():
        for b in (1, 2):
            x = torch.from_numpy(images[:b]).to(dev)
            data, out = codec.encode_to_bytes(x)  # warm-up
            y_shape = tuple(out["y_hat"].shape)
            codec.decode_bytes(data, y_shape)
            enc, dec = [], []
            for _ in range(reps):
                (data, out), t = timed(lambda: codec.encode_to_bytes(x))
                enc.append(t)
                x_hat, t = timed(lambda: codec.decode_bytes(data, y_shape))
                dec.append(t)
            mse = ((x_hat - x) ** 2).mean(dim=(1, 2, 3)).double().cpu().numpy()
            e, d = statistics.median(enc), statistics.median(dec)
            print(json.dumps({
                "elic_batch": b, "encode_ms": e, "decode_ms": d,
                "ms_per_image": (e + d) / b, "bytes": len(data),
                "bpp": len(data) * 8 / (b * H * W),
                "psnr_db": float(np.mean(-10 * np.log10(np.maximum(mse,
                                                                   1e-12)))),
                "stages_ms": elic_stages(codec, x, data, y_shape),
                "card": smi}), flush=True)
    x = torch.from_numpy(images[:1]).to(dev)
    tables = []
    for route in (False, True):
        lat = FastLatencyElicCodec(model, kernel_transforms=route)
        with torch.inference_mode():
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                data, y_shape = lat.encode_certified(x)  # builds the graphs
            runs = {"graph": [], "eager": []}
            for mode in ("graph", "eager"):  # warm-up
                lat._graphed = mode == "graph"
                latency_run(lat, x, data, y_shape)
            if lat._fallback_digests or len(lat._graphs) != 3:
                raise RuntimeError("ELIC latency: not certified on three "
                                   "graphs")
            for r in range(max(reps, 20)):
                for mode in (("graph", "eager") if r % 2 == 0
                             else ("eager", "graph")):
                    lat._graphed = mode == "graph"
                    runs[mode].append(latency_run(lat, x, data, y_shape))
            lat._graphed = True
            device = {}
            for op, fn in (("encode_certified", lambda: lat.encode_certified(x)),
                           ("decode", lambda: lat.decode(data, y_shape))):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                device[op] = device_shares(prof)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                lat.encode_certified(x)
                lat.decode(data, y_shape)
                torch.cuda.synchronize()
            tables.append((route, prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=30,
                max_name_column_width=60)))
        print(json.dumps({
            "elic_latency_route": "kernel_transforms" if route else "default",
            "lanes": lat.lanes, "cap_divisor": lat.cap_divisor,
            "bytes": len(data), "bpp": len(data) * 8 / (H * W),
            "runs": len(runs["graph"]), "ms": {mode: {op: {
                "host_median": statistics.median(r[op][0] for r in rr),
                "cuda_events_median": statistics.median(r[op][1] for r in rr),
                "host_runs": [r[op][0] for r in rr]}
                for op in rr[0]} for mode, rr in runs.items()},
            "device_graph": device, "card": smi}), flush=True)
        del lat
    for route, table in tables:
        print(f"ELIC route {'kernel_transforms' if route else 'default'}, "
              "one graph encode_certified + decode:", flush=True)
        print(table, flush=True)


def single_image(model, image, reps, dev, smi):
    """The latency codec on both routes, graph and eager runs alternating."""
    import statistics
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from flashgmm_tpu_torch.ans import rans_kernels
    from flashgmm_tpu_torch.runtime import FastLatencyGmmCodec

    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(image[None]).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tables = []
    for route in (False, True):
        lat = FastLatencyGmmCodec(model, kernel_transforms=route)
        with torch.inference_mode():
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                data, y_shape = lat.encode_certified(x)  # builds the graphs
            runs = {"graph": [], "eager": []}
            for mode in ("graph", "eager"):  # warm-up
                lat._graphed = mode == "graph"
                latency_run(lat, x, data, y_shape)
            if lat._fallback_digests or len(lat._graphs) != 3:
                raise RuntimeError("latency: not certified on three graphs")
            for r in range(reps):
                for mode in (("graph", "eager") if r % 2 == 0
                             else ("eager", "graph")):
                    lat._graphed = mode == "graph"
                    runs[mode].append(latency_run(lat, x, data, y_shape))
            lat._graphed = False
            b = lat._batched
            b_data, _ = b.encode_to_bytes(x)
            stage_ms = stages(b, x, b_data, y_shape)
            device = {}
            for mode in ("graph", "eager"):
                lat._graphed = mode == "graph"
                device[mode] = {}
                for op, fn in (("encode_certified",
                                lambda: lat.encode_certified(x)),
                               ("decode", lambda: lat.decode(data, y_shape))):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        fn()
                        torch.cuda.synchronize()
                    device[mode][op] = device_shares(prof)
                    if mode == "graph" and op == "decode":
                        tables.append((route, prof.key_averages().table(
                            sort_by="self_device_time_total", row_limit=25,
                            max_name_column_width=60)))
            lat._graphed = True
        mse = float(((lat.decode(data, y_shape) - x) ** 2).mean())
        cluster = min(rans_kernels.MAX_CLUSTER, -(-lat.lanes // 256))
        print(json.dumps({
            "route": "kernel_transforms" if route else "default",
            "lanes": lat.lanes, "cap_divisor": lat.cap_divisor,
            "bytes": len(data), "bpp": len(data) * 8 / (H * W),
            "psnr_db": -10 * math.log10(max(mse, 1e-12)),
            "runs": reps, "ms": {mode: {op: {
                "host_median": statistics.median(r[op][0] for r in rr),
                "cuda_events_median": statistics.median(r[op][1] for r in rr),
                "host_runs": [r[op][0] for r in rr]}
                for op in rr[0]} for mode, rr in runs.items()},
            "eager_stages_ms": stage_ms, "device": device,
            "decoder_cluster_ctas": cluster, "sms": sms,
            "decoder_sm_share": cluster / sms, "card": smi}), flush=True)
    for route, table in tables:
        print(f"route {'kernel_transforms' if route else 'default'}, one "
              "graph decode (decode-y and g_s replays):", flush=True)
        print(table, flush=True)


def forward_steps(model, image, reps, dev, smi):
    """The training forward (``model(x, training=True, generator=g)``)
    and one backward of bits per pixel + MSE on one image, TF32 off as in
    chip_smoke.py: the median forward and backward ms of ``reps`` runs by
    CUDA events (after one warm-up), the eval forward's ms, and profiler
    tables of one training forward + backward by device time and by host
    time."""
    import statistics

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(image[None]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        a.record()
        out = model(x, training=True, generator=gen)
        rate = sum(-torch.log2(v).sum() for v in out["likelihoods"].values())
        loss = rate / (H * W) + F.mse_loss(out["x_hat"], x)
        b.record()
        loss.backward()
        c.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), b.elapsed_time(c)

    step()
    runs = [step() for _ in range(reps)]
    evals = []
    with torch.no_grad():
        for _ in range(reps + 1):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
            model(x, training=False)
            b.record()
            torch.cuda.synchronize()
            evals.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
    print(json.dumps({
        "image": [H, W], "reps": reps,
        "forward_ms": statistics.median(r[0] for r in runs),
        "backward_ms": statistics.median(r[1] for r in runs),
        "eval_forward_ms": statistics.median(evals[1:]),
        "forward_runs": [r[0] for r in runs],
        "backward_runs": [r[1] for r in runs], "card": smi}), flush=True)
    for key in ("self_device_time_total", "cpu_time_total"):
        print(f"one training forward + backward, by {key}:", flush=True)
        print(prof.key_averages().table(sort_by=key, row_limit=20,
                                        max_name_column_width=60), flush=True)
    print("the same, convolutions by input shapes:", flush=True)
    print(prof.key_averages(group_by_input_shape=True).table(
        sort_by="device_time_total", row_limit=12, max_name_column_width=30,
        max_shapes_column_width=90), flush=True)


def device_shares(prof):
    """From a profiler trace of one operation: device ms (the sum of the
    kernels' and memory operations' durations), the span from the first
    one's start to the last one's end, the busy share of that span (their
    union) and the idle share, and the ms and share of the busy time of the
    rANS decoders (``rans_decode_kernel``), and of the y passes' (their GMM
    row source) among them."""
    spans, dec, dec_y = [], 0.0, 0.0
    for e in prof.events():
        if getattr(e, "device_type", None) is None or \
                str(e.device_type) != "DeviceType.CUDA":
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        if "rans_decode_kernel" in e.name:
            dec += t1 - t0
            dec_y += (t1 - t0) * ("GmmRows" in e.name)
    if not spans:
        return {"device_ms": None}  # the trace holds no device activity
    spans.sort()
    busy, (cur0, cur1) = 0.0, spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    span = max(t1 for _, t1 in spans) - spans[0][0]
    return {"device_ms": sum(t1 - t0 for t0, t1 in spans) / 1e3,
            "span_ms": span / 1e3, "busy_share": busy / span,
            "idle_share": 1 - busy / span, "decoder_ms": dec / 1e3,
            "y_decoder_ms": dec_y / 1e3, "decoder_share_of_busy": dec / busy}


def both_routes(codecs, images, batches, reps, dev, smi):
    """Each codec's encode + decode in alternating pairs at each batch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    for b in batches:
        x = torch.from_numpy(np.stack(images[:b])).to(dev)
        res = {}
        for name, c in codecs.items():  # warm-up, peak memory, the result
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                data, out = c.encode_to_bytes(x)
                y_shape = tuple(out["y_hat"].shape)
                x_hat = c.decode_bytes(data, y_shape)
                y_dec = c.decode_y_hat(c.from_bytes(data, y_shape), y_shape)
            torch.cuda.synchronize()
            if not torch.equal(y_dec, out["y_hat"]):
                raise RuntimeError(f"{name}: y_hat differs after the bytes")
            mse = ((x_hat - x) ** 2).mean(dim=(1, 2, 3)).double().cpu().numpy()
            res[name] = {
                "bytes": len(data), "bpp": len(data) * 8 / (b * H * W),
                "psnr_db": float(np.mean(-10 * np.log10(np.maximum(mse, 1e-12)))),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "encode_runs_ms": [], "decode_runs_ms": [], "stages_ms": {}}
            with torch.inference_mode():
                y = c._transform(c._g_a, x)
                for stage, mod, inp in (("g_a", c._g_a, x), ("h_a", c._h_a, y),
                                        ("g_s", c._g_s, out["y_hat"])):
                    res[name]["stages_ms"][stage] = statistics.median(
                        timed(lambda: c._transform(mod, inp))[1]
                        for _ in range(3))
        order = []
        for r in range(reps):
            names = list(codecs)
            for name in (names if r % 2 == 0 else names[::-1]):
                c = codecs[name]
                with torch.inference_mode():
                    (data, out), t_e = timed(lambda: c.encode_to_bytes(x))
                    _, t_d = timed(lambda: c.decode_bytes(
                        data, tuple(out["y_hat"].shape)))
                res[name]["encode_runs_ms"].append(t_e)
                res[name]["decode_runs_ms"].append(t_d)
                order.append(name)
        for v in res.values():
            v["ms_per_image_runs"] = [(e + d) / b for e, d in
                                      zip(v["encode_runs_ms"], v["decode_runs_ms"])]
            v["ms_per_image_median"] = statistics.median(v["ms_per_image_runs"])
        print(json.dumps({"batch": b, "order": order, "routes": res,
                          "card": smi}), flush=True)
        print(json.dumps({"batch": b, "routed_convs": routed_convs(
            codecs["kernel_transforms"], x), "card": smi}), flush=True)

    for name, c in codecs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                data, out = c.encode_to_bytes(x)
                c.decode_bytes(data, tuple(out["y_hat"].shape))
            torch.cuda.synchronize()
        print(f"route {name}, batch {b}:", flush=True)
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=25, max_name_column_width=60),
              flush=True)


def routed_convs(codec, x, reps=5):
    """The bf16 kernel's calls in one encode + decode through ``codec``
    (kernel route), grouped by shape and epilogue, each timed on its own
    inputs beside the default route's cuDNN conv on the same inputs."""
    import torch
    import torch.nn.functional as F

    from flashgmm_tpu_torch.ops import conv_kernel

    kernel = conv_kernel.conv2d_nhwc_bf16
    calls = []

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)

    recording.launches = 0  # the wrapper counts on the name it is bound to
    conv_kernel.conv2d_nhwc_bf16 = recording
    try:
        with torch.inference_mode():
            data, out = codec.encode_to_bytes(x)
            codec.decode_bytes(data, tuple(out["y_hat"].shape))
    finally:
        conv_kernel.conv2d_nhwc_bf16 = kernel
    groups = {}
    for args, kwargs in calls:
        xi, wi, bi = args
        slope, res = kwargs.get("negative_slope"), kwargs.get("residual")
        key = (tuple(xi.shape), tuple(wi.shape), slope, res is not None)
        groups.setdefault(key, []).append((args, kwargs))
    rows, total = [], dict.fromkeys(
        ("kernel_ms", "cudnn_ms", "cudnn_cl_ms", "default_ms"), 0.0)
    flops_total = 0
    sampler = _ClockSampler()
    with torch.inference_mode():
        for (xs, ws, slope, with_res), group in groups.items():
            args, kwargs = group[0]
            xi, wi, bi = args
            res = kwargs.get("residual")
            w_hwio = wi.hwio() if isinstance(
                wi, conv_kernel.PackedBf16Weight) else wi
            # NHWC memory seen as NCHW: channels-last, as the route calls it
            x_nchw = xi.to(torch.bfloat16).permute(0, 3, 1, 2)
            w_oihw = w_hwio.permute(3, 2, 0, 1).contiguous()  # as the route
            w_cl = w_oihw.contiguous(memory_format=torch.channels_last)
            b16 = bi.to(torch.bfloat16)
            pad = w_hwio.shape[0] // 2

            def default():
                y = F.conv2d(x_nchw, w_oihw, b16, padding=pad)
                if slope is not None:
                    y = conv_kernel.leaky_relu(y, slope)
                return y if res is None else y + res.permute(0, 3, 1, 2)
            t = {"kernel_ms": cuda_ms(lambda: kernel(*args, **kwargs), reps),
                 "cudnn_ms": cuda_ms(lambda: F.conv2d(
                     x_nchw, w_oihw, b16, padding=pad), reps),
                 "cudnn_cl_ms": cuda_ms(lambda: F.conv2d(
                     x_nchw, w_cl, b16, padding=pad), reps),
                 "default_ms": cuda_ms(default, reps)}
            flops = 2 * xs[0] * xs[1] * xs[2] * w_hwio.numel()
            n = len(group)
            rows.append({"x": list(xs), "w_hwio": list(w_hwio.shape),
                         "slope": slope, "residual": with_res, "calls": n,
                         **t, **{k.replace("_ms", "_tflop_per_s"):
                                 flops / v / 1e9 for k, v in t.items()}})
            for k, v in t.items():
                total[k] += n * v
            flops_total += n * flops
    return {"calls": len(calls), "shapes": rows, "sum_ms": total,
            **sampler.stop(), "tflop": flops_total / 1e12,
            "tflop_per_s": {k.replace("_ms", ""): flops_total / v / 1e9
                            for k, v in total.items()}}


class _ClockSampler:
    """The card's SM clock (MHz) and power draw (W), sampled every 100 ms
    by nvidia-smi from construction to ``stop()``."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self):
        self.proc.terminate()
        samples = []
        for line in self.proc.communicate(timeout=60)[0].splitlines():
            fields = line.split(",")
            if len(fields) == 2 and all(f.strip().replace(".", "").isdigit()
                                        for f in fields):
                samples.append((float(fields[0]), float(fields[1])))
        clocks = sorted(c for c, _ in samples) or [0.0]
        power = sorted(w for _, w in samples) or [0.0]
        return {"sm_clock_mhz": {"min": clocks[0],
                                 "median": statistics.median(clocks),
                                 "max": clocks[-1]},
                "power_w": {"median": statistics.median(power),
                            "max": power[-1]}}


def decode_steps(dev, smi, steps=864):
    """The decoders on `steps` steps of seeded parameters and symbols (L=98
    as the codec's; the search depth depends on L and the symbols)."""
    import numpy as np
    import torch

    from flashgmm_tpu_torch.ans import interleaved as il
    from flashgmm_tpu_torch.ans import rans_kernels
    from flashgmm_tpu_torch.ans.gaussian_cdf import (gmm_guarded_bounds,
                                                     gmm_guarded_rows)

    lo, num_bins = -48, 97

    def case(w, k, every=1):
        """An encoded pass of `steps` steps of w lanes, lanes 0, every,
        2 * every, ... active (the rest carry parameters, never searched)."""
        n = steps * w
        rs = np.random.RandomState(k)
        p = [rs.uniform(0.11, 8, (n, k)), rs.normal(0, 3, (n, k)),
             rs.uniform(0.05, 1, (n, k))]
        p[2] /= p[2].sum(1, keepdims=True)
        p = [torch.from_numpy(v.astype(np.float32)).to(dev) for v in p]
        v = np.clip(np.round(rs.normal(0, 4, n)), lo, lo + num_bins - 1)
        v = torch.from_numpy(v.astype(np.int64)).to(dev)
        st, fq = gmm_guarded_bounds(v, *p, lo, num_bins)
        act = torch.zeros((steps, w), dtype=torch.bool, device=dev)
        act[:, ::every] = True
        states, words, emits = rans_kernels.encode_scan(
            st.reshape(steps, w), fq.reshape(steps, w), act)
        stream, _ = il.pack_words(words, emits)
        return v, p, act, states, stream

    def gmm_ms(c):
        v, p, act, states, stream = c
        on = act.reshape(-1)

        def run():
            return rans_kernels.decode_scan_gmm(states, stream, *p, act, lo,
                                                num_bins)
        if not torch.equal(run().reshape(-1)[on].long(), v[on]):
            raise RuntimeError("decode_scan_gmm: wrong symbols")
        return cuda_ms(run, 3)

    with torch.inference_mode():
        out = {"steps": steps, "card": smi, "w4096": {}, "floor": {}}
        wide = case(4096, 4)
        rows = gmm_guarded_rows(*wide[1], lo, num_bins).reshape(steps, 4096, -1)
        # the cluster is min(MAX_CLUSTER, W / 256) CTAs: 16 is W's own size
        for cap in (16, 8, 1):
            rans_kernels.MAX_CLUSTER = cap
            out["w4096"][f"cluster {cap}"] = {
                "gmm_ms": gmm_ms(wide), "rows_ms": cuda_ms(
                    lambda: rans_kernels.decode_scan(wide[3], wide[4], rows,
                                                     wide[2], lo), 3)}
        rans_kernels.MAX_CLUSTER = 16
        del rows, wide
        for name, w, k, every in (
                ("K=4, 16 CTAs, one active lane each", 4096, 4, 256),
                ("K=4, 1 CTA of 16 lanes", 16, 4, 1),
                ("K=3 (runtime K), 16 CTAs, one active lane each", 4096, 3,
                 256)):
            ms = gmm_ms(case(w, k, every))
            out["floor"][name] = {"ms": ms, "us_per_step": 1e3 * ms / steps}
        print(json.dumps(out), flush=True)


def encode_steps(dev, smi, steps, w=4096, reps=10):
    """One y pass's encode at batch 24's shape over seeded parameters and
    symbols (L=98 as the codec's), the old pair and the GMM encoder."""
    import numpy as np
    import torch

    from flashgmm_tpu_torch.ans import interleaved as il
    from flashgmm_tpu_torch.ans import rans_kernels
    from flashgmm_tpu_torch.ans.gaussian_cdf import gmm_guarded_bounds

    lo, num_bins = -48, 97
    n = steps * w

    def case(k, n_sym):
        rs = np.random.RandomState(k)
        p = [rs.uniform(0.11, 8, (n_sym, k)), rs.normal(0, 3, (n_sym, k)),
             rs.uniform(0.05, 1, (n_sym, k))]
        p[2] /= p[2].sum(1, keepdims=True)
        v = np.clip(np.round(rs.normal(0, 4, n_sym)), lo, lo + num_bins - 1)
        return (torch.from_numpy(v.astype(np.int32)).to(dev),
                *(torch.from_numpy(a.astype(np.float32)).to(dev) for a in p))

    def timed(fn):
        ms, dev_ms = cuda_ms(fn, reps), cuda_ms(fn, reps, True)
        return {"ms": ms, "us_per_step": 1e3 * ms / steps, "device_ms": dev_ms,
                "device_us_per_step": 1e3 * dev_ms / steps}

    with torch.inference_mode():
        args = case(4, n)
        active = il.active_mask(n, steps, w, dev)

        def pair():  # bounds kernel, lanes, encoder: the codec before
            st, fq = gmm_guarded_bounds(*args, lo, num_bins)
            return rans_kernels.encode_scan(il.to_lanes(st, w),
                                            il.to_lanes(fq, w), active)
        st, fq = gmm_guarded_bounds(*args, lo, num_bins)
        lanes = (il.to_lanes(st, w), il.to_lanes(fq, w), active)
        out = {"steps": steps, "lanes": w, "card": smi}
        sampler = _ClockSampler()
        out["bounds_kernel_then_encoder"] = timed(pair)
        out["encoder_over_bounds"] = timed(
            lambda: rans_kernels.encode_scan(*lanes))
        one = tuple(a[:, :1].contiguous() for a in lanes)  # lane 0 alone
        out["encoder_over_bounds_one_lane"] = timed(
            lambda: rans_kernels.encode_scan(*one))

        def run():
            return rans_kernels.encode_scan_gmm(*args, lo, num_bins, 0, w)
        if not all(torch.equal(a, b) for a, b in zip(run(), pair())):
            raise RuntimeError("gmm_encoder: differs from the pair")
        out["gmm_encoder"] = timed(run)
        for k in (4, 3):  # the floor: the same steps over one lane
            one = case(k, steps)
            out[f"serial_floor_k{k}"] = timed(
                lambda: rans_kernels.encode_scan_gmm(*one, lo, num_bins, 0, 1))
        out.update(sampler.stop())
        print(json.dumps(out), flush=True)


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

    with torch.inference_mode():
        for batch in batches:
            rows, total = [], {"auto": 0.0, "best": 0.0, "F.conv2d": 0.0}
            for h, w, c_in, c_out, k, launches in layers:
                x = torch.randn(batch, h, w, c_in, device=dev)
                wt = torch.randn(k, k, c_in, c_out, device=dev) * 0.05
                bias = torch.randn(c_out, device=dev)
                tiles = [cuda_ms(lambda: conv_kernel.conv2d_nhwc(
                    x, wt, bias, tile=t), 20) for t in range(conv_kernel.TILES)]
                auto = cuda_ms(lambda: conv_kernel.conv2d_nhwc(x, wt, bias), 20)
                x_nchw = x.permute(0, 3, 1, 2)
                w_oihw = wt.permute(3, 2, 0, 1).contiguous()
                lib = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, bias,
                                                padding=k // 2), 20)
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

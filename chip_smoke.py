#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashgmm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in one flushed line with its seconds:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels from the sources in this checkout (nvcc, one
   shared library), with the -Xptxas -v register and shared-memory lines;
   the bf16 conv kernel's SASS, read from the library by cuobjdump, must
   hold wgmma (HGMMA) and TMA loads (UTMALDG), ptxas must report no spill
   stores or loads for it nor for any of the 10 instances of the rANS
   encoder (its K=1 instances, the GSM passes', among them), and the
   library must hold no mma.sync conv kernel;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, all bit-exact: the GMM rows and bounds kernels, rANS
   encode over materialized bounds, rANS encode over GMM parameters (the
   y passes' encoder: in modes 0-2, and equal to the bounds kernel
   followed by the encoder), the cluster decoder over materialized rows and
   over the GMM rows on demand, also one W=8192 pass, and the conv (the same fmaf
   chain), which is also bitwise batch-invariant and repeatable; then the
   bf16 conv at every shape the transforms route to it, with each of its
   epilogues, and once in each shape class the wrapper takes (C_in and
   C_out not multiples of 64, K = 1, 5 and 7, H and W not multiples of the
   8 x 16 tile, N = 1, f32 out, each residual type), within a bf16 ulp
   (``BF16_RTOL`` with an atol of ``BF16_ATOL`` x max|plain|; f32 out
   within ``F32_REL`` of max|plain|); each routed shape's kernel ms and
   TFLOP/s beside F.conv2d's (cuDNN) on the same inputs;
4. codec: the batched checkerboard-GMM codec at N=192, K=4, lanes=4096,
   cap_divisor=4 on two 768x512 textured-leaves images: encode_to_bytes,
   then decode_bytes (the packed single-transfer path: y_hat and x_hat
   equal to decode(from_bytes(...)) bit for bit, one host-to-device copy
   in its profiler trace; an overflow file from ``encode(x, full=True)``
   at cap_divisor=64 takes the unpacked path and decodes exactly), y_hat
   exact through the bytes, bpp and PSNR, and
   every kernel's launch count from that run (one encode + decode: the z
   pass's encoder over its tables once, the GMM encoder twice, the coding
   softmax once a y pass, the bounds kernel, the full rows and the
   boundary rows never; the y passes decode on demand); then the
   same with ``kernel_transforms=True``, whose g_a, h_a and g_s launch the
   bf16 conv 26 times (each call within tolerance of its plain version),
   decode y_hat exactly, and stay within 0.05 dB and 0.5 % bpp of the
   default route;
5. paths: the same batch encoded and decoded along the full-rows path
   (rows kernel, gather, decoder over materialized rows): identical bytes
   and identical y_hat;
6. latency: the single-image codec (FastLatencyGmmCodec, one CUDA graph
   each for encode, decode-y and g_s) at lanes=1024, cap_divisor=4 on the
   first image, on both transform routes: certified on the graph path with
   no fallback; exactly three graphs, each direction's captured launches
   as the path's; bytes equal to the eager run of the same functions (the
   batched codec at the latency codec's settings), whose launches equal
   the graphs'; y_hat exact through the bytes and through the batched
   codec at lanes=1024; a forced certification failure takes the fallback,
   whose bytes decode; a truncated stream raises after the decode-y
   replay; ``decode`` reads the bytes' packed layout with one
   host-to-device copy and gives the unpacked streams' y_hat and x_hat;
   an overflow file (cap_divisor=64) certifies and decodes through a
   decode-y graph of its own; bytes, bpp, PSNR, each direction's
   launches and the median
   host-clock and CUDA-event ms of 20 runs of the certified encode, the
   encode alone and the decode, graph and eager;
7. bytes (ROADMAP C9): the latency codec's batch-1 bytes of the first
   image from fresh processes of this script (``--bytes-worker``), on each
   route one with torch's default flags that runs nothing first and
   builds the image tensor as ``chip_profile.py`` does, and one that sets
   this script's flags, takes all but 6 GiB of the card's memory first
   and slices the image from a batch as this script does: equal sha256
   digests, equal to this process's bytes, and both lengths printed; the
   first stage whose output differs, if any, with both processes' device
   kernels written to chiprun_out/;
8. forward: the training forward of the same model at full width on the
   first image (``forward_phase``): eval, training with a seeded
   generator on the card, one backward of bits per pixel + MSE; finite
   outputs and gradients, eval y_hat = round(y), the eval likelihoods'
   bits within 5 % of the bits the latency codec's bytes carry (the
   words and what the final rANS states hold), forward and backward
   ms;
9. elic: ELIC (Elic2022GMM N=192, M=320, K=4, the synthetic weights)
   through both of its codecs at lanes=512, cap_divisor=1 (``elic_phase``):
   the batched codec on the two images and on the first alone, on both
   routes, y_hat exact through the bytes, the launches of one encode +
   decode (the z pass's coder once a direction, the GMM coder ten times,
   the f32 conv 100 times with h_s's transposed convs, the bounds and
   rows kernels never, the bf16 conv 131 times on the kernel route, each
   distinct routed shape within tolerance of plain), bpp and PSNR of the
   kernel route within 0.5 % and 0.05 dB of the default's; the
   single-image codec (FastLatencyElicCodec) on both routes, certified on
   its three graphs with the path's captured launches, bytes equal to the
   eager batched codec's, a forced failure taking the fallback, the
   medians of 20 runs, graph and eager; a truncated stream raising; the
   eval forward's bits within 5 % of what the latency bytes carry;
10. gsm: the single-Gaussian checkerboard (Cheng2020AnchorCheckerboard
   N=128, the synthetic weights) through FastCheckerboardGsmCodec at the
   codec phase's settings on the two images, on both routes
   (``gsm_phase``): the launches of one encode_to_bytes + decode_bytes
   (every GMM coder call on the K=1 instances), whether the overflow
   fallback fired, y_hat exact through the bytes, every GMM coder call and
   every distinct rows-chain conv shape (426 and 341 channels among them)
   held to its plain version bit for bit, bytes, bpp and PSNR; the eval
   (two-pass) forward's bits within 5 % of what the bytes carry;
11. reference: reference-format coding (``model.compress`` /
   ``decompress``, the host coder csrc/rans.cpp) on the first image at
   full width (``reference_phase``): the flagship in both modes (device
   rows, host math), ELIC in device-rows mode and the GSM model on its
   scale table; the launches of one compress + decompress (the f32 conv
   for every entropy-parameter conv, the coding softmax and the boundary
   rows a GMM pass each, no rANS kernel), every softmax and boundary-rows
   call equal to its plain version bit for bit, y_hat exact, bytes and
   PSNR beside the batched codec's, compress and decompress ms with the
   host coder's share and the card's busy ms, and the port on the CPU
   decoding the card's strings of a 64x64 image to the card's y_hat;
12. timing: every kernel call of those runs timed again by CUDA events,
   back to back ("ms"), beside its plain version, a library call where one
   computes the same function, and its bound; the encoders and the bounds
   kernel also on the device alone ("device_ms": the stream's queue filled
   ahead, so the wrappers' host time is left out); the rows and bounds
   kernels, off the path, on the path's parameters; the on-demand decoder
   and the GMM encoder also beside their serial latency floors; and each
   kernel's calls of the latency path's eager run (batch 1), held to its
   plain version and timed ("latency_ms", "latency_device_ms",
   "latency_bound_ms"), beside its launches in each direction's graph
   ("latency_launches"); and each kernel's calls of ELIC's batched encode
   + decode of the two images ("elic_launches", "elic_ms",
   "elic_device_ms", "elic_bound_ms"), and of the GSM codec's ("gsm_*"),
   each distinct conv shape and each coder call held to its plain version;
   the coders' K=1 instances on lines of their own
   ("rans_encode_gmm_k1", "rans_decode_gmm_k1", their launches and times
   the GSM path's); each kernel's calls of the flagship's reference-format
   compress + decompress ("reference_*"), where the boundary-rows kernel
   has its main path's launches and calls.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its
last line ``{"ok": true, "device": {...}}``. Any failed check raises, so
the run exits non-zero without that line; a hang ends after 1000 s with a
traceback. Needs a CUDA device and this repository; imports no JAX.
"""

import faulthandler
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "ckbd_gmm_n192_k4_synthetic.npz"
H, W, BATCH, N, K, LANES, CAP_DIVISOR = 768, 512, 2, 192, 4, 4096, 4
SEED0 = 500000  # bench.py's held-out image seeds: SEED0 + 1, SEED0 + 2, ...
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
# the bf16 conv against its plain version (which sums in another order):
# |kernel - plain| <= BF16_ATOL * max|plain| + BF16_RTOL * |plain| for a bf16
# result, one bf16 ulp; max|kernel - plain| < F32_REL * max|plain| for an f32
# result (the JAX package's own bound for its kernel, tests/test_pallas_conv.py)
BF16_RTOL, BF16_ATOL, F32_REL = 2.0 ** -7, 1e-3, 1e-5
# the default route's result at PR 6 (NVIDIA H100 80GB HBM3), which the bf16
# kernel must not move: the route is opt-in
DEFAULT_BYTES, DEFAULT_PSNR = 100282, 29.9711
W_WIDE = 8192  # the widest lanes the JAX bench swept: one pass decodes
# the single-image latency codec: the JAX bench's lanes for it
# (bench.py:108-134), and the runs each of its timings is the median of
LAT_LANES, LAT_REPS = 1024, 20
# ELIC (Elic2022GMM, the paper's own model): the weights, M, and its codecs'
# lanes and cap_divisor (the JAX defaults, flashgmm_tpu/runtime/fast_elic.py:
# 31-33 and latency_elic.py:37-39)
ELIC_WEIGHTS = ROOT / "weights" / "elic_gmm_n192_m320_k4_synthetic.npz"
ELIC_M, ELIC_LANES, ELIC_CAP = 320, 512, 1
ELIC_PASSES = 11  # z, then two checkerboard passes of each of 5 groups
# a direction's rows-chain convs: h_s 3, channel contexts 4 x 3, spatial
# contexts 5, aggregation networks 10 x 3; the bf16 kernel's routed convs
# of g_a, h_a and g_s at N=192, M=320
ELIC_ROWS_CONVS, ELIC_BF16 = 50, {"g_a": 65, "h_a": 1, "g_s": 65}
ELIC_INSERTED = 2  # of them h_s's stride-2 deconvs, on zero-inserted inputs
# the single-Gaussian checkerboard (Cheng2020AnchorCheckerboard): the local
# weights' N, and a direction's rows-chain convs (h_s 5, the context 1, the
# entropy parameters 2 x 3), coded at the flagship's batched settings
GSM_WEIGHTS = ROOT / "weights" / "ckbd_gc_n128_synthetic.npz"
GSM_N, GSM_ROWS_CONVS = 128, 12
GSM_REPS = 5  # the encode and decode times are the medians of as many runs
# reference-format coding: its compress and decompress times are the
# medians of as many runs
REF_REPS = 3
# the coder kernels' K=1 instances (the GSM passes), named apart on the
# kernels line; their wrappers count them in ``launches_k1``
K1_INSTANCES = ("rans_encode_gmm", "rans_decode_gmm")
# float32 operations of one mixture term of one rows entry, by APPROX_MODE
# (each add, sub, mul, div, sqrt and floor 1, each FMA 2; XLA's exp is 22):
# Pólya: sub, div, 2 mul, exp, sub, sqrt, add, and the mixture FMA = 31;
# A&S: sub, div, FMA, div, 4 FMA, 2 mul, exp, 2 mul, FMA, sub, FMA = 44;
# logistic: sub, div, mul, exp, add, div, FMA = 29.
ROWS_FLOPS_PER_TERM = {0: 31, 1: 44, 2: 29}
# kernels also timed on the device alone (cuda_ms(..., ahead=True)): their
# wrappers never wait for the device, and their calls are short enough for
# the host's enqueue to bound back-to-back calls
DEVICE_TIMED = ("rans_encode", "rans_encode_gmm", "gmm_bounds",
                "gmm_boundary_rows", "gmm_softmax")
# float32 operations of one softmax entry: the max's compare, the subtract,
# XLA's exp (22), the sum's add, the divide, and the flushes' compares (4)
SOFTMAX_FLOPS_PER_ENTRY = 30

_t_phase = [time.perf_counter()]


def phase(name, detail=""):
    now = time.perf_counter()
    print(f"[{name}] {now - _t_phase[0]:.2f} s {detail}".rstrip(), flush=True)
    _t_phase[0] = now


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bf16_conv_ok(got, ref):
    """The bf16 conv kernel against its plain version, by the result's
    type: (within tolerance, max|kernel - plain|, share of outputs that
    differ at all)."""
    import torch

    g, r = got.float(), ref.float()
    d = (g - r).abs()
    top = float(r.abs().max())
    if got.dtype == torch.bfloat16:
        ok = bool((d <= BF16_ATOL * top + BF16_RTOL * r.abs()).all())
    else:
        ok = float(d.max()) < F32_REL * top
    return ok, float(d.max()), float((d > 0).float().mean())


def sass_counts(lib_path, name_part, ops):
    """{function: {op: instructions}} of the SASS of every function of the
    built library whose name contains ``name_part`` (cuobjdump)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    require(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-400:]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if name_part in fn:
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn in counts:
            for op in ops:
                counts[fn][op] += op in line
    return counts


def ptxas_spills(lines):
    """{function: (spill store bytes, spill load bytes)} from the -Xptxas -v
    lines: each "Function properties for F" line, then its counts."""
    spills, fn = {}, None
    for line in lines:
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn is not None and "bytes spill" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            require(m is not None, f"ptxas line not understood: {line}")
            spills[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return spills


def call_key(args, kwargs):
    """A kernel call's shapes, types and options: calls with equal keys do
    the same work on inputs of the same shapes."""
    def key(v):
        if hasattr(v, "kio"):  # packed bf16 weights
            v = v.kio
        if hasattr(v, "shape"):
            return (tuple(v.shape), str(v.dtype))
        return v
    return (tuple(key(a) for a in args),
            tuple(sorted((k, key(v)) for k, v in kwargs.items())))


def inserted_stride(x):
    """2 where the NHWC conv input x is a stride-2 transposed conv's
    zero-inserted input (``ConvTranspose2d.canonical``: its values at
    [:, ::2, ::2], zeros between), else 1."""
    if x.shape[1] % 2 or x.shape[2] % 2 or not bool(x[:, ::2, ::2].any()):
        return 1
    return 1 if bool(x[:, 1::2].any() or x[:, :, 1::2].any()) else 2


def cuda_ms(fn, reps, ahead=False):
    """Mean ms of fn over reps calls after one warm-up, by CUDA events. With
    ``ahead`` the events time the device's work alone, without the
    wrappers' host time (only for wrappers that never wait for the device):
    a sleep kernel first holds the stream for twice the host's measured
    time to enqueue the reps calls, and a run counts only if the sleep was
    still running once the last call was enqueued (else the sleep doubles
    and the run is repeated)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = 0
    if ahead:  # sleep cycles for twice the enqueue time at up to 2 GHz
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        cycles = int(4e9 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    for _ in range(4):
        if ahead:
            torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        # with ahead: the device had not reached the calls yet
        queued = not ahead or not a.query()
        b.record()
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
        cycles *= 2
    raise RuntimeError("cuda_ms: the sleep ended before the calls were queued")


def h2d_copies(fn):
    """fn() under torch.profiler: (fn's result, the host-to-device copies
    the card ran). A trace that holds no kernel at all lost its device
    events (seen after several profiler sessions in one process) and is
    taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        if any(not n.startswith(("Memcpy", "Memset")) for n in names):
            return out, sum(n.startswith("Memcpy HtoD") for n in names)
    raise RuntimeError("h2d_copies: three traces without device kernels")


def truncate_pass(data, lanes, which, n_passes):
    """Codec bytes of ``n_passes`` passes (docs/bitstream.md §2: per pass
    u32 n_words, u32 x lanes states, u16 x n_words words) with pass
    ``which`` (0 z, then the y passes in order) cut to half its words: a
    truncated file."""
    import numpy as np

    parts, off = [], 0
    for i in range(n_passes):
        n = int(np.frombuffer(data, np.uint32, 1, off)[0])
        head, end = off + 4 + 4 * lanes, off + 4 + 4 * lanes + 2 * n
        if i == which:
            parts += [np.uint32(n // 2).tobytes(), data[off + 4:head],
                      data[head:head + 2 * (n // 2)]]
        else:
            parts.append(data[off:end])
        off = end
    return b"".join(parts)


def latency_run(codec, x, data, y_shape):
    """One run of each single-image operation of a FastLatencyGmmCodec (or
    FastLatencyElicCodec) on image x [1, H, W, 3] whose certified bytes are
    ``data``: the certified encode, the encode alone (the encode direction
    and the bytes of its passes) and the decode of ``data``, each timed by
    host clock around work that ends in a synchronize and by CUDA events
    around it: {op: (host ms, events ms)}."""
    import torch

    ops = {"encode_certified": lambda: codec.encode_certified(x),
           "encode": lambda: codec._batched._bytes_of(
               codec._certifiable(x)[0]),
           "decode": lambda: codec.decode(data, y_shape)}
    out = {}
    for op, fn in ops.items():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out[op] = (1e3 * (time.perf_counter() - t0), a.elapsed_time(b))
    return out


def latency_times(codec, x, reps):
    """Median ms of ``reps`` runs (after one warm-up) of each operation of
    ``latency_run``: {op: {"host_ms", "cuda_ms"}}."""
    import statistics

    data, y_shape = codec.encode_certified(x)
    latency_run(codec, x, data, y_shape)
    runs = [latency_run(codec, x, data, y_shape) for _ in range(reps)]
    return {op: {"host_ms": statistics.median(r[op][0] for r in runs),
                 "cuda_ms": statistics.median(r[op][1] for r in runs)}
            for op in runs[0]}



BYTES_SETUPS = ("cold", "hog", "batched", "inference", "cache", "plain",
                "libconv", "eager", "side")


def bytes_worker(route, setup, stages=""):
    """One fresh process's batch-1 ``encode_certified`` of the first bench
    image (seed SEED0 + 1) at N=192, K=4, the bench weights, lanes=1024 and
    cap_divisor=4, on the default route or the kernel route: prints one JSON
    line with the bytes' length and sha256. ``setup``: "cold" leaves torch's
    global flags at their defaults, runs nothing first and gives the image
    as ``torch.from_numpy(img[None])`` (its batch dimension's stride 0;
    every other setup gives it as the first of a stacked batch, as this
    script does, stride H*W*3); "hog" sets this
    script's flags (TF32 off) and takes all but 6 GiB of the card's free
    memory first; "batched" sets them and first runs the batched codec on
    two images, both routes, as this script's codec phase does;
    "inference" sets them and builds, loads and runs everything under
    ``torch.inference_mode``, as this script does; "cache" first frees 8
    GiB into the allocator's cache; "plain" and "libconv" first run one
    conv of the kernels phase (the bf16 conv's plain version, cuDNN's bf16
    conv); "eager" and "side" first run the batch-1 encode eagerly on the
    current stream or on a side stream. ``stages`` ("1"): the
    line also holds a digest of every stage's output (``stage_digests``)
    and the device kernels that g_a and h_a ran, in order."""
    import contextlib
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.runtime import (FastCheckerboardGmmCodec,
                                            FastLatencyGmmCodec)
    from flashgmm_tpu_torch.zoo import load_npz

    dev = torch.device("cuda", 0)
    hog = None
    if setup != "cold":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if setup == "hog":
        free, _ = torch.cuda.mem_get_info(dev)
        hog = torch.empty(free - (6 << 30), dtype=torch.uint8, device=dev)
    if setup == "cache":  # a large free block in the allocator's cache
        torch.empty(8 << 30, dtype=torch.uint8, device=dev).fill_(0)
        torch.cuda.synchronize()
    if setup in ("plain", "libconv"):  # one conv of the kernels phase first
        from flashgmm_tpu_torch.ops import conv_kernel
        xs = torch.randn(BATCH, H // 8, W // 8, N, device=dev).bfloat16()
        ws = (torch.randn(3, 3, N, N, device=dev) * 0.03).bfloat16()
        if setup == "plain":
            conv_kernel.conv2d_nhwc_bf16_plain(xs, ws)
        else:
            torch.nn.functional.conv2d(
                xs.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last), padding=1)
        torch.cuda.synchronize()
    mode = (torch.inference_mode() if setup == "inference"
            else contextlib.nullcontext())
    with mode:
        model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0, device=dev)
        load_npz(model, WEIGHTS)
        model.update(update_quantiles=True)
        if setup == "batched":
            xb = torch.from_numpy(np.stack([
                textured_leaves(H, W, seed=SEED0 + 1 + i)
                for i in range(BATCH)])).to(dev)
            for kt in (False, True):
                c = FastCheckerboardGmmCodec(model, lanes=LANES,
                                             cap_divisor=CAP_DIVISOR,
                                             kernel_transforms=kt)
                d, o = c.encode_to_bytes(xb)
                c.decode_bytes(d, tuple(o["y_hat"].shape))
        lat = FastLatencyGmmCodec(model, lanes=LAT_LANES,
                                  cap_divisor=CAP_DIVISOR,
                                  kernel_transforms=route == "kernel")
        img = textured_leaves(H, W, seed=SEED0 + 1)
        if setup == "cold":  # as chip_profile.py builds it: batch stride 0
            x = torch.from_numpy(img[None]).to(dev)
        else:  # as this script does: the first image of a stacked batch
            x = torch.from_numpy(np.stack([img, img])).to(dev)[:1]
        if setup in ("eager", "side"):  # batch-1 transforms run first
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side) if setup == "side" \
                    else contextlib.nullcontext():
                lat._batched._encode(x, CAP_DIVISOR)
            torch.cuda.synchronize()
        with torch.inference_mode():
            data, _ = lat.encode_certified(x)
        torch.cuda.synchronize()
        out = {"route": route, "setup": setup, "bytes": len(data),
               "sha256": hashlib.sha256(data).hexdigest()}
        if stages:
            out.update(stage_digests(lat._batched, x))
    del hog
    print(json.dumps(out), flush=True)


def stage_digests(codec, x):
    """Every stage's output of an eager batch-1 encode through ``codec``:
    {"stages": {name: [sha256 prefix, sum, max|v|]} (each module of g_a and
    h_a in call order, then z_bin, h_s's output, the anchor pass's
    parameters, the symbols), "kernels": names of the device kernels g_a
    and h_a ran, in order (torch.profiler)}."""
    import hashlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    stages, hooks = {}, []

    def keep(key, t):
        t = t.detach()
        a = t.float()
        stages[f"{len(stages):03d}_{key}"] = [
            hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                           .tobytes()).hexdigest()[:16],
            float(a.double().sum()),
            float(a.abs().max())]

    for tag, mod in (("g_a", codec._g_a), ("h_a", codec._h_a)):
        for name, m in mod.named_modules():
            if name:
                hooks.append(m.register_forward_hook(
                    lambda _m, _i, o, key=f"{tag}.{name}": keep(key, o)))
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            y = codec._transform(codec._g_a, x)
            z = codec._transform(codec._h_a, y)
            torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        z_bin = torch.round(z - codec._med).to(torch.int32) - codec._z_off
        z_bin = torch.minimum(torch.clamp_min(z_bin, 0), codec._z_maxbin)
        side = codec._side(z_bin)
        params = codec._params0(side[0])
        sym = torch.round(codec._ckbd.unembed(y)).to(torch.int32)
        for key, t in (("z_bin", z_bin), ("side", side), ("scales0", params[0]),
                       ("means0", params[1]), ("weights0", params[2]),
                       ("sym", sym)):
            keep(key, t)
    events = sorted((e for e in prof.events()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    return {"stages": stages, "kernels": [e.name for e in events]}

def pass_words(data, lanes, n_passes):
    """Each pass's n_words in codec bytes (docs/bitstream.md §2)."""
    import numpy as np

    words, off = [], 0
    for _ in range(n_passes):
        words.append(int(np.frombuffer(data, np.uint32, 1, off)[0]))
        off += 4 + 4 * lanes + 2 * words[-1]
    return words


def coded_bits(data, lanes, n_passes):
    """(payload bits, coded bits) of codec bytes of ``n_passes`` passes
    (docs/bitstream.md §2: per pass u32 n_words, u32 x lanes states, u16 x
    n_words words). Payload:
    the words alone, the bytes less the passes' headers and states. Coded:
    the information the passes carry, 16 bits a word plus what each lane's
    final state holds above its initial 2^16, log2(state) - 16 (rANS
    states end in [2^16, 2^32))."""
    import numpy as np

    payload = coded = 0.0
    off = 0
    for _ in range(n_passes):
        n = int(np.frombuffer(data, np.uint32, 1, off)[0])
        states = np.frombuffer(data, np.uint32, lanes, off + 4)
        payload += 16 * n
        coded += 16 * n + float(np.sum(np.log2(states.astype(np.float64))
                                       - 16))
        off += 4 + 4 * lanes + 2 * n
    return payload, coded


def psnr_of(x_hat, x):
    """Mean PSNR (dB) over the batch of images x_hat against x."""
    import numpy as np

    mse = ((x_hat - x) ** 2).mean(dim=(1, 2, 3)).double().cpu().numpy()
    return float(np.mean(-10 * np.log10(np.maximum(mse, 1e-12))))


def eval_bits_gap(model, x, data, lanes, n_passes, tag):
    """The eval forward of ``model`` on images x: finite outputs, and its
    likelihoods' bits within 5 % of the bits that codec bytes ``data`` of
    the same images carry (``coded_bits``; the payload alone printed
    beside them)."""
    import torch

    with torch.no_grad():
        ev = model(x, training=False)
    for name, t in (("x_hat", ev["x_hat"]), *ev["likelihoods"].items()):
        require(bool(torch.isfinite(t).all()), f"{tag}: {name}")
    bits = sum(float(-torch.log2(v.double()).sum())
               for v in ev["likelihoods"].values())
    payload, coded = coded_bits(data, lanes, n_passes)
    gap = bits / coded - 1
    print(f"  {tag}, {x.shape[0]} x {x.shape[1]}x{x.shape[2]}: {bits:.1f} "
          f"bits against the {coded:.1f} the bytes carry (gap "
          f"{100 * gap:+.3f} %; payload alone {payload:.0f} bits)",
          flush=True)
    require(abs(gap) <= 0.05, f"{tag}: the likelihoods' bits are "
            f"{100 * gap:+.2f} % from the codec's coded bits")


def forward_phase(dev, x, codec_data, n_passes):
    """The training forward of the N=192, K=4 flagship with the bench
    weights on image x [1, H, W, 3]: eval, then training with a seeded
    generator, then one backward of bits per pixel + MSE. Requires finite
    outputs and g_a's first conv gradient, finite and not all zero;
    eval-mode y_hat = round(y); the eval likelihoods' bits within 5 % of
    the bits the latency codec's bytes ``codec_data`` (``n_passes``
    passes) carry (``coded_bits``; the payload alone, the bytes less the
    passes' headers and states, is printed beside them); prints the
    forward and backward ms (CUDA events, median of 5)."""
    import statistics

    import torch
    import torch.nn.functional as F

    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.zoo import load_npz

    with torch.inference_mode(False):
        model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0, device=dev)
        load_npz(model, WEIGHTS)
        model.update(update_quantiles=True)  # the codecs' medians
        x = x.clone()
        pixels = x.shape[0] * x.shape[1] * x.shape[2]

        def finite(t, tag):
            require(bool(torch.isfinite(t).all()) and bool((t != 0).any()),
                    f"forward: {tag} not finite or all zero")

        with torch.no_grad():
            ev = model(x, training=False)
            y = model.g_a(x)
            y_hat = model.latent_codec(y, training=False)["y_hat"]
        require(torch.equal(y_hat, torch.round(y)),
                "forward: eval y_hat is not round(y)")
        bits = sum(float(-torch.log2(v.double()).sum())
                   for v in ev["likelihoods"].values())
        payload, coded = coded_bits(codec_data, LAT_LANES, n_passes)
        gap = bits / coded - 1

        def loss_of(out):
            rate = sum(-torch.log2(v).sum() for v in out["likelihoods"].values())
            return rate / pixels + F.mse_loss(out["x_hat"], x)

        gen = torch.Generator(device=dev).manual_seed(0)
        tr = model(x, training=True, generator=gen)
        loss_of(tr).backward()
        grad = model.g_a.layers[0].conv1.weight.grad
        for tag, t in (("eval x_hat", ev["x_hat"]),
                       ("training x_hat", tr["x_hat"]),
                       ("g_a's first conv gradient", grad),
                       *((f"eval {k} likelihoods", v)
                         for k, v in ev["likelihoods"].items()),
                       *((f"training {k} likelihoods", v)
                         for k, v in tr["likelihoods"].items())):
            finite(t, tag)
        fwd, bwd = [], []
        for _ in range(5):
            model.zero_grad(set_to_none=True)
            a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            torch.cuda.synchronize()
            a.record()
            loss = loss_of(model(x, training=True, generator=gen))
            b.record()
            loss.backward()
            c.record()
            torch.cuda.synchronize()
            fwd.append(a.elapsed_time(b))
            bwd.append(b.elapsed_time(c))
        model.zero_grad(set_to_none=True)
    print(f"  forward N={N} K={K} {x.shape[1]}x{x.shape[2]}: eval bits "
          f"{bits:.1f} against the {coded:.1f} bits the latency codec's bytes "
          f"carry (gap {100 * gap:+.3f} %) and their payload alone "
          f"{payload:.0f} bits (gap {100 * (bits / payload - 1):+.3f} %); "
          f"training loss {float(loss):.5f}; "
          f"forward {statistics.median(fwd):.3f} ms, backward "
          f"{statistics.median(bwd):.3f} ms (CUDA events, median of 5)",
          flush=True)
    require(abs(gap) <= 0.05, f"forward: the likelihoods' bits are "
            f"{100 * gap:+.2f} % from the codec's coded bits")
    phase("forward", "eval, training and one backward at full width")


def elic_phase(dev, x, record, originals):
    """ELIC (Elic2022GMM N=192, M=320, K=4, the synthetic weights,
    update(update_quantiles=True)) through both of its codecs on the
    smoke's images x [BATCH, H, W, 3]. Batched (FastElicGmmCodec,
    lanes=512, cap_divisor=1) on the batch and on the first image, each
    route: encode -> to_bytes -> from_bytes -> decode with y_hat exact,
    the launches of one encode + decode (z encoder 1, GMM encoder 10, z
    decoder 1, GMM decoder 10, the f32 conv 100, the bounds and rows
    kernels never, the bf16 conv 131 on the kernel route), each distinct
    routed bf16 shape once within tolerance of its plain version, the
    kernel route's bpp and PSNR within 0.5 % and 0.05 dB of the default's.
    Single image (FastLatencyElicCodec, the same settings), each route:
    certified on its graphs with no fallback, three graphs whose captured
    launches are the path's, bytes equal to the eager batched codec's,
    y_hat exact, a forced certification failure taking the fallback whose
    bytes decode, medians of LAT_REPS runs of encode_certified and decode,
    graph and eager; a truncated stream raising after the decode-y replay
    (at cap_divisor=4: at cap_divisor=1 a stream has room for one word a
    symbol, which no decoder reads past, so truncation shows only as
    wrong symbols, as in the reference). Then the eval forward at full
    width on the first image, its likelihoods' bits within 5 % of the bits
    the latency bytes carry. Returns (launches, recorded calls) of the
    default route's batched encode + decode of the batch, the bf16 conv's
    from the kernel route's, for the timing phase."""
    import numpy as np
    import torch

    from flashgmm_tpu_torch.models import Elic2022GMM
    from flashgmm_tpu_torch.ops import conv_kernel
    from flashgmm_tpu_torch.runtime import (FastElicGmmCodec,
                                            FastLatencyElicCodec)
    from flashgmm_tpu_torch.zoo import load_npz

    model = Elic2022GMM(N=N, M=ELIC_M, K=K, seed=0, device=dev)
    n_loaded = load_npz(model, ELIC_WEIGHTS)
    model.update(update_quantiles=True)
    x1 = x[:1].contiguous()
    print(f"  ELIC N={N} M={ELIC_M} K={K} groups {model.groups}: "
          f"{ELIC_WEIGHTS.name}, {n_loaded} tensors", flush=True)

    def batched(c, xb, tag):
        """One warmed-up encode -> to_bytes -> from_bytes -> decode of xb,
        launches counted from 0: (bytes, y_hat, launches, calls, bpp,
        PSNR)."""
        def once():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data, out = c.encode_to_bytes(xb)
            y_shape = tuple(out["y_hat"].shape)
            t1 = time.perf_counter()
            x_hat = c.decode(c.from_bytes(data, y_shape), y_shape)
            torch.cuda.synchronize()
            return data, out, x_hat, t1 - t0, time.perf_counter() - t1

        once()
        (data, out, x_hat, t_enc, t_dec), launches, calls = record(once)
        y_shape = tuple(out["y_hat"].shape)
        require(len(out["streams"]) == ELIC_PASSES,
                f"{tag}: {len(out['streams'])} streams")
        require(torch.equal(c.decode_y_hat(c.from_bytes(data, y_shape),
                                           y_shape), out["y_hat"]),
                f"{tag}: y_hat differs after the bytes")
        require(tuple(x_hat.shape) == tuple(xb.shape)
                and bool(torch.isfinite(x_hat).all()), f"{tag}: x_hat")
        b = xb.shape[0]
        bpp, psnr = len(data) * 8 / (b * H * W), psnr_of(x_hat, xb)
        print(f"  {tag}: y_hat {list(y_shape)} exact through {len(data)} "
              f"bytes; bpp {bpp:.7f}, PSNR {psnr:.4f} dB; encode "
              f"{1e3 * t_enc / b:.2f} ms, decode {1e3 * t_dec / b:.2f} ms per "
              f"image (host clock); launches {launches}", flush=True)
        return data, out["y_hat"], launches, calls, bpp, psnr

    want = {"rans_encode": 1, "rans_encode_gmm": 10, "rans_decode": 1,
            "rans_decode_gmm": 10, "gmm_bounds": 0, "gmm_rows": 0,
            "gmm_softmax": 20, "gmm_boundary_rows": 0,
            "conv2d_nhwc": 2 * ELIC_ROWS_CONVS, "conv2d_nhwc_bf16": 0}
    runs = {}
    for kt in (False, True):
        c = FastElicGmmCodec(model, lanes=ELIC_LANES, cap_divisor=ELIC_CAP,
                             kernel_transforms=kt)
        for xb, what in ((x, f"batch {BATCH}"), (x1, "image 1")):
            tag = (f"ELIC batched {what}, "
                   f"{'kernel' if kt else 'default'} route")
            r = batched(c, xb, tag)
            w = dict(want, conv2d_nhwc_bf16=sum(ELIC_BF16.values()) if kt
                     else 0)
            require(r[2] == w, f"{tag}: launches {r[2]}, not {w}")
            # the timing phase takes the batch's calls; drop the others
            runs[(kt, what)] = r if xb is x else r[:3] + (None,) + r[4:]
        del c
    shapes = {}  # each distinct routed bf16 conv of the path, once
    for args, kwargs in runs[(True, f"batch {BATCH}")][3]["conv2d_nhwc_bf16"]:
        key = (tuple(args[0].shape), tuple(args[1].shape),
               kwargs.get("negative_slope"),
               None if kwargs.get("residual") is None
               else kwargs["residual"].dtype)
        if key not in shapes:
            got = originals["conv2d_nhwc_bf16"](*args, **kwargs)
            ref = conv_kernel.conv2d_nhwc_bf16_plain(*args, **kwargs)
            ok, err, _ = bf16_conv_ok(got, ref)
            require(ok, f"ELIC bf16 conv {key}: beyond tolerance ({err})")
            shapes[key] = err
    print(f"  ELIC kernel route: {len(shapes)} distinct bf16 conv shapes, "
          f"each within tolerance of plain (max|d| "
          f"{max(shapes.values()):.3g})", flush=True)
    for what in (f"batch {BATCH}", "image 1"):
        (_, _, _, _, bpp, psnr), (_, _, _, _, k_bpp, k_psnr) = (
            runs[(False, what)], runs[(True, what)])
        require(abs(k_psnr - psnr) <= 0.05 and abs(k_bpp - bpp) <= 0.005 * bpp,
                f"ELIC {what}: kernel route bpp {k_bpp} PSNR {k_psnr}, "
                f"default {bpp} {psnr}")

    # the single image: one CUDA graph a direction
    names = {"encode_scan": "rans_encode",
             "encode_scan_gmm": "rans_encode_gmm",
             "decode_scan": "rans_decode", "decode_scan_gmm": "rans_decode_gmm",
             "gmm_softmax": "gmm_softmax", "conv2d_nhwc": "conv2d_nhwc",
             "conv2d_nhwc_bf16": "conv2d_nhwc_bf16"}
    lat_data = None
    for kt in (False, True):
        tag = f"ELIC latency {'kernel' if kt else 'default'} route"
        lat = FastLatencyElicCodec(model, lanes=ELIC_LANES,
                                   cap_divisor=ELIC_CAP, kernel_transforms=kt)
        fallbacks = []
        encode_fallback = lat._encode_fallback

        def counted(*args, _fallback=encode_fallback):
            fallbacks.append(1)
            return _fallback(*args)
        lat._encode_fallback = counted

        def first(lat=lat):
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                data, y_shape = lat.encode_certified(x1)
                x_hat = lat.decode_bytes(data, y_shape)
                torch.cuda.synchronize()
            return data, y_shape, x_hat

        (l_data, l_shape, l_xhat), l_launches, _ = record(first)
        require(not fallbacks and not lat._fallback_digests,
                f"{tag}: certification fell back on the graph path")
        graphs = {d: g for (d, _), g in lat._graphs.items()}
        require(len(lat._graphs) == 3 and sorted(graphs) == [
            "decode_y", "encode", "g_s"], f"{tag}: graphs {list(lat._graphs)}")
        g_launches = {d: {names[k]: v for k, v in g.launches.items() if v}
                      for d, g in graphs.items()}
        bf16 = ELIC_BF16 if kt else dict.fromkeys(ELIC_BF16, 0)
        want_g = {"encode": {"rans_encode": 1, "rans_encode_gmm": 10,
                             "gmm_softmax": 10,
                             "conv2d_nhwc": ELIC_ROWS_CONVS,
                             "conv2d_nhwc_bf16": bf16["g_a"] + bf16["h_a"]},
                  "decode_y": {"rans_decode": 1, "rans_decode_gmm": 10,
                               "gmm_softmax": 10,
                               "conv2d_nhwc": ELIC_ROWS_CONVS},
                  "g_s": {"conv2d_nhwc_bf16": bf16["g_s"]}}
        want_g = {d: {k: v for k, v in c.items() if v}
                  for d, c in want_g.items()}
        require(g_launches == want_g, f"{tag}: captured launches {g_launches}"
                f", not {want_g}")

        def eager(lat=lat, y_shape=l_shape):
            data, out = lat._batched.encode_to_bytes(x1)
            x_hat = lat._batched.decode_bytes(data, y_shape)
            torch.cuda.synchronize()
            return data, out, x_hat

        (e_data, e_out, e_xhat), e_launches, _ = record(eager)
        require(e_data == l_data, f"{tag}: graph bytes differ from eager")
        for name, count in e_launches.items():
            require(count == sum(g.get(name, 0) for g in g_launches.values()),
                    f"{tag}: eager launches {name} {count} times, the "
                    "graphs another number")
        y_graph = lat._decode_y(lat._passes(lat.from_bytes(l_data, l_shape)),
                                l_shape).clone()
        require(int(lat._err) == 0 and torch.equal(y_graph, e_out["y_hat"]),
                f"{tag}: y_hat not exact through the bytes")
        gs_diff = float((l_xhat - e_xhat).abs().max())
        require(tuple(l_xhat.shape) == (1, H, W, 3)
                and bool(torch.isfinite(l_xhat).all()) and gs_diff < 1e-2,
                f"{tag}: x_hat, graph against eager max|d| {gs_diff}")
        lat._cmp = lambda a, b: torch.zeros((), dtype=torch.bool,
                                            device=a.device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            f_data, f_shape = lat.encode_certified(x1)
        del lat._cmp
        require(len(fallbacks) == 1 and lat._fallback_digests and any(
            issubclass(w_.category, RuntimeWarning) for w_ in caught),
            f"{tag}: a forced failure did not take the fallback")
        require(torch.equal(lat.decode_bytes(f_data, f_shape),
                            lat._batched.decode_bytes(f_data, f_shape)),
                f"{tag}: the fallback's bytes do not decode")
        lat._fallback_digests.clear()
        times = {"graph": latency_times(lat, x1, LAT_REPS)}
        lat._graphed = False  # the same functions, eagerly
        times["eager"] = latency_times(lat, x1, LAT_REPS)
        lat._graphed = True
        mse = float(((l_xhat - x1) ** 2).mean())
        print(f"  {tag}: certified on its 3 graphs, y_hat {list(l_shape)} "
              f"exact through {len(l_data)} bytes (the eager run's); bpp "
              f"{len(l_data) * 8 / (H * W):.7f}, PSNR "
              f"{-10 * np.log10(max(mse, 1e-12)):.4f} dB; forced failure: "
              f"fallback taken, bytes decode; captured launches {g_launches}",
              flush=True)
        print(f"  {tag}: median ms of {LAT_REPS} runs (host clock, CUDA "
              f"events): {json.dumps(times)}", flush=True)
        if not kt:
            lat_data = l_data
        del lat
    lat4 = FastLatencyElicCodec(model, lanes=ELIC_LANES, cap_divisor=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        d4, s4 = lat4.encode_certified(x1)
    x4 = lat4.decode_bytes(d4, s4)
    try:
        lat4.decode_bytes(truncate_pass(d4, ELIC_LANES, 1, ELIC_PASSES), s4)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    require("past its end" in raised,
            f"ELIC latency: a truncated stream did not raise ({raised})")
    torch.cuda.synchronize()
    require(torch.equal(lat4.decode_bytes(d4, s4), x4),
            "ELIC latency: decode differs after the truncated stream")
    print("  ELIC latency, cap_divisor=4: a truncated y0 stream raises after "
          "the decode-y replay; the graphs decode the file again", flush=True)
    del lat4

    eval_bits_gap(model, x1, lat_data, ELIC_LANES, ELIC_PASSES,
                  "ELIC eval forward against the latency bytes")
    default, kernel = runs[(False, f"batch {BATCH}")], runs[(True,
                                                             f"batch {BATCH}")]
    launches = dict(default[2], conv2d_nhwc_bf16=kernel[2]["conv2d_nhwc_bf16"])
    calls = dict(default[3], conv2d_nhwc_bf16=kernel[3]["conv2d_nhwc_bf16"])
    phase("elic", "batched and latency codecs, both routes, forward")
    return launches, calls, pass_words(default[0], ELIC_LANES, ELIC_PASSES)


def conv_shape_times(kernel, args, kwargs):
    """Print one rows-chain conv call's kernel ms and TFLOP/s beside
    F.conv2d's (float32, TF32 off) on the same inputs, each on the device
    alone (``cuda_ms(..., ahead=True)``: neither waits for the device, and
    calls this short are bound by the host's enqueue back to back), and
    the kernel's copy route: 4-wide when C_in and C_out are multiples of
    4, else one float a copy. Masked taps are no work."""
    import torch

    x, w, b = args
    flops = 2 * x.shape[0] * x.shape[1] * x.shape[2] * int(
        torch.count_nonzero(w))
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    t_k = cuda_ms(lambda: kernel(*args, **kwargs), 20, True)
    t_l = cuda_ms(lambda: torch.nn.functional.conv2d(
        x_nchw, w_oihw, b, padding=w.shape[0] // 2), 20, True)
    c_in, c_out = w.shape[2], w.shape[3]
    wide = c_in % 4 == 0 and c_out % 4 == 0
    print(f"    conv {'x'.join(map(str, x.shape[:3]))} {c_in}->{c_out} "
          f"k{w.shape[0]} ({'4-wide' if wide else 'scalar'} copies), device "
          f"ms: kernel {t_k:.4f} ({flops / t_k / 1e9:.2f} TFLOP/s), F.conv2d "
          f"{t_l:.4f} ({flops / t_l / 1e9:.2f} TFLOP/s)", flush=True)


def gsm_phase(dev, x, record, originals):
    """The single-Gaussian checkerboard (Cheng2020AnchorCheckerboard N=128,
    the synthetic weights, update(update_quantiles=True)) through
    FastCheckerboardGsmCodec on the smoke's images x [BATCH, H, W, 3] at
    lanes=LANES, cap_divisor=CAP_DIVISOR (the flagship's batched
    configuration), on each route: one warmed-up encode_to_bytes +
    decode_bytes with the launches counted from 0 (z encoder 1, GMM
    encoder 2 and z decoder 1, GMM decoder 2, all four GMM calls on the K=1
    instances; the f32 conv 24; the bounds and rows kernels never; the
    bf16 conv 26 on the kernel route; the encoder's twice over if the
    overflow fallback fired), whether the fallback (full=True) fired,
    y_hat exact through from_bytes and through the
    packed decode_bytes path (x_hat equal to decode(from_bytes)), every GMM
    coder call and every distinct rows-chain conv shape (the 426- and
    341-channel entropy-parameter convs among them) equal to its plain
    version bit for bit and timed on the device beside F.conv2d
    (``conv_shape_times``),
    every distinct bf16 conv shape within tolerance,
    bytes, bpp, PSNR and the medians of GSM_REPS more runs' encode and
    decode times (host clock); then the eval forward's bits within 5 % of the
    bits the default route's bytes carry. Returns (launches, recorded
    calls, pass words) of the default route's run, the bf16 conv's from
    the kernel route's, with the K=1 instances' launches and calls under
    "rans_encode_gmm_k1" and "rans_decode_gmm_k1"."""
    import statistics

    import torch

    from flashgmm_tpu_torch.ans import rans_kernels
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboard
    from flashgmm_tpu_torch.ops import conv_kernel
    from flashgmm_tpu_torch.runtime import FastCheckerboardGsmCodec
    from flashgmm_tpu_torch.zoo import load_npz

    model = Cheng2020AnchorCheckerboard(N=GSM_N, seed=0, device=dev)
    n_loaded = load_npz(model, GSM_WEIGHTS)
    model.update(update_quantiles=True)
    ep = [m.out_ch for m in model.latent_codec.latent_codec["y"]
          .entropy_parameters if hasattr(m, "out_ch")]
    print(f"  GSM N={GSM_N}: {GSM_WEIGHTS.name}, {n_loaded} tensors; entropy "
          f"parameters {4 * GSM_N} -> {' -> '.join(map(str, ep))}", flush=True)

    want = {"rans_encode": 1, "rans_encode_gmm": 2, "rans_decode": 1,
            "rans_decode_gmm": 2, "gmm_bounds": 0, "gmm_rows": 0,
            "gmm_softmax": 0, "gmm_boundary_rows": 0}
    runs = {}
    for kt in (False, True):
        tag = f"GSM batch {BATCH}, {'kernel' if kt else 'default'} route"
        c = FastCheckerboardGsmCodec(model, lanes=LANES,
                                     cap_divisor=CAP_DIVISOR,
                                     kernel_transforms=kt)
        d0, o0 = c.encode_to_bytes(x)  # warm-up (the library's autotuning)
        c.decode_bytes(d0, tuple(o0["y_hat"].shape))

        def once(c=c):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data, out = c.encode_to_bytes(x)
            y_shape = tuple(out["y_hat"].shape)
            t1 = time.perf_counter()
            x_hat = c.decode_bytes(data, y_shape)
            torch.cuda.synchronize()
            return data, out, x_hat, t1 - t0, time.perf_counter() - t1

        (data, out, x_hat, t_enc, t_dec), launches, calls = record(once)
        k1 = dict(record.k1)
        y_shape = tuple(out["y_hat"].shape)
        cap_y = c.stream_capacities(y_shape)[1]
        # the overflow fallback encodes a second time, uncapped
        fell_back = any(out[p].stream.shape[0] != cap_y for p in ("y0", "y1"))
        n_enc = 2 if fell_back else 1
        w = {name: v * (n_enc if name.startswith("rans_encode") else 1)
             for name, v in want.items()}
        w["conv2d_nhwc"] = GSM_ROWS_CONVS * (n_enc + 1)
        w["conv2d_nhwc_bf16"] = (12 * n_enc + 14) if kt else 0  # g_a + h_a, g_s
        require(launches == w, f"{tag}: launches {launches}, not {w}")
        require(k1 == {"rans_encode_gmm": 2 * n_enc, "rans_decode_gmm": 2},
                f"{tag}: K=1 instance launches {k1}, not {2 * n_enc} and 2")
        streams = c.from_bytes(data, y_shape)
        require(torch.equal(c.decode_y_hat(streams, y_shape), out["y_hat"]),
                f"{tag}: y_hat differs after from_bytes")
        host, caps = c.pack(data, y_shape)
        packed = caps == tuple(c._pass_caps(y_shape))  # decode_bytes' path
        if packed:
            y_packed = c.decode_y_hat(c.unpack(c.copy_staged(host), caps),
                                      y_shape)
            require(torch.equal(y_packed, out["y_hat"]),
                    f"{tag}: y_hat differs after the packed decode_bytes path")
        require(torch.equal(x_hat, c.decode(c.from_bytes(data, y_shape),
                                             y_shape)),
                f"{tag}: decode_bytes differs from decode(from_bytes)")
        require(tuple(x_hat.shape) == tuple(x.shape)
                and bool(torch.isfinite(x_hat).all()), f"{tag}: x_hat")
        bpp, psnr = len(data) * 8 / (BATCH * H * W), psnr_of(x_hat, x)
        words = pass_words(data, LANES, 3)
        reps = [once()[3:] for _ in range(GSM_REPS)]
        t_enc, t_dec = (statistics.median(r[i] for r in reps) for i in (0, 1))
        print(f"  {tag}: y_hat {list(y_shape)} exact through {len(data)} "
              f"bytes (from_bytes{' and the packed decode_bytes' if packed else ''}"
              f"); overflow "
              f"fallback {'fired' if fell_back else 'not fired'} (pass words "
              f"{words}, y cap {cap_y}); bpp {bpp:.7f}, PSNR {psnr:.4f} dB; "
              f"encode {1e3 * t_enc:.2f} ms, decode {1e3 * t_dec:.2f} ms, "
              f"{1e3 * (t_enc + t_dec) / BATCH:.2f} ms per image (batch "
              f"{BATCH}, host clock, medians of {GSM_REPS} runs); launches "
              f"{launches}, K=1 instances {k1}", flush=True)
        for name in ("rans_encode_gmm", "rans_decode_gmm"):
            enc = name.startswith("rans_encode")
            plain = (rans_kernels.encode_scan_gmm_plain if enc
                     else rans_kernels.decode_scan_gmm_plain)
            for args, kwargs in calls[name]:
                k = args[1 if enc else 2].shape[1]
                require(k == 1, f"{tag}: {name} at K={k}")
                got, ref = originals[name](*args, **kwargs), plain(*args,
                                                                   **kwargs)
                same = (all(torch.equal(a, b) for a, b in zip(got, ref))
                        if isinstance(got, tuple) else torch.equal(got, ref))
                require(same, f"{tag}: {name} differs from its plain version")
        shapes = {}
        for args, kwargs in calls["conv2d_nhwc"]:
            key = call_key(args, kwargs)
            if key not in shapes:
                got = originals["conv2d_nhwc"](*args, **kwargs)
                ref = conv_kernel.conv2d_nhwc_plain(*args, **kwargs)
                require(torch.equal(got, ref), f"{tag}: conv {key[0]} kernel "
                        f"!= plain, max|d| {float((got - ref).abs().max())}")
                shapes[key] = (args[1].shape[2], args[1].shape[3])
                if not kt:  # B3's data: each shape's ms beside F.conv2d's
                    conv_shape_times(originals["conv2d_nhwc"], args, kwargs)
        chans = sorted(set(shapes.values()))
        n = GSM_N  # 512 -> 426 -> 341 -> 256 at N=128
        require({(4 * n, 10 * n // 3), (10 * n // 3, 8 * n // 3),
                 (8 * n // 3, 2 * n)} <= set(chans),
                f"{tag}: the entropy parameters' convs not among {chans}")
        print(f"  {tag}: every GMM coder call (4, K=1) and each of the "
              f"{len(shapes)} distinct rows-chain conv shapes equal to plain "
              f"bit for bit; (C_in, C_out) {chans}", flush=True)
        if kt:
            errs = {}
            for args, kwargs in calls["conv2d_nhwc_bf16"]:
                key = call_key(args, kwargs)
                if key not in errs:
                    ok, err, _ = bf16_conv_ok(
                        originals["conv2d_nhwc_bf16"](*args, **kwargs),
                        conv_kernel.conv2d_nhwc_bf16_plain(*args, **kwargs))
                    require(ok, f"{tag}: bf16 conv beyond tolerance ({err})")
                    errs[key] = err
            print(f"  {tag}: {len(errs)} distinct bf16 conv shapes within "
                  f"tolerance of plain (max|d| {max(errs.values()):.3g})",
                  flush=True)
        launches.update({f"{n}_k1": v for n, v in k1.items()})
        for name in ("rans_encode_gmm", "rans_decode_gmm"):
            calls[f"{name}_k1"], calls[name] = calls[name], []
            launches[name] -= launches[f"{name}_k1"]
        runs[kt] = (data, launches, calls, words, bpp, psnr)
        del c
    (_, _, _, _, bpp, psnr), (_, _, _, _, k_bpp, k_psnr) = runs[False], \
        runs[True]
    require(abs(k_psnr - psnr) <= 0.05 and abs(k_bpp - bpp) <= 0.005 * bpp,
            f"GSM: kernel route bpp {k_bpp} PSNR {k_psnr}, default {bpp} "
            f"{psnr}")

    eval_bits_gap(model, x, runs[False][0], LANES, 3,
                  "GSM eval (two-pass) forward against the default route's "
                  "bytes")
    data, launches, calls, words = runs[False][:4]
    launches["conv2d_nhwc_bf16"] = runs[True][1]["conv2d_nhwc_bf16"]
    calls["conv2d_nhwc_bf16"] = runs[True][2]["conv2d_nhwc_bf16"]
    phase("gsm", "GSM codec on both routes, K=1 coder instances, forward")
    return launches, calls, words


def device_busy_ms(fn):
    """fn() under torch.profiler: (fn's result, ms the card was busy, the
    union of its kernels' and copies' intervals, the device events, and
    the three names that took the most device time, with their ms and
    counts). A trace that holds no device event lost them (seen after
    several profiler sessions in one process) and is taken again, up to
    three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if events:
            busy, end = 0.0, float("-inf")
            by_name = {}
            for e in sorted(events, key=lambda e: e.time_range.start):
                a, b = e.time_range.start, e.time_range.end
                if b > end:
                    busy += b - max(a, end)
                    end = b
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + (b - a) / 1e3, n + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
            return out, busy / 1e3, len(events), top
    raise RuntimeError("device_busy_ms: three traces without device events")


def reference_phase(dev, x1, model, record, originals, smi_line):
    """Reference-format coding (``model.compress``/``decompress``, the host
    coder csrc/rans.cpp built by ``ans/cext.py``) at full width on the first
    768x512 image: the flagship (N=192, K=4, the phase-4 model) in both of
    its modes (device rows; host math, FLASHGMM_HOST_MATH=1), ELIC
    (Elic2022GMM N=192, M=320, K=4, the synthetic weights) in device-rows
    mode, the single-Gaussian checkerboard (N=128, the synthetic weights)
    on its scale table. For each: the launches of one compress + decompress
    counted from 0 (the f32 conv for every entropy-parameter conv, the
    softmax kernel a GMM pass, the boundary-rows kernel a GMM pass in
    device-rows mode, no rANS kernel: the chain is the host's), every
    softmax and boundary-rows call equal to its plain version bit for bit,
    decompress's y_hat equal to compress's, x_hat finite; bytes and PSNR
    beside the batched codec's on the same image; compress and decompress
    ms (host clock, medians of REF_REPS), the host coder's share of each
    and the card's busy ms (profiler), beside the reference's GPU + AVX2
    yardstick; and the port on the CPU, given the same weights, decoding
    the card's strings of a 64x64 image to the card's y_hat (the CPU's
    rows chain is the conv kernel's plain version, slow at 768x512).
    Returns (launches, recorded calls) of the flagship's device-rows run."""
    import copy
    import os
    import statistics

    import numpy as np
    import torch

    from flashgmm_tpu_torch.ans import cext
    from flashgmm_tpu_torch.ans.gaussian_cdf import (gmm_boundary_rows_plain,
                                                     gmm_softmax_plain)
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboard,
                                           Elic2022GMM)
    from flashgmm_tpu_torch.runtime import (FastCheckerboardGmmCodec,
                                            FastCheckerboardGsmCodec,
                                            FastElicGmmCodec)
    from flashgmm_tpu_torch.zoo import load_npz

    host_s = [0.0]  # seconds inside the host coder
    coder = ("encode_with_indexes", "decode_with_indexes", "encode_rows",
             "decode_rows", "encode_gmm_host", "decode_gmm_host")
    saved = {name: getattr(cext, name) for name in coder}

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                host_s[0] += time.perf_counter() - t0
        return run

    small = torch.from_numpy(textured_leaves(64, 64, seed=SEED0 + 1)[None])
    elic = Elic2022GMM(N=N, M=ELIC_M, K=K, seed=0, device=dev)
    load_npz(elic, ELIC_WEIGHTS)
    elic.update(update_quantiles=True)
    gsm = Cheng2020AnchorCheckerboard(N=GSM_N, seed=0, device=dev)
    load_npz(gsm, GSM_WEIGHTS)
    gsm.update(update_quantiles=True)
    cases = [  # (name, model, modes, f32 convs and GMM passes a direction,
               #  the batched codec)
        ("flagship", model, ("device rows", "host math"), 12, 2,
         FastCheckerboardGmmCodec(model, lanes=LANES,
                                  cap_divisor=CAP_DIVISOR)),
        ("ELIC", elic, ("device rows",), ELIC_ROWS_CONVS, 10,
         FastElicGmmCodec(elic, lanes=ELIC_LANES, cap_divisor=ELIC_CAP)),
        ("GSM", gsm, ("scale table",), GSM_ROWS_CONVS, 0,
         FastCheckerboardGsmCodec(gsm, lanes=LANES,
                                  cap_divisor=CAP_DIVISOR))]
    host_math = os.environ.get("FLASHGMM_HOST_MATH")
    for name in coder:
        setattr(cext, name, timed(saved[name]))
    try:
        result = None
        for tag0, m, modes, convs, passes, batched in cases:
            cpu_model = copy.deepcopy(m).cpu()
            b_data, _ = batched.encode_to_bytes(x1)
            del batched
            for mode in modes:
                tag = f"reference {tag0} ({mode})"
                os.environ["FLASHGMM_HOST_MATH"] = \
                    "1" if mode == "host math" else "0"

                def run(m=m):
                    torch.cuda.synchronize()
                    host_s[0] = 0.0
                    t0 = time.perf_counter()
                    out = m.compress(x1)
                    torch.cuda.synchronize()
                    t1, h1 = time.perf_counter(), host_s[0]
                    dec = m.decompress(out["strings"], out["shape"])
                    torch.cuda.synchronize()
                    return (out, dec["x_hat"], t1 - t0,
                            time.perf_counter() - t1, h1, host_s[0] - h1)

                run()  # warm-up
                (out, x_hat, *_), launches, calls = record(run)
                want = dict.fromkeys(launches, 0)
                want.update(conv2d_nhwc=2 * convs, gmm_softmax=2 * passes,
                            gmm_boundary_rows=2 * passes
                            if mode == "device rows" else 0)
                require(launches == want, f"{tag}: launches {launches}, not "
                        f"{want}")
                strings, shape = out["strings"], out["shape"]
                y_dec = m.latent_codec.decompress(strings, shape)["y_hat"]
                require(torch.equal(y_dec, out["y_hat"]),
                        f"{tag}: decompress's y_hat differs from compress's")
                require(tuple(x_hat.shape) == tuple(x1.shape)
                        and bool(torch.isfinite(x_hat).all()), f"{tag}: x_hat")
                for kname, plain in (("gmm_boundary_rows",
                                      gmm_boundary_rows_plain),
                                     ("gmm_softmax", gmm_softmax_plain)):
                    for args, kwargs in calls[kname]:  # bit for bit
                        got = originals[kname](*args, **kwargs).cpu().numpy()
                        ref = plain(*args, **kwargs).cpu().numpy()
                        require(np.array_equal(got.view(np.uint8),
                                               ref.view(np.uint8)),
                                f"{tag}: {kname} {tuple(args[0].shape)} "
                                "differs from its plain version")
                n_bytes = sum(len(s[0]) if isinstance(s, tuple) else
                              sum(map(len, s)) for s in strings)
                reps = [run()[2:] for _ in range(REF_REPS)]
                t_c, t_d, h_c, h_d = (statistics.median(r[i] for r in reps)
                                      for i in range(4))
                _, busy_c, n_c, top_c = device_busy_ms(
                    lambda m=m: m.compress(x1))
                _, busy_d, n_d, top_d = device_busy_ms(
                    lambda m=m: m.decompress(strings, shape))
                # the card's strings of a small image decoded on the CPU
                s_out = m.compress(small.to(dev))
                t0 = time.perf_counter()
                y_cpu = cpu_model.latent_codec.decompress(
                    s_out["strings"], s_out["shape"])["y_hat"]
                t_cpu = time.perf_counter() - t0
                require(torch.equal(y_cpu, s_out["y_hat"].cpu()),
                        f"{tag}: the port on the CPU decodes the card's "
                        "strings of a 64x64 image to another y_hat")
                print(f"  {tag}: y_hat {list(out['y_hat'].shape)} exact "
                      f"through {n_bytes} bytes (the batched codec: "
                      f"{len(b_data)}), PSNR {psnr_of(x_hat, x1):.4f} dB; "
                      f"compress {1e3 * t_c:.2f} ms (host coder "
                      f"{1e3 * h_c:.2f} ms, card busy {busy_c:.2f} ms), "
                      f"decompress {1e3 * t_d:.2f} ms (host coder "
                      f"{1e3 * h_d:.2f} ms, card busy {busy_d:.2f} ms); "
                      f"host clock, medians of {REF_REPS}, {smi_line}; the "
                      "reference's GPU + AVX2 yardstick ~55 + ~42 ms a Kodak "
                      f"image (BASELINE.md); launches {launches}; "
                      f"{len(calls['gmm_boundary_rows'])} boundary-rows and "
                      f"{len(calls['gmm_softmax'])} softmax calls equal to "
                      "plain bit for bit; the card's strings of a 64x64 "
                      f"image decoded on the CPU exactly ({t_cpu:.1f} s)",
                      flush=True)
                for what, n_ev, top in (("compress", n_c, top_c),
                                        ("decompress", n_d, top_d)):
                    print(f"  {tag} {what}: {n_ev} device events; most "
                          "device time: " + "; ".join(
                              f"{k[:90]} {ms:.2f} ms x{n}"
                              for k, (ms, n) in top), flush=True)
                if (tag0, mode) == ("flagship", "device rows"):
                    result = (launches, calls)
    finally:
        for name in coder:
            setattr(cext, name, saved[name])
        if host_math is None:
            os.environ.pop("FLASHGMM_HOST_MATH", None)
        else:
            os.environ["FLASHGMM_HOST_MATH"] = host_math
    phase("reference", "compress/decompress of the flagship (both modes), "
          "ELIC and the GSM model on the card; their strings decoded on the "
          "CPU")
    return result


def main() -> int:
    faulthandler.dump_traceback_later(1000, exit=True)
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--bytes-worker":
        if not torch.cuda.is_available():
            return 1
        bytes_worker(*sys.argv[2:5])
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    with torch.inference_mode():
        smoke()
    faulthandler.cancel_dump_traceback_later()
    return 0


def smoke():
    import numpy as np
    import torch

    from flashgmm_tpu_torch import _build
    from flashgmm_tpu_torch.ans import interleaved as il
    from flashgmm_tpu_torch.ans import rans_kernels, rows_kernel
    from flashgmm_tpu_torch.ans.gaussian_cdf import (
        get_approx_mode, gmm_boundary_rows_plain, gmm_guarded_bounds,
        gmm_guarded_bounds_plain, gmm_guarded_rows, gmm_guarded_rows_plain,
        gmm_softmax_plain)
    from flashgmm_tpu_torch.ops import conv_kernel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    phase("device", f"{kind} | {smi_line}")

    # 2. build ----------------------------------------------------------
    kernels = _build.load()
    for line in kernels.ptxas:
        if any(k in line for k in ("registers", "smem", "spill",
                                   "Compiling")):
            print("  " + line, flush=True)
    ops = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")
    sass = sass_counts(kernels.path, "conv2d_bf16", ops)
    require(len(sass) > 0, "the bf16 conv kernel is not in the library")
    spills = ptxas_spills(kernels.ptxas)
    for fn, count in sass.items():
        print(f"  {fn}: {count}, spills {spills.get(fn)}", flush=True)
        require(spills.get(fn) == (0, 0),
                f"{fn}: spills (stores, loads) {spills.get(fn)}, not (0, 0)")
        require("wgmma" in fn, f"{fn}: a bf16 conv kernel other than wgmma")
        require(count["HGMMA"] > 0, f"{fn}: no wgmma (HGMMA) instructions")
        require(count["UTMALDG"] > 0, f"{fn}: no TMA loads (UTMALDG)")
        require(count["HMMA"] == 0, f"{fn}: mma.sync (HMMA) instructions")
    enc_spills = {fn: c for fn, c in spills.items() if "rans_encode_kernel" in fn}
    print(f"  rans encoder instances: {len(enc_spills)}, spills (stores, loads) "
          f"{sorted(set(enc_spills.values()))}", flush=True)
    require(len(enc_spills) == 10, "not the 10 rans encoder instances "
            "(Bounds; GmmBounds in 3 modes at K=4, K=1 and runtime K)")
    k1_spills = {fn: c for fn, c in enc_spills.items()
                 if re.search(r"GmmBounds<\(int\)\d+, \(int\)1>|"
                              r"GmmBoundsILi\dELi1E", fn)}
    print(f"  rans encoder K=1 instances: {len(k1_spills)}, spills (stores, "
          f"loads) {sorted(set(k1_spills.values()))}", flush=True)
    require(len(k1_spills) == 3, f"not the 3 K=1 encoder instances among "
            f"{sorted(enc_spills)}")
    require(all(c == (0, 0) for c in enc_spills.values()),
            f"rans encoder spills: {enc_spills}")
    phase("build", f"nvcc {kernels.seconds:.2f} s -> {kernels.path.name}")

    # 3. each kernel against its plain version at the main path's shapes --
    rng = np.random.RandomState(0)
    n_y = BATCH * (H // 16) * (W // 32) * N  # symbols of one y pass
    lo, num_bins = -48, 97
    scales = torch.from_numpy(rng.uniform(0.11, 8.0, (n_y, K)).astype(np.float32)).to(dev)
    means = torch.from_numpy(rng.normal(0, 2, (n_y, K)).astype(np.float32)).to(dev)
    wts = rng.uniform(0.05, 1.0, (n_y, K)).astype(np.float32)
    wts = torch.from_numpy(wts / wts.sum(1, keepdims=True)).to(dev)
    mode = get_approx_mode()  # the codec's
    rows = gmm_guarded_rows(scales, means, wts, lo, num_bins, mode)
    rows_p = gmm_guarded_rows_plain(scales, means, wts, lo, num_bins, mode)
    torch.cuda.synchronize()
    n_diff = int((rows != rows_p).sum())
    print(f"  gmm rows N={n_y} K={K} L={num_bins + 1} mode {mode}: "
          f"{n_diff} of {rows.numel()} entries differ from plain", flush=True)
    require(n_diff == 0, "gmm rows: kernel differs from its plain version")
    values = torch.from_numpy(np.clip(np.round(rng.normal(0, 3, n_y)), -47, 47)
                              .astype(np.int64)).to(dev)
    start = rows.gather(1, (values - lo)[:, None])[:, 0]
    freq = rows.gather(1, (values - lo + 1)[:, None])[:, 0] - start
    start_b, freq_b = gmm_guarded_bounds(values, scales, means, wts, lo,
                                         num_bins, mode)
    start_p, freq_p = gmm_guarded_bounds_plain(values, scales, means, wts, lo,
                                               num_bins, mode)
    torch.cuda.synchronize()
    n_diff = int((start_b != start_p).sum() + (freq_b != freq_p).sum())
    n_gather = int((start_b != start).sum() + (freq_b != freq).sum())
    print(f"  gmm bounds N={n_y}: {n_diff} of {2 * n_y} values differ from "
          f"plain, {n_gather} from the rows' gather", flush=True)
    require(n_diff == 0, "gmm bounds: kernel differs from its plain version")
    require(n_gather == 0, "gmm bounds: kernel differs from the rows' gather")
    t_steps, _ = il.layout(n_y, LANES)
    active = il.active_mask(n_y, t_steps, LANES, dev)
    enc_args = (il.to_lanes(start, LANES), il.to_lanes(freq, LANES), active)
    st_k, wd_k, em_k = rans_kernels.encode_scan(*enc_args)
    st_p, wd_p, em_p = il.encode_scan(*enc_args)
    s_k, n_k = il.pack_words(wd_k, em_k)
    s_p, n_p = il.pack_words(wd_p, em_p)
    torch.cuda.synchronize()
    require(torch.equal(st_k, st_p), "rans encode: states differ")
    require(int(n_k) == int(n_p), "rans encode: n_words differ")
    require(torch.equal(s_k, s_p), "rans encode: streams differ")

    def gmm_encoder_agrees(w, md, pair=None):
        """The GMM encoder against its plain version (and against the pair
        it replaced, when given): states, n_words, packed stream."""
        got = rans_kernels.encode_scan_gmm(values, scales, means, wts, lo,
                                           num_bins, md, w)
        ref = rans_kernels.encode_scan_gmm_plain(values, scales, means, wts,
                                                 lo, num_bins, md, w)
        torch.cuda.synchronize()
        for tag, other in (("plain", ref), ("bounds kernel + encoder", pair)):
            if other is None:
                continue
            sg, ng = il.pack_words(*got[1:])
            so, no = il.pack_words(*other[1:])
            d = (int((got[0] != other[0]).sum()), abs(int(ng) - int(no)),
                 int((sg != so).sum()))
            print(f"  rans encode gmm T={got[1].shape[0]} W={w} n={n_y} mode "
                  f"{md}: against {tag}, (states, n_words, stream words) "
                  f"differing {d}", flush=True)
            require(d == (0, 0, 0), f"rans encode gmm W={w} mode {md}: "
                    f"differs from {tag}")
        return got

    for md in (0, 1, 2):
        gmm_encoder_agrees(LANES, md, (st_k, wd_k, em_k) if md == mode else None)

    def decoders_agree(w, states, stream, act, tag):
        """Both row sources of the cluster decoder against the plain
        decoder on the full rows; returns the plain symbols."""
        t, pad = il.layout(n_y, w)
        rows_l = torch.cat([rows, rows.new_zeros(pad, num_bins + 1)]
                           ).reshape(t, w, num_bins + 1)
        sym_p = il.decode_scan(states, stream, rows_l, act, lo)
        sym_r = rans_kernels.decode_scan(states, stream, rows_l, act, lo)
        sym_g = rans_kernels.decode_scan_gmm(states, stream, scales, means,
                                             wts, act, lo, num_bins, mode)
        torch.cuda.synchronize()
        d_r = int((sym_r != sym_p).sum())
        d_g = int((sym_g != sym_p).sum())
        print(f"  {tag} T={t} W={w} (a cluster of up to "
              f"{min(rans_kernels.MAX_CLUSTER, -(-w // 256))} CTAs): decoder "
              f"over rows {d_r}, over GMM rows on demand {d_g} of "
              f"{sym_p.numel()} symbols differ from plain", flush=True)
        require(d_r == 0, f"rans decode W={w}: symbols differ from plain")
        require(d_g == 0, f"rans decode gmm W={w}: symbols differ from plain")
        require(torch.equal(il.from_lanes(sym_p, n_y).long(), values),
                f"rans decode W={w}: symbols differ from the encoded values")

    decoders_agree(LANES, st_k, s_k, active, "rans encode bit-exact; decode")
    t_wide, _ = il.layout(n_y, W_WIDE)
    act_wide = il.active_mask(n_y, t_wide, W_WIDE, dev)
    st_w, wd_w, em_w = rans_kernels.encode_scan(
        il.to_lanes(start_b, W_WIDE), il.to_lanes(freq_b, W_WIDE), act_wide)
    gmm_encoder_agrees(W_WIDE, mode, (st_w, wd_w, em_w))
    s_w, _ = il.pack_words(wd_w, em_w)
    decoders_agree(W_WIDE, st_w, s_w, act_wide, "one wide pass")

    conv_shapes = [  # (batch, h, w, c_in, c_out, k, leaky): the rows chain
        (BATCH, 12, 8, N, N, 3, True), (BATCH, 12, 8, N, 4 * N, 3, False),
        (BATCH, 24, 16, N, 3 * N // 2, 3, True),
        (BATCH, 24, 16, 3 * N // 2, 6 * N, 3, False),
        (BATCH, 48, 32, 3 * N // 2, 2 * N, 3, False),
        (BATCH, 48, 32, N, 2 * N, 5, False),
        (BATCH, 48, 16, 4 * N, 10 * N // 3, 1, True),
        (BATCH, 48, 16, 10 * N // 3, 10 * N // 3, 1, True),
        (BATCH, 48, 16, 10 * N // 3, 3 * K * N, 1, False),
    ]
    for i, (b, h, w, ci, co, k, leaky) in enumerate(conv_shapes):
        x = torch.randn(b, h, w, ci, device=dev)
        wt = torch.randn(k, k, ci, co, device=dev) * 0.05
        bias = torch.randn(co, device=dev)
        res = torch.randn(b, h, w, co, device=dev) if i == 0 else None
        slope = 0.01 if leaky else None
        y_k = conv_kernel.conv2d_nhwc(x, wt, bias, negative_slope=slope,
                                      residual=res)
        y_p = conv_kernel.conv2d_nhwc_plain(x, wt, bias, negative_slope=slope,
                                            residual=res)
        y_1 = conv_kernel.conv2d_nhwc(x[1:2], wt, bias, negative_slope=slope,
                                      residual=None if res is None else res[1:2])
        y_again = conv_kernel.conv2d_nhwc(x, wt, bias, negative_slope=slope,
                                          residual=res)
        torch.cuda.synchronize()
        require(torch.equal(y_k, y_p),
                f"conv {b}x{h}x{w} {ci}->{co} k{k}: kernel != plain, max|d| "
                f"{float((y_k - y_p).abs().max())}")
        require(torch.equal(y_1, y_k[1:2]), "conv: image alone != in batch")
        require(torch.equal(y_again, y_k), "conv: two calls differ")
    print(f"  conv: {len(conv_shapes)} rows-chain shapes, kernel == plain bit "
          "for bit, bitwise batch-invariant and repeatable", flush=True)

    # the bf16 conv at the shapes g_a, h_a and g_s route to it (768x512
    # images, N=192): (h, w, c_out, epilogues as (slope, residual)); each
    # routed shape also timed beside F.conv2d (cuDNN) on the same inputs
    plain_only, leaky, leaky_res = (None, False), (0.01, False), (0.01, True)
    bf16_shapes = [
        (H // 2, W // 2, N, (plain_only, leaky, leaky_res)),  # g_a, g_s
        (H // 4, W // 4, N, (plain_only, leaky, leaky_res)),
        (H // 8, W // 8, N, (plain_only, leaky, leaky_res)),
        (H // 16, W // 16, N, (leaky, leaky_res)),  # h_a, g_s
        (H // 32, W // 32, N, (leaky,)),  # h_a
        (H // 16, W // 16, 8 * N, (plain_only,)),  # g_s's fused subpel convs
        (H // 8, W // 8, 8 * N, (plain_only,)),
        (H // 4, W // 4, 8 * N, (plain_only,)),
        (37, 23, N, (leaky_res,)),  # edge tiles in M and a ragged image
    ]
    n_bf16 = 0
    for h, w, co, variants in bf16_shapes:
        x = torch.randn(BATCH, h, w, N, device=dev).bfloat16()
        wt = (torch.randn(3, 3, N, co, device=dev) * 0.03).bfloat16()
        bias = torch.randn(co, device=dev) * 0.1
        res = torch.randn(BATCH, h, w, co, device=dev).bfloat16()
        outs = [(torch.bfloat16, slope, r) for slope, r in variants]
        if h == H // 16 and co == N:
            outs.append((torch.float32, 0.01, True))  # f32 out
        for out_dtype, slope, with_res in outs:
            kw = dict(negative_slope=slope, residual=res if with_res else None,
                      out_dtype=out_dtype)
            got = conv_kernel.conv2d_nhwc_bf16(x, wt, bias, **kw)
            ref = conv_kernel.conv2d_nhwc_bf16_plain(x, wt, bias, **kw)
            torch.cuda.synchronize()
            ok, err, share = bf16_conv_ok(got, ref)
            tag = (f"bf16 conv {BATCH}x{h}x{w} {N}->{co} slope {slope} "
                   f"residual {with_res} out {str(out_dtype)[6:]}")
            print(f"  {tag}: max|d| {err:.3g}, {100 * share:.3f} % differ",
                  flush=True)
            require(ok, f"{tag}: kernel differs from plain beyond tolerance")
            n_bf16 += 1
        if (h, w) != (37, 23):
            packed = conv_kernel.pack_bf16_weight(wt)
            flops = 2 * BATCH * h * w * 9 * N * co
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last, as cuDNN likes
            w_cl = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b16 = bias.bfloat16()
            t_k = cuda_ms(lambda: conv_kernel.conv2d_nhwc_bf16(x, packed,
                                                               bias), 20)
            t_l = cuda_ms(lambda: torch.nn.functional.conv2d(
                x_nchw, w_cl, b16, padding=1), 20)
            print(f"  bf16 conv {BATCH}x{h}x{w} {N}->{co}: kernel {t_k:.4f} "
                  f"ms ({flops / t_k / 1e9:.1f} TFLOP/s), F.conv2d {t_l:.4f} "
                  f"ms ({flops / t_l / 1e9:.1f} TFLOP/s)", flush=True)
    # once in each shape class the wrapper takes: (n, h, w, c_in, c_out, k,
    # slope, residual type, output type)
    bf16, f32 = torch.bfloat16, torch.float32
    edge_cases = [
        (1, 37, 23, 72, 136, 3, 0.01, bf16, bf16),  # N = 1, ragged, C % 64
        (BATCH, 24, 40, N, N, 1, 0.01, None, bf16),  # K = 1
        (BATCH, 21, 35, 64, 200, 5, None, f32, bf16),  # K = 5
        (1, 9, 17, 8, 64, 7, 0.2, bf16, f32),  # K = 7, C_in = 8
        (BATCH, 13, 11, 64, 136, 5, 0.2, f32, f32),
    ]
    for n, h, w, ci, co, k, slope, res_t, out_dtype in edge_cases:
        x = torch.randn(n, h, w, ci, device=dev).bfloat16()
        wt = (torch.randn(k, k, ci, co, device=dev) * 0.05).bfloat16()
        kw = dict(negative_slope=slope, out_dtype=out_dtype,
                  residual=None if res_t is None else torch.randn(
                      n, h, w, co, device=dev).to(res_t))
        bias = torch.randn(co, device=dev) * 0.1
        got = conv_kernel.conv2d_nhwc_bf16(x, wt, bias, **kw)
        ref = conv_kernel.conv2d_nhwc_bf16_plain(x, wt, bias, **kw)
        torch.cuda.synchronize()
        ok, err, share = bf16_conv_ok(got, ref)
        tag = (f"bf16 conv {n}x{h}x{w} {ci}->{co} k{k} slope {slope} "
               f"residual {res_t} out {out_dtype}")
        print(f"  {tag}: max|d| {err:.3g}, {100 * share:.3f} % differ",
              flush=True)
        require(ok, f"{tag}: kernel differs from plain beyond tolerance")
        n_bf16 += 1
    print(f"  bf16 conv: {n_bf16} cases within tolerance of plain", flush=True)
    phase("kernels")

    # 4. the codec --------------------------------------------------------
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec
    from flashgmm_tpu_torch.zoo import load_npz

    model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0, device=dev)
    if WEIGHTS.exists():
        n_loaded = load_npz(model, WEIGHTS)
        print(f"  weights: {WEIGHTS.name}, {n_loaded} tensors", flush=True)
    else:
        print(f"  weights: {WEIGHTS.name} absent, random weights from seed 0",
              flush=True)
    model.update(update_quantiles=True)
    codec = FastCheckerboardGmmCodec(model, lanes=LANES,
                                     cap_divisor=CAP_DIVISOR)
    imgs = np.stack([textured_leaves(H, W, seed=SEED0 + 1 + i)
                     for i in range(BATCH)])
    x = torch.from_numpy(imgs).to(dev)
    phase("model", f"N={N} K={K}, update(update_quantiles=True), "
          f"{BATCH} images {H}x{W}")

    # Drive the main path once with every kernel wrapper wrapped in a
    # recorder that keeps its inputs for the timing phase. The wrappers'
    # bodies count on the name their module binds, so during this run the
    # counts land on the recorders, which start at 0.
    bound = {"rans_encode": (rans_kernels, "encode_scan"),
             "rans_encode_gmm": (rans_kernels, "encode_scan_gmm"),
             "rans_decode": (rans_kernels, "decode_scan"),
             "rans_decode_gmm": (rans_kernels, "decode_scan_gmm"),
             "gmm_bounds": (rows_kernel, "gmm_bounds"),
             "gmm_rows": (rows_kernel, "gmm_rows"),
             "gmm_softmax": (rows_kernel, "gmm_softmax"),
             "gmm_boundary_rows": (rows_kernel, "gmm_boundary_rows"),
             "conv2d_nhwc": (conv_kernel, "conv2d_nhwc"),
             "conv2d_nhwc_bf16": (conv_kernel, "conv2d_nhwc_bf16")}
    originals = {name: getattr(*where) for name, where in bound.items()}

    def record(run):
        """run() with every kernel wrapper wrapped in a recorder that keeps
        its inputs, every launch counted from 0: (run's result, launches,
        recorded calls)."""
        calls = {name: [] for name in bound}

        def recorder(name):
            fn = originals[name]

            def wrapped(*args, **kwargs):
                # err=None is the decoders' default, which the plain
                # versions do not take
                kept = {k: v for k, v in kwargs.items()
                        if not (k == "err" and v is None)}
                calls[name].append((args, kept))
                return fn(*args, **kwargs)
            wrapped.launches = 0
            wrapped.launches_k1 = 0
            return wrapped

        for name, (module, attr) in bound.items():
            setattr(module, attr, recorder(name))
        try:
            result = run()
            launches = {name: getattr(*where).launches
                        for name, where in bound.items()}
            record.k1 = {name: getattr(*bound[name]).launches_k1
                         for name in K1_INSTANCES}
        finally:
            for name, (module, attr) in bound.items():
                setattr(module, attr, originals[name])
        return result, launches, calls

    def drive(c):
        """One encode_to_bytes + decode_bytes of the batch through codec c
        (after a warm-up for the library's autotuning), every launch
        counted from 0: (bytes, encoder output, decoded images, launches,
        recorded calls, encode s, decode s)."""
        data, out = c.encode_to_bytes(x)
        c.decode_bytes(data, tuple(out["y_hat"].shape))

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data, out = c.encode_to_bytes(x)
            t1 = time.perf_counter()
            x_hat = c.decode_bytes(data, tuple(out["y_hat"].shape))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return data, out, x_hat, t1 - t0, t2 - t1

        (data, out, x_hat, t_enc, t_dec), launches, calls = record(run)
        return data, out, x_hat, launches, calls, t_enc, t_dec

    def check_run(c, data, out, x_hat, tag):
        """y_hat exact through the bytes, finite pixels that are g_s of
        y_hat; returns (bpp, PSNR)."""
        y_shape = tuple(out["y_hat"].shape)
        y_dec = c.decode_y_hat(c.from_bytes(data, y_shape), y_shape)
        require(torch.equal(y_dec, out["y_hat"]),
                f"{tag}: y_hat differs after the bytes")
        require(tuple(x_hat.shape) == (BATCH, H, W, 3),
                f"{tag}: x_hat {tuple(x_hat.shape)}")
        require(bool(torch.isfinite(x_hat).all()), f"{tag}: x_hat not finite")
        x_ref = torch.clamp(c._transform(c._g_s, out["y_hat"]), 0, 1)
        gs_err = float((x_hat - x_ref).abs().max())
        require(gs_err < 1e-2, f"{tag}: decoded pixels vs g_s(y_hat): {gs_err}")
        mse = ((x_hat - x) ** 2).mean(dim=(1, 2, 3)).double().cpu().numpy()
        psnr = float(np.mean(-10 * np.log10(np.maximum(mse, 1e-12))))
        return len(data) * 8 / (BATCH * H * W), psnr

    data, out, x_hat, launches, calls, t_enc, t_dec = drive(codec)
    y_shape = tuple(out["y_hat"].shape)
    for name, count in launches.items():
        if name not in ("gmm_rows", "gmm_bounds", "gmm_boundary_rows",
                        "conv2d_nhwc_bf16"):
            require(count > 0, f"{name} was not launched on the main path")
    # per encode: the z pass over its tables, 2 y passes over their GMM
    # parameters (bounds evaluated in the encoder); per decode: the z pass
    # over its tables, 2 y passes over the GMM rows
    require(launches["gmm_rows"] == 0, "the main path built full GMM rows")
    require((launches["gmm_softmax"], launches["gmm_boundary_rows"]) == (4, 0),
            "not one softmax a y pass of each direction and no boundary rows")
    require(launches["conv2d_nhwc_bf16"] == 0,
            "the default route launched the bf16 conv kernel")
    require((launches["rans_encode"], launches["rans_encode_gmm"],
             launches["gmm_bounds"]) == (1, 2, 0),
            "encode: not 1 z-pass encode, 2 GMM encodes and no bounds kernel")
    require(launches["rans_decode_gmm"] == 2 * launches["rans_decode"],
            "decode: the y passes did not go through the GMM decoder")
    bpp, psnr = check_run(codec, data, out, x_hat, "default route")
    y_dec = out["y_hat"]  # equal to the decoded y_hat (check_run)
    # the packed single-transfer decode_bytes against the unpacked path,
    # one host-to-device copy; an overflow file takes the unpacked path
    unpacked = codec.from_bytes(data, y_shape)
    host, caps = codec.pack(data, y_shape)
    y_packed = codec.decode_y_hat(codec.unpack(codec.copy_staged(host), caps),
                                  y_shape)
    require(torch.equal(y_packed, y_dec), "packed: y_hat differs")
    x_packed, n_h2d = h2d_copies(lambda: codec.decode_bytes(data, y_shape))
    require(torch.equal(x_packed, codec.decode(unpacked, y_shape))
            and torch.equal(x_packed, x_hat),
            "packed decode_bytes: x_hat differs from decode(from_bytes)")
    require(n_h2d == 1, f"packed decode_bytes: {n_h2d} host-to-device copies")
    tight = FastCheckerboardGmmCodec(model, lanes=LANES, cap_divisor=64)
    o_out = tight.encode(x, full=True)
    o_data = tight.to_bytes(o_out)
    o_caps = tight.pack(o_data, y_shape)[1]
    require(o_caps != (tight.stream_capacities(y_shape)[0],) + (
        tight.stream_capacities(y_shape)[1],) * 2, "not an overflow file")
    o_unp = tight.from_bytes(o_data, y_shape)
    require(torch.equal(tight.decode_y_hat(o_unp, y_shape), o_out["y_hat"])
            and torch.equal(tight.decode_bytes(o_data, y_shape),
                            tight.decode(o_unp, y_shape)),
            "overflow file: decode_bytes is not exact")
    print(f"  packed decode_bytes: y_hat and x_hat equal to decode(from_bytes) "
          f"bit for bit, {n_h2d} host-to-device copy; an overflow file "
          f"({len(o_data)} bytes, cap_divisor=64, stream lengths {o_caps}) "
          "decodes exactly", flush=True)
    print(f"  y_hat {list(y_shape)} exact through {len(data)} bytes; "
          f"bpp {bpp:.7f}, PSNR {psnr:.4f} dB; encode {1e3 * t_enc:.1f} ms, "
          f"decode {1e3 * t_dec:.1f} ms (batch {BATCH}, host clock)",
          flush=True)
    print(f"  launches in one encode + decode: {launches}", flush=True)
    if WEIGHTS.exists():
        require(len(data) == DEFAULT_BYTES,
                f"default route: {len(data)} bytes, not {DEFAULT_BYTES}")
        require(abs(psnr - DEFAULT_PSNR) < 1e-4,
                f"default route: PSNR {psnr} moved from {DEFAULT_PSNR}")

    # the transforms through the bf16 conv kernel (kernel_transforms=True)
    kcodec = FastCheckerboardGmmCodec(model, lanes=LANES,
                                      cap_divisor=CAP_DIVISOR,
                                      kernel_transforms=True)
    k_data, k_out, k_x_hat, k_launches, k_calls, k_enc, k_dec = drive(kcodec)
    k_bpp, k_psnr = check_run(kcodec, k_data, k_out, k_x_hat,
                              "kernel_transforms route")
    print(f"  kernel_transforms: y_hat exact through {len(k_data)} bytes; "
          f"bpp {k_bpp:.7f}, PSNR {k_psnr:.4f} dB; encode {1e3 * k_enc:.1f} "
          f"ms, decode {1e3 * k_dec:.1f} ms", flush=True)
    print(f"  launches in one encode + decode: {k_launches}", flush=True)
    require(k_launches["conv2d_nhwc_bf16"] == 26,
            f"kernel_transforms: {k_launches['conv2d_nhwc_bf16']} bf16 conv "
            "launches, not the 26 of g_a (9), h_a (3) and g_s (14)")
    for name, count in k_launches.items():
        if name != "conv2d_nhwc_bf16":
            require(count == launches[name],
                    f"kernel_transforms: {name} launched {count} times, "
                    f"the default route {launches[name]}")
    bf16_errs = []
    for args, kwargs in k_calls["conv2d_nhwc_bf16"]:
        got = originals["conv2d_nhwc_bf16"](*args, **kwargs)
        ref = conv_kernel.conv2d_nhwc_bf16_plain(*args, **kwargs)
        ok, err, share = bf16_conv_ok(got, ref)
        require(ok, f"bf16 conv on the path {tuple(args[0].shape)} -> "
                f"{tuple(got.shape)}: beyond tolerance (max|d| {err})")
        bf16_errs.append((err, share))
    print(f"  every one of the {len(bf16_errs)} bf16 conv calls within "
          f"tolerance of plain; max|d| {max(e for e, _ in bf16_errs):.3g}, "
          f"at most {100 * max(s_ for _, s_ in bf16_errs):.3f} % of outputs "
          "differ", flush=True)
    require(abs(k_psnr - psnr) <= 0.05,
            f"kernel_transforms PSNR {k_psnr} vs default {psnr}")
    require(abs(k_bpp - bpp) <= 0.005 * bpp,
            f"kernel_transforms bpp {k_bpp} vs default {bpp}")
    launches["conv2d_nhwc_bf16"] = k_launches["conv2d_nhwc_bf16"]
    calls["conv2d_nhwc_bf16"] = k_calls["conv2d_nhwc_bf16"]
    phase("codec")

    # 5. the full-rows path: same bytes, same y_hat ------------------------
    lo_c, bins_c = codec._lo_bins()
    with_rows = {}  # pass -> (params, rows)

    def rows_path(x_in, full):
        """codec.encode with the y passes' (start, freq) gathered from the
        full rows instead of the bounds kernel."""
        cd = 1 if full else codec.cap_divisor
        y = codec._transform(codec._g_a, x_in)
        z = codec._transform(codec._h_a, y)
        z_bin = torch.round(z - codec._med).to(torch.int32) - codec._z_off
        z_bin = torch.minimum(torch.clamp_min(z_bin, 0), codec._z_maxbin)
        sym = torch.clamp(torch.round(codec._ckbd.unembed(y)).to(torch.int32),
                          -codec.max_abs, codec.max_abs)
        side = codec._side(z_bin)
        enc = {}
        for name, params, s_pass in (
                ("y0", codec._params0(side[0]), sym[0]),
                ("y1", codec._params1(side[1], sym[0]), sym[1])):
            rows_p = gmm_guarded_rows(*params, lo_c, bins_c, codec.mode)
            j = (s_pass.reshape(-1).long() - lo_c)[:, None]
            st = rows_p.gather(1, j)[:, 0]
            enc[name] = fast_codec._encode_pass(
                st, rows_p.gather(1, j + 1)[:, 0] - st, codec.lanes, cd)
            with_rows[name] = (params, rows_p)
        return enc

    from flashgmm_tpu_torch.runtime import fast_codec

    try:
        data_rows = codec.to_bytes({"z": out["z"], **rows_path(x, False)})
    except fast_codec.StreamOverflow:
        data_rows = codec.to_bytes({"z": out["z"], **rows_path(x, True)})
    require(data_rows == data, "full-rows path bytes differ from the codec's")
    streams = codec.from_bytes(data, y_shape)
    n_pass = out["y_hat"].numel() // 2  # symbols of one y pass
    syms = [fast_codec._decode_pass(streams[name], with_rows[name][1], n_pass,
                                    lo_c, codec.lanes) for name in ("y0", "y1")]
    b_, h_, w_, c_ = y_shape
    y_rows = codec._ckbd.embed(torch.stack(
        [s_.reshape(b_, h_, w_ // 2, c_) for s_ in syms]).float())
    require(torch.equal(y_rows, y_dec), "full-rows decoder y_hat differs")
    print(f"  full-rows path: the same {len(data_rows)} bytes; its decoder "
          "gives the same y_hat", flush=True)
    phase("paths")

    # 6. the single-image latency codec: one CUDA graph a direction -------
    from flashgmm_tpu_torch.runtime import FastLatencyGmmCodec

    x1 = x[:1].contiguous()  # seed SEED0 + 1, bench.py's first image
    wrapper_name = {attr: name for name, (_, attr) in bound.items()}
    # each direction's launches of each kernel: (default route, kernel route)
    expected = {"encode": {"rans_encode": 1, "rans_encode_gmm": 2,
                           "gmm_softmax": 2, "conv2d_nhwc": 12,
                           "conv2d_nhwc_bf16": (0, 12)},
                "decode_y": {"rans_decode": 1, "rans_decode_gmm": 2,
                             "gmm_softmax": 2, "conv2d_nhwc": 12},
                "g_s": {"conv2d_nhwc_bf16": (0, 14)}}
    lanes_codec = FastCheckerboardGmmCodec(model, lanes=LAT_LANES,
                                           cap_divisor=CAP_DIVISOR)
    lat_runs = {}
    lat_bytes = {}  # route -> the certified bytes of the first image
    for route in (False, True):
        tag = "kernel_transforms" if route else "default"
        lat = FastLatencyGmmCodec(model, lanes=LAT_LANES,
                                  cap_divisor=CAP_DIVISOR,
                                  kernel_transforms=route)
        fallbacks = []
        encode_fallback = lat._encode_fallback

        def counted(*args, _fallback=encode_fallback):
            fallbacks.append(1)
            return _fallback(*args)
        lat._encode_fallback = counted

        def first(lat=lat):
            """The first encode_certified + decode: each direction's eager
            warm-up, its capture and its replays."""
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                t0 = time.perf_counter()
                data, y_shape = lat.encode_certified(x1)
                x_hat = lat.decode(data, y_shape)
                torch.cuda.synchronize()
            return data, y_shape, x_hat, time.perf_counter() - t0

        (l_data, l_shape, l_xhat, t_build), l_launches, _ = record(first)
        n_lat_passes = len(lat._batched._pass_caps(l_shape))
        require(not fallbacks and not lat._fallback_digests,
                f"latency {tag}: certification fell back on the graph path")
        graphs = {d: g for (d, _), g in lat._graphs.items()}
        require(len(lat._graphs) == 3 and sorted(graphs) == [
            "decode_y", "encode", "g_s"], f"latency {tag}: graphs "
            f"{list(lat._graphs)}, not one each for encode, decode-y, g_s")
        g_launches = {d: {wrapper_name[k]: v for k, v in g.launches.items()}
                      for d, g in graphs.items()}
        for d, counts in g_launches.items():
            for name, count in counts.items():
                want = expected[d].get(name, 0)
                want = want[route] if isinstance(want, tuple) else want
                require(count == want, f"latency {tag}: the {d} graph "
                        f"launches {name} {count} times, not {want}")
        for name, count in l_launches.items():
            if sum(g_launches[d].get(name, 0) for d in g_launches):
                require(count > 0, f"latency {tag}: {name} not launched")

        def eager(lat=lat, y_shape=l_shape):
            """The same functions without graphs: the batched codec's
            encode_to_bytes and decode_bytes at the latency codec's
            settings."""
            data, out = lat._batched.encode_to_bytes(x1)
            x_hat = lat._batched.decode_bytes(data, y_shape)
            torch.cuda.synchronize()
            return data, out, x_hat

        (e_data, e_out, e_xhat), e_launches, e_calls = record(eager)
        require(e_data == l_data, f"latency {tag}: graph bytes differ from "
                "the eager run's")
        for name, count in e_launches.items():
            require(count == sum(g_launches[d].get(name, 0)
                                 for d in g_launches),
                    f"latency {tag}: the eager run launches {name} {count} "
                    "times, the graphs another number")
        y_graph = lat._decode_y(lat._passes(lat.from_bytes(l_data, l_shape)),
                                l_shape).clone()
        require(int(lat._err) == 0, f"latency {tag}: decoder error flag set")
        require(torch.equal(y_graph, e_out["y_hat"]),
                f"latency {tag}: y_hat not exact through the bytes")
        y_lanes = lanes_codec.decode_y_hat(
            lanes_codec.from_bytes(l_data, l_shape), l_shape)
        require(torch.equal(y_lanes, e_out["y_hat"]), f"latency {tag}: the "
                f"batched codec at lanes={LAT_LANES} decodes another y_hat")
        gs_diff = float((l_xhat - e_xhat).abs().max())
        require(tuple(l_xhat.shape) == (1, H, W, 3)
                and bool(torch.isfinite(l_xhat).all()) and gs_diff < 1e-2,
                f"latency {tag}: x_hat {tuple(l_xhat.shape)}, graph against "
                f"eager g_s max|d| {gs_diff}")
        mse = float(((l_xhat - x1) ** 2).mean())
        l_psnr = -10 * np.log10(max(mse, 1e-12))
        l_bpp = len(l_data) * 8 / (H * W)

        # a forced certification failure takes the fallback, whose bytes
        # decode (the failure is forced in both comparisons: the digest)
        lat._cmp = lambda a, b: torch.zeros((), dtype=torch.bool,
                                            device=a.device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            f_data, f_shape = lat.encode_certified(x1)
        del lat._cmp
        require(len(fallbacks) == 1 and lat._fallback_digests and any(
            issubclass(w_.category, RuntimeWarning) for w_ in caught),
            f"latency {tag}: a forced failure did not take the fallback")
        require(torch.equal(lat.decode(f_data, f_shape),
                            lat._batched.decode_bytes(f_data, f_shape)),
                f"latency {tag}: the fallback's bytes do not decode")
        lat._fallback_digests.clear()
        # a truncated stream raises after the decode-y replay (the flag)
        try:
            lat.decode(truncate_pass(l_data, LAT_LANES, 1, n_lat_passes),
                       l_shape)
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        require("past its end" in raised,
                f"latency {tag}: a truncated stream did not raise ({raised})")
        torch.cuda.synchronize()
        require(torch.equal(lat.decode(l_data, l_shape), l_xhat),
                f"latency {tag}: decode differs after the truncated stream")

        # decode reads the packed layout: one host-to-device copy, the
        # same y_hat and x_hat as the unpacked streams through the graphs
        x_pk, n_h2d = h2d_copies(lambda: lat.decode(l_data, l_shape))
        y_unp = lat._decode_y(lat._passes(lat.from_bytes(l_data, l_shape)),
                              l_shape).clone()
        require(torch.equal(y_unp, e_out["y_hat"])
                and torch.equal(x_pk, lat._gs(y_unp)),
                f"latency {tag}: packed decode differs from the unpacked")
        require(n_h2d == 1, f"latency {tag}: decode made {n_h2d} "
                "host-to-device copies, not 1")
        if not route:  # an overflow file decodes through a graph of its own
            lat_o = FastLatencyGmmCodec(model, lanes=LAT_LANES,
                                        cap_divisor=64)
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                o_data, o_shape = lat_o.encode_certified(x1)
            o_b = lat_o._batched
            o_host, o_caps = o_b.pack(o_data, o_shape)
            y_o = lat_o._decode_y_packed(o_host, o_shape, o_caps).clone()
            require(o_caps[1] > o_b.stream_capacities(o_shape)[1]
                    and torch.equal(y_o, o_b.decode_y_hat(
                        o_b.from_bytes(o_data, o_shape), o_shape)),
                    "latency: the overflow file's y_hat is not exact")
            o_diff = float((lat_o.decode(o_data, o_shape)
                            - o_b.decode_bytes(o_data, o_shape)).abs().max())
            # encode, decode-y at both layouts, g_s
            require(len(lat_o._graphs) == 4 and o_diff < 1e-2,
                    f"latency: the overflow file decodes to x_hat {o_diff} "
                    "from the batched codec's")
            del lat_o
        print(f"  latency {tag}: packed decode, {n_h2d} host-to-device copy, "
              "y_hat and x_hat equal to the unpacked streams'"
              + ("; an overflow file (cap_divisor=64) certifies and decodes "
                 "through its own decode-y graph" if not route else ""),
              flush=True)

        times = {"graph": latency_times(lat, x1, LAT_REPS)}
        lat._graphed = False  # the same functions, eagerly
        times["eager"] = latency_times(lat, x1, LAT_REPS)
        lat._graphed = True
        lat_runs[route] = (e_out, e_calls, g_launches)
        lat_bytes[route] = l_data
        print(f"  latency {tag}: y_hat {list(l_shape)} exact through "
              f"{len(l_data)} bytes (the eager run's, and the batched codec "
              f"at lanes={LAT_LANES} decodes them); bpp {l_bpp:.7f}, PSNR "
              f"{l_psnr:.4f} dB; graph and eager x_hat max|d| {gs_diff:.3g}; "
              f"forced failure: fallback taken, bytes decode; truncated y0 "
              f"raises; first call (warm-up, capture) {t_build:.2f} s",
              flush=True)
        print(f"  latency {tag}: kernel launches captured, each direction: "
              f"{g_launches}", flush=True)
        print(f"  latency {tag}: median ms of {LAT_REPS} runs (host clock, "
              f"CUDA events): {json.dumps(times)}", flush=True)
    phase("latency", f"batch 1, lanes={LAT_LANES}, both routes")

    # 7. bytes: batch 1 in fresh processes (ROADMAP C9) ---------------------
    import hashlib

    digests = {}
    for route in ("default", "kernel"):
        for setup in ("cold", "hog"):
            p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                                "--bytes-worker", route, setup, "1"],
                               capture_output=True, text=True, timeout=300)
            require(p.returncode == 0, f"bytes worker {route} {setup} failed:"
                    f" {p.stderr[-2000:]}")
            digests[(route, setup)] = json.loads(
                p.stdout.strip().splitlines()[-1])
        cold, hog = digests[(route, "cold")], digests[(route, "hog")]
        own = lat_bytes[route == "kernel"]
        print(f"  bytes {route} route, batch 1, lanes={LAT_LANES}: cold "
              f"process {cold['bytes']} bytes sha256 {cold['sha256'][:16]}, "
              f"flags set and card memory taken {hog['bytes']} bytes sha256 "
              f"{hog['sha256'][:16]}; this process {len(own)} bytes sha256 "
              f"{hashlib.sha256(own).hexdigest()[:16]}", flush=True)
        # this process's stages against the cold one's: the first that
        # differs, and the device kernels of g_a and h_a where they differ
        mine = stage_digests(FastCheckerboardGmmCodec(
            model, lanes=LAT_LANES, cap_divisor=CAP_DIVISOR,
            kernel_transforms=route == "kernel"), x1)
        first = next((k for k in cold["stages"]
                      if cold["stages"][k][0] != mine["stages"][k][0]), None)
        print(f"  bytes {route} route: every stage's digest here equal to "
              f"the cold process's: {first is None}", flush=True)
        if first is not None:  # both processes' kernel lists, for the record
            print(f"  first differing stage {first}: cold "
                  f"{cold['stages'][first]}, here {mine['stages'][first]}",
                  flush=True)
            out_dir = ROOT / "chiprun_out"
            out_dir.mkdir(exist_ok=True)
            (out_dir / f"c9_kernels_{route}.json").write_text(json.dumps(
                {"first_stage": first, "cold": cold["kernels"],
                 "this": mine["kernels"]}, indent=0))
        require(cold["sha256"] == hog["sha256"], f"bytes ({route} route): two "
                f"fresh processes give different batch-1 bytes "
                f"({cold['bytes']} and {hog['bytes']})")
        require(hashlib.sha256(own).hexdigest() == cold["sha256"],
                f"bytes ({route} route): this process's batch-1 bytes "
                f"({len(own)}) differ from a fresh process's")
    phase("bytes", "batch-1 bytes equal across fresh processes and this "
          "one, both routes")

    # 8. the training forward at full width ------------------------------
    forward_phase(dev, x1, lat_bytes[False], n_lat_passes)

    # 9. ELIC through both codecs ------------------------------------------
    elic_launches, elic_calls, elic_words = elic_phase(dev, x, record,
                                                       originals)

    # 10. the single-Gaussian checkerboard through its codec --------------
    gsm_launches, gsm_calls, gsm_words = gsm_phase(dev, x, record, originals)

    # 11. reference-format coding (model.compress/decompress) ------------
    ref_launches, ref_calls = reference_phase(dev, x1, model, record,
                                              originals, smi_line)

    # 12. timing of every recorded call -----------------------------------
    pass_words = [int(out[k].n_words) for k in ("z", "y0", "y1")]

    def probes_by_count(L):
        """Entries the bisection evaluates for each count 0..L-1 (the probe
        at L-1 is the guard 65536 and costs nothing)."""
        probes = []
        for c in range(L):
            a, b, n_eval = 0, L, 0
            while a < b:
                mid = (a + b) >> 1
                n_eval += mid != L - 1
                a, b = (mid + 1, b) if mid < c else (a, mid)
            probes.append(n_eval)
        return probes

    def stats(name, i, args, kwargs, words):
        """(bytes, flops, max|kernel - plain|, library call or None) of one
        recorded call, the i-th of its kernel in a run whose z, y0 and y1
        passes hold ``words`` stream words; bytes count each input read once
        and each output written once, at what this call's data needs."""
        if name == "rans_encode":
            starts, _, _ = args
            t, w = starts.shape
            got = originals[name](*args)
            ref = il.encode_scan(*args)
            pk, pp = il.pack_words(*got[1:]), il.pack_words(*ref[1:])
            err = max(int((got[0] - ref[0]).abs().max()),
                      int((pk[0] - pp[0]).abs().max()),
                      abs(int(pk[1]) - int(pp[1])))
            # starts, freqs (int32), active (1 B); states; words, emits
            return t * w * 9 + 4 * w + t * w * 5, 0, err, None
        if name == "rans_encode_gmm":
            vals, sc, _, _, _, _, md, w = args
            n, k = sc.shape
            t = -(-n // w)
            got = originals[name](*args)
            ref = rans_kernels.encode_scan_gmm_plain(*args)
            pk, pp = il.pack_words(*got[1:]), il.pack_words(*ref[1:])
            err = max(int((got[0] - ref[0]).abs().max()),
                      int((pk[0] - pp[0]).abs().max()),
                      abs(int(pk[1]) - int(pp[1])))
            # values (int32) and parameters in; states, words (int32) and
            # emits (1 B) out; two entries a symbol
            return (4 * n + 12 * n * k + 4 * w + t * w * 5,
                    2 * n * (k * ROWS_FLOPS_PER_TERM[md] + 2), err, None)
        if name == "gmm_rows":
            sc, _, _, _, nb, md = args
            n, k = sc.shape
            L = nb + 1
            err = int((originals[name](*args) - gmm_guarded_rows_plain(*args))
                      .abs().max())
            # rows out; scales, means, weights in; float32 operations of
            # each entry's K terms plus its quantization
            return (4 * n * L + 12 * n * k,
                    n * L * (k * ROWS_FLOPS_PER_TERM[md] + 2), err, None)
        if name == "gmm_boundary_rows":
            sc, _, _, _, nb, md = args
            n, k = sc.shape
            L = nb + 1
            got = originals[name](*args).cpu().numpy().astype(np.int64)
            err = int(np.abs(got - gmm_boundary_rows_plain(*args).cpu()
                             .numpy().astype(np.int64)).max())
            # uint16 rows out; scales, means, weights in; each entry's K
            # terms and its quantization
            return (2 * n * L + 12 * n * k,
                    n * L * (k * ROWS_FLOPS_PER_TERM[md] + 2), err, None)
        if name == "gmm_softmax":
            (logits,) = args
            err = float((originals[name](logits) - gmm_softmax_plain(logits))
                        .abs().max())
            # the logits read and the weights written, float32
            return (8 * logits.numel(),
                    SOFTMAX_FLOPS_PER_ENTRY * logits.numel(), err, None)
        if name == "gmm_bounds":
            vals, sc, _, _, _, _, md = args
            n, k = sc.shape
            got = originals[name](*args)
            ref = gmm_guarded_bounds_plain(*args)
            err = max(int((got[0] - ref[0]).abs().max()),
                      int((got[1] - ref[1]).abs().max()))
            # values (at the width given: int32 on the path) and parameters
            # in, start and freq (int32) out; two entries a symbol
            return ((vals.element_size() + 8) * n + 12 * n * k,
                    2 * n * (k * ROWS_FLOPS_PER_TERM[md] + 2), err, None)
        if name == "rans_decode":
            _, _, rws, act, _ = args
            t, w, _ = rws.shape
            err = int((originals[name](*args) - il.decode_scan(*args))
                      .abs().max())
            # states, the consumed words, the two row entries that bound each
            # active symbol's bin, active (1 B), symbols out (int32)
            return (4 * w + 4 * words[0] + 8 * int(act.sum())
                    + t * w * 5, 0, err, None)
        if name == "rans_decode_gmm":
            _, _, sc, _, _, act, lo_, nb, md = args
            t, w = act.shape
            n, k = sc.shape
            got = originals[name](*args)
            err = int((got - rans_kernels.decode_scan_gmm_plain(*args))
                      .abs().max())
            # entries evaluated: the bisection's probes for each symbol
            probes = torch.tensor(probes_by_count(nb + 1), device=dev)
            count = (il.from_lanes(got, n).long() - lo_ + 1).clamp(0, nb)
            n_eval = int(probes[count].sum())
            # states, the consumed words, each symbol's parameters, active
            # (1 B), symbols out (int32)
            return (4 * w + 4 * words[1 + i % (len(words) - 1)] + 12 * n * k
                    + t * w * 5, n_eval * (k * ROWS_FLOPS_PER_TERM[md] + 2),
                    err, None)
        xi, wi, bi = args
        res = kwargs.get("residual")
        if name == "conv2d_nhwc_bf16":
            got = originals[name](*args, **kwargs)
            ok, err, _ = bf16_conv_ok(
                got, conv_kernel.conv2d_nhwc_bf16_plain(*args, **kwargs))
            require(ok, "bf16 conv on the path: beyond tolerance")
            if isinstance(wi, conv_kernel.PackedBf16Weight):
                wi = wi.hwio()  # the routed convs' packed weights
            flops = 2 * xi.shape[0] * xi.shape[1] * xi.shape[2] * wi.numel()
            nbytes = (2 * (xi.numel() + wi.numel()) + got.numel()
                      * got.element_size() + (0 if bi is None else
                                              4 * bi.numel())
                      + (0 if res is None else res.numel()
                         * res.element_size()))
            x_nchw = xi.permute(0, 3, 1, 2)  # channels-last, as cuDNN likes
            w_oihw = wi.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b16 = None if bi is None else bi.to(torch.bfloat16)
            pad = wi.shape[0] // 2

            def library():
                return torch.nn.functional.conv2d(x_nchw, w_oihw, b16,
                                                  padding=pad)
            return nbytes, flops, err, library
        got = originals[name](*args, **kwargs)
        ref = conv_kernel.conv2d_nhwc_plain(*args, **kwargs)
        require(torch.equal(got, ref), "conv on the main path: kernel != plain")
        # masked taps and a transposed conv's inserted zeros are not work:
        # such a conv reads its input's values alone, each with every tap
        s = inserted_stride(xi)
        x_in = xi[:, ::s, ::s]
        flops = 2 * x_in.shape[0] * x_in.shape[1] * x_in.shape[2] * int(
            torch.count_nonzero(wi))
        nbytes = 4 * (x_in.numel() + wi.numel() + got.numel()
                      + (0 if bi is None else bi.numel())
                      + (0 if res is None else res.numel()))
        x_nchw = xi.permute(0, 3, 1, 2)
        w_oihw = wi.permute(3, 2, 0, 1).contiguous()
        pad = wi.shape[0] // 2

        def library():
            return torch.nn.functional.conv2d(x_nchw, w_oihw, bi, padding=pad)
        return nbytes, flops, 0.0, library

    def serial_floor(args):
        """The on-demand decoder's latency floor for one recorded call: the
        same T steps over the same parameters in a pass of 16 * 256 lanes
        with one active lane on each of the 16 CTAs of its cluster, so a
        step is one search, the scan and one cluster barrier, with nothing
        to wait behind (ms, CUDA events)."""
        _, _, sc, mu, wt, act, lo_, nb, md = args
        t, w = act.shape
        n = sc.shape[0]
        wide, one = 16 * 256, 256  # lanes of the pass, lanes a CTA
        idx = (torch.arange(t, device=dev)[:, None] * w
               + torch.arange(16, device=dev)[None, :]).reshape(-1).clamp(max=n - 1)
        sym = il.from_lanes(originals["rans_decode_gmm"](*args), n)[idx]
        sub = [p[idx] for p in (sc, mu, wt)]
        st, fq = gmm_guarded_bounds(sym, *sub, lo_, nb, md)
        act_f = torch.zeros((t, wide), dtype=torch.bool, device=dev)
        act_f[:, ::one] = True
        lanes = torch.nonzero(act_f.reshape(-1))[:, 0]  # step-major, as idx
        full = [torch.ones((t * wide, p.shape[1]), device=dev) for p in sub]
        st_f = torch.zeros(t * wide, dtype=torch.int32, device=dev)
        fq_f = torch.zeros(t * wide, dtype=torch.int32, device=dev)
        for dst, src in zip(full + [st_f, fq_f], sub + [st, fq]):
            dst[lanes] = src
        states_f, wd, em = rans_kernels.encode_scan(
            st_f.reshape(t, wide), fq_f.reshape(t, wide), act_f)
        stream_f, _ = il.pack_words(wd, em)

        def run():
            return originals["rans_decode_gmm"](states_f, stream_f, *full,
                                                act_f, lo_, nb, md)
        require(torch.equal(run().reshape(-1)[lanes].long(), sym.long()),
                "serial floor: the one-lane-per-CTA decode is wrong")
        return cuda_ms(run, 20)  # as many calls as the kernel is timed over

    def encoder_floor(args):
        """The GMM encoder's serial floor, device ms, for one recorded call:
        the same T steps over one lane (one CTA, one active lane)."""
        vals, sc, mu, wt, lo_, nb, md, w = args
        n = sc.shape[0]
        t = -(-n // w)
        idx = (torch.arange(t, device=dev) * w).clamp(max=n - 1)
        one = (vals[idx], sc[idx], mu[idx], wt[idx], lo_, nb, md, 1)
        got = originals["rans_encode_gmm"](*one)
        ref = rans_kernels.encode_scan_gmm_plain(*one)
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                "serial floor: the one-lane GMM encode differs from plain")
        return cuda_ms(lambda: originals["rans_encode_gmm"](*one), 20, True)

    plains = {"rans_encode": il.encode_scan, "rans_decode": il.decode_scan,
              "rans_encode_gmm": rans_kernels.encode_scan_gmm_plain,
              "rans_decode_gmm": rans_kernels.decode_scan_gmm_plain,
              "gmm_bounds": gmm_guarded_bounds_plain,
              "gmm_rows": gmm_guarded_rows_plain,
              "gmm_boundary_rows": gmm_boundary_rows_plain,
              "gmm_softmax": gmm_softmax_plain,
              "conv2d_nhwc": conv_kernel.conv2d_nhwc_plain,
              "conv2d_nhwc_bf16": conv_kernel.conv2d_nhwc_bf16_plain}
    sources = {
        "rans_encode": ("flashgmm_tpu_torch/csrc/rans_kernels.cu",
                        "flashgmm_tpu/ans/pallas_coder.py:207"),
        # the same TPU kernel, with the plain-XLA gmm_guarded_bounds
        # (flashgmm_tpu/ans/gaussian_cdf.py:150) inside it
        "rans_encode_gmm": ("flashgmm_tpu_torch/csrc/rans_kernels.cu",
                            "flashgmm_tpu/ans/pallas_coder.py:207"),
        "rans_decode": ("flashgmm_tpu_torch/csrc/rans_kernels.cu",
                        "flashgmm_tpu/ans/pallas_coder.py:75"),
        "rans_decode_gmm": ("flashgmm_tpu_torch/csrc/rans_kernels.cu",
                            "flashgmm_tpu/ans/pallas_coder.py:75"),
        # not Pallas kernels: the plain-XLA fusions of gmm_guarded_bounds
        # and gmm_guarded_rows
        "gmm_bounds": ("flashgmm_tpu_torch/csrc/gmm_rows.cu",
                       "flashgmm_tpu/ans/gaussian_cdf.py:150"),
        "gmm_rows": ("flashgmm_tpu_torch/csrc/gmm_rows.cu",
                     "flashgmm_tpu/ans/gaussian_cdf.py:114"),
        # not Pallas either: the plain-XLA gmm_boundary_rows (the reference
        # format's device rows) and jax.nn.softmax in the GMM codec
        "gmm_boundary_rows": ("flashgmm_tpu_torch/csrc/gmm_rows.cu",
                              "flashgmm_tpu/ans/gaussian_cdf.py:71"),
        "gmm_softmax": ("flashgmm_tpu_torch/csrc/gmm_rows.cu",
                        "flashgmm_tpu/latent_codecs/"
                        "gaussian_mixture_conditional.py:55"),
        "conv2d_nhwc": ("flashgmm_tpu_torch/csrc/conv_kernel.cu",
                        "flashgmm_tpu/ops/pallas_conv.py:108"),
        # the same TPU kernel's bf16 route (compute_dtype=jnp.bfloat16)
        "conv2d_nhwc_bf16": ("flashgmm_tpu_torch/csrc/conv_bf16.cu",
                             "flashgmm_tpu/ops/pallas_conv.py:108"),
    }
    # the rows and bounds kernels are off the path: time them on the path's
    # parameters and symbols
    calls["gmm_bounds"] = [(a[:7], {}) for a, _ in calls["rans_encode_gmm"]]
    calls["gmm_rows"] = [(a[1:7], {}) for a, _ in calls["rans_encode_gmm"]]
    # the boundary rows run on the reference format's path alone: its
    # launches and calls there are their main path's
    calls["gmm_boundary_rows"] = ref_calls["gmm_boundary_rows"]
    launches["gmm_boundary_rows"] = ref_launches["gmm_boundary_rows"]
    # the latency path's calls (batch 1, lanes=LAT_LANES): its eager run of
    # the functions its graphs capture; the bf16 conv's on the kernel route
    lat_words = {route: [int(run[0][k].n_words) for k in ("z", "y0", "y1")]
                 for route, run in lat_runs.items()}
    # the K=1 instances run on the GSM path alone: their launches, calls and
    # times there are their main path's
    for name in K1_INSTANCES:
        calls[f"{name}_k1"] = gsm_calls[f"{name}_k1"]
        launches[f"{name}_k1"] = gsm_launches[f"{name}_k1"]

    def path_times(base, kern, peak, path_calls, words):
        """A batched path's calls of one kernel (ELIC's, the GSM codec's):
        each distinct conv shape (the decoder's rows-chain convs repeat the
        encoder's inputs) and every coder call held to its plain version
        once, every call timed: ({"ms", "device_ms", "bound_ms"}, max|kernel
        - plain|, zero-inserted conv inputs)."""
        t = {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
        seen = {}
        err = 0.0
        inserted = 0
        for i, (args, kwargs) in enumerate(path_calls):
            key = i if base.startswith("rans") else call_key(args, kwargs)
            if base == "conv2d_nhwc":
                stride = inserted_stride(args[0])
                inserted += stride > 1
                key = key + (stride,)
            if key not in seen:
                nbytes, flops, e, _ = stats(base, i, args, kwargs, words)
                err = max(err, e)
                seen[key] = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / peak)
            t["bound_ms"] += seen[key]
            t["ms"] += cuda_ms(lambda: kern(*args, **kwargs), 20)
            if base in DEVICE_TIMED:
                t["device_ms"] += cuda_ms(lambda: kern(*args, **kwargs), 20,
                                          True)
        return t, err, inserted

    results = []
    t_lat = t_elic = t_gsm = t_ref = 0.0  # seconds on those paths' calls
    for name in [*originals, *(f"{n}_k1" for n in K1_INSTANCES)]:
        base = name.removesuffix("_k1")
        kern = originals[base]
        words = gsm_words if name != base else pass_words
        ms = plain_ms = 0.0
        lib_ms = None
        err = 0.0
        by = {"bytes": 0.0, "operations": 0.0}
        floor_ms = device_ms = 0.0
        flops_total = 0
        peak = BF16_FLOP_PER_S if name == "conv2d_nhwc_bf16" else F32_FLOP_PER_S
        for i, (args, kwargs) in enumerate(calls[name]):
            nbytes, flops, e, library = stats(base, i, args, kwargs, words)
            err = max(err, e)
            ms += cuda_ms(lambda: kern(*args, **kwargs), 20)
            if base in DEVICE_TIMED:
                device_ms += cuda_ms(lambda: kern(*args, **kwargs), 20, True)
            plain_ms += cuda_ms(lambda: plains[base](*args, **kwargs), 1)
            if library is not None:
                lib_ms = (lib_ms or 0.0) + cuda_ms(library, 20)
            if name == "rans_decode_gmm":
                floor_ms += serial_floor(args)
            if name == "rans_encode_gmm":
                floor_ms += encoder_floor(args)
            flops_total += flops
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            by["bytes" if t_bytes >= t_ops else "operations"] += max(t_bytes, t_ops)
        route = name == "conv2d_nhwc_bf16"
        l_calls, g_launches = lat_runs[route][1], lat_runs[route][2]
        lat_t = {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
        t0 = time.perf_counter()
        for i, (args, kwargs) in enumerate(l_calls.get(name, [])):
            nbytes, flops, e, _ = stats(name, i, args, kwargs,
                                        lat_words[route])
            err = max(err, e)
            lat_t["ms"] += cuda_ms(lambda: kern(*args, **kwargs), 20)
            if name in DEVICE_TIMED:
                lat_t["device_ms"] += cuda_ms(lambda: kern(*args, **kwargs),
                                              20, True)
            lat_t["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                           flops / peak)
        t_lat += time.perf_counter() - t0
        t0 = time.perf_counter()
        elic_t, e, inserted = path_times(base, kern, peak,
                                         elic_calls.get(name, []), elic_words)
        err = max(err, e)
        t_elic += time.perf_counter() - t0
        if name == base:
            t0 = time.perf_counter()
            gsm_t, e, gsm_inserted = path_times(
                base, kern, peak, gsm_calls.get(name, []), gsm_words)
            err = max(err, e)
            t_gsm += time.perf_counter() - t0
        else:  # timed above: the GSM path is the K=1 instances' own
            gsm_t = {"ms": ms, "device_ms": device_ms,
                     "bound_ms": by["bytes"] + by["operations"]}
            gsm_inserted = 0
        t0 = time.perf_counter()
        ref_t, e, _ = path_times(base, kern, peak, ref_calls.get(name, [])
                                 if name == base else [], pass_words)
        err = max(err, e)
        t_ref += time.perf_counter() - t0
        if name == "conv2d_nhwc":  # h_s's deconvs in the encode and decode
            require(inserted == 2 * ELIC_INSERTED, f"ELIC: {inserted} "
                    "zero-inserted conv inputs, not h_s's deconvs'")
            require(gsm_inserted == 0 and all(
                inserted_stride(a[0]) == 1 for a, _ in calls[name]),
                "a zero-inserted conv input on the flagship's or GSM path")
        if name != "conv2d_nhwc_bf16":  # held to its tolerance in stats
            require(err == 0, f"{name} differs from its plain version")
        lat_launches = {d: g_launches[d].get(name, 0) for d in g_launches}
        # a certified encode replays encode and decode-y, a decode decode-y
        # and g_s
        lat_launches["encode_certified_and_decode"] = (
            lat_launches["encode"] + 2 * lat_launches["decode_y"]
            + lat_launches["g_s"])
        results.append({
            "name": name, "route": "cuda", "source": sources[base][0],
            "replaces": sources[base][1], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": by["bytes"] + by["operations"],
            "bound_by": max(by, key=by.get), "library_ms": lib_ms})
        if name != base:
            results[-1]["instance"] = "K=1 (zero means, unit weights)"
        results[-1].update({"latency_launches": lat_launches,
                            "latency_ms": lat_t["ms"],
                            "latency_bound_ms": lat_t["bound_ms"],
                            "elic_launches": elic_launches.get(name, 0),
                            "elic_ms": elic_t["ms"],
                            "elic_bound_ms": elic_t["bound_ms"],
                            "gsm_launches": gsm_launches[name],
                            "gsm_ms": gsm_t["ms"],
                            "gsm_bound_ms": gsm_t["bound_ms"],
                            "reference_launches": ref_launches.get(name, 0)
                            if name == base else 0,
                            "reference_ms": ref_t["ms"],
                            "reference_bound_ms": ref_t["bound_ms"]})
        if base in DEVICE_TIMED:
            results[-1]["device_ms"] = device_ms
            results[-1]["latency_device_ms"] = lat_t["device_ms"]
            results[-1]["elic_device_ms"] = elic_t["device_ms"]
            results[-1]["gsm_device_ms"] = gsm_t["device_ms"]
            results[-1]["reference_device_ms"] = ref_t["device_ms"]
        if name in ("rans_decode_gmm", "rans_encode_gmm"):
            results[-1]["serial_floor_ms"] = floor_ms
        if name == "conv2d_nhwc_bf16":
            results[-1]["tflop_per_s"] = flops_total / ms / 1e9
            results[-1]["library_tflop_per_s"] = flops_total / lib_ms / 1e9
    phase("timing", "(sums over every launch of one encode + decode; "
          "latency_*: of one encode + decode at batch 1, eager, "
          f"{t_lat:.2f} s of the phase; elic_*: of ELIC's batched encode + "
          f"decode at batch {BATCH}, {t_elic:.2f} s; gsm_*: of the GSM "
          f"codec's at batch {BATCH}, {t_gsm:.2f} s; reference_*: of the "
          f"flagship's reference-format compress + decompress of one image "
          f"in device-rows mode, {t_ref:.2f} s)")

    print(json.dumps({"kernels": results, "card": kind,
                      "power_limit": smi_line.split(",")[-1].strip()}),
          flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

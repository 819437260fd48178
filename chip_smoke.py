#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashgmm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in one flushed line with its seconds:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels from the sources in this checkout (nvcc, one
   shared library), with the -Xptxas -v register and shared-memory lines;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (the GMM rows kernel and rANS encode and decode bit-exact,
   the conv within a stated tolerance, bitwise batch-invariant and
   repeatable);
4. codec: the batched checkerboard-GMM codec at N=192, K=4, lanes=4096,
   cap_divisor=4 on two 768x512 textured-leaves images: encode_to_bytes,
   then decode_bytes, y_hat exact through the bytes, bpp and PSNR, and
   every kernel's launch count from that run;
5. timing: every kernel call of that run timed again by CUDA events, beside
   its plain version, a library call where one computes the same function,
   and its bound.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its
last line ``{"ok": true, "device": {...}}``. Any failed check raises, so
the run exits non-zero without that line; a hang ends after 600 s with a
traceback. Needs a CUDA device and this repository; imports no JAX.
"""

import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "ckbd_gmm_n192_k4_synthetic.npz"
H, W, BATCH, N, K, LANES, CAP_DIVISOR = 768, 512, 2, 192, 4, 4096, 4
SEED0 = 500000  # bench.py's held-out image seeds: SEED0 + 1, SEED0 + 2, ...
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CONV_TOL = 1e-4  # max|kernel - plain| <= CONV_TOL * (1 + max|plain|)
# float32 operations of one mixture term of one rows entry, by APPROX_MODE
# (each add, sub, mul, div, sqrt and floor 1, each FMA 2; XLA's exp is 22):
# Pólya: sub, div, 2 mul, exp, sub, sqrt, add, and the mixture FMA = 31;
# A&S: sub, div, FMA, div, 4 FMA, 2 mul, exp, 2 mul, FMA, sub, FMA = 44;
# logistic: sub, div, mul, exp, add, div, FMA = 29.
ROWS_FLOPS_PER_TERM = {0: 31, 1: 44, 2: 29}

_t_phase = [time.perf_counter()]


def phase(name, detail=""):
    now = time.perf_counter()
    print(f"[{name}] {now - _t_phase[0]:.2f} s {detail}".rstrip(), flush=True)
    _t_phase[0] = now


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def main() -> int:
    faulthandler.dump_traceback_later(600, exit=True)
    import torch

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
    from flashgmm_tpu_torch.ans.gaussian_cdf import (get_approx_mode,
                                                     gmm_guarded_rows,
                                                     gmm_guarded_rows_plain)
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
        if "registers" in line or "smem" in line or "Compiling" in line:
            print("  " + line, flush=True)
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
    rows_l = rows.reshape(t_steps, LANES, num_bins + 1)
    sym_k = rans_kernels.decode_scan(st_k, s_k, rows_l, active, lo)
    sym_p = il.decode_scan(st_k, s_k, rows_l, active, lo)
    torch.cuda.synchronize()
    require(torch.equal(sym_k, sym_p), "rans decode: symbols differ from plain")
    require(torch.equal(il.from_lanes(sym_k, n_y).long(), values),
            "rans decode: symbols differ from the encoded values")
    print(f"  rans encode/decode T={t_steps} W={LANES} L={num_bins + 1}: "
          f"bit-exact, {int(n_k)} words", flush=True)

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
    conv_err = 0.0
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
        err = float((y_k - y_p).abs().max())
        require(err <= CONV_TOL * (1 + float(y_p.abs().max())),
                f"conv {b}x{h}x{w} {ci}->{co} k{k}: max|d| {err}")
        require(torch.equal(y_1, y_k[1:2]), "conv: image alone != in batch")
        require(torch.equal(y_again, y_k), "conv: two calls differ")
        conv_err = max(conv_err, err)
    print(f"  conv: {len(conv_shapes)} rows-chain shapes, max|kernel - plain| "
          f"{conv_err:.3g} (tol {CONV_TOL} x (1 + max|plain|)), bitwise "
          "batch-invariant and repeatable", flush=True)
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

    data, out = codec.encode_to_bytes(x)  # warm-up: library autotuning
    codec.decode_bytes(data, tuple(out["y_hat"].shape))
    torch.cuda.synchronize()

    # Drive the main path once with every kernel wrapper wrapped in a
    # recorder that keeps its inputs for the timing phase. The wrappers'
    # bodies count on the name their module binds, so during this run the
    # counts land on the recorders, which start at 0.
    calls = {"rans_encode": [], "rans_decode": [], "conv2d_nhwc": [],
             "gmm_rows": []}
    bound = {"rans_encode": (rans_kernels, "encode_scan"),
             "rans_decode": (rans_kernels, "decode_scan"),
             "conv2d_nhwc": (conv_kernel, "conv2d_nhwc"),
             "gmm_rows": (rows_kernel, "gmm_rows")}
    originals = {name: getattr(*where) for name, where in bound.items()}

    def recorder(name):
        fn = originals[name]

        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        wrapped.launches = 0
        return wrapped

    for name, (module, attr) in bound.items():
        setattr(module, attr, recorder(name))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, out = codec.encode_to_bytes(x)
    t1 = time.perf_counter()
    y_shape = tuple(out["y_hat"].shape)
    x_hat = codec.decode_bytes(data, y_shape)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: getattr(*where).launches for name, where in bound.items()}
    for name, (module, attr) in bound.items():
        setattr(module, attr, originals[name])

    for name, count in launches.items():
        require(count > 0, f"{name} was not launched on the main path")
    # two rows passes for each encode and each decode (3 coder passes each)
    require(3 * launches["gmm_rows"]
            == 2 * (launches["rans_encode"] + launches["rans_decode"]),
            "gmm_rows: not one launch per y pass of every encode and decode")
    y_dec = codec.decode_y_hat(codec.from_bytes(data, y_shape), y_shape)
    require(torch.equal(y_dec, out["y_hat"]), "y_hat differs after the bytes")
    require(tuple(x_hat.shape) == (BATCH, H, W, 3), f"x_hat {tuple(x_hat.shape)}")
    require(bool(torch.isfinite(x_hat).all()), "x_hat not finite")
    x_ref = torch.clamp(codec._transform(codec._g_s, out["y_hat"]), 0, 1)
    gs_err = float((x_hat - x_ref).abs().max())
    require(gs_err < 1e-2, f"decoded pixels vs g_s(y_hat): {gs_err}")
    mse = ((x_hat - x) ** 2).mean(dim=(1, 2, 3)).double().cpu().numpy()
    psnr = float(np.mean(-10 * np.log10(np.maximum(mse, 1e-12))))
    bpp = len(data) * 8 / (BATCH * H * W)
    print(f"  y_hat {list(y_shape)} exact through {len(data)} bytes; "
          f"bpp {bpp:.4f}, PSNR {psnr:.3f} dB; encode {1e3 * (t1 - t0):.1f} ms, "
          f"decode {1e3 * (t2 - t1):.1f} ms (batch {BATCH}, host clock)",
          flush=True)
    print(f"  launches in one encode + decode: {launches}", flush=True)
    phase("codec")

    # 5. timing of every recorded call ------------------------------------
    def cuda_ms(fn, reps):
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

    pass_words = [int(out[k].n_words) for k in ("z", "y0", "y1")]

    def stats(name, i, args, kwargs):
        """(bytes, flops, max|kernel - plain|, library call or None) of one
        recorded call; bytes count each input read once and each output
        written once, at what this call's data needs."""
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
        if name == "rans_decode":
            _, _, rws, act, _ = args
            t, w, _ = rws.shape
            err = int((originals[name](*args) - il.decode_scan(*args))
                      .abs().max())
            # states, the consumed words, the two row entries that bound each
            # active symbol's bin, active (1 B), symbols out (int32)
            n_words = pass_words[i % 3]
            return (4 * w + 4 * n_words + 8 * int(act.sum()) + t * w * 5,
                    0, err, None)
        xi, wi, bi = args
        res = kwargs.get("residual")
        got = originals[name](*args, **kwargs)
        ref = conv_kernel.conv2d_nhwc_plain(*args, **kwargs)
        err = float((got - ref).abs().max())
        require(err <= CONV_TOL * (1 + float(ref.abs().max())),
                f"conv on the main path: max|d| {err}")
        flops = 2 * xi.shape[0] * xi.shape[1] * xi.shape[2] * int(
            torch.count_nonzero(wi))  # masked taps are not work
        nbytes = 4 * (xi.numel() + wi.numel() + got.numel()
                      + (0 if bi is None else bi.numel())
                      + (0 if res is None else res.numel()))
        x_nchw = xi.permute(0, 3, 1, 2)
        w_oihw = wi.permute(3, 2, 0, 1).contiguous()
        pad = wi.shape[0] // 2

        def library():
            return torch.nn.functional.conv2d(x_nchw, w_oihw, bi, padding=pad)
        return nbytes, flops, err, library

    plains = {"rans_encode": il.encode_scan, "rans_decode": il.decode_scan,
              "conv2d_nhwc": conv_kernel.conv2d_nhwc_plain,
              "gmm_rows": gmm_guarded_rows_plain}
    sources = {
        "rans_encode": ("flashgmm_tpu_torch/csrc/rans_kernels.cu",
                        "flashgmm_tpu/ans/pallas_coder.py:207"),
        "rans_decode": ("flashgmm_tpu_torch/csrc/rans_kernels.cu",
                        "flashgmm_tpu/ans/pallas_coder.py:75"),
        "conv2d_nhwc": ("flashgmm_tpu_torch/csrc/conv_kernel.cu",
                        "flashgmm_tpu/ops/pallas_conv.py:108"),
        # not a Pallas kernel: the plain-XLA fusion of gmm_guarded_rows
        "gmm_rows": ("flashgmm_tpu_torch/csrc/gmm_rows.cu",
                     "flashgmm_tpu/ans/gaussian_cdf.py:114"),
    }
    results = []
    for name, kern in originals.items():
        ms = plain_ms = 0.0
        lib_ms = None
        err = 0.0
        by = {"bytes": 0.0, "operations": 0.0}
        for i, (args, kwargs) in enumerate(calls[name]):
            nbytes, flops, e, library = stats(name, i, args, kwargs)
            err = max(err, e)
            ms += cuda_ms(lambda: kern(*args, **kwargs), 20)
            plain_ms += cuda_ms(lambda: plains[name](*args, **kwargs), 3)
            if library is not None:
                lib_ms = (lib_ms or 0.0) + cuda_ms(library, 20)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            by["bytes" if t_bytes >= t_ops else "operations"] += max(t_bytes, t_ops)
        if name != "conv2d_nhwc":
            require(err == 0, f"{name} differs from its plain version")
        results.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": by["bytes"] + by["operations"],
            "bound_by": max(by, key=by.get), "library_ms": lib_ms})
    phase("timing", "(sums over every launch of one encode + decode)")

    print(json.dumps({"kernels": results, "card": kind,
                      "power_limit": smi_line.split(",")[-1].strip()}),
          flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

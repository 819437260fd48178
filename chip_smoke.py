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
   digests, equal to this process's bytes, and both lengths printed (the
   two cold processes run side by side, each of the others alone); the
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
   host coder's share and the card's busy ms (not in host-math mode,
   whose device kernels are the device-rows run's), and the port on the
   CPU decoding the card's strings of a 64x64 image to the card's y_hat
   (in phase 17);
11b. tools: the last modules (ROADMAP item 15; ``tools_phase``): tiled
   synthesis (``runtime/tiled.py``) of the flagship on one 3840x2160
   image (a 136 x 240 x 192 latent) on both transform routes, within the
   JAX test's bounds of the direct g_s, with the largest difference, the
   share of pixels apart, each one's ms and peak memory and the bf16 conv's
   launches; the .fgm file CLI (``python -m
   flashgmm_tpu_torch.examples.codec``) in subprocesses on the card, the
   flagship and bmshj2018-factorized on a 768x512 PPM and a 3-frame
   ssf2020 GOP, its files decoded on the CPU by the same CLI (``--device cpu``; queued after the zoo phase,
   read in phase 17) to the card's y_hat exactly and pixels within 1
   level, and its ``main`` once under the kernel recorder;
   the standalone codec's model card exported on the card and its streams
   crossing the C++ binaries ``fgsc_encode`` / ``fgsc_decode`` (built from
   csrc/ in the CpuSide process after the kernels' build); the range coder
   (``set_entropy_coder("rangecoder")``) giving the rANS coder's y_hat;
   and the last public names (ROADMAP A8): the JAX test's tiled case (the
   seed-initialised flagship on random latents, at [1, 24, 8, 192] and
   [1, 40, 24, 192], both routes, the same bounds;
   ``tiled_random_cases``), ``save_npz_weights`` writing the flagship's
   weight file back bit for bit (``weights_round_trip``), GDN1 and the
   spectral convs on the card against the CPU (``last_layers_on_card``).
   ``python3 chip_smoke.py --tools`` runs this phase alone;
11c. parallel: batch-data-parallel coding and the sharded forwards
   (ROADMAP A9; ``parallel_phase``) over every card of the host, or on a
   one-card host over 4 slots named on cuda:0: the flagship's batched
   codec with ``use_mesh`` on both routes (launches by card: the bf16
   conv on every card, the coders and the f32 conv on the first; every
   round trip exact; one card's bytes decoded on the mesh and the mesh's
   on one card; ``portable=False`` exact; the bytes against one card's,
   ROADMAP C15), GSM and ELIC on the mesh, the height-sharded forward
   within the JAX test's bounds of the whole one, each card's peak
   memory. ``python3 chip_smoke.py --parallel`` runs it alone, with the
   times at global batch 24 and 96 on one card and on the mesh, the
   transforms' share, each card's busy share and a 3840x2176 forward;
12. vbr: the variable-bitrate models (ROADMAP item 13; ``vbr_phase``),
   while the zoo phase's CPU runs go on, on the two 768x512 images of the
   JAX package's sweep: the shipped mbt2018-mean-vbr (N=192, M=320, the variable-step bottleneck) at each of
   its 8 gains and at one continuous scale, bmshj2018-hyperprior-vbr and
   mbt2018-vbr seed-initialised: the launches of each level's compress +
   decompress (the f32 conv for h_s's three convs a direction), y_hat
   exact, bytes, bpp, PSNR, MS-SSIM, compress and decompress ms, the rate
   monotone over the gains and the sweep beside
   results/synthetic/vbr_sweep.json; the rows-chain conv at the path's h_s
   shapes against its plain version; the card's strings of a small image
   decoded on the CPU at s=7 (in phase 17); 10 ``vbr_train_step``s of the
   shipped model.
   ``python3 chip_smoke.py --vbr`` runs this phase alone;
13. video: scale-space flow, ssf2020 at its published widths (ROADMAP
   item 14a; ``video_phase``), while the zoo phase's CPU runs go on: the
   video eval CLI with ``--real`` on the card over a raw 8-bit 4:2:0
   1920x1080 file of 8 panned textured-leaves frames (padded to
   1920x1152; encode and decode ms a frame, bpp, PSNR, MS-SSIM); a
   seed-initialised model's 3-frame GOP at 256x256: the decoded frames
   equal the encoder's reconstructions bit for bit, and a CPU copy decodes
   the card's strings to every branch's y_hat bit for bit (in phase 17);
   the launches of both (the f32 conv 6 times a hyperprior a direction,
   each hyper decoder's stride-2 deconvs zero-inserted; phase 16 holds
   the conv to its plain version at each of their shapes); 5
   ``video_train_step``s at batch 4, GOP 3, 256x256 crops: finite terms,
   ms a step, peak memory.
   ``python3 chip_smoke.py --video`` runs this phase alone;
13b. pcc: point-cloud compression (ROADMAP item 14b; ``pcc_phase``),
   while the zoo phase's CPU runs go on: the shipped hrtzxf2022-pcc-rec
   and sfu-pcc-rec-pointnet (256 wide) from the zoo over the 8 held-out
   clouds of tools/train_pointcloud_artifact.py, each decoded twice (bit
   for bit the same), mean bpp within 1 % and mean chamfer within 2 % of
   the JAX package's on the same clouds and weights, hrtzxf2022's 1026
   points out, none of the port's hand kernels launched (no TPU kernel is
   on this path), compress and decompress ms, each direction's device
   events and busy ms, the FPS loop's share of the encode; the other two
   codecs seed-initialised, their strings decoding to the encoder's
   latent bit for bit; the card's strings of the first cloud decoded on
   the CPU to the card's symbols (in phase 17); 10
   ``pointcloud_train_step``s of each shipped architecture (seed
   weights), ms a step and peak memory; the point-cloud trainer CLI for
   one epoch of 2 steps on the card.
   ``python3 chip_smoke.py --pcc`` runs this phase alone;
14. train: training at full width under the trainer's library settings
   (cuDNN TF32 on, autotuning on; ``train_phase``), while the zoo phase's
   CPU runs go on: the flagship on a fixed batch of 8 256x256 crops, 20
   ``train_step``s (finite terms, the loss going down, the quantiles and
   g_a moved, a NaN batch guarded), the step,
   forward and backward ms, peak memory, the top device kernels of a step,
   and one step under the coding path's pinned settings (TF32 off, no
   autotuning) beside it; 2 ``data_parallel_train_step``s on a world-1
   NCCL group beside 2 ``train_step``s from the same weights, batch and
   noise (cuDNN deterministic): the parameters bitwise equal, both steps'
   ms and one all-reduce's ms of the flat gradient on the group;
   the trainer CLI on a folder of PPMs (2 epochs across a milestone, a
   resume, the checkpoints loading bit for bit); one step each of ELIC and
   GSM. None of the port's hand kernels runs there; its cached device
   memory is released for the zoo phase's card runs.
   ``python3 chip_smoke.py --train-parallel`` trains across the host's
   cards alone (``train_parallel_only``; ROADMAP A10): one process a card
   over NCCL (on a one-card host 2 processes on cuda:0 over gloo), the
   flagship at full width, 20 steps at global batch 8 (finite, the loss
   going down, the replicas bitwise equal, the first loss within 1 % of
   one card's ``train_step``), the step ms at global batch 8 and 32 on one
   card and on all, the all-reduce's ms and share, each card's peak
   memory; then the trainer CLI under torchrun for an epoch;
15. zoo: the CompressAI image-model line (ROADMAP item 12) at its zoo
   widths on the first image (``zoo_phase``): bmshj2018-factorized,
   bmshj2018-hyperprior and mbt2018-mean (both coders) at q4 (N=128,
   M=192) on the repository's weights, mbt2018 (N=192, M=320), Cheng2020
   anchor and attention (N=192) and the Chandelier ELIC (N=192, M=320)
   seed-initialised: the launches of one compress + decompress (the f32
   conv for each rows-chain conv, the Gaussian rows kernel once a
   direction on the search coder), y_hat exact, bytes, bpp, PSNR,
   compress and decompress ms with the raster scan's host loop apart, the
   search coder's rows kernel against its plain version at the path's
   shape, the port on the CPU decoding the card's strings of a 64x64
   image to the card's y_hat (in phase 17); sigmoid-cdf's eval forward;
   the evaluation CLI with ``--real`` in subprocesses on two 768x512
   PPMs, mbt2018-mean
   and bmshj2018-hyperprior at q4 from port checkpoints on the card and on
   the CPU (bpp within 0.5 %, PSNR within 0.05 dB), the flagship on the
   card, and ``update_model``'s file reloading and coding the same bytes
   (the CPU runs start after the build, at the lowest priority, beside the
   earlier phases). ``python3 chip_smoke.py --zoo`` runs this phase alone;
16. timing: every kernel call of those runs timed again by CUDA events,
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
   each distinct conv shape and each coder call held to its plain version
   and timed once, its time counted at every call of that shape;
   the coders' K=1 instances on lines of their own
   ("rans_encode_gmm_k1", "rans_decode_gmm_k1", their launches and times
   the GSM path's); each kernel's calls of the flagship's reference-format
   compress + decompress ("reference_*"), where the boundary-rows kernel
   has its main path's launches and calls; and each kernel's calls of the
   zoo phase's compress + decompress ("zoo_*"), where the single-Gaussian
   rows kernel (the boundary-rows kernel at K=1) has its main path's
   launches and calls; and of the vbr phase's ("vbr_*"); and of the
   video phase's ("video_*", the conv also on the device alone,
   "video_device_ms"); and of the tools phase's tiled UHD g_s (kernel
   route) and in-process .fgm CLI encode + decode ("tools_*");
17. cpu: the CPU decodes that phases 11, 11b, 12, 13, 13b and 15 queued,
   each a CPU copy of the card's model decoding the card's strings, run in a
   process of their own (``CpuSide``, started after the build) while the
   card's phases go on: their lines and checks, and the seconds this
   process waited for the last of them.

It prints its total seconds, a ``{"kernels": [...]}`` line, the nvidia-smi
line, and as its last line ``{"ok": true, "device": {...}}``. Any failed check raises, so
the run exits non-zero without that line; a hang ends after 1150 s with a
traceback (within a run's limit of 1200 s); every process it started is
stopped on the way out. Needs a CUDA device and this repository; imports no JAX.
"""

import faulthandler
import json
import re
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager
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
REF_REPS = 2
# the timing phase: each kernel call timed as the mean of as many
# back-to-back launches (20 until the tools phase joined the smoke; cut to
# keep the smoke within its time)
TIMING_REPS = 10
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
                "gmm_boundary_rows", "gmm_softmax", "gaussian_boundary_rows")
# float32 operations of one softmax entry: the max's compare, the subtract,
# XLA's exp (22), the sum's add, the divide, and the flushes' compares (4)
SOFTMAX_FLOPS_PER_ENTRY = 30
# the zoo phase: the CompressAI image-model line at its zoo widths, (tag,
# architecture, quality, coder); the q4 slots load the repository's trained
# weights (zoo.image.local_weights), the others are seed-initialised
ZOO_CASES = (
    ("bmshj2018-factorized q4", "bmshj2018-factorized", 4, None),
    ("bmshj2018-hyperprior q4", "bmshj2018-hyperprior", 4, None),
    ("mbt2018-mean q4 table", "mbt2018-mean", 4, "table"),
    ("mbt2018-mean q4 search", "mbt2018-mean", 4, "search"),
    ("mbt2018 q5", "mbt2018", 5, None),
    ("cheng2020-anchor q4", "cheng2020-anchor", 4, None),
    ("cheng2020-attn q4", "cheng2020-attn", 4, None),
    ("elic2022-chandelier", "elic2022-chandelier", None, None))
ZOO_TRAINED = ("bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean")
# a direction's rows-chain convs: h_s's (3, or Cheng2020's 5), and the
# Chandelier's h_s 3, channel contexts 4 x 3, spatial contexts 5,
# aggregation networks 10 x 3
ZOO_ROWS_CONVS = {"bmshj2018-factorized": 0, "bmshj2018-hyperprior": 3,
                  "mbt2018-mean": 3, "mbt2018": 3, "cheng2020-anchor": 5,
                  "cheng2020-attn": 5, "elic2022-chandelier": 50}
ZOO_SMALL = 64  # the side of the image whose card strings the CPU decodes
# the eval CLI's runs held against the CPU: (architecture, quality, widths)
ZOO_CLI = (("mbt2018-mean", 4, ("-N", "128", "-M", "192")),
           ("bmshj2018-hyperprior", 4, ("-N", "128", "-M", "192")))
ZOO_CLI_BPP, ZOO_CLI_PSNR = 5e-3, 0.05  # card against CPU: relative, dB
ZOO_CLI_THREADS = (4, 3)  # CPU threads of the two CPU runs, side by side
# the vbr phase: the JAX sweep's images (tools/vbr_sweep.py) and its record
# (read only), the continuous scale run between gains 4 and 5, the
# seed-initialised models and their gain levels, the side of the image
# whose card strings the CPU decodes, and the training steps of the
# shipped model (s cycling 0..7)
VBR_SEEDS = (600000, 600001)
VBR_RECORD = ROOT / "results" / "synthetic" / "vbr_sweep.json"
VBR_INPUTSCALE = 0.45
VBR_SEEDED = (("bmshj2018-hyperprior-vbr", (0, 3, 7)), ("mbt2018-vbr", (0, 7)))
VBR_ROWS_CONVS = 3  # h_s's convs a direction
VBR_SMALL = 256
VBR_TRAIN_STEPS = 10
# the video phase: ssf2020 (its published widths, seed-initialised); the
# video eval CLI over a raw 8-bit 4:2:0 sequence at the HEVC class-B / UVG
# size (padded by the CLI to 1920x1152), VIDEO_CLI_FRAMES frames in one GOP;
# a VIDEO_GOP-frame GOP at VIDEO_SIDE^2 coded on the card and decoded on the
# CPU, its frames within VIDEO_CPU_ATOL of the card's; VIDEO_TRAIN_STEPS
# video_train_steps at the video trainer's defaults (batch 4, GOP 3,
# 256x256 crops, lambda 0.01)
VIDEO_SEED = 700000
VIDEO_CLI_W, VIDEO_CLI_H, VIDEO_CLI_FRAMES = 1920, 1080, 8
VIDEO_GOP, VIDEO_SIDE, VIDEO_CPU_ATOL = 3, 256, 1e-4
VIDEO_TRAIN_STEPS, VIDEO_TRAIN_BATCH, VIDEO_LMBDA = 5, 4, 0.01
VIDEO_ROWS_CONVS = 6  # a hyperprior's scale and mean decoders, 3 deconvs each
# the pcc phase (ROADMAP item 14b): the held-out clouds of
# tools/train_pointcloud_artifact.py (PCC_CLOUDS clouds of PCC_POINTS points
# from RandomState(PCC_EVAL_SEED), batch 1); each shipped codec's zoo name,
# the mean bpp and chamfer the JAX package gives on those clouds with the
# same weights after update(force=True, update_quantiles=True), and its
# decoded point count (the decoder's ceil takes 38 -> 114 -> 342 -> 1026);
# the tolerances on those means; the runs each timing is the median of; the
# seed-initialised codecs; the training steps (the artifact tool's batches
# from RandomState(0), its lambda for the chamfer loss)
PCC_POINTS, PCC_CLOUDS, PCC_EVAL_SEED = 1024, 8, 999
PCC_SHIPPED = (("hrtzxf2022-pcc-rec", 0.69921875, 0.0100103, 1026),
               ("sfu-pcc-rec-pointnet", 0.2421875, 0.0066151, 1024))
PCC_BPP_RTOL, PCC_CHAMFER_RTOL, PCC_REPS = 0.01, 0.02, 5
PCC_SEEDED, PCC_SEED = ("sfu-pcc-rec-pointnet2", "folding-pcc-rec"), 800000
PCC_TRAIN = (("hrtzxf2022-pcc-rec", "hrtzxf2022", 1.0),
             ("sfu-pcc-rec-pointnet", "chamfer", 600.0))
PCC_TRAIN_STEPS, PCC_TRAIN_BATCH, PCC_CLI_CLOUDS = 10, 8, 16
# torch threads of the process that decodes the card's strings on the CPU
# (CpuSide) beside the card's phases
CPU_SIDE_THREADS = 4
# the tools phase (ROADMAP item 15): tiled synthesis of one UHD image
# (TOOLS_UHD; padded to 2176 x 3840, a 136 x 240 x 192 latent) against the
# direct g_s within the JAX test's bounds (tests/test_fast_codec.py:
# 210-225), each timed as the median of TILED_REPS runs; the .fgm CLI's
# video GOP and the standalone codec's and the range coder's images
# TOOLS_SMALL on a side; the standalone decoders' pixels within
# STANDALONE_LEVELS of each other
TOOLS_UHD = (2160, 3840)
TILED_ATOL, TILED_FRAC, TILED_REPS = 2e-2, 0.05, 3
TOOLS_SMALL, TOOLS_VIDEO_FRAMES, STANDALONE_LEVELS = 256, 3, 2
FACTORIZED_WEIGHTS = ROOT / "weights" / "factorized_n128_m192_synthetic.npz"
# the training phase: the trainer CLI's defaults (examples/train.py) and
# the steps the flagship takes on one fixed batch
TRAIN_BATCH, TRAIN_PATCH, TRAIN_STEPS = 8, 256, 20
TRAIN_LR, TRAIN_AUX_LR, TRAIN_LMBDA = 1e-4, 1e-3, 0.01
# training across cards (--train-parallel): one process a card over NCCL
# (on a one-card host TRAIN_SHARED_RANKS processes on cuda:0 over gloo),
# TRAIN_STEPS steps at the first global batch, then TRAIN_PAR_TIMED timed
# after a first step at each global batch, on one card and on all of them;
# every collective waits at most TRAIN_RANK_TIMEOUT seconds
TRAIN_PAR_BATCHES, TRAIN_PAR_TIMED, TRAIN_SHARED_RANKS = (8, 32), 5, 2
TRAIN_RANK_TIMEOUT, TRAIN_PAR_LOSS_RTOL = 600, 1e-2

_T_START = time.perf_counter()
_t_phase = [_T_START]


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


def cuda_ms(fn, reps, ahead=False, warm=True):
    """Mean ms of fn over reps calls after one warm-up, by CUDA events. With
    ``ahead`` the events time the device's work alone, without the
    wrappers' host time (only for wrappers that never wait for the device):
    a sleep kernel first holds the stream for twice the host's measured
    time to enqueue the reps calls, and a run counts only if the sleep was
    still running once the last call was enqueued (else the sleep doubles
    and the run is repeated). ``warm=False`` leaves the warm-up out, for a
    call the caller has just made on the same inputs."""
    import torch

    if warm:
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


def _cpu_side_init(root, threads):
    sys.path.insert(0, root)
    import torch

    torch.set_num_threads(threads)


def _cpu_side_run(fn, payload):
    """In the CpuSide process: (fn(*pickle.loads(payload)), its seconds)."""
    import pickle

    args = pickle.loads(payload)
    t0 = time.perf_counter()
    result = fn(*args)
    return result, time.perf_counter() - t0


class CpuSide:
    """A process of its own for the port on the CPU decoding the card's
    strings (the reference, vbr, video, pcc and zoo phases' CPU checks), so
    that the card's phases go on meanwhile. ``submit(fn, args, then)`` queues
    ``fn(*args)`` there: a top-level function of this script over CPU
    models and tensors, pickled here into bytes (no shared memory), whose
    result is plain Python values; ``drain()`` waits for each result in
    order and calls ``then(result, seconds)``, the phase's print and
    require, so a failed check fails the run there. ``close`` stops the
    process."""

    def __init__(self, threads):
        import multiprocessing

        self._pool = multiprocessing.get_context("spawn").Pool(
            1, initializer=_cpu_side_init, initargs=(str(ROOT), threads))
        self._pending = []

    def submit(self, fn, args, then):
        import pickle

        self._pending.append((self._pool.apply_async(
            _cpu_side_run, (fn, pickle.dumps(args))), then))

    def start(self, fn, args):
        """``fn(*args)`` queued now, outside ``drain``'s list: the pool's
        AsyncResult, whose ``get`` gives (result, seconds)."""
        import pickle

        return self._pool.apply_async(_cpu_side_run,
                                      (fn, pickle.dumps(args)))

    def drain(self):
        while self._pending:
            pending, then = self._pending.pop(0)
            then(*pending.get(timeout=900))

    def close(self):
        self._pool.terminate()
        self._pool.join()


def _cpu_latent_equal(model, strings, shape, want, host_math):
    """Whether a CPU copy's latent codec decodes the card's reference-format
    strings to ``want`` (the card's y_hat), FLASHGMM_HOST_MATH=host_math."""
    import os

    import torch

    os.environ["FLASHGMM_HOST_MATH"] = host_math
    return torch.equal(model.latent_codec.decompress(strings, shape)["y_hat"],
                       want)


def _cpu_y_equal(model, strings, shape, kwargs, want):
    """Whether a CPU copy's ``decompress_y`` gives ``want`` (the card's
    y_hat) from the card's strings."""
    import torch

    return torch.equal(model.decompress_y(strings, shape, **kwargs), want)


def _cpu_vbr_symbols(model, out, s, card_symbols, card_y):
    """A hyperprior VBR model's CPU copy over the card's strings: (whether
    its y symbols equal the card's, max |y_hat difference| from the
    card's)."""
    import torch

    y_cpu = model.decompress_y(out["strings"], out["shape"], s=s)
    return (torch.equal(_vbr_symbols(model, out, s), card_symbols),
            float((y_cpu - card_y).abs().max()))


def _cpu_video_decode(model, strings, shapes, y_card, frames_card):
    """ScaleSpaceFlow's CPU copy decoding the card's GOP strings:
    ([(frame, branch)] whose y_hat differs from the card's, the frames' max
    |difference| from the card's)."""
    import torch

    frames, details = model.decompress(strings, shapes, details=True)
    wrong = [(i, branch) for i, (got, want) in
             enumerate(zip(details["y_hat"], y_card)) for branch in want
             if not torch.equal(got[branch], want[branch])]
    return wrong, max(float((a - b).abs().max())
                      for a, b in zip(frames, frames_card))


def _pcc_symbols(model, strings, shape):
    """The EntropyBottleneck values (symbols + medians) that a point-cloud
    codec's strings decode to: the features' and the latent positions'
    for hrtzxf2022, the latent vector's for the PointNet family."""
    if isinstance(shape, list):  # hrtzxf2022: [features, positions]
        codec = model.latent_codec
        return [codec["feat"].entropy_bottleneck.decompress(
                    strings[0][0], tuple(shape[0])),
                codec["xyz"].entropy_bottleneck.decompress(
                    strings[1][0], tuple(shape[1]))]
    return [model.entropy_bottleneck.decompress(strings[0], tuple(shape))]


def _cpu_pcc_decode(model, strings, shape, card_symbols, card_x_hat):
    """A point-cloud codec's CPU copy decoding the card's strings: (whether
    its symbols equal the card's, the chamfer distance between its x_hat
    and the card's, the rows more than 1e-4 from the card's, the rows)."""
    import torch

    from flashgmm_tpu_torch.losses import chamfer_distance

    with torch.inference_mode():
        same = all(torch.equal(a, b) for a, b in zip(
            _pcc_symbols(model, strings, shape), card_symbols))
        x_hat = model.decompress(strings, shape)["x_hat"]
    rows = (x_hat - card_x_hat).abs().amax(-1) > 1e-4
    return (same, float(chamfer_distance(x_hat, card_x_hat)),
            int(rows.sum()), int(rows.numel()))


def h2d_copies(fn):
    """fn() under torch.profiler: (fn's result, the host-to-device copies
    the card ran). fn decodes bytes from the host, so it copies at least
    once: a trace that holds no kernel at all, or no host-to-device copy,
    lost device events (seen after several profiler sessions in one
    process, and once in a latency decode's trace that held its kernels)
    and is taken again, up to three times."""
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
        copies = sum(n.startswith("Memcpy HtoD") for n in names)
        if copies and any(not n.startswith(("Memcpy", "Memset"))
                          for n in names):
            return out, copies
    raise RuntimeError("h2d_copies: three traces without device kernels or "
                       "without a host-to-device copy")


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
            "gaussian_boundary_rows": 0,
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
            "gmm_softmax": 0, "gmm_boundary_rows": 0,
            "gaussian_boundary_rows": 0}
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


def device_busy_ms(fn, top_n=3):
    """fn() under torch.profiler: (fn's result, ms the card was busy, the
    union of its kernels' and copies' intervals, the device events, and
    the ``top_n`` names that took the most device time, with their ms and
    counts). A trace that holds no device event lost them (seen after
    several profiler sessions in one process) and is taken again, up to
    three times; after three such traces the profiler stays blind in this
    process (with most of the card's memory free), so the CUDA-event span
    of one more call stands in for the busy ms, with 0 device events and
    no names, and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        # a user annotation (``Optimizer.step#Adam.step``) spans kernels
        # on the device timeline; it is not one
        events = [e for e in prof.events() if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False)]
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
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
            return out, busy / 1e3, len(events), top
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    span = a.elapsed_time(b)
    print(f"  device_busy_ms: three traces without device events; the call's "
          f"CUDA-event span, {span:.3f} ms, stands in for its busy ms "
          "(device events and busy time not measured)", flush=True)
    return out, span, 0, []


def reference_phase(dev, x1, model, record, originals, smi_line, cpu):
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
    and the card's busy ms (profiler; not in host-math mode, whose device
    kernels are the device-rows run's), beside the reference's GPU + AVX2
    yardstick; and the port on the CPU (``cpu``, a CpuSide), given the
    same weights, decoding the card's strings of a 64x64 image to the
    card's y_hat (the CPU's rows chain is the conv kernel's plain version,
    slow at 768x512). Returns (launches, recorded calls) of the flagship's
    device-rows run."""
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
                busy = ("", "")
                if mode != "host math":
                    _, busy_c, n_c, top_c = device_busy_ms(
                        lambda m=m: m.compress(x1))
                    _, busy_d, n_d, top_d = device_busy_ms(
                        lambda m=m: m.decompress(strings, shape))
                    busy = (f", card busy {busy_c:.2f} ms",
                            f", card busy {busy_d:.2f} ms")
                # the card's strings of a small image, decoded on the CPU
                s_out = m.compress(small.to(dev))

                def then(same, t_cpu, tag=tag):
                    require(same, f"{tag}: the port on the CPU decodes the "
                            "card's strings of a 64x64 image to another "
                            "y_hat")
                    print(f"  {tag}: the card's strings of a 64x64 image "
                          f"decoded on the CPU exactly ({t_cpu:.1f} s)",
                          flush=True)
                cpu.submit(_cpu_latent_equal, (
                    cpu_model, s_out["strings"], s_out["shape"],
                    s_out["y_hat"].cpu(), os.environ["FLASHGMM_HOST_MATH"]),
                    then)
                print(f"  {tag}: y_hat {list(out['y_hat'].shape)} exact "
                      f"through {n_bytes} bytes (the batched codec: "
                      f"{len(b_data)}), PSNR {psnr_of(x_hat, x1):.4f} dB; "
                      f"compress {1e3 * t_c:.2f} ms (host coder "
                      f"{1e3 * h_c:.2f} ms{busy[0]}), decompress "
                      f"{1e3 * t_d:.2f} ms (host coder {1e3 * h_d:.2f} ms"
                      f"{busy[1]}); host clock, medians of {REF_REPS}, "
                      f"{smi_line}; the reference's GPU + AVX2 yardstick ~55 "
                      "+ ~42 ms a Kodak image (BASELINE.md); launches "
                      f"{launches}; {len(calls['gmm_boundary_rows'])} "
                      f"boundary-rows and {len(calls['gmm_softmax'])} "
                      "softmax calls equal to plain bit for bit", flush=True)
                if mode != "host math":
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
          "ELIC and the GSM model on the card; their strings queued for the "
          "CPU")
    return result


def _cli_report(proc, tag, timeout):
    """The JSON report a finished eval CLI process printed."""
    out, err = proc.communicate(timeout=timeout)
    require(proc.returncode == 0,
            f"zoo: the eval CLI ({tag}) exited {proc.returncode}: "
            f"{err[-1500:]}")
    return json.loads(out[out.index("{"):])


class ZooCli:
    """The eval CLI (``python -m flashgmm_tpu_torch.utils.eval_model``) with
    ``--real`` in subprocesses over two 768x512 textured-leaves PPMs (seeds
    SEED0 + 2, SEED0 + 3): mbt2018-mean and bmshj2018-hyperprior at q4
    (N=128, M=192) from port checkpoints of their trained weights, on the
    CPU (``--device cpu``) and on the card, the reports within ZOO_CLI_BPP
    and ZOO_CLI_PSNR of each other; the flagship at its synthetic weights
    on the card. Beside the card's runs, ``update_model`` on the
    mbt2018-mean checkpoint: the file it writes reloads and codes the
    card's bytes of the first image as the model it was made from.

    The CPU runs take minutes (the CPU's rows chain is the conv kernel's
    plain version), so the smoke starts them (``start``) right after the
    build, at the lowest priority with ZOO_CLI_THREADS threads, while the
    card works through the earlier phases; ``finish`` (in the zoo phase)
    runs the rest and reads them. ``close`` stops every process still
    running and removes the files."""

    def __init__(self, dev):
        import tempfile

        from flashgmm_tpu_torch.datasets import save_image, textured_leaves
        from flashgmm_tpu_torch.utils.checkpoint import save_checkpoint
        from flashgmm_tpu_torch.zoo import image_models

        self.dev = dev
        self._tmp = tempfile.TemporaryDirectory()
        self.root = Path(self._tmp.name)
        (self.root / "images").mkdir()
        for seed in (SEED0 + 2, SEED0 + 3):
            save_image(self.root / "images" / f"leaves_{seed}.ppm",
                       textured_leaves(H, W, seed=seed))
        self.runs = [(arch, q, widths) for arch, q, widths in ZOO_CLI]
        self.runs.append(("cheng2020-anchor-checkerboard-gmm", 5,
                          ("-N", str(N), "-K", str(K))))
        for arch, q, _ in self.runs:
            m = image_models(arch, q, pretrained=True, device=dev)
            save_checkpoint(self.root / f"{arch}-q{q}", m)
            del m
        self.cpu_runs = {}
        self.card_runs = []

    def _start(self, arch, q, widths, device, threads=None):
        import os

        env = dict(os.environ)
        cmd = [sys.executable, "-m", "flashgmm_tpu_torch.utils.eval_model",
               "checkpoint", str(self.root / "images"), "-a", arch, *widths,
               "-p", str(self.root / f"{arch}-q{q}"), "--real", "--device",
               device]
        if threads:
            env["OMP_NUM_THREADS"] = str(threads)
            cmd = ["nice", "-n", "19"] + cmd
        return subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    def start(self):
        self.t0 = time.perf_counter()
        self.cpu_runs = {arch: self._start(arch, q, widths, "cpu", threads=n)
                         for (arch, q, widths), n in zip(ZOO_CLI,
                                                         ZOO_CLI_THREADS)}
        return self

    def finish(self, smi_line, meanwhile):
        """The card's runs and update_model side by side, ``meanwhile()``,
        then the CPU runs' reports held against the card's. Returns the
        seconds from the CPU runs' start to the end of the last one's
        wait."""
        import numpy as np
        import torch

        from flashgmm_tpu_torch.datasets import textured_leaves
        from flashgmm_tpu_torch.models import MeanScaleHyperprior
        from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint
        from flashgmm_tpu_torch.zoo import image_models

        dev = self.dev
        # the card's runs and update_model side by side (the reports' bpp,
        # PSNR and MS-SSIM do not depend on it; their host times may)
        procs = {arch: self._start(arch, q, widths, "cuda")
                 for arch, q, widths in self.runs}
        src = self.root / "mbt2018-mean-q4"
        up = subprocess.Popen(
            [sys.executable, "-m", "flashgmm_tpu_torch.utils.update_model",
             str(src), "-a", "mbt2018-mean", "-N", "128", "-M", "192"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self.card_runs = [*procs.values(), up]
        card = {}
        for arch, q, _ in self.runs:
            card[arch] = _cli_report(procs[arch], f"{arch}, card", 600)
            print(f"  zoo eval CLI {arch} q{q} on the card, beside the other "
                  f"card runs ({smi_line}): " + json.dumps(card[arch]),
                  flush=True)

        # update_model once; the file reloads and codes the same bytes
        out, err = up.communicate(timeout=600)
        require(up.returncode == 0, f"zoo: update_model exited "
                f"{up.returncode}: {err[-1500:]}")
        written = Path(out.strip().rsplit(" ", 1)[-1])
        require(written.exists() and written.name.startswith(
            "mbt2018-mean-q4-"), f"zoo: update_model wrote {written}")
        fresh = MeanScaleHyperprior(128, 192, seed=1, device=dev).eval()
        load_checkpoint(written, fresh)
        made = image_models("mbt2018-mean", 4, pretrained=True,
                            device=dev).eval()
        made.update(force=True, update_quantiles=True)
        x = torch.from_numpy(textured_leaves(H, W, seed=SEED0 + 2)[None])
        a, b = made.compress(x.to(dev)), fresh.compress(x.to(dev))
        require(a["strings"] == b["strings"], "zoo: the updated checkpoint "
                "codes other bytes than its model")
        n_bytes = sum(len(s) for group in a["strings"] for s in group)
        print(f"  zoo update_model: {written.name} reloads and codes the "
              f"first image's {n_bytes} bytes as its model", flush=True)
        del fresh, made
        meanwhile()

        for arch, q, _ in ZOO_CLI:
            cpu = _cli_report(self.cpu_runs[arch], f"{arch}, CPU", 1000)
            c, g = cpu["results"], card[arch]["results"]
            rel = abs(g["bpp"] / c["bpp"] - 1)
            dpsnr = abs(g["psnr-rgb"] - c["psnr-rgb"])
            print(f"  zoo eval CLI {arch} q{q} on the CPU: " + json.dumps(cpu),
                  flush=True)
            print(f"  zoo eval CLI {arch}: card against CPU bpp "
                  f"{100 * rel:.4f} % apart, PSNR {dpsnr:.5f} dB apart",
                  flush=True)
            require(rel <= ZOO_CLI_BPP and dpsnr <= ZOO_CLI_PSNR,
                    f"zoo: the eval CLI's {arch} report on the card is not "
                    "the CPU's")
            require(np.isfinite(g["ms-ssim-rgb"]), f"zoo: {arch} MS-SSIM")
        return time.perf_counter() - self.t0

    def close(self):
        for proc in [*self.cpu_runs.values(), *self.card_runs]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self._tmp.cleanup()


@contextmanager
def raster_loop_seconds():
    """Yields a one-entry list to which the raster scan's host loops
    (``rasterscan.raster_scan_encode`` and
    ``raster_scan_decompress_single_stream``) add their seconds while the
    block runs; the caller sets it to 0 where it starts counting."""
    from flashgmm_tpu_torch.runtime import rasterscan

    loop_s = [0.0]
    loops = ("raster_scan_encode", "raster_scan_decompress_single_stream")
    saved = {name: getattr(rasterscan, name) for name in loops}

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                loop_s[0] += time.perf_counter() - t0
        return run

    for name in loops:
        setattr(rasterscan, name, timed(saved[name]))
    try:
        yield loop_s
    finally:
        for name in loops:
            setattr(rasterscan, name, saved[name])


def zoo_phase(dev, record, originals, smi_line, cli, cpu):
    """The CompressAI image-model line (ROADMAP item 12) at its zoo widths
    on the first 768x512 image, and the evaluation CLIs (15a): for each
    coding model of ZOO_CASES, reference-format ``compress`` +
    ``decompress`` with every launch counted from 0 (the f32 conv for each
    rows-chain conv, the Gaussian rows kernel once a direction on the
    search coder, nothing else), decompress's y_hat equal to compress's,
    bytes, bpp and PSNR, compress and decompress ms (host clock, medians of
    REF_REPS after the counted run; the raster scan's host loop apart); the
    search coder's rows kernel at the path's shape against its plain
    version, with its ms, device ms and bound; the port on the CPU
    (``cpu``, a CpuSide) decoding each model's card strings of a ZOO_SMALL
    image to the card's y_hat. Then ``cli.finish`` (a started ``ZooCli``),
    and while its CPU runs go on, sigmoid-cdf's eval forward. Returns
    (launches, recorded calls) summed over the models."""
    import copy
    import statistics

    import torch

    from flashgmm_tpu_torch.ans.gaussian_cdf import gaussian_boundary_rows_plain
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import (Elic2022Chandelier,
                                           SigmoidCDFCompressor)
    from flashgmm_tpu_torch.utils.eval_model.__main__ import _count_bytes
    from flashgmm_tpu_torch.zoo import create_model, image_models

    x1 = torch.from_numpy(textured_leaves(H, W, seed=SEED0 + 1)[None]).to(dev)
    small = torch.from_numpy(textured_leaves(ZOO_SMALL, ZOO_SMALL,
                                             seed=SEED0 + 1)[None])

    def dec_kw(out):
        return {"abs_max": out["abs_max"]} if "abs_max" in out else {}

    zoo_launches, zoo_calls = {}, {}
    with raster_loop_seconds() as loop_s:
        for tag, arch, q, coder in ZOO_CASES:
            kw = {} if coder is None else {"coder": coder}
            if arch == "elic2022-chandelier":
                m = Elic2022Chandelier(N=N, M=ELIC_M, device=dev)
            elif arch in ZOO_TRAINED:
                m = image_models(arch, q, pretrained=True, device=dev, **kw)
            else:
                m = create_model(arch, q, device=dev, **kw)
            m.eval().update(force=True,
                            update_quantiles=arch not in ZOO_TRAINED)

            def run(m=m):
                torch.cuda.synchronize()
                loop_s[0] = 0.0
                t0 = time.perf_counter()
                out = m.compress(x1)
                torch.cuda.synchronize()
                t1, l1 = time.perf_counter(), loop_s[0]
                dec = m.decompress(out["strings"], out["shape"],
                                   **dec_kw(out))
                torch.cuda.synchronize()
                return (out, dec["x_hat"], t1 - t0, time.perf_counter() - t1,
                        l1, loop_s[0] - l1)

            (out, x_hat, *_), launches, calls = record(run)
            want = dict.fromkeys(launches, 0)
            want.update(conv2d_nhwc=2 * ZOO_ROWS_CONVS[arch],
                        gaussian_boundary_rows=2 if coder == "search" else 0)
            require(launches == want, f"zoo {tag}: launches {launches}, not "
                    f"{want}")
            for name, n in launches.items():
                zoo_launches[name] = zoo_launches.get(name, 0) + n
                zoo_calls.setdefault(name, []).extend(calls[name])
            strings, shape = out["strings"], out["shape"]
            y_dec = m.decompress_y(strings, shape, **dec_kw(out))
            require(torch.equal(y_dec, out["y_hat"]),
                    f"zoo {tag}: decompress's y_hat differs from compress's")
            require(tuple(x_hat.shape) == tuple(x1.shape)
                    and bool(torch.isfinite(x_hat).all()), f"zoo {tag}: x_hat")
            for args, kwargs in calls["gaussian_boundary_rows"]:
                got = originals["gaussian_boundary_rows"](*args, **kwargs)
                ref = gaussian_boundary_rows_plain(*args, **kwargs)
                n_diff = int((got != ref).sum())
                ms = cuda_ms(lambda: originals["gaussian_boundary_rows"](
                    *args, **kwargs), 20)
                dev_ms = cuda_ms(lambda: originals["gaussian_boundary_rows"](
                    *args, **kwargs), 20, True)
                bound = 1e3 * (2 * got.numel() + 4 * got.shape[0]) \
                    / HBM_BYTES_PER_S
                print(f"  zoo {tag}: Gaussian rows [{got.shape[0]}, "
                      f"{got.shape[1]}] mode {args[3]}: {n_diff} of "
                      f"{got.numel()} entries differ from plain; kernel "
                      f"{ms:.4f} ms, device {dev_ms:.4f} ms, bound "
                      f"{bound:.4f} ms (bytes)", flush=True)
                require(n_diff == 0, f"zoo {tag}: the Gaussian rows kernel "
                        "differs from its plain version")
            n_bytes = _count_bytes(strings)
            reps = [run()[2:] for _ in range(REF_REPS)]
            t_c, t_d, l_c, l_d = (statistics.median(r[i] for r in reps)
                                  for i in range(4))
            # the card's strings of a small image, decoded on the CPU
            s_out = m.compress(small.to(dev))

            def then(same, dt, tag=tag):
                require(same, f"zoo {tag}: the port on the CPU decodes the "
                        f"card's strings of a {ZOO_SMALL}x{ZOO_SMALL} image "
                        "to another y_hat")
                print(f"  zoo {tag}: the card's strings of a {ZOO_SMALL}x"
                      f"{ZOO_SMALL} image decoded on the CPU to the card's "
                      f"y_hat ({dt:.1f} s)", flush=True)
            cpu.submit(_cpu_y_equal, (
                copy.deepcopy(m).cpu(), s_out["strings"], s_out["shape"],
                dec_kw(s_out), s_out["y_hat"].cpu()), then)
            loop = (f" (host loop {1e3 * l_c:.2f} ms)" if l_c else "",
                    f" (host loop {1e3 * l_d:.2f} ms)" if l_d else "")
            print(f"  zoo {tag}: y_hat {list(out['y_hat'].shape)} exact "
                  f"through {n_bytes} bytes, {8 * n_bytes / (H * W):.4f} bpp, "
                  f"PSNR {psnr_of(x_hat, x1):.4f} dB; compress "
                  f"{1e3 * t_c:.2f} ms{loop[0]}, decompress {1e3 * t_d:.2f} "
                  f"ms{loop[1]} (host clock, medians of {REF_REPS}, "
                  f"{smi_line}); launches: conv2d_nhwc "
                  f"{launches['conv2d_nhwc']}, gaussian_boundary_rows "
                  f"{launches['gaussian_boundary_rows']}", flush=True)
            del m

    def meanwhile():
        sig = SigmoidCDFCompressor(N=N, K=K, device=dev).eval()
        out = sig(x1, training=False)
        require(all(bool(torch.isfinite(v).all()) for v in
                    [out["x_hat"], *out["likelihoods"].values()]),
                "zoo sigmoid-cdf: the eval forward is not finite")
        bpp = sum(float(torch.sum(-torch.log2(v)))
                  for v in out["likelihoods"].values()) / (H * W)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fwd = []
        for _ in range(REF_REPS):
            a.record()
            sig(x1, training=False)
            b.record()
            torch.cuda.synchronize()
            fwd.append(a.elapsed_time(b))
        print(f"  zoo sigmoid-cdf N={N} K={K} (seed-initialised): eval "
              f"forward {statistics.median(fwd):.2f} ms (CUDA events, median "
              f"of {REF_REPS}, beside the CPU runs), estimated {bpp:.4f} bpp, "
              f"PSNR {psnr_of(out['x_hat'].clamp(0, 1), x1):.4f} dB",
              flush=True)

    t_cli = cli.finish(smi_line, meanwhile)
    phase("zoo", f"the image-model line at its zoo widths; the eval CLI on "
          f"the card and the CPU (the CPU runs {t_cli:.2f} s from their "
          "start after the build)")
    return zoo_launches, zoo_calls


def _vbr_symbols(model, out, s, inputscale=0):
    """The integer y symbols that a hyperprior VBR model's ``out`` decodes
    to on its device, as a CPU tensor."""
    scale = model._get_scale(s, inputscale)
    params = model._vbr_side_params(out["strings"][1], out["shape"],
                                    model._z_qs(scale))
    gc = model.gaussian_conditional
    return gc.decompress(out["strings"][0], gc.build_indexes(
        model._split(params)[0] * scale)).cpu()


def conv_work(x, w, b=None, residual=None):
    """(bytes, float32 operations) of one rows-chain conv call. Masked taps
    and a transposed conv's inserted zeros are not work: such a conv reads
    its input's values alone, each with every tap."""
    import torch

    s = inserted_stride(x)
    x_in = x[:, ::s, ::s]
    n_px = x_in.shape[0] * x_in.shape[1] * x_in.shape[2]
    n_out = x.shape[0] * x.shape[1] * x.shape[2] * w.shape[3]
    return (4 * (x_in.numel() + w.numel() + n_out
                 + (0 if b is None else b.numel())
                 + (0 if residual is None else residual.numel())),
            2 * n_px * int(torch.count_nonzero(w)))


def conv_check(kernel, args, kwargs, tag):
    """One rows-chain conv call against its plain version (the number of
    outputs that differ must be 0), its ms back to back (CUDA events) and
    its bound; printed."""
    from flashgmm_tpu_torch.ops import conv_kernel

    x, w, _ = args
    got = kernel(*args, **kwargs)
    ref = conv_kernel.conv2d_nhwc_plain(*args, **kwargs)
    n_diff = int((got != ref).sum())
    s = inserted_stride(x)
    nbytes, flops = conv_work(*args, kwargs.get("residual"))
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    ms = cuda_ms(lambda: kernel(*args, **kwargs), 20)
    print(f"  {tag}: conv {'x'.join(map(str, x.shape[:3]))} "
          f"{w.shape[2]}->{w.shape[3]} k{w.shape[0]}"
          f"{' (zero-inserted, stride %d)' % s if s > 1 else ''}: {n_diff} of "
          f"{got.numel()} outputs differ from plain; kernel {ms:.4f} ms, "
          f"bound {max(t_b, t_o):.4f} ms "
          f"({'bytes' if t_b >= t_o else 'operations'})", flush=True)
    require(n_diff == 0, f"{tag}: the rows-chain conv differs from its plain "
            "version")


def vbr_phase(dev, record, originals, smi_line, cpu):
    """The variable-bitrate models (ROADMAP item 13) on the two 768x512
    images of the JAX package's sweep (textured leaves, VBR_SEEDS):
    1. the shipped mbt2018-mean-vbr (``image_models(..., pretrained=True)``,
       N=192, M=320, the variable-step bottleneck) at each gain s = 0..7:
       ``update(force=True, scale=...)``, then (after one warm-up round
       trip) compress + decompress of both images with every launch
       counted from 0 (the rows-chain conv 3
       times a direction an image, nothing else): z step, bytes, bpp, PSNR,
       MS-SSIM, compress and decompress ms (host clock), every decode's
       y_hat equal to the encoder's; bpp at least 0.98 x the previous
       level's and PSNR at s=7 above s=0 (tools/vbr_sweep.py's asserts);
       each level's difference from results/synthetic/vbr_sweep.json (read
       only; a report); and ``inputscale`` VBR_INPUTSCALE, whose bpp must
       lie between gains 4's and 5's;
    2. the rows-chain conv against its plain version at the path's h_s
       shapes (N->M and M->3M/2 transposed, 3M/2->2M), 0 outputs differing;
    3. bmshj2018-hyperprior-vbr and mbt2018-vbr (192, 320), seed-initialised
       (VBR_SEEDED levels), the same line a level, the raster scan's host
       loop apart;
    4. at s=7 each model's card strings of a VBR_SMALL^2 image decoded on
       the CPU by a CPU copy (``cpu``, a CpuSide): the same y symbols
       (mbt2018-vbr: the same y_hat, its offsets run on the host), the
       hyperprior models' max |y_hat difference| printed (their offsets
       run on each device);
    5. VBR_TRAIN_STEPS ``vbr_train_step``s of the shipped model on 8 random
       256x256 crops of the two images, s cycling 0..7 at ``VBR_LMBDAS[s]``,
       cuDNN TF32 on and its autotuning off (the first step's autotuning
       alone took 22-39 s in the train phase): every loss finite, Gain
       unchanged, g_a's first weight moved; the median step ms and the
       peak memory.
    Returns (launches, recorded calls) of the coding runs."""
    import copy
    import random
    import statistics

    import numpy as np
    import torch

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.datasets.image import random_crop
    from flashgmm_tpu_torch.models.vbr import VBR_LMBDAS
    from flashgmm_tpu_torch.parallel import make_train_state, vbr_train_step
    from flashgmm_tpu_torch.utils.eval_model.__main__ import _count_bytes
    from flashgmm_tpu_torch.utils.metrics import ms_ssim
    from flashgmm_tpu_torch.zoo import create_model, image_models

    imgs = [textured_leaves(H, W, seed=seed) for seed in VBR_SEEDS]
    xs = [torch.from_numpy(img[None]).to(dev) for img in imgs]
    small = torch.from_numpy(textured_leaves(VBR_SMALL, VBR_SMALL,
                                             seed=VBR_SEEDS[0])[None])
    jax_record = json.loads(VBR_RECORD.read_text())["results"]
    vbr_launches, vbr_calls = {}, {}

    def level(tag, m, s, loop_s, inputscale=0):
        """One gain level of ``m`` on both images: its printed line's
        numbers, and the level's recorded calls."""
        scale = m._get_scale(s, inputscale)
        m.update(force=True, scale=scale)
        qs = m._z_qs(scale)

        def run():
            res = []
            for x in xs:
                torch.cuda.synchronize()
                loop_s[0] = 0.0
                t0 = time.perf_counter()
                out = m.compress(x, s=s, inputscale=inputscale)
                torch.cuda.synchronize()
                t1, l1 = time.perf_counter(), loop_s[0]
                x_hat = m.decompress(out["strings"], out["shape"], s=s,
                                     inputscale=inputscale)["x_hat"]
                torch.cuda.synchronize()
                res.append((out, x_hat, t1 - t0, time.perf_counter() - t1,
                            l1, loop_s[0] - l1))
            return res

        res, launches, calls = record(run)
        want = dict.fromkeys(launches, 0)
        want["conv2d_nhwc"] = 2 * len(xs) * VBR_ROWS_CONVS
        require(launches == want, f"vbr {tag} s={s}: launches {launches}, "
                f"not {want}")
        for name, n in launches.items():
            vbr_launches[name] = vbr_launches.get(name, 0) + n
            vbr_calls.setdefault(name, []).extend(calls[name])
        n_bytes, psnrs, ssims = [], [], []
        for (out, x_hat, *_), x in zip(res, xs):
            y_dec = m.decompress_y(out["strings"], out["shape"], s=s,
                                   inputscale=inputscale)
            require(torch.equal(y_dec, out["y_hat"]), f"vbr {tag} s={s}: "
                    "decompress's y_hat differs from compress's")
            require(tuple(x_hat.shape) == tuple(x.shape)
                    and bool(torch.isfinite(x_hat).all()),
                    f"vbr {tag} s={s}: x_hat")
            n_bytes.append(_count_bytes(out["strings"]))
            psnrs.append(psnr_of(x_hat, x))
            ssims.append(float(ms_ssim(x, x_hat)))
        lv = {"bpp": 8 * float(np.mean(n_bytes)) / (H * W),
              "psnr": float(np.mean(psnrs)), "ms-ssim": float(np.mean(ssims))}
        t_c, t_d, l_c, l_d = (1e3 * float(np.mean([r[i] for r in res]))
                              for i in range(2, 6))
        loop = (f" (host loop {l_c:.2f} ms)" if l_c else "",
                f" (host loop {l_d:.2f} ms)" if l_d else "")
        at = f"inputscale {inputscale}" if inputscale else f"s={s}"
        print(f"  vbr {tag} {at}: gain {float(scale):.6g}, z step "
              f"{'1 (fixed)' if qs is None else repr(qs)}; {n_bytes} bytes, "
              f"{lv['bpp']:.4f} bpp, PSNR {lv['psnr']:.4f} dB, MS-SSIM "
              f"{lv['ms-ssim']:.5f}; y_hat exact; compress {t_c:.2f} ms"
              f"{loop[0]}, decompress {t_d:.2f} ms{loop[1]} (host clock, an "
              f"image, {smi_line}); launches: conv2d_nhwc "
              f"{launches['conv2d_nhwc']}", flush=True)
        if s == 7 and not inputscale:  # 4. queued for the CPU
            on_cpu(tag, m, s, m.compress(small.to(dev), s=s))
        return lv, calls

    def on_cpu(tag, m, s, out):
        """The card's strings ``out`` of the small image, decoded by a CPU
        copy of ``m`` in the CpuSide process."""
        cpu_model = copy.deepcopy(m).cpu()
        y_card = out["y_hat"].cpu()
        what = f"vbr {tag} s={s}: the card's strings of a {VBR_SMALL}x" \
               f"{VBR_SMALL} image decoded on the CPU to"
        if hasattr(m, "scale_to_context"):  # mbt2018-vbr
            def then(same, dt):
                require(same, f"vbr {tag}: the CPU decodes the card's "
                        "strings to another y_hat")
                print(f"  {what} the card's y_hat bit for bit ({dt:.1f} s)",
                      flush=True)
            cpu.submit(_cpu_y_equal, (cpu_model, out["strings"], out["shape"],
                                      {"s": s}, y_card), then)
            return

        def then(result, dt):
            same, gap = result
            require(same, f"vbr {tag}: the CPU decodes the card's strings "
                    "to other symbols")
            print(f"  {what} the card's symbols, max |y_hat difference| "
                  f"{gap:.3g} ({dt:.1f} s)", flush=True)
        cpu.submit(_cpu_vbr_symbols, (
            cpu_model, {"strings": out["strings"], "shape": out["shape"]}, s,
            _vbr_symbols(m, out, s), y_card), then)

    with raster_loop_seconds() as loop_s:
        # 1. the shipped model over its 8 gains
        tag = "mbt2018-mean-vbr (shipped)"
        m = image_models("mbt2018-mean-vbr", 1, pretrained=True,
                         device=dev).eval()
        require(m.vr_entbttlnck, "vbr: the zoo's VBR model lacks the "
                "variable-step bottleneck")
        # a warm-up round trip (cuDNN's first calls), outside the counts
        m.update(force=True, scale=m._get_scale(0))
        out = m.compress(xs[0], s=0)
        m.decompress(out["strings"], out["shape"], s=0)
        sweep = []
        for s in range(m.levels):
            lv, calls = level(tag, m, s, loop_s)
            sweep.append(lv)
            d_bpp = 100 * (lv["bpp"] / jax_record["bpp"][s] - 1)
            d_psnr = lv["psnr"] - jax_record["psnr-rgb"][s]
            print(f"  vbr {tag} s={s} against results/synthetic/"
                  f"vbr_sweep.json ({jax_record['bpp'][s]:.4f} bpp, "
                  f"{jax_record['psnr-rgb'][s]:.4f} dB): bpp {d_bpp:+.3f} %, "
                  f"PSNR {d_psnr:+.4f} dB", flush=True)
            if s == 0:  # 2. the rows-chain conv at the path's h_s shapes
                for args, kwargs in calls["conv2d_nhwc"][:VBR_ROWS_CONVS]:
                    conv_check(originals["conv2d_nhwc"], args, kwargs,
                               f"vbr {tag} h_s")
        bpps = [lv["bpp"] for lv in sweep]
        require(all(b2 >= 0.98 * b1 for b1, b2 in zip(bpps, bpps[1:])),
                f"vbr: the rate is not monotone across the gains: {bpps}")
        require(sweep[-1]["psnr"] > sweep[0]["psnr"],
                "vbr: PSNR at s=7 is not above s=0's")
        mid, _ = level(tag, m, 1, loop_s, inputscale=VBR_INPUTSCALE)
        require(bpps[4] < mid["bpp"] < bpps[5], f"vbr: inputscale "
                f"{VBR_INPUTSCALE} gives {mid['bpp']:.4f} bpp, not between "
                f"gains 4 and 5 ({bpps[4]:.4f}, {bpps[5]:.4f})")
        del m

        # 3. the seed-initialised models
        for arch, levels in VBR_SEEDED:
            m = create_model(arch, 1, device=dev).eval()
            for s in levels:
                level(f"{arch} (seed 0)", m, s, loop_s)
            del m

    # 5. training steps of the shipped model
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.benchmark)
    try:
        cudnn.allow_tf32, cudnn.benchmark = True, False
        random.seed(VBR_SEEDS[0])
        batch = torch.from_numpy(np.stack([
            random_crop(imgs[i % len(imgs)], TRAIN_PATCH)
            for i in range(TRAIN_BATCH)])).to(dev)
        with torch.inference_mode(False):
            batch = batch.clone()
            m = image_models("mbt2018-mean-vbr", 1, pretrained=True,
                             device=dev)
            opts = make_train_state(m, TRAIN_LR, TRAIN_AUX_LR, 1.0)
            gen = torch.Generator(device=dev).manual_seed(VBR_SEEDS[0])
            gain0 = m.Gain.detach().clone()
            w0 = m.g_a.layers[0].weight.detach().clone()
            torch.cuda.reset_peak_memory_stats()
            losses, step_ms = [], []
            for i in range(VBR_TRAIN_STEPS):
                s = i % m.levels
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                out = vbr_train_step(m, *opts, batch, gen, s, VBR_LMBDAS[s])
                b.record()
                torch.cuda.synchronize()
                step_ms.append(a.elapsed_time(b))
                losses.append((s, float(out["loss"])))
                require(all(np.isfinite(float(v)) for v in out.values()),
                        f"vbr train: step {i + 1} (s={s}): {out}")
            peak = torch.cuda.max_memory_allocated()
            require(torch.equal(m.Gain.detach(), gain0),
                    "vbr train: a step moved Gain")
            require(not torch.equal(m.g_a.layers[0].weight.detach(), w0),
                    "vbr train: g_a's first weight did not move")
    finally:
        cudnn.allow_tf32, cudnn.benchmark = saved
    print(f"  vbr train mbt2018-mean-vbr (shipped), batch {TRAIN_BATCH} x "
          f"{TRAIN_PATCH}^2, cuDNN TF32 on, autotuning off: losses (s, loss) "
          f"{[(s, round(v, 4)) for s, v in losses]}, all finite; Gain "
          f"unchanged, g_a moved; step {statistics.median(step_ms):.3f} ms "
          f"(median of {VBR_TRAIN_STEPS}, CUDA events; the first "
          f"{step_ms[0]:.1f}), peak {peak / 2 ** 30:.2f} GiB ({smi_line})",
          flush=True)
    phase("vbr", "the shipped mbt2018-mean-vbr over its 8 gains, the "
          "seed-initialised VBR models, card strings queued for the CPU, "
          "vbr_train_step")
    return vbr_launches, vbr_calls


def _panned_frames(h, w, n, seed):
    """n frames [h, w, 3] of one textured-leaves still panned by (i, 2i)
    pixels, frame i (tools/train_video_artifact.py makes its clips so)."""
    from flashgmm_tpu_torch.datasets import textured_leaves

    big = textured_leaves(h + n, w + 2 * n, seed=seed)
    return [big[i:i + h, 2 * i:2 * i + w] for i in range(n)]


def _yuv420_bytes(rgb):
    """8-bit 4:2:0 planes (BT.601 full range, chroma averaged 2x2) of an RGB
    frame [H, W, 3] in [0, 1], in the raw file's order Y, U, V."""
    import numpy as np

    r, g, b = np.moveaxis(rgb.astype(np.float64), -1, 0)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    h, w = y.shape
    planes = [y] + [c.reshape(h // 2, 2, w // 2, 2).mean((1, 3)) for c in
                    (0.5 * (b - y) / (1 - 0.114) + 0.5,
                     0.5 * (r - y) / (1 - 0.299) + 0.5)]
    return b"".join(np.clip(np.round(p * 255), 0, 255).astype(np.uint8)
                    .tobytes() for p in planes)


def video_phase(dev, record, smi_line, cpu):
    """Scale-space flow video, ssf2020 (ROADMAP item 14a), while the zoo
    phase's CPU runs go on:
    1. the video eval CLI (``python -m flashgmm_tpu_torch.utils.video.
       eval_model --real``, its ``main`` in this process, on the card: a
       seed-initialised ssf2020 with its quantiles updated) over a raw
       8-bit 4:2:0 file ``*_1920x1080_30fps_420_8bit.yuv`` of
       VIDEO_CLI_FRAMES panned textured-leaves frames in a temporary
       directory, one GOP: once on 2 frames to warm up, then counted: the
       rows-chain conv VIDEO_ROWS_CONVS times a hyperprior a direction
       (the keyframe's one, two an inter frame), nothing else; the report's
       encode and decode ms a frame, bpp, PSNR and MS-SSIM
       (``chip_profile.py --video`` breaks a frame's time down);
    2. ssf2020 from a ``torch.Generator`` (VIDEO_SEED) with
       ``update(update_quantiles=True)``: compress/decompress of a
       VIDEO_GOP-frame GOP at VIDEO_SIDE^2 on the card, launches counted as
       in 1: the decoded frames equal the encoder's reconstructions and
       the decoder's y_hat of every branch the encoder's, bit for bit (the
       timing phase holds the rows-chain conv to its plain version at each
       of the path's shapes); a CPU copy of the model (``cpu``, a CpuSide)
       decodes the card's strings to every branch's y_hat bit for bit and
       to frames within VIDEO_CPU_ATOL;
    3. VIDEO_TRAIN_STEPS ``video_train_step``s of a seed-initialised model
       on one batch of VIDEO_TRAIN_BATCH random 256x256 crops of panned
       clips, GOP 3, lambda VIDEO_LMBDA, cuDNN TF32 on and its autotuning
       off: every term finite, the parameters moved; the median step ms and
       the peak memory.
    Returns (launches, recorded calls) of the counted coding runs."""
    import contextlib
    import copy
    import io
    import random
    import statistics
    import tempfile

    import numpy as np
    import torch

    from flashgmm_tpu_torch.models.video import ScaleSpaceFlow
    from flashgmm_tpu_torch.parallel import make_train_state, video_train_step
    from flashgmm_tpu_torch.utils.video.eval_model.__main__ import (
        _count, main as video_cli)

    video_launches, video_calls = {}, {}
    model = ScaleSpaceFlow(generator=torch.Generator().manual_seed(
        VIDEO_SEED), device=dev).eval()
    model.update(update_quantiles=True)

    def counted(tag, run, n_hyperpriors):
        result, launches, calls = record(run)
        want = dict.fromkeys(launches, 0)
        want["conv2d_nhwc"] = 2 * VIDEO_ROWS_CONVS * n_hyperpriors
        require(launches == want, f"video {tag}: launches {launches}, not "
                f"{want}")
        for name, n in launches.items():
            video_launches[name] = video_launches.get(name, 0) + n
            video_calls.setdefault(name, []).extend(calls[name])
        return result, launches, calls

    # 1. the eval CLI on the card
    with tempfile.TemporaryDirectory() as d:
        seq = Path(d) / (f"leaves_{VIDEO_CLI_W}x{VIDEO_CLI_H}_30fps_420_"
                         "8bit.yuv")
        seq.write_bytes(b"".join(_yuv420_bytes(f) for f in _panned_frames(
            VIDEO_CLI_H, VIDEO_CLI_W, VIDEO_CLI_FRAMES, VIDEO_SEED)))

        def cli(n_frames):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = video_cli([str(seq), "-f", str(n_frames), "--gop",
                                str(n_frames), "--real", "--device", "cuda"])
            require(rc == 0, f"video eval CLI: exit code {rc}")
            return json.loads(buf.getvalue())

        cli(2)  # warm-up: cuDNN's first calls at these shapes
        report, launches, _ = counted(
            "eval CLI", lambda: cli(VIDEO_CLI_FRAMES),
            2 * VIDEO_CLI_FRAMES - 1)
    res = report["results"]
    require(all(np.isfinite(v) for v in res.values()),
            f"video eval CLI: {res}")
    print(f"  video eval CLI ssf2020 --real on the card, {VIDEO_CLI_W}x"
          f"{VIDEO_CLI_H} 8-bit 4:2:0 (padded to a multiple of 128), "
          f"{VIDEO_CLI_FRAMES} frames, one GOP: encode "
          f"{1e3 * res['enc_time_per_frame']:.2f} ms, decode "
          f"{1e3 * res['dec_time_per_frame']:.2f} ms a frame (host clock, "
          f"{smi_line}); {res['bpp']:.5f} bpp, PSNR RGB "
          f"{res['psnr-rgb']:.4f} dB, YUV {res['psnr-yuv']:.4f} dB, MS-SSIM "
          f"{res['ms-ssim-rgb']:.5f}; launches: conv2d_nhwc "
          f"{launches['conv2d_nhwc']}", flush=True)

    # 2. a GOP coded on the card, decoded on the card and on the CPU
    frames = [torch.from_numpy(f[None].copy()).to(dev) for f in
              _panned_frames(VIDEO_SIDE, VIDEO_SIDE, VIDEO_GOP,
                             VIDEO_SEED + 1)]

    def gop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strings, shapes, details = model.compress(frames, details=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec, dec_details = model.decompress(strings, shapes, details=True)
        torch.cuda.synchronize()
        return (strings, shapes, details, dec, dec_details["y_hat"], t1 - t0,
                time.perf_counter() - t1)

    (strings, shapes, details, dec, y_card, t_c, t_d), _, _ = counted(
        f"GOP {VIDEO_SIDE}^2", gop, 2 * VIDEO_GOP - 1)
    for i, (got, want) in enumerate(zip(dec, details["x_hat"])):
        require(torch.equal(got, want), f"video GOP: frame {i} decodes to "
                "another frame than the encoder's reconstruction")
    for i, (got, enc) in enumerate(zip(y_card, details["y_hat"])):
        for branch in enc:
            require(torch.equal(got[branch], enc[branch]), f"video GOP: "
                    f"frame {i} {branch} y_hat differs from the encoder's")
    n_bytes = _count(strings)
    psnrs = [psnr_of(torch.clamp(x_hat, 0, 1), x)
             for x_hat, x in zip(dec, frames)]
    print(f"  video GOP ssf2020 (seed {VIDEO_SEED}), {VIDEO_GOP} frames "
          f"{VIDEO_SIDE}x{VIDEO_SIDE}: decoded frames equal the encoder's "
          f"reconstructions, every branch's y_hat exact; {n_bytes} bytes, "
          f"{8 * n_bytes / (VIDEO_GOP * VIDEO_SIDE ** 2):.4f} bpp, PSNR a "
          f"frame {[round(p, 4) for p in psnrs]} dB; compress "
          f"{1e3 * t_c:.2f} ms, decompress {1e3 * t_d:.2f} ms (host clock)",
          flush=True)

    def then(result, dt):
        wrong, gap = result
        require(not wrong, f"video: the CPU decodes the strings of (frame, "
                f"branch) {wrong} to another y_hat")
        require(gap <= VIDEO_CPU_ATOL, f"video: the CPU's frames {gap:.3g} "
                "from the card's")
        print(f"  video GOP ssf2020: the card's strings decoded on the CPU to "
              f"every branch's y_hat bit for bit, frames max |difference| "
              f"{gap:.3g} ({dt:.1f} s)", flush=True)
    cpu.submit(_cpu_video_decode, (
        copy.deepcopy(model).cpu(), strings, shapes,
        [{b: t.cpu() for b, t in y.items()} for y in y_card],
        [f.cpu() for f in dec]), then)
    del model

    # 3. training steps
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.benchmark)
    try:
        cudnn.allow_tf32, cudnn.benchmark = True, False
        random.seed(VIDEO_SEED)
        clips = [_panned_frames(TRAIN_PATCH + 64, TRAIN_PATCH + 64, 3,
                                VIDEO_SEED + 2 + b)
                 for b in range(VIDEO_TRAIN_BATCH)]
        crops = []
        for clip in clips:  # one random crop a clip, the same in its frames
            top = random.randint(0, 64)
            left = random.randint(0, 64)
            crops.append([f[top:top + TRAIN_PATCH, left:left + TRAIN_PATCH]
                          for f in clip])
        with torch.inference_mode(False):
            batch = [torch.from_numpy(np.stack([c[t] for c in crops])).to(dev)
                     for t in range(3)]
            m = ScaleSpaceFlow(seed=VIDEO_SEED, device=dev)
            opts = make_train_state(m, TRAIN_LR, TRAIN_AUX_LR, 1.0)
            gen = torch.Generator(device=dev).manual_seed(VIDEO_SEED)
            w0 = m.res_decoder.layers[0].weight.detach().clone()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            losses, step_ms = [], []
            for i in range(VIDEO_TRAIN_STEPS):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                out = video_train_step(m, *opts, batch, gen, VIDEO_LMBDA)
                b.record()
                torch.cuda.synchronize()
                step_ms.append(a.elapsed_time(b))
                losses.append(float(out["loss"]))
                require(all(np.isfinite(float(v)) for v in out.values()),
                        f"video train: step {i + 1}: {out}")
            peak = torch.cuda.max_memory_allocated()
            require(not torch.equal(m.res_decoder.layers[0].weight.detach(),
                                    w0), "video train: the weights did not "
                    "move")
            del m, opts
    finally:
        cudnn.allow_tf32, cudnn.benchmark = saved
    print(f"  video train ssf2020 (seed {VIDEO_SEED}), batch "
          f"{VIDEO_TRAIN_BATCH} x GOP 3 x {TRAIN_PATCH}^2, lambda "
          f"{VIDEO_LMBDA}, cuDNN TF32 on, autotuning off: losses "
          f"{[round(v, 4) for v in losses]}, all finite, weights moved; step "
          f"{statistics.median(step_ms):.3f} ms (median of "
          f"{VIDEO_TRAIN_STEPS}, CUDA events; the first {step_ms[0]:.1f}), "
          f"peak {peak / 2 ** 30:.2f} GiB, {(peak - before) / 2 ** 30:.2f} "
          f"GiB above what was allocated before the steps ({smi_line})",
          flush=True)
    phase("video", "ssf2020: the eval CLI on the card at "
          f"{VIDEO_CLI_W}x{VIDEO_CLI_H}, a GOP exact on the card and queued "
          "for the CPU, video_train_step")
    return video_launches, video_calls


def synth_cloud(rs, n):
    """One unit-cube point cloud sampled from a random shape surface (a
    copy of tools/train_pointcloud_artifact.py's)."""
    import numpy as np

    kind = rs.randint(3)
    if kind == 0:  # sphere surface
        v = rs.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    elif kind == 1:  # box surface
        v = rs.uniform(-1, 1, size=(n, 3))
        face = rs.randint(3, size=n)
        sign = rs.choice([-1.0, 1.0], size=n)
        v[np.arange(n), face] = sign
    else:  # cylinder surface
        theta = rs.uniform(0, 2 * np.pi, size=n)
        z = rs.uniform(-1, 1, size=n)
        v = np.stack([np.cos(theta), np.sin(theta), z], axis=1)
    # random rotation (QR of a gaussian), anisotropic scale, jitter
    q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
    scale = rs.uniform(0.2, 0.45, size=3)
    v = (v @ q) * scale
    v += rs.normal(scale=0.004, size=v.shape)
    return (v + 0.5 + rs.uniform(-0.04, 0.04, size=3)).clip(0, 1)


def _nbits(obj):
    if isinstance(obj, (bytes, bytearray)):
        return 8 * len(obj)
    return sum(_nbits(o) for o in obj)


def pcc_phase(dev, record, smi_line, cpu):
    """Point-cloud compression (ROADMAP item 14b), while the zoo phase's
    CPU runs go on:
    1. each shipped codec of PCC_SHIPPED from the zoo (``image_models(...,
       pretrained=True)``) with ``update(force=True,
       update_quantiles=True)``, over the PCC_CLOUDS held-out clouds: a
       ``compress`` and two ``decompress``es each, the two decodes equal bit
       for bit, the decoded point count, the mean bpp within PCC_BPP_RTOL
       and the mean chamfer within PCC_CHAMFER_RTOL of the JAX package's
       over the same clouds and weights; none of the port's hand kernels
       launched; the median compress and decompress ms of one cloud over
       PCC_REPS runs (host clock: the host coder is on the path), the
       device events (kernels and copies) and busy ms of each direction
       from a profiler trace, and the farthest-point sampling of one encode
       alone (its ms and device events); the card's strings of the first
       cloud decoded by a CPU copy (``cpu``, a CpuSide) to the card's
       symbols, and the chamfer distance between the two clouds;
    2. the PCC_SEEDED codecs from a ``torch.Generator`` (PCC_SEED): the
       strings of the first cloud decode to the encoder's quantized latent
       bit for bit, and the decoded cloud is finite;
    3. PCC_TRAIN_STEPS ``pointcloud_train_step``s of each PCC_TRAIN codec
       (seed-initialised, the zoo's widths) on one batch of
       PCC_TRAIN_BATCH x PCC_POINTS synthetic clouds: every term finite,
       the parameters moved; the median step ms and the peak memory; then
       the trainer CLI (``python -m flashgmm_tpu_torch.examples.
       train_pointcloud``, its ``main`` in this process) on the card for
       one epoch of 2 steps over PCC_CLI_CLOUDS ``.npy`` clouds, its
       ``latest`` checkpoint loading into a new model.
    Prints the phase's seconds."""
    import contextlib
    import copy
    import io
    import statistics
    import tempfile

    import numpy as np
    import torch

    from flashgmm_tpu_torch.examples.train_pointcloud import \
        main as train_cli
    from flashgmm_tpu_torch.layers import pinned_library_settings
    from flashgmm_tpu_torch.layers.pointcloud import farthest_point_sample
    from flashgmm_tpu_torch.losses import chamfer_distance
    from flashgmm_tpu_torch.parallel import (make_train_state,
                                             pointcloud_train_step)
    from flashgmm_tpu_torch.registry import MODELS
    from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint
    from flashgmm_tpu_torch.zoo import create_model, image_models

    t_start = time.perf_counter()
    rs = np.random.RandomState(PCC_EVAL_SEED)
    clouds = [torch.from_numpy(np.stack([synth_cloud(rs, PCC_POINTS)])
                               .astype(np.float32)).to(dev)
              for _ in range(PCC_CLOUDS)]

    def host_ms(fn):
        times = []
        for _ in range(PCC_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    # 1. the shipped codecs over the held-out clouds ----------------------
    for arch, want_bpp, want_chamfer, n_out in PCC_SHIPPED:
        model = image_models(arch, 1, pretrained=True, device=dev).eval()
        model.update(force=True, update_quantiles=True)

        def code_all():
            outs = []
            for x in clouds:
                c = model.compress(x)
                outs.append((c, model.decompress(c["strings"], c["shape"]),
                             model.decompress(c["strings"], c["shape"])))
            torch.cuda.synchronize()
            return outs

        outs, launches, _ = record(code_all)
        require(not any(launches.values()), f"pcc {arch}: the path launched "
                f"the port's hand kernels: {launches}")
        bpps, chamfers = [], []
        for i, (x, (c, r1, r2)) in enumerate(zip(clouds, outs)):
            require(torch.equal(r1["x_hat"], r2["x_hat"]), f"pcc {arch}: "
                    f"cloud {i} decodes to two different clouds")
            require(tuple(r1["x_hat"].shape) == (1, n_out, 3), f"pcc {arch}: "
                    f"cloud {i} decodes to {tuple(r1['x_hat'].shape)}")
            require(bool(torch.isfinite(r1["x_hat"]).all()),
                    f"pcc {arch}: cloud {i} decodes to non-finite points")
            bpps.append(_nbits(c["strings"]) / PCC_POINTS)
            chamfers.append(float(chamfer_distance(r1["x_hat"], x)))
        bpp, ch = float(np.mean(bpps)), float(np.mean(chamfers))
        require(abs(bpp / want_bpp - 1) <= PCC_BPP_RTOL, f"pcc {arch}: mean "
                f"bpp {bpp} is not within {PCC_BPP_RTOL} of {want_bpp}")
        require(abs(ch / want_chamfer - 1) <= PCC_CHAMFER_RTOL, f"pcc {arch}: "
                f"mean chamfer {ch} is not within {PCC_CHAMFER_RTOL} of "
                f"{want_chamfer}")

        x0, (c0, r0, _) = clouds[0], outs[0]
        enc_ms = host_ms(lambda: model.compress(x0))
        dec_ms = host_ms(lambda: model.decompress(c0["strings"],
                                                  c0["shape"]))
        _, enc_busy, enc_events, _ = device_busy_ms(
            lambda: model.compress(x0))
        _, dec_busy, dec_events, _ = device_busy_ms(
            lambda: model.decompress(c0["strings"], c0["shape"]))
        fps = ""
        if arch == "hrtzxf2022-pcc-rec":
            levels = []
            n = PCC_POINTS
            for layer in model.encoder.layers:
                m = round(n * layer.downsample_rate)
                levels.append((n, m))
                n = m

            def fps_all():
                with pinned_library_settings():
                    pts = x0
                    for _, m in levels:
                        pts = torch.gather(pts, 1, farthest_point_sample(
                            pts, m)[..., None].expand(1, m, 3))
                return pts

            fps_ms = host_ms(fps_all)
            _, fps_busy, fps_events, _ = device_busy_ms(fps_all)
            fps = (f"; FPS alone ({' -> '.join(str(a) for a, _ in levels)} "
                   f"-> {levels[-1][1]}, {sum(m - 1 for _, m in levels)} loop "
                   f"steps): {fps_ms:.3f} ms ({100 * fps_ms / enc_ms:.1f} % of "
                   f"the encode), {fps_events} device events, busy "
                   f"{fps_busy:.3f} ms")
        print(f"  pcc {arch} (the shipped weights), {PCC_CLOUDS} held-out "
              f"clouds of {PCC_POINTS} points: decodes repeatable, "
              f"{n_out} points out, mean {bpp:.8f} bpp (JAX {want_bpp}), "
              f"mean chamfer {ch:.7f} (JAX {want_chamfer}); none of the "
              f"port's hand kernels launched; one cloud: compress "
              f"{enc_ms:.3f} ms, decompress {dec_ms:.3f} ms (medians of "
              f"{PCC_REPS}, host clock, {smi_line}); device events a "
              f"direction: compress {enc_events} (busy {enc_busy:.3f} ms), "
              f"decompress {dec_events} (busy {dec_busy:.3f} ms){fps}",
              flush=True)

        def then(result, dt, arch=arch, n_out=n_out):
            same, gap, rows, total = result
            require(same, f"pcc {arch}: the CPU decodes the card's strings to "
                    "other symbols")
            print(f"  pcc {arch}: the card's strings of cloud 0 decoded on the "
                  f"CPU to the card's symbols; chamfer between the CPU's and "
                  f"the card's cloud {gap:.3g}, {rows} of {total} rows more "
                  f"than 1e-4 apart ({dt:.1f} s)", flush=True)
        cpu.submit(_cpu_pcc_decode, (
            copy.deepcopy(model).cpu(), c0["strings"], c0["shape"],
            [t.cpu() for t in _pcc_symbols(model, c0["strings"],
                                           c0["shape"])],
            r0["x_hat"].cpu()), then)
        del model

    # 2. the seed-initialised codecs --------------------------------------
    for arch in PCC_SEEDED:
        model = MODELS[arch](generator=torch.Generator().manual_seed(
            PCC_SEED), device=dev).eval()
        model.update(force=True, update_quantiles=True)
        x0 = clouds[0]
        c = model.compress(x0)
        with pinned_library_settings():
            y = model._encode_latent(x0)[:, None, None, :]
        eb = model.entropy_bottleneck
        want = eb.quantize(y, "dequantize", eb._medians(tuple(y.shape)))
        (got,) = _pcc_symbols(model, c["strings"], c["shape"])
        require(torch.equal(got, want), f"pcc {arch}: the strings decode to "
                "another latent than the encoder's")
        x_hat = model.decompress(c["strings"], c["shape"])["x_hat"]
        require(tuple(x_hat.shape) == (1, PCC_POINTS, 3)
                and bool(torch.isfinite(x_hat).all()),
                f"pcc {arch}: decoded {tuple(x_hat.shape)}, finite "
                f"{bool(torch.isfinite(x_hat).all())}")
        print(f"  pcc {arch} (seed {PCC_SEED}): the strings of cloud 0 "
              f"({_nbits(c['strings'])} bits) decode to the encoder's "
              "quantized latent bit for bit; the decoded cloud is finite",
              flush=True)
        del model

    # 3. training steps and the trainer CLI -------------------------------
    rs = np.random.RandomState(0)
    batch = torch.from_numpy(np.stack([
        synth_cloud(rs, PCC_POINTS) for _ in range(PCC_TRAIN_BATCH)])
        .astype(np.float32)).to(dev)
    with torch.inference_mode(False):
        batch = batch.clone()
        for arch, loss_type, lmbda in PCC_TRAIN:
            m = create_model(arch, 1, seed=PCC_SEED, device=dev)
            opts = make_train_state(m, 1e-4, 1e-3, 1.0)
            gen = torch.Generator(device=dev).manual_seed(PCC_SEED)
            w0 = [p.detach().clone() for p in m.parameters()]
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            losses, step_ms = [], []
            for i in range(PCC_TRAIN_STEPS):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                out = pointcloud_train_step(m, *opts, batch, gen, loss_type,
                                            lmbda)
                b.record()
                torch.cuda.synchronize()
                step_ms.append(a.elapsed_time(b))
                out = {k: float(v) for k, v in out.items()}
                require(all(np.isfinite(v) for v in out.values()),
                        f"pcc train {arch}: step {i + 1}: {out}")
                losses.append(out["loss"])
            peak = torch.cuda.max_memory_allocated()
            require(any(not torch.equal(p.detach(), q)
                        for p, q in zip(m.parameters(), w0)),
                    f"pcc train {arch}: the weights did not move")
            print(f"  pcc train {arch} ({loss_type} loss, lambda {lmbda}), "
                  f"batch {PCC_TRAIN_BATCH} x {PCC_POINTS} points: losses "
                  f"{[round(v, 4) for v in losses]}, every term finite, "
                  f"weights moved; step {statistics.median(step_ms):.3f} ms "
                  f"(median of {PCC_TRAIN_STEPS}, CUDA events; the first "
                  f"{step_ms[0]:.1f}), peak {peak / 2 ** 30:.3f} GiB, "
                  f"{(peak - before) / 2 ** 30:.3f} GiB above what was "
                  f"allocated before the steps ({smi_line})", flush=True)
            del m, opts

        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            (root / "data" / "train").mkdir(parents=True)
            rs = np.random.RandomState(1)
            for i in range(PCC_CLI_CLOUDS):
                np.save(root / "data" / "train" / f"{i}.npy",
                        synth_cloud(rs, PCC_POINTS + 200).astype(np.float32))
            args = ["-d", str(root / "data"), "--model", "hrtzxf2022-pcc-rec",
                    "-e", "1", "--batch-size", str(PCC_TRAIN_BATCH),
                    "--steps-per-epoch", "2", "--num-workers", "2",
                    "--checkpoint-dir", str(root / "ck"), "--device", "cuda"]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_cli(args)
            t_cli = time.perf_counter() - t0
            require(rc == 0, f"pcc trainer CLI: exit code {rc}")
            m = MODELS["hrtzxf2022-pcc-rec"](device=dev)
            meta = load_checkpoint(root / "ck" / "latest", m)
            require(meta.get("epoch") == 0 and np.isfinite(meta["loss"]),
                    f"pcc trainer CLI: checkpoint meta {meta}")
            del m
    print(f"  pcc trainer CLI hrtzxf2022-pcc-rec on the card: 1 epoch of 2 "
          f"steps at batch {PCC_TRAIN_BATCH} over {PCC_CLI_CLOUDS} .npy "
          f"clouds in {t_cli:.2f} s, loss {meta['loss']:.4f}; its latest "
          "checkpoint loads", flush=True)
    phase("pcc", f"point cloud: the shipped codecs on {PCC_CLOUDS} held-out "
          "clouds, the seed-initialised codecs, pointcloud_train_step, the "
          f"trainer CLI ({time.perf_counter() - t_start:.2f} s of the 60 s "
          "target)")


@contextmanager
def _decoded_y(codec_cli):
    """Over the .fgm CLI module: every model that its ``load_model`` makes
    keeps the y_hat its ``decompress_y`` returns in the yielded dict's "y"
    (the CLI's decode runs ``decompress``, which calls it)."""
    kept = {}
    load = codec_cli.load_model

    def load_keeping(*args):
        model = load(*args)
        decompress_y = model.decompress_y

        def wrapped(*a, **kw):
            kept["y"] = decompress_y(*a, **kw)
            return kept["y"]
        model.decompress_y = wrapped
        return model
    codec_cli.load_model = load_keeping
    try:
        yield kept
    finally:
        codec_cli.load_model = load


def _levels(a_path, b_path):
    """(max, share of pixels off) of the 8-bit difference of two images."""
    import numpy as np

    from flashgmm_tpu_torch.datasets import load_image

    d = np.abs(np.round(load_image(a_path) * 255)
               - np.round(load_image(b_path) * 255))
    return float(d.max()), float((d.max(-1) > 0).mean())


def _cpu_fgm_decode(path, weights, out_ppm, card_ppm, card_y):
    """The .fgm CLI decoding a card's image file on the CPU
    (``--device cpu``): (whether its y_hat equals the card's, the max and
    share of pixels off the card's decoded image, in 8-bit levels)."""
    import torch

    from flashgmm_tpu_torch.examples import codec as codec_cli

    with _decoded_y(codec_cli) as kept:
        codec_cli.main(["decode", path, "-o", out_ppm, "--weights", weights,
                        "--device", "cpu"])
    return (torch.equal(kept["y"], card_y),) + _levels(out_ppm, card_ppm)


def _cpu_fgmv_decode(path, out_dir, card_dir, card_y):
    """The .fgm CLI decoding a card's video file on the CPU (``--device
    cpu``, the seed-initialised ssf2020): (the (GOP, frame, branch) whose
    y_hat differs from the card's, the max and share of pixels off the
    card's decoded frames)."""
    from pathlib import Path

    import torch

    from flashgmm_tpu_torch.examples import codec as codec_cli

    with open(path, "rb") as f:
        (quality, *_), gops = codec_cli.read_video_file(f)
    model = codec_cli.load_video_model(quality, None, "cpu")
    load = codec_cli.load_video_model
    codec_cli.load_video_model = lambda *args: model
    try:
        codec_cli.main(["decode_video", path, "-o", out_dir, "--ext", "ppm",
                        "--device", "cpu"])
    finally:
        codec_cli.load_video_model = load
    wrong = [(g, i, branch) for g, (strings, shapes) in enumerate(gops)
             for i, (got, want) in enumerate(zip(
                 model.decompress_y(strings, shapes), card_y[g]))
             for branch in want if not torch.equal(got[branch], want[branch])]
    worst, share = 0.0, 0.0
    frames = sorted(Path(card_dir).iterdir())
    for f in frames:
        m, s = _levels(Path(out_dir) / f.name, f)
        worst, share = max(worst, m), max(share, s)
    return wrong, worst, share, len(frames)


class ToolsCli:
    """The .fgm CLI (``python -m flashgmm_tpu_torch.examples.codec``) in
    subprocesses on the card: ``jobs`` maps a tag to its argv lists, run in
    order (encode, then decode), the tags side by side, each in a thread
    of its own. ``finish`` waits and requires each command to succeed:
    {tag: [(command, seconds, its last output line)]}; ``close`` stops
    what still runs."""

    def __init__(self, jobs):
        import threading

        self.procs, self.results = [], {}
        self.threads = [threading.Thread(target=self._run, args=(tag, cmds),
                                         daemon=True)
                        for tag, cmds in jobs.items()]
        for t in self.threads:
            t.start()

    def _run(self, tag, cmds):
        done = []
        for argv in cmds:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "flashgmm_tpu_torch.examples.codec",
                 *map(str, argv)], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            self.procs.append(proc)
            out, err = proc.communicate(timeout=600)
            done.append((argv[0], proc.returncode, time.perf_counter() - t0,
                         (out.strip().splitlines() or [""])[-1], err))
            if proc.returncode:
                break
        self.results[tag] = done

    def finish(self):
        for t in self.threads:
            t.join(timeout=900)
        for tag, done in self.results.items():
            for cmd, rc, _, _, err in done:
                require(rc == 0, f"tools: the .fgm CLI's {cmd} ({tag}) "
                        f"exited {rc}: {err[-1500:]}")
        require(len(self.results) == len(self.threads),
                "tools: a .fgm CLI job did not end")
        return {tag: [(cmd, s, line) for cmd, _, s, line, _ in done]
                for tag, done in self.results.items()}

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def shared_calls(calls):
    """Recorded calls with each repeated call key's tensors shared with its
    first call's (the timing phase times a key once), so that a long run's
    recorded inputs hold no more memory than its distinct shapes'."""
    first = {}
    return [first.setdefault(call_key(args, kwargs), (args, kwargs))
            for args, kwargs in calls]


# the JAX test's own tiled case (tests/test_fast_codec.py:209-225): the
# flagship seed-initialised, np.random.RandomState(7).rand as the latent,
# at its shape [1, 24, 8, N] by tiles of 4 rows and at the card test's
# [1, 40, 24, N] by tiles of 8, halo 8: (latent rows, columns, tile_h)
TILED_RANDOM_CASES = ((24, 8, 4), (40, 24, 8))


def tiled_random_cases(dev, smi_line):
    """Tiled against direct g_s of the seed-initialised flagship on random
    latents (TILED_RANDOM_CASES) on both transform routes, within
    TILED_ATOL with under TILED_FRAC of the pixels more than 1e-6 apart."""
    import numpy as np
    import torch

    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec
    from flashgmm_tpu_torch.runtime.tiled import make_tiled_gs

    t0 = time.perf_counter()
    model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0, device=dev)
    model.update(update_quantiles=True)
    rows = []
    for kernel in (False, True):
        codec = FastCheckerboardGmmCodec(model, lanes=256,
                                         kernel_transforms=kernel)
        for h, w, tile_h in TILED_RANDOM_CASES:
            y = torch.from_numpy(np.random.RandomState(7).rand(
                1, h, w, N).astype(np.float32)).to(dev)
            direct = torch.clamp(codec._transform(codec._g_s, y), 0, 1)
            tiled = make_tiled_gs(codec, tile_h=tile_h, halo=8)(y)
            diff = (tiled - direct).abs()
            worst = float(diff.max())
            frac = float((diff > 1e-6).float().mean())
            tag = (f"{'kernel' if kernel else 'default'} route, "
                   f"[1, {h}, {w}, {N}] by {tile_h} rows")
            require(tuple(tiled.shape) == (1, 16 * h, 16 * w, 3),
                    f"tiled random latent, {tag}: shape {tuple(tiled.shape)}")
            require(worst <= TILED_ATOL and frac < TILED_FRAC,
                    f"tiled random latent, {tag}: {worst} max, {frac} of "
                    "pixels beyond 1e-6")
            rows.append(f"{tag}: max {worst:.3g}, {100 * frac:.4f} % beyond "
                        "1e-6")
        del codec
    del model
    print("  tiled g_s, seed-initialised flagship on random latents "
          "(the JAX test's case): " + "; ".join(rows) + f"; "
          f"{time.perf_counter() - t0:.2f} s with the model's build "
          f"({smi_line})", flush=True)


def weights_round_trip(model, smi_line):
    """``zoo.save_npz_weights`` on the card: a copy of the phase-4 flagship
    loaded from WEIGHTS on the card and written to a temporary file must
    give WEIGHTS' key set and every array bit for bit (float16 -> float32 ->
    float16 is exact)."""
    import copy
    import tempfile

    import numpy as np

    from flashgmm_tpu_torch.zoo import load_npz, save_npz_weights

    t_all = time.perf_counter()
    m = copy.deepcopy(model)
    load_npz(m, WEIGHTS)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "saved.npz"
        t0 = time.perf_counter()
        save_npz_weights(m, out)
        t_save = time.perf_counter() - t0
        with np.load(WEIGHTS) as want, np.load(out) as got:
            require(set(got.files) == set(want.files),
                    f"save_npz_weights: keys {sorted(set(got.files) ^ set(want.files))[:4]} "
                    "differ from the repository file's")
            bad = [k for k in want.files
                   if got[k].dtype != np.float16
                   or not np.array_equal(got[k].view(np.uint16),
                                         want[k].view(np.uint16))]
            require(not bad, f"save_npz_weights: arrays {bad[:4]} differ")
            n = len(want.files)
    del m
    print(f"  save_npz_weights: the flagship loaded on the card from "
          f"{WEIGHTS.name} written back in {t_save:.2f} s: its {n} keys and "
          f"every float16 array bit for bit the file's; "
          f"{time.perf_counter() - t_all:.2f} s in all ({smi_line})",
          flush=True)


# GDN1 and the spectral convs on the card against the CPU: float32 sums in
# other orders (cuDNN, cuBLAS and cuFFT with TF32 off against the CPU's)
LAYERS_ATOL = 1e-4


def last_layers_on_card(dev, smi_line):
    """GDN1 (both directions), SpectralConv2d and SpectralConvTranspose2d at
    N channels on a 1 x 64 x 64 input, on the card against the same module
    on the CPU, within LAYERS_ATOL."""
    import copy

    import numpy as np
    import torch

    from flashgmm_tpu_torch.layers import (GDN1, SpectralConv2d,
                                           SpectralConvTranspose2d,
                                           pinned_library_settings)

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED0)
    gdn = []
    for inverse in (False, True):
        g = GDN1(N, inverse=inverse)
        with torch.no_grad():  # away from the identity init
            g.beta.uniform_(0.5, 1.5, generator=gen)
            g.gamma.uniform_(0.0, 0.1, generator=gen)
        gdn.append((f"GDN1(inverse={inverse})", g))
    layers = gdn + [
        ("SpectralConv2d 3x3", SpectralConv2d(N, N, 3, 1, 1, generator=gen)),
        ("SpectralConvTranspose2d 5x5 s2",
         SpectralConvTranspose2d(N, N, 5, 2, 2, 1, generator=gen))]
    x = torch.from_numpy(np.random.RandomState(SEED0).randn(
        1, 64, 64, N).astype(np.float32))
    worst = {}
    with torch.no_grad(), pinned_library_settings():
        for name, cpu_layer in layers:
            want = cpu_layer(x)
            got = copy.deepcopy(cpu_layer).to(dev)(x.to(dev)).cpu()
            require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"{name} on the card: shape {tuple(got.shape)}")
            worst[name] = float((got - want).abs().max())
            require(worst[name] <= LAYERS_ATOL,
                    f"{name}: the card {worst[name]} from the CPU")
    print("  layers on the card against the CPU (1x64x64x"
          f"{N}, within {LAYERS_ATOL}): " + ", ".join(
              f"{k} max {v:.3g}" for k, v in worst.items())
          + f"; {time.perf_counter() - t0:.2f} s ({smi_line})", flush=True)


def tools_phase(dev, model, record, smi_line, early):
    """The last modules (ROADMAP item 15) on the card: tiled synthesis at
    UHD, the .fgm file CLI, the standalone codec and the range coder.

    - Tiled synthesis: the flagship (the phase-4 model) through the batched
      codec (lanes=LANES, cap_divisor=CAP_DIVISOR) on one 3840x2160
      textured-leaves image, padded to 3840x2176 (a 136 x 240 x 192
      latent), on both transform routes: y_hat exact through the bytes,
      then ``make_tiled_gs(codec)`` (tile_h=32, halo=8) against the direct
      g_s within TILED_ATOL with under TILED_FRAC of the pixels more than
      1e-6 apart (the JAX test's bounds); the largest difference, the share
      of pixels apart, whether the kernel route is bitwise equal, each one's
      ms (CUDA events, after a warm-up) and peak memory above its start
      (``torch.cuda.max_memory_allocated``); the bf16 conv's launches in
      the kernel route's tiled run (recorded for the timing phase).
    - The .fgm CLI in subprocesses on the card (``ToolsCli``): encode and
      decode of the flagship (q5, its synthetic weights) and of
      bmshj2018-factorized (q1, N=128, M=192, the repository's weights) on
      one 768x512 PPM, and encode_video and decode_video of a
      seed-initialised ssf2020 GOP of TOOLS_VIDEO_FRAMES 256x256 frames;
      bytes, bpp, PSNR and each command's seconds. The card's files are to be decoded on the CPU
      by the same CLI (``--device cpu``): the card's y_hat exactly, pixels
      within 1 level of the card's decode; the phase returns these jobs
      for the caller to queue on its CpuSide (the smoke queues them after
      the zoo phase, whose eval CLI's CPU runs they would slow). The image
      CLI's ``main`` runs once in this process under the kernel recorder,
      encode and decode of the flagship: the f32 conv for each
      entropy-parameter conv, the softmax and the boundary rows a GMM pass
      each, no rANS kernel.
    - The standalone codec: the card of bmshj2018-factorized (the same
      weights) exported on the card (``synthesis_gains`` runs g_s there),
      ``fgsc_encode`` / ``fgsc_decode`` built from csrc/ (in the CpuSide
      process, right after the kernels' build); on a 256x256 PPM the port's
      stream decoded by ``fgsc_decode`` and ``fgsc_encode``'s by the port,
      pixels within STANDALONE_LEVELS of the other side's decode, the
      C++ stream's symbols re-packed by the port to its bytes, each
      direction's ms.
    - The range coder: bmshj2018-hyperprior (q4, N=128) built under
      ``set_entropy_coder("rangecoder")`` and under "rans", one compress and
      decompress of a 256x256 image each: the same y_hat; the registry is
      reset after.
    - The last public names: ``tiled_random_cases``,
      ``weights_round_trip`` and ``last_layers_on_card``.

    Returns (launches, recorded calls) of the kernel route's tiled run and
    the in-process image CLI run together, and the CPU decodes as
    ``CpuSide.submit`` argument tuples."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    import flashgmm_tpu_torch
    from flashgmm_tpu_torch.datasets import (load_image, save_image,
                                             textured_leaves)
    from flashgmm_tpu_torch.examples import codec as codec_cli
    from flashgmm_tpu_torch.ops import compute_padding, pad_image
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec
    from flashgmm_tpu_torch.runtime.tiled import make_tiled_gs
    from flashgmm_tpu_torch.standalone import (decode_bitstream,
                                               encode_bitstream,
                                               export_model_card)
    from flashgmm_tpu_torch.standalone.format import (encode_symbols,
                                                      pack_bitstream,
                                                      unpack_bitstream)
    from flashgmm_tpu_torch.zoo import image_models

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    ppm = root / "leaves.ppm"
    save_image(ppm, textured_leaves(H, W, seed=SEED0 + 1))
    frames = root / "frames"
    frames.mkdir()
    for i, f in enumerate(_panned_frames(TOOLS_SMALL, TOOLS_SMALL,
                                         TOOLS_VIDEO_FRAMES, VIDEO_SEED)):
        save_image(frames / f"f{i}.ppm", f)
    archs = {"flagship": ("cheng2020-anchor-checkerboard-gmm", "5", WEIGHTS),
             "factorized": ("bmshj2018-factorized", "1",
                            FACTORIZED_WEIGHTS)}
    jobs = {tag: [["encode", ppm, "-o", root / f"{tag}.fgm", "-a", arch,
                   "-q", q, "--weights", w],
                  ["decode", root / f"{tag}.fgm", "-o",
                   root / f"{tag}_card.ppm", "--weights", w]]
            for tag, (arch, q, w) in archs.items()}
    jobs["video"] = [["encode_video", frames, "-o", root / "gop.fgmv",
                      "--gop", str(TOOLS_VIDEO_FRAMES)],
                     ["decode_video", root / "gop.fgmv", "-o",
                      root / "video_card", "--ext", "ppm"]]
    cli = ToolsCli(jobs)
    _CLEANUP.append(cli.close)
    _CLEANUP.append(tmp.cleanup)

    # the range coder: the same y_hat as the host rANS coder's ------------
    x_small = torch.from_numpy(textured_leaves(TOOLS_SMALL, TOOLS_SMALL,
                                               seed=SEED0 + 4)[None]).to(dev)
    coded = {}
    for name in ("rans", "rangecoder"):
        flashgmm_tpu_torch.set_entropy_coder(name)
        try:
            m = image_models("bmshj2018-hyperprior", 4, pretrained=True,
                             device=dev).eval()
        finally:
            flashgmm_tpu_torch.set_entropy_coder("rans")
        require(m.entropy_bottleneck.entropy_coder.name == name
                and m.gaussian_conditional.entropy_coder.name == name,
                f"tools: the {name} model codes with another backend")
        m.update(force=True)
        m.compress(x_small)  # warm-up: the first call loads the convs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.compress(x_small)
        t1 = time.perf_counter()
        y = m.decompress_y(out["strings"], out["shape"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        require(torch.equal(y, out["y_hat"]), f"tools: {name}: decompress's "
                "y_hat differs from compress's")
        n_bytes = sum(len(s) for group in out["strings"] for s in group)
        coded[name] = (y, n_bytes, t1 - t0, t2 - t1)
        del m
    require(torch.equal(coded["rans"][0], coded["rangecoder"][0]),
            "tools: the range coder's y_hat differs from the rANS coder's")
    require(flashgmm_tpu_torch.get_entropy_coder() == "rans",
            "tools: the registry was not reset")
    print("  range coder: bmshj2018-hyperprior q4 on a "
          f"{TOOLS_SMALL}x{TOOLS_SMALL} image, y_hat equal to the rANS "
          "coder's; " + "; ".join(
              f"{name} {n} bytes, compress {1e3 * tc:.1f} ms, decompress "
              f"{1e3 * td:.1f} ms" for name, (_, n, tc, td) in coded.items())
          + f" (host clock; {smi_line})", flush=True)

    # the standalone codec: the card's streams and the C++ binaries' -------
    (enc_bin, dec_bin), build_s = early["standalone"].get(timeout=900)
    fm = image_models("bmshj2018-factorized", 4, pretrained=True,
                      device=dev).eval()
    fm.update(force=True)
    card = root / "factorized.fgsam"
    t0 = time.perf_counter()
    card_bytes = export_model_card(fm, str(card))
    t_export = time.perf_counter() - t0
    small_ppm = root / "small.ppm"
    save_image(small_ppm, x_small[0].cpu().numpy())
    img = load_image(small_ppm)

    def binary(*argv):
        t0 = time.perf_counter()
        r = subprocess.run([str(a) for a in argv], capture_output=True,
                           text=True, timeout=300)
        require(r.returncode == 0, f"tools: {Path(str(argv[0])).name} "
                f"exited {r.returncode}: {r.stderr[-800:]}")
        return time.perf_counter() - t0

    def u8(x):
        return np.clip(x * 255 + 0.5, 0, 255).astype(np.uint8).astype(int)

    times = {}
    t0 = time.perf_counter()
    bs_port = encode_bitstream(fm, img)
    times["port encode (card)"] = time.perf_counter() - t0
    (root / "port.fgs").write_bytes(bs_port)
    times["fgsc_decode"] = binary(dec_bin, card, root / "port.fgs",
                                  root / "port_by_cpp.ppm")
    t0 = time.perf_counter()
    rec_port = decode_bitstream(fm, bs_port)
    times["port decode (card)"] = time.perf_counter() - t0
    times["fgsc_encode"] = binary(enc_bin, card, small_ppm, root / "cpp.fgs")
    bs_cpp = (root / "cpp.fgs").read_bytes()
    rec_cpp_port = decode_bitstream(fm, bs_cpp)
    binary(dec_bin, card, root / "cpp.fgs", root / "cpp_by_cpp.ppm")
    syms_cpp, w_cpp, h_cpp = unpack_bitstream(bs_cpp, fm)
    require(pack_bitstream(syms_cpp, fm, w_cpp, h_cpp) == bs_cpp,
            "tools: the port re-packs the C++ stream's symbols to other bytes")
    syms_port = encode_symbols(fm, img)[0]
    require(np.array_equal(unpack_bitstream(bs_port, fm)[0], syms_port),
            "tools: the port's stream unpacks to other symbols")
    offs = []
    for tag, got, ref in (
            ("port stream: fgsc_decode against the port",
             u8(load_image(root / "port_by_cpp.ppm")), u8(rec_port)),
            ("C++ stream: the port against fgsc_decode", u8(rec_cpp_port),
             u8(load_image(root / "cpp_by_cpp.ppm")))):
        d = np.abs(got - ref)
        offs.append(f"{tag} max {int(d.max())} levels, "
                    f"{100 * float((d.max(-1) > 0).mean()):.3f} % of pixels "
                    "off")
        require(int(d.max()) <= STANDALONE_LEVELS, f"tools: standalone {tag}"
                f": {int(d.max())} levels apart")
    print(f"  standalone: {card.name} {card_bytes} bytes exported on the "
          f"card in {t_export:.2f} s (g_s's synthesis gains there); fgsc "
          f"binaries built in {build_s:.1f} s (CpuSide); on a "
          f"{TOOLS_SMALL}x{TOOLS_SMALL} PPM the port's stream "
          f"{len(bs_port)} bytes, fgsc_encode's {len(bs_cpp)} bytes (its "
          "symbols re-packed by the port to its bytes; "
          f"{100 * float((syms_cpp == syms_port).mean()):.3f} % of the two "
          "encoders' symbols equal); " + "; ".join(offs) + "; " + ", ".join(
              f"{k} {1e3 * v:.1f} ms" for k, v in times.items())
          + f" (host clock; {smi_line})", flush=True)
    del fm

    # the in-process CLI run under the kernel recorder --------------------
    arch, q, w = archs["flagship"]
    inproc = root / "flagship_inproc.fgm"
    _, enc_launches, enc_calls = record(lambda: codec_cli.main(
        ["encode", str(ppm), "-o", str(inproc), "-a", arch, "-q", q,
         "--weights", str(w)]))
    # while the jobs run: the card's video model (its update takes
    # seconds) and the UHD image's y_hat on both routes, exact through the
    # bytes (the timed runs wait for the jobs)
    vm = codec_cli.load_video_model(5, None, dev)
    uhd, _ = early["uhd"].get(timeout=900)
    x = torch.from_numpy(uhd[None]).to(dev)
    x = pad_image(x, compute_padding(*TOOLS_UHD, min_div=64)[0])
    padded = tuple(x.shape[1:3])  # (2176, 3840)
    uhd_coded = {}
    for route in (False, True):
        tag = f"tiled ({'kernel' if route else 'default'} route)"
        codec = FastCheckerboardGmmCodec(model, lanes=LANES,
                                         cap_divisor=CAP_DIVISOR,
                                         kernel_transforms=route)
        data, enc = codec.encode_to_bytes(x)
        y_shape = tuple(enc["y_hat"].shape[1:])
        require(y_shape == (padded[0] // 16, padded[1] // 16, N),
                f"{tag}: latent {y_shape}")
        y_hat = codec.decode_y_hat(codec.from_bytes(data, y_shape), y_shape)
        require(torch.equal(y_hat, enc["y_hat"]),
                f"{tag}: y_hat not exact through the bytes")
        uhd_coded[route] = (tag, codec, y_hat, len(data))
        del enc, data
    del x, uhd
    # the last public names, still while the jobs run
    tiled_random_cases(dev, smi_line)
    weights_round_trip(model, smi_line)
    last_layers_on_card(dev, smi_line)
    done = cli.finish()
    for tag, runs in done.items():
        print(f"  .fgm CLI {tag} on the card: " + "; ".join(
            f"{cmd} {s:.2f} s ({line})" for cmd, s, line in runs), flush=True)

    def card_y(tag, run=lambda fn: fn()):
        """The card's y_hat of the subprocess's file of ``tag``, decoded by
        the CLI's main in this process under ``run``: (y_hat, run's
        result)."""
        with _decoded_y(codec_cli) as kept:
            result = run(lambda: codec_cli.main(
                ["decode", str(root / f"{tag}.fgm"), "-o",
                 str(root / f"{tag}_inproc.ppm"), "--weights",
                 str(archs[tag][2])]))
        return kept["y"], result

    y_card, (_, dec_launches, dec_calls) = card_y("flagship", record)
    launches = {k: enc_launches[k] + dec_launches[k] for k in enc_launches}
    want = dict.fromkeys(launches, 0)
    want.update(conv2d_nhwc=2 * 12, gmm_softmax=2 * 2,
                gmm_boundary_rows=2 * 2)
    require(launches == want, f"tools: the in-process CLI run's launches "
            f"{launches}, not {want}")
    same_file = inproc.read_bytes() == (root / "flagship.fgm").read_bytes()
    cpu_jobs = []  # (fn, args, then) for the caller to queue on the CpuSide
    for tag, (arch, q, w) in archs.items():
        y = y_card if tag == "flagship" else card_y(tag)[0]
        nbytes = (root / f"{tag}.fgm").stat().st_size
        x_card = load_image(root / f"{tag}_card.ppm")
        apart = _levels(root / f"{tag}_card.ppm", root / f"{tag}_inproc.ppm")
        require(apart[0] <= 1, f"tools: {tag}: the card's two decodes "
                f"{apart[0]} levels apart")
        mse = float(np.mean((x_card.astype(np.float64)
                             - load_image(ppm)) ** 2))
        print(f"  .fgm {tag} ({arch} q{q}): {nbytes} bytes, "
              f"{8 * nbytes / (H * W):.4f} bpp, PSNR "
              f"{-10 * np.log10(mse):.4f} dB on the card; the subprocess's "
              f"and this process's decodes {apart[0]:.0f} levels apart "
              f"({100 * apart[1]:.3f} % of pixels)", flush=True)

        def then(result, t_cpu, tag=tag):
            same, worst, share = result
            require(same, f"tools: {tag}: the CPU decodes the card's .fgm "
                    "file to another y_hat")
            require(worst <= 1, f"tools: {tag}: the CPU's pixels "
                    f"{worst} levels from the card's")
            print(f"  .fgm {tag}: the card's file decoded on the CPU "
                  f"(--device cpu) to the card's y_hat exactly, pixels "
                  f"within {worst:.0f} level ({100 * share:.3f} % off), "
                  f"{t_cpu:.1f} s", flush=True)
        cpu_jobs.append((_cpu_fgm_decode, (
            str(root / f"{tag}.fgm"), str(w), str(root / f"{tag}_cpu.ppm"),
            str(root / f"{tag}_card.ppm"), y.cpu()), then))

    with open(root / "gop.fgmv", "rb") as f:
        header, gops = codec_cli.read_video_file(f)
    y_video = [[{b: t.cpu() for b, t in frame.items()}
                for frame in vm.decompress_y(s, shapes)]
               for s, shapes in gops]
    del vm
    v_bytes = (root / "gop.fgmv").stat().st_size
    print(f"  .fgm video (ssf2020, seed-initialised): {header[3]} frames "
          f"{TOOLS_SMALL}x{TOOLS_SMALL}, {v_bytes} bytes, "
          f"{8 * v_bytes / (TOOLS_SMALL ** 2 * header[3]):.4f} bpp a frame",
          flush=True)

    def then_video(result, t_cpu):
        wrong, worst, share, n = result
        require(not wrong and n == TOOLS_VIDEO_FRAMES, f"tools: video: the "
                f"CPU's y_hat differs at {wrong} ({n} frames)")
        require(worst <= 1, f"tools: video: the CPU's frames {worst} levels "
                "from the card's")
        print(f"  .fgm video: the card's file decoded on the CPU (--device "
              f"cpu) to the card's y_hat of every branch exactly, {n} frames "
              f"within {worst:.0f} level ({100 * share:.3f} % off), "
              f"{t_cpu:.1f} s", flush=True)
    cpu_jobs.append((_cpu_fgmv_decode, (str(root / "gop.fgmv"),
                                        str(root / "video_cpu"),
                                        str(root / "video_card"), y_video),
                     then_video))
    print(f"  .fgm CLI in this process (flagship encode + decode): launches "
          f"{launches}; its bytes {'equal' if same_file else 'NOT equal'} "
          "to the subprocess's", flush=True)

    # tiled synthesis at UHD on both routes, timed ----------------------------
    tiled_launches = tiled_calls = None
    for route in (False, True):
        tag, codec, y_hat, n_bytes = uhd_coded.pop(route)
        gs = make_tiled_gs(codec)
        runs = {"direct": lambda: torch.clamp(
                    codec._transform(codec._g_s, y_hat), 0, 1),
                "tiled": lambda: gs(y_hat)}
        outs, ms, peak = {}, {}, {}
        for name, fn in runs.items():
            fn()  # warm-up: the library's algorithms for these shapes
            times_ms = []
            for _ in range(TILED_REPS):
                outs.pop(name, None)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                outs[name] = fn()
                b.record()
                torch.cuda.synchronize()
                times_ms.append(a.elapsed_time(b))
                peak[name] = torch.cuda.max_memory_allocated() - base
            ms[name] = statistics.median(times_ms)
        diff = (outs["tiled"] - outs["direct"]).abs()
        worst = float(diff.max())
        frac = float((diff > 1e-6).float().mean())
        require(tuple(outs["tiled"].shape) == (1, *padded, 3),
                f"{tag}: shape {tuple(outs['tiled'].shape)}")
        require(worst <= TILED_ATOL and frac < TILED_FRAC,
                f"{tag}: {worst} max, {frac} of pixels beyond 1e-6")
        if route:
            out, tiled_launches, tiled_calls = record(lambda: gs(y_hat))
            require(torch.equal(out, outs["tiled"]),
                    f"{tag}: the recorded run differs")
            require(tiled_launches["conv2d_nhwc_bf16"] > 0,
                    f"{tag}: no bf16 conv launched")
            tiled_calls = {k: shared_calls(v) for k, v in tiled_calls.items()}
        print(f"  {tag}: {TOOLS_UHD[1]}x{TOOLS_UHD[0]} (padded to "
              f"{padded[1]}x{padded[0]}, latent {list(y_hat.shape[1:])}) "
              f"through {n_bytes} bytes, y_hat exact; "
              f"tiled (tile_h=32, halo=8) against direct g_s: max "
              f"{worst:.3g}, {100 * frac:.4f} % of pixels beyond 1e-6, "
              f"bitwise {'equal' if worst == 0 else 'NOT equal'}; ms direct "
              f"{ms['direct']:.2f}, tiled {ms['tiled']:.2f} (CUDA events, "
              f"medians of {TILED_REPS}); peak memory above the start direct "
              f"{peak['direct'] / 2**30:.3f} GiB, tiled "
              f"{peak['tiled'] / 2**30:.3f} GiB "
              f"({100 * peak['tiled'] / peak['direct']:.1f} %); {smi_line}"
              + (f"; bf16 conv launches in the tiled run "
                 f"{tiled_launches['conv2d_nhwc_bf16']}" if route else ""),
              flush=True)
        del codec, gs, outs, diff, y_hat
    torch.cuda.empty_cache()

    launches = {k: launches[k] + tiled_launches[k] for k in launches}
    calls = {k: enc_calls[k] + dec_calls[k] + tiled_calls[k]
             for k in enc_calls}
    phase("tools", "tiled UHD synthesis on both routes, the .fgm CLI on the "
          "card, the standalone codec against its C++ binaries, the range "
          "coder, the last public names")
    return launches, calls, cpu_jobs


def tools_only():
    """``python3 chip_smoke.py --tools``: the device line, the build and the
    tools phase alone (the flagship built as phase 4 builds it), then each
    kernel's launches on its path."""
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.zoo import load_npz

    dev, smi_line = _device_and_build()
    cpu = _cpu_side()
    early = tools_early(cpu)
    model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0, device=dev)
    load_npz(model, WEIGHTS)
    model.update(update_quantiles=True)
    bound = kernel_wrappers()
    originals = {name: getattr(*where) for name, where in bound.items()}
    launches, _, cpu_jobs = tools_phase(dev, model,
                                        make_record(bound, originals),
                                        smi_line, early)
    for job in cpu_jobs:
        cpu.submit(*job)
    cpu.drain()
    print(json.dumps({"tools_launches": launches}), flush=True)


def tools_early(cpu):
    """The tools phase's CPU work started in the CpuSide process right
    after the kernels' build: the standalone binaries' build and the UHD
    image."""
    from flashgmm_tpu_torch.datasets.synthetic import textured_leaves
    from flashgmm_tpu_torch.standalone.build import build_binaries

    return {"standalone": cpu.start(build_binaries, ()),
            "uhd": cpu.start(textured_leaves, (*TOOLS_UHD, SEED0 + 5))}


# the parallel phase (ROADMAP A9): the slots of the mesh a one-card host
# names on cuda:0; the default run's global batch (the smoke's images
# twice over, one a slot) and its height-sharded image (both images one
# above the other: 1536 rows, 6 units of 64 a slot); --parallel's global
# batches (24 distinct images, repeated 4 times for 96), its UHD frame
# (3840x2176: 34 units of 64 rows, 9/9/8/8 over four cards) and the
# repetitions its times are the medians of
PAR_SLOTS = 4
PAR_BATCHES, PAR_UHD, PAR_REPS = (24, 96), (2176, 3840), 3


def sync_all():
    """Wait for every card."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def par_meshes(dev):
    """(data mesh, spatial mesh, what they are): every card of the host,
    or on a one-card host PAR_SLOTS slots named on it."""
    import torch

    from flashgmm_tpu_torch.parallel import Mesh, make_mesh

    n = torch.cuda.device_count()
    if n > 1:
        return (make_mesh(n), make_mesh(n, data=1, spatial=n),
                f"{n} cards, one slot each")
    return (Mesh([dev] * PAR_SLOTS), Mesh([[dev] * PAR_SLOTS]),
            f"{PAR_SLOTS} slots named on {dev} (a one-card host: the split, "
            "gather and halo code runs, no second card)")


def launches_by_device(calls):
    """{kernel: {device: launches}} of recorded calls, each counted on the
    device of its first tensor argument."""
    import torch

    out = {}
    for name, cs in calls.items():
        for args, kwargs in cs:
            t = next(a for a in (*args, *kwargs.values())
                     if isinstance(a, torch.Tensor))
            per = out.setdefault(name, {})
            per[str(t.device)] = per.get(str(t.device), 0) + 1
    return out


def busy_by_device(fn):
    """fn() under torch.profiler: (its result, the host-clock ms of the
    call, {device index: ms that card was busy}, the union of its kernels'
    and copies' intervals); {} when the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync_all()
        wall = 1e3 * (time.perf_counter() - t0)
    spans = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and not getattr(
                e, "is_user_annotation", False):
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    busy = {}
    for d, iv in spans.items():
        total, end = 0.0, float("-inf")
        for a, b in sorted(iv):
            if b > end:
                total += b - max(a, end)
                end = b
        busy[d] = total / 1e3
    return out, wall, busy


def split_report(one, c, xs, d1, dm):
    """The mesh codec c's encode of xs against one card's (the codec one):
    whether the bytes are equal, else how many z bins and y_hat values the
    two encoders gave otherwise (ROADMAP C15: the library picks a conv's
    algorithm by the batch's shape, so a card's share may round a latent
    otherwise than the whole batch)."""
    if dm == d1:
        return f"{len(dm)} bytes, equal to one card's"
    z1, zm = one._analyze(xs)[0], c._analyze_all(xs)[0]
    y1, ym = one.encode(xs)["y_hat"], c.encode(xs)["y_hat"]
    return (f"{len(dm)} bytes, NOT equal to one card's {len(d1)} (ROADMAP "
            f"C15: {int((z1 != zm).sum())} of {z1.numel()} z bins and "
            f"{int((y1 != ym).sum())} of {y1.numel()} y_hat values apart)")


def parallel_phase(dev, model, record, smi_line, full=False):
    """Batch-data-parallel coding and the sharded forwards (ROADMAP A9;
    ``parallel/``), over every card of the host, or on a one-card host
    over PAR_SLOTS slots named on cuda:0 (``par_meshes``):
    1. the flagship (the phase-4 model) through FastCheckerboardGmmCodec
       at lanes=LANES, cap_divisor=CAP_DIVISOR on both routes: one
       encode_to_bytes + decode_bytes on the mesh with the launches counted
       from 0 and by card (every kernel of the path launched: the bf16 conv
       on every card on the kernel route, the rANS coders and the f32 conv
       on the first card alone); the mesh's bytes against the one card's
       (equal on the kernel route, the default route's y_hat flips
       counted: ROADMAP C15); y_hat exact through the mesh's bytes; the one
       card's bytes decoded on the mesh and the mesh's on one card;
       ``portable=False`` exact on its mesh; bpp, PSNR, encode and decode
       ms;
    2. GSM (N=128) and ELIC (N=192, M=320) at their batched settings on
       the mesh, default route: y_hat exact, bytes equal to the one card's
       or their flips counted;
    3. the flagship's height-sharded forward (``make_spatial_sharded_
       forward``) against the whole forward (at most 2 % of pixels beyond
       2e-5, bits within 1e-3: the JAX test's bounds), each card's peak
       memory against the whole forward's, both ms.
    The default run codes the smoke's images twice over (one a slot) and
    shards them one above the other (1536x512). ``full`` (``--parallel``)
    also times the flagship at global batches PAR_BATCHES on one card and
    on the mesh, both routes (medians of PAR_REPS, host clock; the
    transforms' share of each direction; each card's busy share from
    torch.profiler), GSM and ELIC at batch 24, and shards a PAR_UHD frame.
    Returns the kernel route's mesh launches by card."""
    import numpy as np
    import torch

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboard,
                                           Elic2022GMM)
    from flashgmm_tpu_torch.parallel import make_spatial_sharded_forward
    from flashgmm_tpu_torch.runtime import (FastCheckerboardGmmCodec,
                                            FastCheckerboardGsmCodec,
                                            FastElicGmmCodec)
    from flashgmm_tpu_torch.zoo import load_npz

    t_phase = time.perf_counter()
    mesh, spatial, what = par_meshes(dev)
    cards = sorted({str(d) for d in mesh.flat})
    peers = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
             for a in range(torch.cuda.device_count())
             for b in range(torch.cuda.device_count()) if a != b}
    print(f"  mesh: {what}; peer access {peers or 'n/a (one card)'}; "
          f"{smi_line}", flush=True)
    x2 = torch.from_numpy(np.stack([textured_leaves(
        H, W, seed=SEED0 + 1 + i) for i in range(BATCH)])).to(dev)
    xb = torch.cat([x2] * (mesh.size // BATCH or 1))

    def both(codec, xs, tag):
        """codec's encode_to_bytes + decode_bytes of xs: (bytes, out,
        x_hat, encode s, decode s)."""
        sync_all()
        t0 = time.perf_counter()
        data, out = codec.encode_to_bytes(xs)
        sync_all()
        t1 = time.perf_counter()
        x_hat = codec.decode_bytes(data, tuple(out["y_hat"].shape))
        sync_all()
        return data, out, x_hat, t1 - t0, time.perf_counter() - t1

    def mesh_checks(cls, m, xs, tag, kw):
        """One codec of class cls on the mesh against one card: (mesh
        launches by card, launches, bytes)."""
        one = cls(m, **kw)
        d1, o1 = one.encode_to_bytes(xs)
        c = cls(m, **kw).use_mesh(mesh)
        both(c, xs, tag)  # warm-up
        (dm, om, x_hat, t_enc, t_dec), launches, calls = record(
            lambda: both(c, xs, tag))
        y_shape = tuple(om["y_hat"].shape)
        require(torch.equal(c.decode_y_hat(c.from_bytes(dm, y_shape),
                                           y_shape), om["y_hat"]),
                f"{tag}: y_hat differs after the mesh's bytes")
        require(torch.equal(c.decode_y_hat(c.from_bytes(d1, y_shape),
                                           y_shape), o1["y_hat"]),
                f"{tag}: one card's bytes do not decode on the mesh")
        require(torch.equal(one.decode_y_hat(one.from_bytes(dm, y_shape),
                                             y_shape), om["y_hat"]),
                f"{tag}: the mesh's bytes do not decode on one card")
        require(tuple(x_hat.shape) == tuple(xs.shape)
                and bool(torch.isfinite(x_hat).all()), f"{tag}: x_hat")
        b = xs.shape[0]
        print(f"  {tag}: {split_report(one, c, xs, d1, dm)}; y_hat exact "
              f"through the mesh's bytes, bytes cross one card and the mesh "
              f"both ways; bpp {len(dm) * 8 / (b * H * W):.7f}, PSNR "
              f"{psnr_of(x_hat, xs):.4f} dB; encode {1e3 * t_enc / b:.3f}, "
              f"decode {1e3 * t_dec / b:.3f} ms per image (batch {b}, host "
              f"clock); launches by card {launches_by_device(calls)}",
              flush=True)
        return launches_by_device(calls), launches, dm

    kw = dict(lanes=LANES, cap_divisor=CAP_DIVISOR)
    by_card = {}
    for route in (False, True):
        tag = f"flagship, {'kernel' if route else 'default'} route"
        per, launches, dm = mesh_checks(
            FastCheckerboardGmmCodec, model, xb, tag,
            dict(kw, kernel_transforms=route))
        for name in ("rans_encode", "rans_encode_gmm", "rans_decode",
                     "rans_decode_gmm", "gmm_softmax", "conv2d_nhwc"):
            require(launches[name] > 0 and set(per[name]) == {str(dev)},
                    f"{tag}: {name} not launched on {dev} alone: "
                    f"{per.get(name)}")
        if route:
            require(set(per.get("conv2d_nhwc_bf16", {})) == set(cards),
                    f"{tag}: the bf16 conv ran on "
                    f"{per.get('conv2d_nhwc_bf16')}, not on every card "
                    f"{cards}")
            by_card = per
        else:
            require(launches["conv2d_nhwc_bf16"] == 0,
                    f"{tag}: the bf16 conv launched")
        spmd = FastCheckerboardGmmCodec(model, kernel_transforms=route,
                                        **kw).use_mesh(mesh, portable=False)
        dn, on = spmd.encode_to_bytes(xb)
        y_shape = tuple(on["y_hat"].shape)
        require(torch.equal(spmd.decode_y_hat(spmd.from_bytes(dn, y_shape),
                                              y_shape), on["y_hat"]),
                f"{tag}: portable=False does not round-trip")
        print(f"  {tag}, portable=False: y_hat exact through its {len(dn)} "
              f"bytes ({'equal to' if dn == dm else 'not'} the portable "
              "mode's)", flush=True)
        del spmd
    torch.cuda.empty_cache()

    # GSM and ELIC at their batched settings
    gsm = Cheng2020AnchorCheckerboard(N=GSM_N, seed=0, device=dev)
    load_npz(gsm, GSM_WEIGHTS)
    gsm.update(update_quantiles=True)
    elic = Elic2022GMM(N=N, M=ELIC_M, K=K, seed=0, device=dev)
    load_npz(elic, ELIC_WEIGHTS)
    elic.update(update_quantiles=True)
    others = ((FastCheckerboardGsmCodec, gsm, "GSM N=128", kw),
              (FastElicGmmCodec, elic, "ELIC N=192 M=320",
               dict(lanes=ELIC_LANES, cap_divisor=ELIC_CAP)))
    for cls, m, tag, okw in others:
        mesh_checks(cls, m, xb, f"{tag}, default route", okw)
    torch.cuda.empty_cache()

    # the height-sharded forward against the whole one
    def sharded_forward(img, tag):
        sync_all()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        ref = model(img, training=False)
        sync_all()
        t_whole = time.perf_counter() - t0
        peak_whole = torch.cuda.max_memory_allocated(dev) - base
        run = make_spatial_sharded_forward(model, spatial)
        run(img)  # warm-up: the library's choices for the band shapes
        sync_all()
        devs = sorted({d.index for d in spatial.flat})
        bases = {}
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
            bases[d] = torch.cuda.memory_allocated(d)
        t0 = time.perf_counter()
        got = run(img)
        sync_all()
        t_sharded = time.perf_counter() - t0
        peaks = {f"cuda:{d}": round((torch.cuda.max_memory_allocated(d)
                                     - bases[d]) / 2 ** 30, 3) for d in devs}
        share = float(((got["x_hat"] - ref["x_hat"]).abs() > 2e-5)
                      .float().mean())

        def bits(o):
            return sum(float(-torch.log2(v).sum())
                       for v in o["likelihoods"].values())

        gap = abs(bits(got) - bits(ref)) / bits(ref)
        print(f"  {tag}: {share:.6f} of pixels beyond 2e-5, bits "
              f"{bits(got):.1f} against {bits(ref):.1f} (gap {gap:.3g}); "
              f"whole {1e3 * t_whole:.1f} ms peaking at "
              f"{peak_whole / 2 ** 30:.3f} GiB, sharded "
              f"{1e3 * t_sharded:.1f} ms, peak GiB by card {peaks}; "
              f"{smi_line}", flush=True)
        require(share < 0.02, f"{tag}: {share} of pixels beyond 2e-5")
        require(gap < 1e-3, f"{tag}: bits {gap} apart")
        del ref, got

    sharded_forward(torch.cat(list(x2), dim=0)[None],
                    f"height-sharded forward of {BATCH * H}x{W}")
    if full:
        print(f"  the checks above: {time.perf_counter() - t_phase:.2f} s",
              flush=True)
        parallel_times(dev, model, gsm, elic, mesh, smi_line)
        uhd = torch.from_numpy(textured_leaves(*PAR_UHD, seed=SEED0 + 7)
                               )[None].to(dev)
        sharded_forward(uhd, f"height-sharded forward of {PAR_UHD[1]}x"
                        f"{PAR_UHD[0]}")
    del gsm, elic
    torch.cuda.empty_cache()
    phase("parallel", f"batch-data-parallel coding and the height-sharded "
          f"forward over {what}")
    return by_card


def parallel_times(dev, model, gsm, elic, mesh, smi_line):
    """``--parallel``'s times: the flagship at each global batch of
    PAR_BATCHES on one card and on the mesh, both routes, ms per image of
    encode_to_bytes + decode_bytes (medians of PAR_REPS after a warm-up,
    host clock to every card's synchronize), the mesh's bytes against the
    one card's (y_hat flips counted), the transforms' share of each
    direction (the analysis alone, encode's g_a, h_a and gather; decode's
    g_s: decode minus decode_y_hat), and each card's busy share of one
    mesh encode + decode (torch.profiler); GSM and ELIC at batch 24 on one
    card and on the mesh, default route."""
    import statistics

    import numpy as np
    import torch

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.runtime import (FastCheckerboardGmmCodec,
                                            FastCheckerboardGsmCodec,
                                            FastElicGmmCodec)

    imgs = torch.from_numpy(np.stack([textured_leaves(
        H, W, seed=SEED0 + 1 + i) for i in range(PAR_BATCHES[0])])).to(dev)

    def timed(fn):
        fn()
        ts = []
        for _ in range(PAR_REPS):
            sync_all()
            t0 = time.perf_counter()
            fn()
            sync_all()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    def measure(cls, m, kw, xs, tag):
        """xs coded on one card and on the mesh: each one's times, the
        transforms' shares and the busy shares printed, then the mesh's
        bytes against one card's."""
        b = xs.shape[0]
        rows = {}
        for where in ("1 card", "mesh"):
            c = cls(m, **kw)
            if where == "mesh":
                c.use_mesh(mesh)
            data, out = c.encode_to_bytes(xs)
            y_shape = tuple(out["y_hat"].shape)
            t_enc = timed(lambda: c.encode_to_bytes(xs))
            t_dec = timed(lambda: c.decode_bytes(data, y_shape))
            t_ana = timed(lambda: c._analyze_all(xs))
            streams = c.from_bytes(data, y_shape)
            t_dy = timed(lambda: c.decode_y_hat(streams, y_shape))
            t_full = timed(lambda: c.decode(streams, y_shape))
            _, wall, busy = busy_by_device(lambda: c.decode_bytes(
                c.encode_to_bytes(xs)[0], y_shape))
            shares = {f"cuda:{d}": round(v / wall, 4)
                      for d, v in sorted(busy.items())} or "not measured"
            rows[where] = (c, data)
            print(f"  {tag}, batch {b}, {where}: encode "
                  f"{1e3 * t_enc / b:.4f} + decode {1e3 * t_dec / b:.4f} = "
                  f"{1e3 * (t_enc + t_dec) / b:.4f} ms per image; {len(data)}"
                  f" bytes; transforms {100 * t_ana / t_enc:.1f} % of encode"
                  f" (g_a, h_a, gather: {1e3 * t_ana / b:.4f} ms/img), g_s "
                  f"{100 * (t_full - t_dy) / t_full:.1f} % of decode; busy "
                  f"share of an encode + decode by card {shares} "
                  f"({wall:.2f} ms); "
                  f"{smi_line}", flush=True)
        (one, d1), (c, dm) = rows["1 card"], rows["mesh"]
        print(f"  {tag}, batch {b}: the mesh's "
              f"{split_report(one, c, xs, d1, dm)}", flush=True)
        del rows, one, c
        torch.cuda.empty_cache()

    kw = dict(lanes=LANES, cap_divisor=CAP_DIVISOR)
    for batch in PAR_BATCHES:
        xs = torch.cat([imgs] * (batch // imgs.shape[0]))
        for route in (False, True):
            measure(FastCheckerboardGmmCodec, model,
                    dict(kw, kernel_transforms=route), xs,
                    f"flagship {'kernel' if route else 'default'} route")
    measure(FastCheckerboardGsmCodec, gsm, kw, imgs, "GSM N=128")
    measure(FastElicGmmCodec, elic, dict(lanes=ELIC_LANES,
                                         cap_divisor=ELIC_CAP), imgs,
            "ELIC N=192 M=320")


def parallel_only():
    """``python3 chip_smoke.py --parallel``: the device line, the build and
    the parallel phase alone with its times (``full``), then the kernel
    route's launches by card."""
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.zoo import load_npz

    dev, smi_line = _device_and_build()
    model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0, device=dev)
    load_npz(model, WEIGHTS)
    model.update(update_quantiles=True)
    bound = kernel_wrappers()
    originals = {name: getattr(*where) for name, where in bound.items()}
    by_card = parallel_phase(dev, model, make_record(bound, originals),
                             smi_line, full=True)
    print(json.dumps({"parallel_launches": by_card}), flush=True)


def train_phase(dev):
    """Training on the card under the trainer's library settings (cuDNN's
    TF32 on, as PyTorch's default, matmul TF32 off, ``cudnn.benchmark``
    on), restored to this script's afterwards:
    1. the flagship (Cheng2020AnchorCheckerboardGMMv2 N=192, K=4, seed 0)
       on one fixed batch of TRAIN_BATCH random TRAIN_PATCH^2 crops of
       textured-leaves images (``random.seed(SEED0)``), TRAIN_STEPS
       ``train_step``s at the trainer's defaults: every returned term
       finite, the mean of the last 5 losses below the first 5's, the
       quantiles and a g_a weight moved by the first step; a batch holding
       a NaN leaves every parameter finite and advances both optimizers'
       step counts. Prints the median step ms of steps 6-20 (CUDA events),
       the forward and backward ms apart (medians of 3), the peak memory
       (steps 1-5, with cuDNN's autotuning, and steps 6-20 apart) and the
       top 5 device kernels of one step (profiler); and one step
       of the same weights, batch and noise under the coding path's pinned
       settings (TF32 off, no autotuning): its ms, and its loss within 1e-2 relative of
       the trainer settings' loss;
    2. the trainer CLI (``flashgmm_tpu_torch.examples.train.main``) on the
       card over a temporary folder of 768x512 textured-leaves binary PPMs
       (16 train, 4 test): 2 epochs at batch 8, 256^2, milestone 1, then a
       resume from ``latest`` for a third: three finite records in
       train_log.jsonl with lr 1e-4, 1e-5, 1e-5; ``latest`` and ``best``
       load into a fresh model bit for bit;
    3. ELIC (Elic2022GMM N=192, M=320, K=4) and the GSM checkerboard
       (Cheng2020AnchorCheckerboard N=128), seed 0: two steps each on the
       same batch, finite terms, g_a and the quantiles moved; both steps'
       ms (the first includes cuDNN's autotuning)."""
    import copy
    import random
    import statistics
    import tempfile

    import numpy as np
    import torch

    from flashgmm_tpu_torch.datasets import save_image, textured_leaves
    from flashgmm_tpu_torch.datasets.image import random_crop
    from flashgmm_tpu_torch.examples import train as trainer
    from flashgmm_tpu_torch.losses import rate_distortion_loss
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboard,
                                           Cheng2020AnchorCheckerboardGMMv2,
                                           Elic2022GMM)
    from flashgmm_tpu_torch.optimizers import net_aux_partition
    from flashgmm_tpu_torch.parallel import (make_train_state,
                                             set_guarded_grads, train_step)
    from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cudnn.benchmark, matmul.allow_tf32)

    def settings(cudnn_tf32, benchmark, matmul_tf32=False):
        cudnn.allow_tf32, cudnn.benchmark = cudnn_tf32, benchmark
        matmul.allow_tf32 = matmul_tf32

    def timed_step(model, opts, batch, gen):
        return _step_ms(train_step, model, opts, batch, gen)

    def step_counts(opt):
        return {int(st["step"]) for st in opt.state.values()}

    def quantiles(model):
        _, aux = net_aux_partition(model)
        return [p.detach().clone() for p in aux.values()]

    def first_weight(model):
        return next(p for n, p in model.named_parameters()
                    if n.startswith("g_a.")).detach().clone()

    def moved(model, q0, w0, tag):
        require(all(not torch.equal(p, q) for p, q in zip(quantiles(model),
                                                          q0)),
                f"train: {tag}: a step left the quantiles unchanged")
        require(not torch.equal(first_weight(model), w0),
                f"train: {tag}: a step left g_a's first weight unchanged")

    def finite(out, tag):
        require(all(np.isfinite(v) for v in out.values()),
                f"train: {tag}: a returned term is not finite: {out}")

    try:
        settings(True, True)  # the trainer's
        imgs = [textured_leaves(H, W, seed=SEED0 + 1 + i) for i in range(20)]
        random.seed(SEED0)
        batch = torch.from_numpy(np.stack([
            random_crop(imgs[i], TRAIN_PATCH) for i in range(TRAIN_BATCH)])
        ).to(dev)
        with torch.inference_mode(False):
            # 1. the flagship at full width --------------------------------
            batch = batch.clone()
            model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0,
                                                     device=dev)
            opts = make_train_state(model, TRAIN_LR, TRAIN_AUX_LR, 1.0)
            gen = torch.Generator(device=dev).manual_seed(SEED0)
            torch.cuda.reset_peak_memory_stats()
            q0, w0 = quantiles(model), first_weight(model)
            losses, step_ms = [], []
            for i in range(TRAIN_STEPS):
                if i == 5:  # steps 1-5 hold cuDNN's autotuning workspaces
                    peak_first = torch.cuda.max_memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                out, ms = timed_step(model, opts, batch, gen)
                finite(out, f"flagship step {i + 1}")
                if i == 0:
                    moved(model, q0, w0, "flagship")
                losses.append(out["loss"])
                step_ms.append(ms)
            peak = torch.cuda.max_memory_allocated()
            require(np.mean(losses[-5:]) < np.mean(losses[:5]),
                    f"train: the flagship's loss did not go down: {losses}")

            fwd, bwd = [], []
            net = list(net_aux_partition(model)[0].values())
            for _ in range(3):
                a, b, c = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
                torch.cuda.synchronize()
                a.record()
                o = model(batch, training=True, generator=gen)
                loss = rate_distortion_loss(o, batch, TRAIN_LMBDA)["loss"]
                b.record()
                set_guarded_grads(loss, net, 1.0)
                c.record()
                torch.cuda.synchronize()
                fwd.append(a.elapsed_time(b))
                bwd.append(b.elapsed_time(c))
                model.zero_grad(set_to_none=True)
                del o, loss
            _, busy, n_events, top = device_busy_ms(
                lambda: train_step(model, *opts, batch, gen, TRAIN_LMBDA),
                top_n=5)

            counts = [step_counts(o) for o in opts]
            bad = batch.clone()
            bad[0, 5, 7, 1] = float("nan")
            out = {k: float(v) for k, v in train_step(
                model, *opts, bad, gen, TRAIN_LMBDA).items()}
            require(not np.isfinite(out["loss"]),
                    "train: a NaN batch gave a finite loss")
            require(all(bool(torch.isfinite(p).all())
                        for p in model.parameters()),
                    "train: a NaN batch left a parameter not finite")
            require([step_counts(o) for o in opts]
                    == [{max(c) + 1} for c in counts],
                    "train: the guarded step did not count in both "
                    "optimizers")

            state = gen.get_state()
            runs = {}
            for tag, cudnn_tf32, benchmark in (("trainer", True, True),
                                               ("pinned", False, False)):
                settings(cudnn_tf32, benchmark)
                m = copy.deepcopy(model)
                o = make_train_state(m, TRAIN_LR, TRAIN_AUX_LR, 1.0)
                gen.set_state(state)
                first, ms1 = timed_step(m, o, batch, gen)
                _, ms2 = timed_step(m, o, batch, gen)
                runs[tag] = (first["loss"], ms1, ms2)
                del m, o
            settings(True, True)
            rel = abs(runs["pinned"][0] / runs["trainer"][0] - 1)
            require(rel <= 1e-2, f"train: the loss under the pinned settings is "
                    f"{100 * rel:.3f} % from the trainer settings' loss")
            print(f"  train flagship N={N} K={K}, batch {TRAIN_BATCH} x "
                  f"{TRAIN_PATCH}^2, lr {TRAIN_LR}, aux lr {TRAIN_AUX_LR}, "
                  f"lambda {TRAIN_LMBDA}: loss {losses[0]:.3f} -> "
                  f"{losses[-1]:.3f} over {TRAIN_STEPS} steps; step "
                  f"{statistics.median(step_ms[5:]):.3f} ms (median of steps "
                  f"6-{TRAIN_STEPS}, CUDA events; first step "
                  f"{step_ms[0]:.1f} ms); forward {statistics.median(fwd):.3f} "
                  f"ms, backward {statistics.median(bwd):.3f} ms (medians of "
                  f"3); peak memory {peak / 2**30:.3f} GiB over steps 6-"
                  f"{TRAIN_STEPS} ({peak_first / 2**30:.3f} GiB over steps 1-5, "
                  f"cuDNN's autotuning); one profiled step "
                  f"busy {busy:.3f} ms over {n_events} device events",
                  flush=True)
            print("  train flagship top 5 device kernels of one step: "
                  + "; ".join(f"{name[:90]} {ms:.3f} ms x{n}"
                              for name, (ms, n) in top), flush=True)
            print(f"  train flagship, one step of the same weights, batch and "
                  f"noise: trainer settings (cuDNN TF32 on, benchmark on) "
                  f"loss {runs['trainer'][0]:.4f}, {runs['trainer'][1]:.3f} "
                  f"then {runs['trainer'][2]:.3f} ms; pinned settings (TF32 "
                  f"off, benchmark off) loss {runs['pinned'][0]:.4f} "
                  f"({100 * rel:.4f} % apart), {runs['pinned'][1]:.3f} then "
                  f"{runs['pinned'][2]:.3f} ms", flush=True)
            train_world_one(dev, model, batch)
            del model, opts

            # 2. the trainer CLI over a folder of PPMs ----------------------
            with tempfile.TemporaryDirectory() as tmp:
                root = Path(tmp)
                for split, idx in (("train", range(16)),
                                   ("test", range(16, 20))):
                    (root / "data" / split).mkdir(parents=True)
                    for i in idx:
                        save_image(root / "data" / split / f"{i}.ppm", imgs[i])
                ck = root / "ck"
                args = ["-d", str(root / "data"), "-n", str(N), "-K", str(K),
                        "--batch-size", str(TRAIN_BATCH), "--patch-size",
                        str(TRAIN_PATCH), "--lr-milestones", "1", "--device",
                        str(dev), "--checkpoint-dir", str(ck)]
                t0 = time.perf_counter()
                require(trainer.main(args + ["--epochs", "2"]) == 0,
                        "train: the trainer's run failed")
                t1 = time.perf_counter()
                require(trainer.main(args + ["--epochs", "3", "--checkpoint",
                                             str(ck / "latest")]) == 0,
                        "train: the trainer's resume failed")
                t2 = time.perf_counter()
                settings(True, True)  # main() set the same
                records = [json.loads(line) for line in
                           (ck / "train_log.jsonl").read_text().splitlines()]
                require([r["epoch"] for r in records] == [0, 1, 2]
                        and all(np.isfinite(r[k]) for r in records
                                for k in ("loss", "bpp_loss", "mse_loss",
                                          "aux_loss", "test_loss")),
                        f"train: the trainer's log is not three finite "
                        f"epochs: {records}")
                lrs = [r["lr"] for r in records]
                require(np.allclose(lrs, [1e-4, 1e-5, 1e-5], rtol=1e-9,
                                    atol=0), f"train: the trainer's lr {lrs}")
                for name in ("latest", "best"):
                    saved_sd = torch.load(ck / name, map_location=dev,
                                          weights_only=True)["model"]
                    fresh = Cheng2020AnchorCheckerboardGMMv2(
                        N=N, K=K, seed=1, device=dev)
                    load_checkpoint(ck / name, fresh)
                    require(all(torch.equal(p, saved_sd[k])
                                for k, p in fresh.named_parameters()),
                            f"train: the {name} checkpoint does not load "
                            "bit for bit")
                    del fresh, saved_sd
            print(f"  train CLI: 2 epochs of 16 PPMs ({16 // TRAIN_BATCH} "
                  f"steps each, eval on 4) in {t1 - t0:.2f} s, the resumed third in "
                  f"{t2 - t1:.2f} s; lr {lrs}; loss "
                  f"{[round(r['loss'], 3) for r in records]}, test loss "
                  f"{[round(r['test_loss'], 3) for r in records]}", flush=True)

            # 3. ELIC and GSM ----------------------------------------------
            for tag, build in (
                    (f"ELIC N={N} M={ELIC_M} K={K}", lambda: Elic2022GMM(
                        N=N, M=ELIC_M, K=K, seed=0, device=dev)),
                    (f"GSM N={GSM_N}", lambda: Cheng2020AnchorCheckerboard(
                        N=GSM_N, seed=0, device=dev))):
                m = build()
                o = make_train_state(m, TRAIN_LR, TRAIN_AUX_LR, 1.0)
                q0, w0 = quantiles(m), first_weight(m)
                first, ms1 = timed_step(m, o, batch, gen)
                finite(first, tag)
                moved(m, q0, w0, tag)
                second, ms2 = timed_step(m, o, batch, gen)
                finite(second, tag)
                print(f"  train {tag}: batch {TRAIN_BATCH} x {TRAIN_PATCH}^2, "
                      f"loss {first['loss']:.3f} then {second['loss']:.3f}; "
                      f"step {ms1:.1f} ms (autotuning) then {ms2:.3f} ms",
                      flush=True)
                del m, o
    finally:
        settings(*saved)
    phase("train", "the flagship, the trainer CLI, ELIC and GSM at full "
          "width under the trainer's settings")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_ms(step, model, opts, batch, gen):
    """One step's terms and its ms (CUDA events)."""
    import torch

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = step(model, *opts, batch, gen, TRAIN_LMBDA)
    b.record()
    torch.cuda.synchronize()
    return {k: float(v) for k, v in out.items()}, a.elapsed_time(b)


def flat_parameters(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def allreduce_ms(numel, dev, reps=TIMING_REPS):
    """The median ms (CUDA events, after 3 warm-ups) of one all-reduce of
    ``numel`` float32 values over the default group: the flat gradient and
    the loss terms, as ``set_guarded_grads`` reduces them."""
    import statistics

    import torch
    import torch.distributed as dist

    buf = torch.zeros(numel, device=dev)
    times = []
    for i in range(3 + reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        dist.all_reduce(buf)
        b.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def train_world_one(dev, model, batch):
    """The flagship's ``data_parallel_train_step`` on a world-1 NCCL group
    against ``train_step``: 2 steps each from copies of ``model``, on
    ``batch``, from one generator state. cuDNN is held deterministic (no
    autotuning; TF32 as the trainer's), so a difference is the step's: the
    parameters must be bitwise equal. Prints both steps' ms and the ms of
    the all-reduce a step makes over a group (the flat gradient and the
    terms; on a world of 1 the step skips it)."""
    import copy
    import datetime

    import torch
    import torch.distributed as dist

    from flashgmm_tpu_torch.optimizers import net_aux_partition
    from flashgmm_tpu_torch.parallel import (data_parallel_train_step,
                                             make_train_state, train_step)

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(
                                seconds=TRAIN_RANK_TIMEOUT))
    try:
        runs = {}
        for tag, step in (("train_step", train_step),
                          ("data_parallel_train_step",
                           data_parallel_train_step)):
            m = copy.deepcopy(model)
            opts = make_train_state(m, TRAIN_LR, TRAIN_AUX_LR, 1.0)
            gen = torch.Generator(device=dev).manual_seed(SEED0 + 7)
            steps = [_step_ms(step, m, opts, batch, gen) for _ in range(2)]
            runs[tag] = (flat_parameters(m), steps)
            del m, opts
        (a, sa), (b, sb) = runs.values()
        require(torch.equal(a, b), "train: data_parallel_train_step on a "
                "world-1 NCCL group is not train_step bit for bit "
                f"(parameters {float((a - b).abs().max())} apart)")
        require([t for t, _ in sa] == [t for t, _ in sb],
                f"train: the world-1 step's terms {sb} are not train_step's "
                f"{sa}")
        n_flat = sum(p.numel() for p in net_aux_partition(model)[0].values())
        ar = allreduce_ms(n_flat + 3, dev)
    finally:
        dist.destroy_process_group()
        cudnn.deterministic, cudnn.benchmark = saved
    print(f"  train flagship, data_parallel_train_step on a world-1 NCCL "
          f"group (cuDNN deterministic, no autotuning): parameters bitwise "
          f"train_step's after 2 steps; step ms {sa[0][1]:.3f}, "
          f"{sa[1][1]:.3f} (train_step) and {sb[0][1]:.3f}, {sb[1][1]:.3f}; "
          f"one all-reduce of the flat gradient ({n_flat} values) and the "
          f"terms {ar:.4f} ms on the group (median of {TIMING_REPS}); "
          f"{time.perf_counter() - t0:.2f} s with the group's start",
          flush=True)


def _train_rank_group(mode):
    """The default group of a --train-rank process, from torchrun's
    variables: NCCL on cuda:LOCAL_RANK (``init_from_env``), or on a
    one-card host ("shared") gloo with every rank on cuda:0. Returns the
    rank's device."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    from flashgmm_tpu_torch.parallel import init_from_env

    timeout = datetime.timedelta(seconds=TRAIN_RANK_TIMEOUT)
    if mode == "nccl":
        return init_from_env("cuda", timeout=timeout)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    world = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", rank=int(os.environ["RANK"]),
        world_size=world, timeout=timeout)
    return dev


def train_rank_steps(dev, shared=False):
    """One rank's work in --train-parallel, under the trainer's library
    settings: the flagship (N, K, seed 0) on global batches of
    TRAIN_PATCH^2 random crops of textured-leaves images (the train
    phase's batch of 8 first). The first rank alone times ``train_step`` on
    each whole global batch (a first step, then TRAIN_PAR_TIMED) while the
    others wait; then every rank runs TRAIN_STEPS
    ``data_parallel_train_step``s on its rows of the batch of 8 (finite
    terms), all-gathers the flat parameters (bitwise equal on every rank),
    takes 1 + TRAIN_PAR_TIMED steps at each larger global batch, and times
    one all-reduce of the flat gradient and the terms. ``shared``: the
    ranks share one card, and each is held to its share of the card's
    memory once the first rank's one-card steps are done. Returns the
    rank's report: losses, ms, peak memory, whether the replicas are
    equal."""
    import copy
    import random
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.datasets.image import random_crop
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.optimizers import net_aux_partition
    from flashgmm_tpu_torch.parallel import (broadcast_parameters,
                                             data_parallel_train_step,
                                             local_rows, make_train_state,
                                             train_step)

    torch.backends.cudnn.allow_tf32 = True  # the trainer's settings
    torch.backends.cudnn.benchmark = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    imgs = [textured_leaves(H, W, seed=SEED0 + 1 + i) for i in range(20)]

    def global_batch(b):
        random.seed(SEED0 + b - TRAIN_BATCH)  # the train phase's at 8
        return torch.from_numpy(np.stack([
            random_crop(imgs[i % len(imgs)], TRAIN_PATCH) for i in range(b)])
        ).to(dev)

    def timed_steps(step, model, opts, batch, gen, n):
        outs = [_step_ms(step, model, opts, batch, gen) for _ in range(n)]
        for out, _ in outs:
            require(all(np.isfinite(v) for v in out.values()),
                    f"train-parallel: rank {rank}: a term is not finite: "
                    f"{out}")
        return outs

    model = Cheng2020AnchorCheckerboardGMMv2(N=N, K=K, seed=0, device=dev)
    broadcast_parameters(model)
    report = {"rank": rank, "world": world, "device": str(dev),
              "card": torch.cuda.get_device_name(dev)}
    if rank == 0:
        for b in TRAIN_PAR_BATCHES:
            m = copy.deepcopy(model)
            opts = make_train_state(m, TRAIN_LR, TRAIN_AUX_LR, 1.0)
            gen = torch.Generator(device=dev).manual_seed(SEED0)
            outs = timed_steps(train_step, m, opts, global_batch(b), gen,
                               1 + TRAIN_PAR_TIMED)
            report[f"one_{b}"] = {
                "loss": outs[0][0]["loss"], "first_ms": outs[0][1],
                "ms": statistics.median(t for _, t in outs[1:])}
            del m, opts, outs
            torch.cuda.empty_cache()
    dist.barrier()
    if shared:
        torch.cuda.set_per_process_memory_fraction(0.9 / world, dev)

    opts = make_train_state(model, TRAIN_LR, TRAIN_AUX_LR, 1.0)
    gen = torch.Generator(device=dev).manual_seed(SEED0)
    torch.cuda.reset_peak_memory_stats(dev)
    rows = local_rows(global_batch(TRAIN_BATCH))
    outs = timed_steps(data_parallel_train_step, model, opts, rows, gen, 5)
    peak_first = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    outs += timed_steps(data_parallel_train_step, model, opts, rows, gen,
                        TRAIN_STEPS - 5)
    losses = [o["loss"] for o, _ in outs]
    flat = flat_parameters(model)
    replicas = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(replicas, flat)
    report[f"group_{TRAIN_BATCH}"] = {
        "losses": losses, "first_ms": outs[0][1],
        "ms": statistics.median(t for _, t in outs[5:]),
        "peak": torch.cuda.max_memory_allocated(dev), "peak_first": peak_first}
    report["equal"] = all(torch.equal(r, flat) for r in replicas)
    for b in TRAIN_PAR_BATCHES[1:]:
        outs = timed_steps(data_parallel_train_step, model, opts,
                           local_rows(global_batch(b)), gen,
                           1 + TRAIN_PAR_TIMED)
        report[f"group_{b}"] = {
            "first_ms": outs[0][1],
            "ms": statistics.median(t for _, t in outs[1:]),
            "peak": torch.cuda.max_memory_allocated(dev)}
    n_flat = sum(p.numel() for p in net_aux_partition(model)[0].values())
    report["allreduce_ms"] = allreduce_ms(n_flat + 3, dev)
    report["flat_values"] = n_flat
    return report


def train_rank(out_path, mode):
    """``python3 chip_smoke.py --train-rank OUT nccl|shared``: one rank of
    --train-parallel, started with torchrun's variables; its report as JSON
    in OUT."""
    import torch.distributed as dist

    dev = _train_rank_group(mode)
    try:
        report = train_rank_steps(dev, shared=mode == "shared")
    finally:
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(report))


def _tail(path, n=3000):
    return Path(path).read_text(errors="replace")[-n:]


def train_parallel_only():
    """``python3 chip_smoke.py --train-parallel``: training across the
    host's cards, alone. One process a card over NCCL (``--train-rank``,
    torchrun's variables); on a one-card host TRAIN_SHARED_RANKS processes
    on cuda:0 over gloo in its place (NCCL refuses two ranks on one card).
    Each rank runs ``train_rank_steps``: the flagship at full width on
    global batches of TRAIN_PAR_BATCHES x TRAIN_PATCH^2, the loss going
    down over TRAIN_STEPS steps, the replicas bitwise equal after them, the
    first step's loss within TRAIN_PAR_LOSS_RTOL of one card's
    ``train_step`` on the whole batch. Prints the step ms at each global
    batch on one card and on all, the all-reduce's ms and its share of a
    step, and each card's peak memory. Then the trainer CLI under torchrun
    (one process a card; on a one-card host one process) for one epoch on a
    temporary folder of PPMs written as the train phase writes its folder:
    one finite log line of 2 steps."""
    import os
    import tempfile

    import numpy as np
    import torch

    from flashgmm_tpu_torch.datasets import save_image, textured_leaves

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    cards = torch.cuda.device_count()
    phase("device", f"{torch.cuda.get_device_name(0)} | {smi_line} | "
          f"{cards} cards")
    world, mode = (cards, "nccl") if cards > 1 else (TRAIN_SHARED_RANKS,
                                                     "shared")
    tmp = tempfile.TemporaryDirectory()
    _CLEANUP.append(tmp.cleanup)
    root = Path(tmp.name)
    port, procs = free_port(), []

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    _CLEANUP.insert(0, stop)  # before the folder goes
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank if mode == "nccl" else 0),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        with open(root / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--train-rank",
                 str(root / f"rank{rank}.json"), mode], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + 2 * TRAIN_RANK_TIMEOUT
    for rank, proc in enumerate(procs):
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            rc = None
        require(rc == 0, f"train-parallel: rank {rank} ended with {rc}:\n"
                + _tail(root / f"rank{rank}.log"))
    reports = [json.loads((root / f"rank{r}.json").read_text())
               for r in range(world)]
    phase("train-ranks", f"{world} ranks ({mode}) done")
    train_parallel_report(reports, mode, smi_line)

    # the trainer CLI under torchrun --------------------------------------
    imgs = [textured_leaves(H, W, seed=SEED0 + 1 + i) for i in range(20)]
    for split, idx in (("train", range(16)), ("test", range(16, 20))):
        (root / "data" / split).mkdir(parents=True)
        for i in idx:
            save_image(root / "data" / split / f"{i}.ppm", imgs[i])
    cli_world = cards  # one process a card; NCCL refuses two on one
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", str(cli_world), "--master-addr", "127.0.0.1",
         "--master-port", str(free_port()), "-m",
         "flashgmm_tpu_torch.examples.train", "-d", str(root / "data"),
         "-n", str(N), "-K", str(K), "--batch-size", str(TRAIN_BATCH),
         "--patch-size", str(TRAIN_PATCH), "--epochs", "1",
         "--checkpoint-dir", str(root / "ck")], cwd=ROOT,
        capture_output=True, text=True, timeout=2 * TRAIN_RANK_TIMEOUT)
    seconds = time.perf_counter() - t0
    require(cli.returncode == 0, "train-parallel: the trainer under torchrun "
            f"ended with {cli.returncode}:\n{cli.stderr[-3000:]}")
    records = [json.loads(line) for line in
               (root / "ck" / "train_log.jsonl").read_text().splitlines()]
    require(len(records) == 1 and records[0]["steps"] == 16 // TRAIN_BATCH
            and all(np.isfinite(records[0][k]) for k in
                    ("loss", "bpp_loss", "mse_loss", "aux_loss",
                     "test_loss")),
            f"train-parallel: the trainer's log under torchrun: {records}")
    require((root / "ck" / "latest").exists(),
            "train-parallel: the trainer wrote no latest checkpoint")
    r = records[0]
    print(f"  train-parallel CLI: torchrun --nproc-per-node {cli_world}, 1 "
          f"epoch of 16 768x512 PPMs at global batch {TRAIN_BATCH} x "
          f"{TRAIN_PATCH}^2 ({r['steps']} steps, eval on 4): loss "
          f"{r['loss']:.3f}, test loss {r['test_loss']:.3f}; the epoch "
          f"{r['seconds']:.2f} s (its log), the run {seconds:.2f} s with "
          f"the processes' start; {smi_line}", flush=True)
    phase("train-parallel", f"training across {world} ranks and the trainer "
          "CLI under torchrun")


def train_parallel_report(reports, mode, smi_line):
    """The checks and lines of --train-parallel from the ranks' reports."""
    import numpy as np

    world = len(reports)
    first = reports[0]
    losses = first[f"group_{TRAIN_BATCH}"]["losses"]
    require(all(r["equal"] for r in reports),
            "train-parallel: the replicas differ after the steps")
    require(all(r[f"group_{TRAIN_BATCH}"]["losses"] == losses
                for r in reports),
            "train-parallel: the ranks logged other global losses")
    require(np.mean(losses[-5:]) < np.mean(losses[:5]),
            f"train-parallel: the loss did not go down: {losses}")
    ref = first[f"one_{TRAIN_BATCH}"]["loss"]
    rel = abs(losses[0] / ref - 1)
    require(rel <= TRAIN_PAR_LOSS_RTOL,
            f"train-parallel: the first step's loss {losses[0]} is "
            f"{100 * rel:.3f} % from one card's train_step's {ref}")
    ar = first["allreduce_ms"]
    where = (f"{world} cards, NCCL" if mode == "nccl" else
             f"{world} ranks on one card over gloo (a one-card host)")
    print(f"  train-parallel: the flagship N={N} K={K} over {where}; "
          f"global batch {TRAIN_BATCH} x {TRAIN_PATCH}^2: loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f} over {TRAIN_STEPS} steps, "
          f"the first {100 * rel:.4f} % from one card's train_step ({ref:.3f}); "
          f"replicas bitwise equal; {smi_line}", flush=True)
    for b in TRAIN_PAR_BATCHES:
        one, group = first[f"one_{b}"], first[f"group_{b}"]
        print(f"  train-parallel step ms at global batch {b}: one card "
              f"{one['ms']:.3f} (first {one['first_ms']:.1f}), {world} ranks "
              f"{group['ms']:.3f} (first {group['first_ms']:.1f}; medians of "
              f"the timed steps, CUDA events); all-reduce of "
              f"{first['flat_values'] + 3} float32 values {ar:.4f} ms, "
              f"{100 * ar / group['ms']:.2f} % of the step", flush=True)
    print("  train-parallel peak memory by rank (GiB; steps 1-5 with cuDNN's "
          "autotuning, steps 6-20, then the larger batches): "
          + "; ".join(f"{r['device']} {r[f'group_{TRAIN_BATCH}']['peak_first'] / 2**30:.3f}, "
                      f"{r[f'group_{TRAIN_BATCH}']['peak'] / 2**30:.3f}, "
                      + ", ".join(f"{r[f'group_{b}']['peak'] / 2**30:.3f}"
                                  for b in TRAIN_PAR_BATCHES[1:])
                      for r in reports), flush=True)


def kernel_wrappers():
    """{name: (module, attribute)} of every kernel wrapper: the main path's
    codecs call each through its module's name, so a replaced attribute
    sees every call."""
    from flashgmm_tpu_torch.ans import rans_kernels, rows_kernel
    from flashgmm_tpu_torch.ops import conv_kernel

    return {"rans_encode": (rans_kernels, "encode_scan"),
            "rans_encode_gmm": (rans_kernels, "encode_scan_gmm"),
            "rans_decode": (rans_kernels, "decode_scan"),
            "rans_decode_gmm": (rans_kernels, "decode_scan_gmm"),
            "gmm_bounds": (rows_kernel, "gmm_bounds"),
            "gmm_rows": (rows_kernel, "gmm_rows"),
            "gmm_softmax": (rows_kernel, "gmm_softmax"),
            "gmm_boundary_rows": (rows_kernel, "gmm_boundary_rows"),
            "gaussian_boundary_rows": (rows_kernel, "gaussian_boundary_rows"),
            "conv2d_nhwc": (conv_kernel, "conv2d_nhwc"),
            "conv2d_nhwc_bf16": (conv_kernel, "conv2d_nhwc_bf16")}


def make_record(bound, originals):
    """record(run): run() with every kernel wrapper wrapped in a recorder
    that keeps its inputs, every launch counted from 0: (run's result,
    launches, recorded calls). The wrappers' bodies count on the name their
    module binds, so during the run the counts land on the recorders, which
    start at 0."""
    def record(run):
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
    return record


_CLEANUP = []  # what stops the processes a run started, and removes files


def main() -> int:
    faulthandler.dump_traceback_later(1150, exit=True)
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--bytes-worker":
        if not torch.cuda.is_available():
            return 1
        bytes_worker(*sys.argv[2:5])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--train-rank":
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, str(ROOT))
        train_rank(*sys.argv[2:4])
        faulthandler.cancel_dump_traceback_later()
        return 0
    alone = {"--zoo": zoo_only, "--vbr": vbr_only, "--video": video_only,
             "--pcc": pcc_only, "--tools": tools_only,
             "--parallel": parallel_only,
             "--train-parallel": train_parallel_only}
    if len(sys.argv) > 1 and sys.argv[1] in alone:
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, str(ROOT))
        try:
            with torch.inference_mode():
                alone[sys.argv[1]]()
        finally:
            for stop in _CLEANUP:
                stop()
        faulthandler.cancel_dump_traceback_later()
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        with torch.inference_mode():
            smoke()
    finally:
        for stop in _CLEANUP:
            stop()
    faulthandler.cancel_dump_traceback_later()
    return 0


def _device_and_build():
    """The device line and the build of a phase run alone: (device,
    nvidia-smi's name and power limit)."""
    import torch

    from flashgmm_tpu_torch import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    phase("device", f"{torch.cuda.get_device_name(0)} | {smi_line}")
    kernels = _build.load()
    phase("build", f"nvcc {kernels.seconds:.2f} s -> {kernels.path.name}")
    return dev, smi_line


def _cpu_side():
    """A started CpuSide, stopped on the way out."""
    cpu = CpuSide(CPU_SIDE_THREADS)
    _CLEANUP.append(cpu.close)
    return cpu


def vbr_only():
    """``python3 chip_smoke.py --vbr``: the device line, the build and the
    vbr phase alone, then each kernel's launches on its path."""
    dev, smi_line = _device_and_build()
    cpu = _cpu_side()
    bound = kernel_wrappers()
    originals = {name: getattr(*where) for name, where in bound.items()}
    launches, _ = vbr_phase(dev, make_record(bound, originals), originals,
                            smi_line, cpu)
    cpu.drain()
    print(json.dumps({"vbr_launches": launches}), flush=True)


def video_only():
    """``python3 chip_smoke.py --video``: the device line, the build and the
    video phase alone, then each kernel's launches on its path."""
    dev, smi_line = _device_and_build()
    cpu = _cpu_side()
    bound = kernel_wrappers()
    originals = {name: getattr(*where) for name, where in bound.items()}
    launches, _ = video_phase(dev, make_record(bound, originals), smi_line,
                              cpu)
    cpu.drain()
    print(json.dumps({"video_launches": launches}), flush=True)


def pcc_only():
    """``python3 chip_smoke.py --pcc``: the device line, the build and the
    pcc phase alone."""
    dev, smi_line = _device_and_build()
    cpu = _cpu_side()
    bound = kernel_wrappers()
    originals = {name: getattr(*where) for name, where in bound.items()}
    pcc_phase(dev, make_record(bound, originals), smi_line, cpu)
    cpu.drain()


def zoo_only():
    """``python3 chip_smoke.py --zoo``: the device line, the build and the
    zoo phase alone, then each kernel's launches on its path."""
    dev, smi_line = _device_and_build()
    cli = ZooCli(dev)
    _CLEANUP.append(cli.close)
    cli.start()
    cpu = _cpu_side()
    bound = kernel_wrappers()
    originals = {name: getattr(*where) for name, where in bound.items()}
    launches, _ = zoo_phase(dev, make_record(bound, originals), originals,
                            smi_line, cli, cpu)
    cpu.drain()
    print(json.dumps({"zoo_launches": launches}), flush=True)


def smoke():
    import numpy as np
    import torch

    from flashgmm_tpu_torch import _build
    from flashgmm_tpu_torch.ans import interleaved as il
    from flashgmm_tpu_torch.ans import rans_kernels, rows_kernel
    from flashgmm_tpu_torch.ans.gaussian_cdf import (
        gaussian_boundary_rows_plain, get_approx_mode, gmm_boundary_rows_plain,
        gmm_guarded_bounds, gmm_guarded_bounds_plain, gmm_guarded_rows,
        gmm_guarded_rows_plain, gmm_softmax_plain)
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
    # the zoo phase's CPU runs of the eval CLI, in the background from here
    zoo_cli = ZooCli(dev)
    _CLEANUP.append(zoo_cli.close)
    zoo_cli.start()
    # the process for the later phases' CPU decodes of the card's strings
    cpu = _cpu_side()
    early = tools_early(cpu)  # the tools phase's binaries and UHD image

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
    # recorder that keeps its inputs for the timing phase.
    bound = kernel_wrappers()
    originals = {name: getattr(*where) for name, where in bound.items()}
    record = make_record(bound, originals)

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
                        "gaussian_boundary_rows", "conv2d_nhwc_bf16"):
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

    procs = []

    def bytes_run(route, setup):
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--bytes-worker",
             route, setup, "1"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        return procs[-1]

    def bytes_digest(proc, route, setup):
        out, err = proc.communicate(timeout=300)
        require(proc.returncode == 0, f"bytes worker {route} {setup} failed:"
                f" {err[-2000:]}")
        return json.loads(out.strip().splitlines()[-1])

    routes = ("default", "kernel")
    # the two cold processes side by side; each hog process alone, as it
    # takes the card's free memory
    try:
        colds = {route: bytes_run(route, "cold") for route in routes}
        digests = {(route, "cold"): bytes_digest(colds[route], route, "cold")
                   for route in routes}
        for route in routes:
            digests[(route, "hog")] = bytes_digest(bytes_run(route, "hog"),
                                                   route, "hog")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for route in routes:
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
                                              originals, smi_line, cpu)

    # 11b. the last modules: tiled synthesis, the .fgm CLI, the standalone
    # codec, the range coder --------------------------------------------
    tools_launches, tools_calls, tools_cpu = tools_phase(
        dev, model, record, smi_line, early)

    # 11c. batch-data-parallel coding and the sharded forwards over every
    # card (on one card over slots named on it) ------------------------------
    par_by_card = parallel_phase(dev, model, record, smi_line)

    # 12. the variable-bitrate models, while the eval CLI's CPU runs go on
    vbr_launches, vbr_calls = vbr_phase(dev, record, originals, smi_line,
                                        cpu)

    # 13. scale-space flow video, while the eval CLI's CPU runs go on -----
    video_launches, video_calls = video_phase(dev, record, smi_line, cpu)

    # 13b. point-cloud compression, while the eval CLI's CPU runs go on ---
    pcc_phase(dev, record, smi_line, cpu)

    # 14. training at full width under the trainer's settings, while the
    # eval CLI's CPU runs go on --------------------------------------------
    train_phase(dev)
    torch.cuda.empty_cache()  # room for the zoo phase's card runs

    # 15. the image-model line and the evaluation CLIs --------------------
    zoo_launches, zoo_calls = zoo_phase(dev, record, originals, smi_line,
                                        zoo_cli, cpu)
    # the tools phase's CPU decodes (the flagship's takes minutes of CPU),
    # queued once the eval CLI's CPU runs, which the zoo phase waits for,
    # are done: they run beside the timing phase
    for job in tools_cpu:
        cpu.submit(*job)

    # 16. timing of every recorded call -----------------------------------
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
        if name == "gaussian_boundary_rows":
            sc, _, nb, md = args
            n, L = sc.shape[0], nb + 1
            got = originals[name](*args).cpu().numpy().astype(np.int64)
            err = int(np.abs(got - gaussian_boundary_rows_plain(*args).cpu()
                             .numpy().astype(np.int64)).max())
            # uint16 rows out, the scales in; each entry's one term and its
            # quantization
            return (2 * n * L + 4 * n,
                    n * L * (ROWS_FLOPS_PER_TERM[md] + 2), err, None)
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
        nbytes, flops = conv_work(xi, wi, bi, res)
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
        return cuda_ms(run, TIMING_REPS)  # as the kernel is timed

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
        return cuda_ms(lambda: originals["rans_encode_gmm"](*one),
                       TIMING_REPS, True)

    plains = {"rans_encode": il.encode_scan, "rans_decode": il.decode_scan,
              "rans_encode_gmm": rans_kernels.encode_scan_gmm_plain,
              "rans_decode_gmm": rans_kernels.decode_scan_gmm_plain,
              "gmm_bounds": gmm_guarded_bounds_plain,
              "gmm_rows": gmm_guarded_rows_plain,
              "gmm_boundary_rows": gmm_boundary_rows_plain,
              "gaussian_boundary_rows": gaussian_boundary_rows_plain,
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
        # the same kernel at K=1 for the plain-XLA gaussian_boundary_rows
        # (the search coder's single-Gaussian rows)
        "gaussian_boundary_rows": ("flashgmm_tpu_torch/csrc/gmm_rows.cu",
                                   "flashgmm_tpu/ans/gaussian_cdf.py:170"),
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
    # the single-Gaussian rows run on the zoo path alone (mbt2018-mean's
    # search coder)
    calls["gaussian_boundary_rows"] = zoo_calls["gaussian_boundary_rows"]
    launches["gaussian_boundary_rows"] = zoo_launches["gaussian_boundary_rows"]
    # the latency path's calls (batch 1, lanes=LAT_LANES): its eager run of
    # the functions its graphs capture; the bf16 conv's on the kernel route
    lat_words = {route: [int(run[0][k].n_words) for k in ("z", "y0", "y1")]
                 for route, run in lat_runs.items()}
    # the K=1 instances run on the GSM path alone: their launches, calls and
    # times there are their main path's
    for name in K1_INSTANCES:
        calls[f"{name}_k1"] = gsm_calls[f"{name}_k1"]
        launches[f"{name}_k1"] = gsm_launches[f"{name}_k1"]

    def path_times(base, kern, peak, path_calls, words, device=False):
        """A path's calls of one kernel (ELIC's, the GSM codec's, ...): each
        distinct call (a conv's shapes: the decoder's rows-chain convs
        repeat the encoder's, a VBR level's the level before's; every coder
        call) held to its plain version and timed once, its bound and times
        counted at each of its calls: ({"ms", "device_ms", "bound_ms"},
        max|kernel - plain|, zero-inserted conv inputs). ``device`` times
        every kernel on the device alone too, not only DEVICE_TIMED's."""
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
                seen[key] = {
                    "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                          flops / peak),
                    "ms": cuda_ms(lambda: kern(*args, **kwargs),
                                  TIMING_REPS),
                    "device_ms": cuda_ms(lambda: kern(*args, **kwargs),
                                         TIMING_REPS, True)
                    if device or base in DEVICE_TIMED else 0.0}
            for k in t:
                t[k] += seen[key][k]
        return t, err, inserted

    results = []
    # seconds on those paths' calls
    t_lat = t_elic = t_gsm = t_ref = t_zoo = t_vbr = t_video = t_tools = 0.0
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
            ms += cuda_ms(lambda: kern(*args, **kwargs), TIMING_REPS)
            if base in DEVICE_TIMED:
                device_ms += cuda_ms(lambda: kern(*args, **kwargs),
                                     TIMING_REPS, True)
            # stats has just run the plain version on these inputs
            plain_ms += cuda_ms(lambda: plains[base](*args, **kwargs), 1,
                                warm=False)
            if library is not None:
                lib_ms = (lib_ms or 0.0) + cuda_ms(library, TIMING_REPS)
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
            lat_t["ms"] += cuda_ms(lambda: kern(*args, **kwargs), TIMING_REPS)
            if name in DEVICE_TIMED:
                lat_t["device_ms"] += cuda_ms(lambda: kern(*args, **kwargs),
                                              TIMING_REPS, True)
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
        t0 = time.perf_counter()
        zoo_t, e, _ = path_times(base, kern, peak, zoo_calls.get(name, [])
                                 if name == base else [], pass_words)
        err = max(err, e)
        t_zoo += time.perf_counter() - t0
        t0 = time.perf_counter()
        vbr_t, e, vbr_inserted = path_times(
            base, kern, peak, vbr_calls.get(name, []) if name == base else [],
            pass_words)
        err = max(err, e)
        t_vbr += time.perf_counter() - t0
        t0 = time.perf_counter()
        video_t, e, video_inserted = path_times(
            base, kern, peak, video_calls.get(name, []) if name == base
            else [], pass_words, device=name == "conv2d_nhwc")
        err = max(err, e)
        t_video += time.perf_counter() - t0
        t0 = time.perf_counter()
        tools_t, e, _ = path_times(
            base, kern, peak, tools_calls.get(name, []) if name == base
            else [], pass_words)
        err = max(err, e)
        t_tools += time.perf_counter() - t0
        if name == "conv2d_nhwc":  # h_s's deconvs in the encode and decode
            require(inserted == 2 * ELIC_INSERTED, f"ELIC: {inserted} "
                    "zero-inserted conv inputs, not h_s's deconvs'")
            require(gsm_inserted == 0 and all(
                inserted_stride(a[0]) == 1 for a, _ in calls[name]),
                "a zero-inserted conv input on the flagship's or GSM path")
            # two of h_s's three convs a direction are transposed
            require(3 * vbr_inserted == 2 * vbr_launches[name],
                    f"vbr: {vbr_inserted} zero-inserted conv inputs of "
                    f"{vbr_launches[name]} launches, not h_s's deconvs'")
            # every conv of the video hyper decoders is a stride-2 deconv
            require(video_inserted == video_launches[name], f"video: "
                    f"{video_inserted} zero-inserted conv inputs of "
                    f"{video_launches[name]} launches")
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
        if name != base or name == "gaussian_boundary_rows":
            results[-1]["instance"] = "K=1 (zero means, unit weights)"
        results[-1]["parallel_launches"] = (par_by_card.get(name, {})
                                            if name == base else {})
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
                            "reference_bound_ms": ref_t["bound_ms"],
                            "zoo_launches": zoo_launches.get(name, 0)
                            if name == base else 0,
                            "zoo_ms": zoo_t["ms"],
                            "zoo_bound_ms": zoo_t["bound_ms"],
                            "vbr_launches": vbr_launches.get(name, 0)
                            if name == base else 0,
                            "vbr_ms": vbr_t["ms"],
                            "vbr_bound_ms": vbr_t["bound_ms"],
                            "video_launches": video_launches.get(name, 0)
                            if name == base else 0,
                            "video_ms": video_t["ms"],
                            "video_bound_ms": video_t["bound_ms"],
                            "tools_launches": tools_launches.get(name, 0)
                            if name == base else 0,
                            "tools_ms": tools_t["ms"],
                            "tools_bound_ms": tools_t["bound_ms"]})
        if base in DEVICE_TIMED or name == "conv2d_nhwc":
            results[-1]["video_device_ms"] = video_t["device_ms"]
        if base in DEVICE_TIMED:
            results[-1]["device_ms"] = device_ms
            results[-1]["latency_device_ms"] = lat_t["device_ms"]
            results[-1]["elic_device_ms"] = elic_t["device_ms"]
            results[-1]["gsm_device_ms"] = gsm_t["device_ms"]
            results[-1]["reference_device_ms"] = ref_t["device_ms"]
            results[-1]["zoo_device_ms"] = zoo_t["device_ms"]
            results[-1]["vbr_device_ms"] = vbr_t["device_ms"]
            results[-1]["tools_device_ms"] = tools_t["device_ms"]
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
          f"in device-rows mode, {t_ref:.2f} s; zoo_*: of the image-model "
          f"line's compress + decompress of one image, {t_zoo:.2f} s; vbr_*: "
          f"of the VBR models' compress + decompress of two images at each "
          f"level, {t_vbr:.2f} s; video_*: of the video phase's eval CLI run "
          f"and GOP, compress + decompress, {t_video:.2f} s; tools_*: of the "
          "tools phase's tiled UHD g_s on the kernel route and its "
          f"in-process .fgm CLI encode + decode, {t_tools:.2f} s)")

    # 17. the CPU decodes queued by phases 11, 11b, 12, 13, 13b and 15 ----
    cpu.drain()
    phase("cpu", "the card's strings and files decoded on the CPU by copies "
          "of the models, in a process of their own beside phases 11-16 "
          "(this phase's seconds: the wait for the last)")

    print(f"smoke total {time.perf_counter() - _T_START:.2f} s", flush=True)
    print(json.dumps({"kernels": results, "card": kind,
                      "power_limit": smi_line.split(",")[-1].strip()}),
          flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

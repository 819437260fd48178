"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip without a CUDA device. This file imports no JAX
(the machine with the card has none), so run it there without the repo's
conftest, which imports JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q

Every kernel must equal its plain version bit for bit: rANS encode (over
materialized bounds, and over GMM parameters whose bounds it evaluates
itself, which also equals the bounds kernel followed by the encoder),
both row sources of the cluster
decoder (materialized rows, and the GMM rows
evaluated on demand) at cluster sizes up to 16 (``MAX_CLUSTER`` lowered
to reach the smaller ones), the GMM rows and bounds
kernels (against the plain version, which is XLA's CPU arithmetic written
out), and the conv (against its plain version, the same fmaf chain with
an exact FMA), which is also bitwise batch-invariant. The bf16 conv (the
transforms' route) is held to one bf16 ulp of its plain version, which
sums in another order (1e-5 of max|plain| for an f32 result), at every
shape the N=192 transforms route to it (with HWIO and with packed
weights), at a full batch of 24 of the largest level, at ragged edges and
in each shape class the wrapper takes; operands off the kernel's alignment
or not contiguous are copied, never read wrongly. ELIC's rows chain on the
card (h_s's transposed convs as zero-inserted convs included) gives the
CPU plain version's GMM parameters bit for bit, its batched and latency
codecs round-trip exactly, and its three graphs launch as the eager run.
The coders' K=1 instances (the single-Gaussian passes) equal their plain
versions; the GSM codec's rows chain on the card gives the CPU plain
version's scales and means bit for bit, its round trips are exact on both
routes, and its bytes cross between the card and the CPU. The reference
format's boundary-rows kernel and the coding softmax kernel equal their
plain versions; the card's mixture weights, and so the batched codecs'
bytes of one image, equal the CPU's; reference-format round trips are
exact on the card in both modes, and the card's strings decode on the CPU.
The search coder's single-Gaussian rows kernel equals its plain version,
and its card strings decode on the CPU.
One training step of the narrow flagship on the card agrees with the
CPU's (loss and gradients within 1e-4, TF32 off, zero noise), and its
non-finite guard keeps the parameters finite. A VBR model's round trip on
the card is exact, and its card strings decode on the CPU to the card's
symbols. The video model's (ssf2020) round trip of a GOP on the card is
exact, and the CPU decodes the card's strings to every branch's y_hat bit
for bit. A point-cloud codec's (hrtzxf2022) round trip on the card is
repeatable, and the CPU decodes the card's strings to the card's symbols.
Tiled synthesis of the flagship's g_s stays within the JAX test's bounds
of the direct g_s on both transform routes. Over every card of a host of
two or more (they skip below two): the flagship's batch coded with
``use_mesh`` round-trips exactly, its bytes cross one card and the mesh
both ways (every card launching the bf16 conv on the kernel route), its
height-sharded forward stays within the JAX test's bounds of the whole
forward, and ``data_parallel_train_step`` over the cards keeps its
replicas bitwise equal and its terms within 1e-4 of one card's step.
"""

import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from flashgmm_tpu_torch.ans import interleaved as il
from flashgmm_tpu_torch.ans import rans_kernels, rows_kernel
from flashgmm_tpu_torch.ans.gaussian_cdf import (gmm_guarded_bounds,
                                                 gmm_guarded_bounds_plain,
                                                 gmm_guarded_rows,
                                                 gmm_guarded_rows_plain)
from flashgmm_tpu_torch.layers import run_canonical
from flashgmm_tpu_torch.ops import conv_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _coder_case(n, w, num_bins, dev, seed=0):
    rs = np.random.RandomState(seed)
    k = 3
    s = torch.from_numpy(rs.uniform(0.11, 10, (n, k)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rs.normal(0, 3, (n, k)).astype(np.float32)).to(dev)
    wt = rs.uniform(0.1, 1, (n, k)).astype(np.float32)
    wt = torch.from_numpy(wt / wt.sum(1, keepdims=True)).to(dev)
    lo = -(num_bins // 2)
    params = (s, m, wt)
    rows = gmm_guarded_rows(*params, lo, num_bins)
    values = torch.from_numpy(np.clip(np.round(rs.normal(0, 4, n)), lo,
                                      lo + num_bins - 1).astype(np.int64)).to(dev)
    start = rows.gather(1, (values - lo)[:, None])[:, 0]
    freq = rows.gather(1, (values - lo + 1)[:, None])[:, 0] - start
    t, pad = il.layout(n, w)
    active = il.active_mask(n, t, w, dev)
    rows = torch.cat([rows, rows[-1:].expand(pad, -1)]) if pad else rows
    return (il.to_lanes(start, w), il.to_lanes(freq, w), active,
            rows.reshape(t, w, -1), values, lo, params)


# the W/T grid; T = n / W steps, T = 1 in the last rows
@pytest.mark.parametrize("w,n,num_bins", [
    (40, 1000, 19), (128, 5000, 97), (1000, 9000, 33), (4096, 30000, 97),
    (8192, 40000, 97), (1000, 1000, 97), (4096, 4000, 97), (8192, 8192, 97)])
def test_rans_kernels_match_plain(cuda, monkeypatch, w, n, num_bins):
    starts, freqs, active, rows, values, lo, params = _coder_case(
        n, w, num_bins, cuda)
    before = rans_kernels.encode_scan.launches
    st_k, wd_k, em_k = rans_kernels.encode_scan(starts, freqs, active)
    st_p, wd_p, em_p = il.encode_scan(starts, freqs, active)
    assert rans_kernels.encode_scan.launches == before + 1
    assert torch.equal(st_k, st_p) and torch.equal(em_k, em_p)
    s_k, n_k = il.pack_words(wd_k, em_k)
    s_p, n_p = il.pack_words(wd_p, em_p)
    assert int(n_k) == int(n_p) and torch.equal(s_k, s_p)

    sym_p = il.decode_scan(st_k, s_k, rows, active, lo)
    assert torch.equal(il.from_lanes(sym_p, n).long(), values)
    before = (rans_kernels.decode_scan.launches,
              rans_kernels.decode_scan_gmm.launches)
    # every cluster size gives the same symbols: the cap lowers the
    # cluster min(cap, ceil(W / 256)) that W alone would pick
    for cap in (16, 8, 2, 1):
        monkeypatch.setattr(rans_kernels, "MAX_CLUSTER", cap)
        sym_k = rans_kernels.decode_scan(st_k, s_k[: int(n_k)], rows, active,
                                         lo)
        assert torch.equal(sym_k, sym_p), ("rows", cap)
        sym_g = rans_kernels.decode_scan_gmm(st_k, s_k[: int(n_k)], *params,
                                             active, lo, num_bins)
        assert torch.equal(sym_g, sym_p), ("gmm", cap)
    assert rans_kernels.decode_scan.launches == before[0] + 4
    assert rans_kernels.decode_scan_gmm.launches == before[1] + 4
    ref = rans_kernels.decode_scan_gmm_plain(st_k, s_k, *params, active, lo,
                                             num_bins)
    assert torch.equal(ref, sym_p)


def _gmm_symbols(n, k, num_bins, dev, seed):
    """Seeded [n, K] mixture parameters and [n] symbols, both ends of the
    range included."""
    rs = np.random.RandomState(seed)
    s = rs.uniform(0.11, 10, (n, k))
    m = rs.normal(0, 3, (n, k))
    w = rs.uniform(0.1, 1, (n, k))
    w /= w.sum(1, keepdims=True)
    lo = -(num_bins // 2)
    v = np.clip(np.round(rs.normal(0, 4, n)), lo, lo + num_bins - 1)
    v[:3], v[3:6] = lo, lo + num_bins - 1
    params = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (s, m, w)]
    return torch.from_numpy(v.astype(np.int32)).to(dev), params, lo


# the W/T grid of test_rans_kernels_match_plain, and W = 37, whose segments
# are off the 16-byte alignment of the kernel's wide copies
@pytest.mark.parametrize("k", [4, 3])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("w,n,num_bins", [
    (40, 1000, 19), (128, 5000, 97), (1000, 9000, 33), (4096, 30000, 97),
    (8192, 40000, 97), (1000, 1000, 97), (4096, 4000, 97), (8192, 8192, 97),
    (37, 3000, 97)])
def test_rans_encode_gmm_matches_plain(cuda, w, n, num_bins, mode, k):
    values, params, lo = _gmm_symbols(n, k, num_bins, cuda, w + mode + k)
    ref = rans_kernels.encode_scan_gmm_plain(values, *params, lo, num_bins,
                                             mode, w)
    s_ref, n_ref = il.pack_words(*ref[1:])
    # the parent's pair: the bounds kernel, then the encoder over them
    t, _ = il.layout(n, w)
    start, freq = gmm_guarded_bounds(values, *params, lo, num_bins, mode)
    pair = rans_kernels.encode_scan(il.to_lanes(start, w), il.to_lanes(freq, w),
                                    il.active_mask(n, t, w, cuda))
    before = rans_kernels.encode_scan_gmm.launches
    got = rans_kernels.encode_scan_gmm(values, *params, lo, num_bins, mode, w)
    assert rans_kernels.encode_scan_gmm.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    s_got, n_got = il.pack_words(*got[1:])
    assert int(n_got) == int(n_ref) and torch.equal(s_got, s_ref)
    for a, b in zip(pair, ref):
        assert torch.equal(a, b)
    # and it decodes
    sym = rans_kernels.decode_scan_gmm(got[0], s_got[: int(n_got)], *params,
                                       il.active_mask(n, t, w, cuda), lo,
                                       num_bins, mode)
    assert torch.equal(il.from_lanes(sym, n), values)


def test_rans_encode_over_bounds_off_alignment(cuda):
    """The encoder over materialized bounds at a W whose active bytes and
    words sit off 4- and 16-byte alignment (its plain-copy staging)."""
    for w, n in ((37, 2000), (5, 101), (1, 17)):
        starts, freqs, active, *_ = _coder_case(n, w, 33, cuda, seed=w)
        got = rans_kernels.encode_scan(starts, freqs, active)
        ref = il.encode_scan(starts, freqs, active)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), w


def test_rans_encode_gmm_refuses_what_it_does_not_take(cuda):
    v = torch.zeros(100, dtype=torch.int32, device=cuda)
    p = torch.ones(100, 4, device=cuda)
    with pytest.raises(TypeError):
        rans_kernels.encode_scan_gmm(v, p.double(), p.double(), p.double(),
                                     -48, 97)
    with pytest.raises(ValueError):  # values not [n]
        rans_kernels.encode_scan_gmm(v[:, None], p, p, p, -48, 97)
    with pytest.raises(ValueError):  # values as floats
        rans_kernels.encode_scan_gmm(v.float(), p, p, p, -48, 97)
    with pytest.raises(ValueError):  # fewer parameters than values
        rans_kernels.encode_scan_gmm(v, p[:50], p[:50], p[:50], -48, 97)
    with pytest.raises(ValueError):  # K above the kernel's 8
        q = torch.ones(100, 9, device=cuda)
        rans_kernels.encode_scan_gmm(v, q, q, q, -48, 97)
    with pytest.raises(ValueError):
        rans_kernels.encode_scan_gmm(v, p, p, p, -48, 97, mode=3)
    with pytest.raises(ValueError):
        rans_kernels.encode_scan_gmm(v, p, p, p, -48, 97, w=0)
    with pytest.raises(ValueError):  # not all on the card
        rans_kernels.encode_scan_gmm(v.cpu(), p, p, p, -48, 97)


def test_rans_encoder_instances_do_not_spill(cuda):
    """ptxas reports no spill stores or loads for any instance of the
    encoder (Bounds, and GmmBounds in 3 modes at K = 4, K = 1 and runtime
    K), as chip_smoke.py requires."""
    import re

    from flashgmm_tpu_torch import _build

    spills = {fn: c for fn, c in _smoke().ptxas_spills(_build.load().ptxas).items()
              if "rans_encode_kernel" in fn}
    assert len(spills) == 10, spills
    assert sum(bool(re.search(r"GmmBoundsILi\dELi1E", fn))
               for fn in spills) == 3, spills
    assert all(c == (0, 0) for c in spills.values()), spills


@pytest.mark.parametrize("source", ["rows", "gmm"])
def test_rans_decode_desync_fails_instead_of_faulting(cuda, source):
    starts, freqs, active, rows, _, lo, params = _coder_case(
        20000, 4096, 97, cuda)
    states, words, emits = rans_kernels.encode_scan(starts, freqs, active)
    stream, n_words = il.pack_words(words, emits)
    cut = stream[: int(n_words) // 2]
    with pytest.raises(RuntimeError, match="past its end"):
        if source == "rows":
            rans_kernels.decode_scan(states, cut, rows, active, lo)
        else:
            rans_kernels.decode_scan_gmm(states, cut, *params, active, lo, 97)
    torch.cuda.synchronize()  # the card is still healthy


def test_rans_decode_searches_rows_that_never_decrease(cuda):
    """The kernel finds each count by bisection, the plain version counts
    directly: they agree on rows that never decrease (every row of the
    codec), and on a row that decreases the kernel returns the bisection's
    symbol. This records that behaviour for one step of 64 lanes."""
    row = torch.tensor([0, 100, 50000, 200, 300, 400, 500, 65536],
                       dtype=torch.int32)
    L = row.numel()
    cf = torch.arange(64) * 1031 % 65536  # one x & 0xFFFF a lane
    states = (1 << 16) + cf  # x >> 16 == 1
    stream = torch.arange(64, dtype=torch.int32) + 1
    active = torch.ones(1, 64, dtype=torch.bool)

    def bisect(c):
        a, b = 0, L
        while a < b:
            mid = (a + b) >> 1
            a, b = (mid + 1, b) if int(row[mid]) <= c else (a, mid)
        return min(max(a - 1, 0), L - 2)

    rows = row.expand(1, 64, L).contiguous()
    got = rans_kernels.decode_scan(states.to(cuda), stream.to(cuda),
                                   rows.to(cuda), active.to(cuda), -3)
    plain = il.decode_scan(states, stream, rows, active, -3)
    assert got.cpu()[0].tolist() == [bisect(int(c)) - 3 for c in cf]
    assert int((got.cpu() != plain).sum()) > 0
    # a row that never decreases: the two agree
    mono = torch.sort(row).values.expand(1, 64, L).contiguous()
    assert torch.equal(
        rans_kernels.decode_scan(states.to(cuda), stream.to(cuda),
                                 mono.to(cuda), active.to(cuda), -3).cpu(),
        il.decode_scan(states, stream, mono, active, -3))


@pytest.mark.parametrize("k,width,c_in,c_out,leaky,res",
                         [(1, 16, 768, 640, True, False),
                          (3, 7, 5, 9, False, True),
                          (5, 32, 192, 384, False, False),
                          (7, 13, 16, 24, True, True)])
def test_conv_kernel_matches_plain(cuda, k, width, c_in, c_out, leaky, res):
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(2, 6, width, c_in, device=cuda, generator=g)
    w = torch.randn(k, k, c_in, c_out, device=cuda, generator=g) * 0.05
    b = torch.randn(c_out, device=cuda, generator=g)
    r = torch.randn(2, 6, width, c_out, device=cuda, generator=g) if res else None
    slope = 0.01 if leaky else None
    before = conv_kernel.conv2d_nhwc.launches
    got = conv_kernel.conv2d_nhwc(x, w, b, negative_slope=slope, residual=r)
    assert conv_kernel.conv2d_nhwc.launches == before + 1
    ref = conv_kernel.conv2d_nhwc_plain(x, w, b, negative_slope=slope, residual=r)
    assert torch.equal(got, ref)  # the same fmaf chain and epilogue
    # bitwise: one image alone equals the same image inside the batch
    one = conv_kernel.conv2d_nhwc(x[1:], w, b, negative_slope=slope,
                                  residual=None if r is None else r[1:])
    assert torch.equal(one, got[1:])


def _rows_params(n, k, seed, edge):
    rs = np.random.RandomState(seed)
    s = rs.uniform(0.11, 20.0, (n, k))
    m = rs.normal(0, 5, (n, k))
    w = rs.uniform(0.05, 1.0, (n, k))
    w /= w.sum(1, keepdims=True)
    if edge:  # scales at the clamps, far means, subnormal weights
        s = np.where(rs.rand(n, k) < 0.5, rs.choice([0.11, 256.0], (n, k)), s)
        m = np.where(rs.rand(n, k) < 0.3, rs.choice([-1e3, -60, 60, 1e4],
                                                    (n, k)), m)
        w = np.where(rs.rand(n, k) < 0.3, rs.choice([1e-45, 1e-39, 1e-30],
                                                    (n, k)), w)
    return [torch.from_numpy(v.astype(np.float32)) for v in (s, m, w)]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_rows_kernel_equals_plain(cuda, mode, k):
    for edge in (False, True):
        params = [t.to(cuda) for t in _rows_params(30000, k, mode, edge)]
        before = rows_kernel.gmm_rows.launches
        got = gmm_guarded_rows(*params, -48, 97, mode)
        assert rows_kernel.gmm_rows.launches == before + 1
        ref = gmm_guarded_rows_plain(*params, -48, 97, mode)
        assert got.dtype == torch.int32 and got.shape == (30000, 98)
        assert int((got != ref).sum()) == 0
        # and the card's plain version equals the CPU's
        cpu = gmm_guarded_rows_plain(*[t.cpu() for t in params], -48, 97, mode)
        assert torch.equal(ref.cpu(), cpu)


def test_rows_kernel_refuses_what_it_does_not_take(cuda):
    s = torch.ones(8, 4, device=cuda)
    with pytest.raises(TypeError):
        rows_kernel.gmm_rows(s.double(), s.double(), s.double(), -48, 97)
    with pytest.raises(ValueError):
        rows_kernel.gmm_rows(s, s, s[:, :3], -48, 97)  # shapes differ
    with pytest.raises(ValueError):
        rows_kernel.gmm_rows(s.reshape(-1), s.reshape(-1), s.reshape(-1), -48, 97)
    with pytest.raises(ValueError):
        big = torch.ones(8, 9, device=cuda)  # K above the kernel's 8
        rows_kernel.gmm_rows(big, big, big, -48, 97)
    with pytest.raises(ValueError):
        rows_kernel.gmm_rows(s.cpu(), s.cpu(), s.cpu(), -48, 97)  # not CUDA


@pytest.mark.parametrize("n,h,width,c_in,c_out,k", [
    (2, 12, 8, 192, 192, 3),  # the rows chain's smallest layer, M = 192
    (2, 48, 16, 640, 2304, 1),  # the last entropy-parameter conv
])
def test_conv_kernel_rows_chain_shapes(cuda, n, h, width, c_in, c_out, k):
    g = torch.Generator(device=cuda).manual_seed(c_out)
    x = torch.randn(n, h, width, c_in, device=cuda, generator=g)
    w = torch.randn(k, k, c_in, c_out, device=cuda, generator=g) * 0.05
    b = torch.randn(c_out, device=cuda, generator=g)
    got = conv_kernel.conv2d_nhwc(x, w, b)
    assert torch.equal(got, conv_kernel.conv2d_nhwc_plain(x, w, b))
    for i in range(n):  # each image alone equals itself in the batch
        assert torch.equal(conv_kernel.conv2d_nhwc(x[i:i + 1], w, b),
                           got[i:i + 1])
    big = torch.cat([x] * 12)  # batch 24: other tile shapes, same bits
    assert torch.equal(conv_kernel.conv2d_nhwc(big, w, b)[:n], got)
    assert torch.equal(conv_kernel.conv2d_nhwc(x, w, b), got)
    for tile in range(conv_kernel.TILES):  # every tile shape, same bits
        assert torch.equal(conv_kernel.conv2d_nhwc(x, w, b, tile=tile), got)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bounds_kernel_equals_rows_gather_and_plain(cuda, mode, k):
    for edge in (False, True):
        params = [t.to(cuda) for t in _rows_params(30000, k, mode + 7, edge)]
        rs = np.random.RandomState(mode)
        v = rs.randint(-48, 49, 30000)
        v[:100], v[100:200] = -48, 48  # both ends of the range
        values = torch.from_numpy(v).to(cuda)
        before = (rows_kernel.gmm_bounds.launches, rows_kernel.gmm_rows.launches)
        start, freq = gmm_guarded_bounds(values, *params, -48, 97, mode)
        rows = gmm_guarded_rows(*params, -48, 97, mode)
        assert rows_kernel.gmm_bounds.launches == before[0] + 1
        assert rows_kernel.gmm_rows.launches == before[1] + 1
        j = (values - -48)[:, None]
        assert torch.equal(start, rows.gather(1, j)[:, 0])
        assert torch.equal(freq, rows.gather(1, j + 1)[:, 0] - start)
        ps, pf = gmm_guarded_bounds_plain(values, *params, -48, 97, mode)
        assert torch.equal(start, ps) and torch.equal(freq, pf)


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv_kernel.conv2d_nhwc(x, torch.zeros(3, 3, 8, 8, device=cuda,
                                                dtype=torch.float16))
    with pytest.raises(ValueError):
        conv_kernel.conv2d_nhwc(x.float(), torch.zeros(3, 3, 8, 8))  # mixed
    with pytest.raises(ValueError):
        conv_kernel.conv2d_nhwc(x.float(), torch.zeros(3, 3, 8, 8, device=cuda),
                                tile=conv_kernel.TILES)
    states = torch.zeros(64, dtype=torch.int64, device=cuda)
    stream = torch.zeros(10, dtype=torch.int32, device=cuda)
    active = torch.zeros(2, 64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # rows not [T, W, L]
        rans_kernels.decode_scan(states, stream, torch.zeros(
            2, 32, 4, dtype=torch.int32, device=cuda), active, 0)
    p = torch.ones(100, 4, device=cuda)
    with pytest.raises(ValueError):  # more symbols than T * W lanes
        rans_kernels.decode_scan_gmm(states, stream, p, p, p[:, :3], active,
                                     -48, 97)
    with pytest.raises(ValueError):  # K above the kernel's 8
        q = torch.ones(100, 9, device=cuda)
        rans_kernels.decode_scan_gmm(states, stream, q, q, q, active, -48, 97)
    with pytest.raises(TypeError):
        rans_kernels.decode_scan_gmm(states, stream, p[:64].double(),
                                     p[:64].double(), p[:64].double(), active,
                                     -48, 97)
    with pytest.raises(ValueError):  # values not [N]
        rows_kernel.gmm_bounds(torch.zeros(8, 2, dtype=torch.int32, device=cuda),
                               p[:8], p[:8], p[:8], -48, 97)
    with pytest.raises(ValueError):  # not CUDA
        rows_kernel.gmm_bounds(torch.zeros(8, dtype=torch.int32),
                               p[:8], p[:8], p[:8], -48, 97)


@pytest.mark.parametrize("n,kernel_transforms", [(32, False), (64, True)])
def test_codec_roundtrip_on_card(cuda, n, kernel_transforms):
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec

    model = Cheng2020AnchorCheckerboardGMMv2(N=n, K=2, seed=0, device=cuda)
    model.update(update_quantiles=True)
    codec = FastCheckerboardGmmCodec(model, lanes=256, cap_divisor=1,
                                     kernel_transforms=kernel_transforms)
    x = torch.rand(2, 128, 128, 3, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(1))
    wrappers = (rans_kernels.encode_scan, rans_kernels.decode_scan,
                rans_kernels.decode_scan_gmm, conv_kernel.conv2d_nhwc,
                rows_kernel.gmm_bounds, rows_kernel.gmm_rows,
                conv_kernel.conv2d_nhwc_bf16, rans_kernels.encode_scan_gmm)
    counts = [f.launches for f in wrappers]
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    x_hat = codec.decode_bytes(data, y_shape)
    # z encodes over its tables, the y passes over their GMM parameters
    # (no bounds kernel); z decodes over its tables, the y passes over the
    # GMM rows on demand; no full rows; with kernel_transforms, g_a (9), h_a
    # (3) and g_s (14) convs on the bf16 conv kernel
    assert [f.launches - c for f, c in zip(wrappers, counts)] == \
        [1, 1, 2, 24, 0, 0, 26 if kernel_transforms else 0, 2]
    y_dec = codec.decode_y_hat(codec.from_bytes(data, y_shape), y_shape)
    assert torch.equal(y_dec, out["y_hat"])
    assert x_hat.shape == x.shape and bool(torch.isfinite(x_hat).all())


def _smoke():
    """chip_smoke.py as a module (its helpers)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _latency_case(dev, n, k, weights=None, size=128):
    """A model (random from seed 0, or the repository's N=192 weights)
    after update(update_quantiles=True), and one textured-leaves image."""
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.zoo import load_npz

    model = Cheng2020AnchorCheckerboardGMMv2(N=n, K=k, seed=0, device=dev)
    if weights is not None:
        load_npz(model, Path(__file__).resolve().parent.parent / weights)
    model.update(update_quantiles=True)
    x = torch.from_numpy(textured_leaves(size, size, seed=500001)[None])
    return model, x.to(dev)


def _certified(codec, x):
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        return codec.encode_certified(x)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("kernel_transforms", [False, True])
def test_latency_graphs_equal_the_eager_run(cuda, n, kernel_transforms):
    """Each direction's CUDA graph against the eager run of the same
    functions (the batched codec's at the latency codec's settings): the
    same bytes, the same y_hat and the same pixels; one graph each for
    encode, decode-y and g_s, whose captured launches are the path's."""
    from flashgmm_tpu_torch.runtime import FastLatencyGmmCodec

    model, x = _latency_case(cuda, n, 2)
    lat = FastLatencyGmmCodec(model, lanes=128, cap_divisor=1,
                              kernel_transforms=kernel_transforms)
    data, y_shape = _certified(lat, x)
    x_hat = lat.decode(data, y_shape)
    assert not lat._fallback_digests
    graphs = {d: g for (d, _), g in lat._graphs.items()}
    assert len(lat._graphs) == 3 and sorted(graphs) == ["decode_y", "encode",
                                                        "g_s"]
    e_data, out = lat._batched.encode_to_bytes(x)
    assert data == e_data
    y_graph = lat._decode_y(lat._passes(lat.from_bytes(data, y_shape)),
                            y_shape).clone()
    assert torch.equal(y_graph, out["y_hat"]) and int(lat._err) == 0
    assert torch.equal(x_hat, lat._batched.decode_bytes(data, y_shape))
    assert torch.equal(lat.decode(data, y_shape), x_hat)
    routed = 12 if kernel_transforms and n >= 64 else 0  # g_a 9, h_a 3
    assert graphs["encode"].launches == {
        "encode_scan": 1, "encode_scan_gmm": 2, "decode_scan": 0,
        "decode_scan_gmm": 0, "gmm_softmax": 2, "conv2d_nhwc": 12,
        "conv2d_nhwc_bf16": routed}
    assert graphs["decode_y"].launches == {
        "encode_scan": 0, "encode_scan_gmm": 0, "decode_scan": 1,
        "decode_scan_gmm": 2, "gmm_softmax": 2, "conv2d_nhwc": 12,
        "conv2d_nhwc_bf16": 0}
    assert graphs["g_s"].launches["conv2d_nhwc_bf16"] == (14 if routed else 0)


def test_latency_overflow_gets_its_own_decode_graph(cuda):
    """Random weights code far over a 1/8 cap: the fallback's uncapped bytes
    certify through a decode-y graph of their own capacity, and decode."""
    from flashgmm_tpu_torch.runtime import FastLatencyGmmCodec

    model, x = _latency_case(cuda, 32, 2)
    lat = FastLatencyGmmCodec(model, lanes=128, cap_divisor=8)
    data, y_shape = _certified(lat, x)
    assert not lat._fallback_digests
    keys = sorted(key for d, key in lat._graphs if d == "decode_y")
    caps = lat.stream_capacities(y_shape)
    assert len(keys) == 2 and keys[0][1] == (caps[0], caps[1], caps[1])
    e_data, out = lat._batched.encode_to_bytes(x)
    assert data == e_data
    y_graph = lat._decode_y(lat._passes(lat.from_bytes(data, y_shape)),
                            y_shape)
    assert torch.equal(y_graph, out["y_hat"])
    assert torch.equal(lat.decode(data, y_shape),
                       lat._batched.decode_bytes(data, y_shape))


def test_latency_truncated_stream_raises_after_the_replay(cuda):
    """A file whose y0 stream is cut to half its words: the decoders read
    past the stream's capacity, the deferred flag is set inside the graph,
    and decode() raises after the replay; the graphs stay usable. (At the
    repository's N=192 weights the streams fit their 1/4 cap, so the cut
    stream runs out inside it.)"""
    from flashgmm_tpu_torch.runtime import FastLatencyGmmCodec

    model, x = _latency_case(cuda, 192, 4,
                             "weights/ckbd_gmm_n192_k4_synthetic.npz", 256)
    lat = FastLatencyGmmCodec(model)
    data, y_shape = _certified(lat, x)
    x_hat = lat.decode(data, y_shape)
    bad = _smoke().truncate_pass(data, lat.lanes, 1,
                                 len(lat._batched._pass_caps(y_shape)))
    with pytest.raises(RuntimeError, match="past its end"):
        lat.decode(bad, y_shape)
    torch.cuda.synchronize()  # the card is still healthy
    assert torch.equal(lat.decode(data, y_shape), x_hat)


def test_rans_decoders_share_a_deferred_error_flag(cuda):
    """Given ``err``, both decoders equal their plain versions without
    waiting for the device; a desynchronised stream sets the flag instead
    of raising, and a later decode through the same flag leaves it set."""
    starts, freqs, active, rows, _, lo, params = _coder_case(
        20000, 1024, 97, cuda)
    states, words, emits = rans_kernels.encode_scan(starts, freqs, active)
    stream, n_words = il.pack_words(words, emits)
    plain = il.decode_scan(states, stream, rows, active, lo)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    got_r = rans_kernels.decode_scan(states, stream, rows, active, lo,
                                     err=err)
    got_g = rans_kernels.decode_scan_gmm(states, stream, *params, active, lo,
                                         97, err=err)
    assert torch.equal(got_r, plain) and torch.equal(got_g, plain)
    assert int(err) == 0
    cut = stream[: int(n_words) // 2]
    rans_kernels.decode_scan_gmm(states, cut, *params, active, lo, 97,
                                 err=err)
    torch.cuda.synchronize()
    assert int(err) == 1
    assert torch.equal(rans_kernels.decode_scan(states, stream, rows, active,
                                                lo, err=err), plain)
    assert int(err) == 1
    with pytest.raises(ValueError, match="err"):
        rans_kernels.decode_scan(states, stream, rows, active, lo,
                                 err=err.cpu())


def _bf16_case(dev, n, h, w, c_in, c_out, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, w, c_in, device=dev, generator=g).bfloat16()
    wt = (torch.randn(k, k, c_in, c_out, device=dev, generator=g)
          * 0.03).bfloat16()
    b = torch.randn(c_out, device=dev, generator=g) * 0.1
    r = torch.randn(n, h, w, c_out, device=dev, generator=g)
    return x, wt, b, r


def _bf16_close(got, ref):
    """One bf16 ulp (2**-7 relative, with 1e-3 x max|plain| absolute) for a
    bf16 result; 1e-5 of max|plain| for an f32 one."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    top = float(r.abs().max())
    if got.dtype == torch.bfloat16:
        assert bool((d <= 1e-3 * top + 2 ** -7 * r.abs()).all()), float(d.max())
    else:
        assert float(d.max()) < 1e-5 * top, float(d.max()) / top


# every (H, W, C_out) the N=192 transforms route at 768x512, batch 2, with
# each epilogue the path gives it: (slope, residual)
_ROUTED = [(384, 256, 192), (192, 128, 192), (96, 64, 192), (48, 32, 192),
           (24, 16, 192), (48, 32, 1536), (96, 64, 1536), (192, 128, 1536)]


@pytest.mark.parametrize("h,w,c_out", _ROUTED)
@pytest.mark.parametrize("slope,res", [(None, False), (0.01, False),
                                       (0.01, True)])
def test_conv_bf16_kernel_matches_plain_at_routed_shapes(cuda, h, w, c_out,
                                                         slope, res):
    x, wt, b, r = _bf16_case(cuda, 2, h, w, 192, c_out, 3, h + c_out)
    kw = dict(negative_slope=slope, residual=r.bfloat16() if res else None)
    before = conv_kernel.conv2d_nhwc_bf16.launches
    got = conv_kernel.conv2d_nhwc_bf16(x, wt, b, **kw)
    assert conv_kernel.conv2d_nhwc_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (2, h, w, c_out)
    _bf16_close(got, conv_kernel.conv2d_nhwc_bf16_plain(x, wt, b, **kw))


@pytest.mark.parametrize("n,h,w,c_in,c_out,k,res_f32", [
    (2, 37, 23, 192, 192, 3, False),  # ragged M: edge tiles
    (1, 5, 3, 64, 8, 1, True),  # C_out 8: columns past C_out masked
    (2, 13, 11, 64, 136, 5, True),  # C_out not a multiple of the tile
    (1, 9, 17, 8, 64, 7, False),  # C_in 8: taps change inside a tile
    (3, 16, 24, 128, 1536, 3, True),
    (1, 21, 35, 72, 200, 5, False),  # C_in, C_out not multiples of 64
    (2, 24, 40, 192, 192, 1, True),  # K = 1, W not a multiple of 16
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_conv_bf16_kernel_edges_and_f32_out(cuda, n, h, w, c_in, c_out, k,
                                            res_f32, out_dtype):
    x, wt, b, r = _bf16_case(cuda, n, h, w, c_in, c_out, k, c_in + c_out + k)
    kw = dict(negative_slope=0.2, residual=r if res_f32 else r.bfloat16(),
              out_dtype=out_dtype)
    got = conv_kernel.conv2d_nhwc_bf16(x, wt, b, **kw)
    assert got.dtype == out_dtype
    _bf16_close(got, conv_kernel.conv2d_nhwc_bf16_plain(x, wt, b, **kw))
    # no bias, no epilogue; float32 inputs are rounded to bf16 first
    _bf16_close(conv_kernel.conv2d_nhwc_bf16(x.float(), wt.float()),
                conv_kernel.conv2d_nhwc_bf16_plain(x, wt))
    # input that starts off the 16-byte boundary is copied, not refused
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=cuda)
    flat[4:] = x.reshape(-1)
    off = flat[4:].view(x.shape)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(conv_kernel.conv2d_nhwc_bf16(off, wt, b),
                       conv_kernel.conv2d_nhwc_bf16(x, wt, b))


@pytest.mark.parametrize("h,w,c_out", _ROUTED)
def test_conv_bf16_kernel_with_packed_weights_at_routed_shapes(cuda, h, w,
                                                              c_out):
    """The routed convs hand the kernel weights packed once (as the layers
    hold them): the same result as the HWIO weights, within tolerance of
    the plain version."""
    x, wt, b, r = _bf16_case(cuda, 2, h, w, 192, c_out, 3, h + c_out + 1)
    kw = dict(negative_slope=0.01, residual=r.bfloat16())
    packed = conv_kernel.pack_bf16_weight(wt)
    got = conv_kernel.conv2d_nhwc_bf16(x, packed, b, **kw)
    assert torch.equal(got, conv_kernel.conv2d_nhwc_bf16(x, wt, b, **kw))
    _bf16_close(got, conv_kernel.conv2d_nhwc_bf16_plain(x, wt, b, **kw))


def test_conv_bf16_kernel_at_a_full_batch_of_the_largest_level(cuda):
    """Batch 24 at the transforms' largest level (384x256, 192 -> 192,
    LeakyReLU and a bf16 residual), as the batch-24 path runs it."""
    x, wt, b, r = _bf16_case(cuda, 24, 384, 256, 192, 192, 3, 24)
    kw = dict(negative_slope=0.01, residual=r.bfloat16())
    got = conv_kernel.conv2d_nhwc_bf16(x, conv_kernel.pack_bf16_weight(wt),
                                       b, **kw)
    _bf16_close(got, conv_kernel.conv2d_nhwc_bf16_plain(x, wt, b, **kw))


def test_conv_bf16_kernel_copies_misaligned_or_strided_operands(cuda):
    """Operands that are not contiguous or start off the kernel's alignment
    (16 bytes for what TMA reads, 8 for the bias) are copied first, never
    read wrongly: the same result as the contiguous call."""
    x, wt, b, r = _bf16_case(cuda, 2, 13, 21, 64, 136, 3, 5)
    r = r.bfloat16()
    kw = dict(negative_slope=0.01)
    want = conv_kernel.conv2d_nhwc_bf16(x, wt, b, residual=r, **kw)

    def off(t, k):
        """t's values in a buffer that starts k elements late."""
        flat = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
        flat[k:] = t.reshape(-1)
        return flat[k:].view(t.shape)

    wide = torch.zeros(2, 13, 21, 72, dtype=x.dtype, device=cuda)
    wide[..., :64] = x
    strided_x = wide[..., :64]
    assert not strided_x.is_contiguous()
    packed = conv_kernel.pack_bf16_weight(wt)
    kio_off = conv_kernel.PackedBf16Weight(off(packed.kio, 4))
    assert kio_off.kio.data_ptr() % 16 != 0
    b_off = off(b, 1)
    assert b_off.data_ptr() % 8 != 0
    r_off = off(r, 2)
    assert r_off.data_ptr() % 16 != 0
    r_t = r.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not r_t.is_contiguous()
    for args, res in (((strided_x, wt, b), r), ((x, kio_off, b), r),
                      ((x, wt, b_off), r), ((x, wt, b), r_off),
                      ((x, wt, b), r_t)):
        got = conv_kernel.conv2d_nhwc_bf16(*args, residual=res, **kw)
        assert torch.equal(got, want)


def test_conv_bf16_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 4, 4, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # C_out not a multiple of 8
        conv_kernel.conv2d_nhwc_bf16(x, w[..., :60])
    with pytest.raises(ValueError):  # even K
        conv_kernel.conv2d_nhwc_bf16(x, w[:2, :2])
    with pytest.raises(ValueError):  # mixed devices
        conv_kernel.conv2d_nhwc_bf16(x, w.cpu())
    with pytest.raises(ValueError):  # residual shape
        conv_kernel.conv2d_nhwc_bf16(x, w, residual=x[..., :8])
    with pytest.raises(TypeError):
        conv_kernel.conv2d_nhwc_bf16(x.half(), w)
    with pytest.raises(TypeError):
        conv_kernel.conv2d_nhwc_bf16(x, w, out_dtype=torch.float16)
    torch.cuda.synchronize()  # the card is still healthy


@pytest.mark.parametrize("route", ["default", "kernel"])
def test_batch1_bytes_equal_across_fresh_processes(cuda, route):
    """ROADMAP C9: the latency codec's batch-1 bytes of the first bench
    image at N=192 with the repository's weights are the same bytes from a
    process with torch's default flags that runs nothing first and gives
    the image as ``torch.from_numpy(img[None])`` (batch stride 0), and from
    one that sets the smoke's flags, takes most of the card's memory first
    and gives the image as the first of a stacked batch. Before the codec
    copied its input to canonical strides, cuDNN ran g_a's first convs in
    another memory format for each, with another algorithm, and the bytes
    differed."""
    import json
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    digests = []
    for setup in ("cold", "hog"):
        p = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                            "--bytes-worker", route, setup],
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        run = json.loads(p.stdout.strip().splitlines()[-1])
        digests.append((run["bytes"], run["sha256"]))
    assert digests[0] == digests[1], digests


def test_packed_decode_one_copy_equals_unpacked(cuda):
    """Packed decode_bytes (batched) and decode (latency) against the
    unpacked streams, bit for bit, each with one host-to-device copy."""
    from flashgmm_tpu_torch.runtime import (FastCheckerboardGmmCodec,
                                            FastLatencyGmmCodec)

    smoke = _smoke()
    model, x = _latency_case(cuda, 64, 4)
    codec = FastCheckerboardGmmCodec(model, lanes=256, cap_divisor=1)
    x2 = torch.cat([x, x.flip(1)])
    data, out = codec.encode_to_bytes(x2)
    y_shape = tuple(out["y_hat"].shape)
    x_hat, n_h2d = smoke.h2d_copies(lambda: codec.decode_bytes(data, y_shape))
    assert n_h2d == 1
    streams = codec.from_bytes(data, y_shape)
    assert torch.equal(x_hat, codec.decode(streams, y_shape))
    host, caps = codec.pack(data, y_shape)
    assert torch.equal(codec.decode_y_hat(codec.unpack(
        codec.copy_staged(host), caps), y_shape), out["y_hat"])
    lat = FastLatencyGmmCodec(model, lanes=256, cap_divisor=1)
    l_data, l_shape = _certified(lat, x)
    l_xhat, n_h2d = smoke.h2d_copies(lambda: lat.decode(l_data, l_shape))
    assert n_h2d == 1
    y_unp = lat._decode_y(lat._passes(lat.from_bytes(l_data, l_shape)),
                          l_shape).clone()
    assert torch.equal(l_xhat, lat._gs(y_unp))
    assert torch.equal(y_unp, lat._batched.decode_y_hat(
        lat._batched.from_bytes(l_data, l_shape), l_shape))


def test_forward_and_backward_on_card_match_the_cpu(cuda):
    """The training forward at N=64 on a 128x128 image: eval x_hat and
    likelihoods within atol 1e-4 of the same model's CPU run (float32
    convs, TF32 off), and one backward of bits per pixel + MSE whose
    gradients are finite and within 1e-3 of each gradient's largest CPU
    entry."""
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2

    model, x = _latency_case(cuda, 64, 4)
    cpu = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        y_g, y_c = model.g_a(x), cpu.g_a(x.cpu())
        z_g = model.latent_codec.latent_codec["hyper"].h_a(y_g)
        z_c = cpu.latent_codec.latent_codec["hyper"].h_a(y_c)
    med = cpu.latent_codec.latent_codec["hyper"].entropy_bottleneck \
        ._get_medians()[:, 0, 0].detach()
    for got, ref in ((y_g, y_c), (z_g - med.to(cuda), z_c - med)):
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
        # no latent of this image lies within the two runs' difference of
        # a rounding boundary, so both round it alike
        assert torch.equal(torch.round(got).cpu(), torch.round(ref))

    def loss_of(m, v):
        out = m(v, training=False)
        rate = sum(-torch.log2(t).sum() for t in out["likelihoods"].values())
        return out, rate / (128 * 128) + torch.mean((out["x_hat"] - v) ** 2)

    out_g, loss_g = loss_of(model, x)
    out_c, loss_c = loss_of(cpu, x.cpu())
    for got, ref in ((out_g["x_hat"], out_c["x_hat"]),
                     (out_g["likelihoods"]["y"], out_c["likelihoods"]["y"]),
                     (out_g["likelihoods"]["z"], out_c["likelihoods"]["z"])):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    loss_g.backward()
    loss_c.backward()
    cpu_params = dict(cpu.named_parameters())
    for name, p in model.named_parameters():
        ref = cpu_params[name].grad
        if ref is None:
            assert p.grad is None, name
            continue
        assert bool(torch.isfinite(p.grad).all()), name
        scale = float(ref.abs().max())
        torch.testing.assert_close(p.grad.cpu(), ref, rtol=0,
                                   atol=1e-3 * max(scale, 1e-12), msg=name)
    grad = model.g_a.layers[0].conv1.weight.grad
    assert bool((grad != 0).any())
    gen = torch.Generator(device=cuda).manual_seed(0)
    tr = model(x, training=True, generator=gen)
    assert all(bool(torch.isfinite(t).all())
               for t in (tr["x_hat"], *tr["likelihoods"].values()))


def _elic(dev, n, m, k, groups=None):
    """An ELIC from seed 0 after update(update_quantiles=True) on ``dev``."""
    from flashgmm_tpu_torch.models import Elic2022GMM

    model = Elic2022GMM(N=n, M=m, K=k, groups=groups, seed=0, device=dev)
    model.update(update_quantiles=True)
    return model


def test_elic_rows_chain_on_card_equals_the_cpu_plain_version(cuda):
    """The ELIC codec's shared stages on the card against the CPU (the
    conv kernel's plain version) for the same z bins and symbols: h_s (its
    transposed convs as zero-inserted convs), each group's context
    parameters, spatial contexts and aggregation networks through
    ``conv2d_nhwc`` bit for bit, and so each pass's scales and means; and
    the mixture weights, the coding softmax of those bits (its kernel on
    the card, its plain version on the CPU: ROADMAP C11's repair), bit for
    bit too."""
    import copy

    from flashgmm_tpu_torch.runtime import FastElicGmmCodec

    groups = [8, 8, 16, 16, 16]
    cpu_model = _elic("cpu", 32, 64, 2, groups)
    codecs = {dev: FastElicGmmCodec(m, lanes=64) for dev, m in (
        ("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to(cuda)))}
    rs = np.random.RandomState(3)
    z_max = codecs["cpu"]._z_maxbin.numpy()
    z_bin = torch.from_numpy(np.stack([rs.randint(0, z_max + 1)
                                       for _ in range(2 * 6)]).reshape(
        2, 2, 3, 32).astype(np.int32))
    syms = [torch.from_numpy(rs.randint(-6, 7, (2, 8, 6, g)).astype(np.int32))
            for g in groups for _ in range(2)]
    stages = {}
    with torch.inference_mode():
        for dev, c in codecs.items():
            side_all = c._side(z_bin.to(c.device))
            ss = [s.to(c.device) for s in syms]
            out = {"h_s": side_all}
            for k, ckbd in enumerate(c._ckbds):
                ctx_params = c._ctxparams(side_all, ss[:2 * k], k)
                side = ckbd.unembed(ctx_params)
                y_ = torch.stack([ss[2 * k].float(),
                                  torch.zeros_like(ss[2 * k],
                                                   dtype=torch.float32)])
                ctxs = [side[0].new_zeros(side[0].shape[:-1] + (
                    ckbd.context_prediction.out_ch,)), ckbd.unembed(
                    run_canonical(ckbd.context_prediction, ckbd.embed(y_)))[1]]
                out[f"group {k} context parameters"] = ctx_params
                out[f"group {k} spatial context"] = ctxs[1]
                for i in range(2):
                    out[f"pass {k}.{i} aggregation"] = run_canonical(
                        ckbd.entropy_parameters, ckbd.merge(ctxs[i], side[i]))
                    params = c._pass_params(k, side[i],
                                            None if i == 0 else ss[2 * k])
                    for n, t in zip(("scales", "means", "weights"), params):
                        out[f"pass {k}.{i} {n}"] = t
            stages[dev] = out
    for name, ref in stages["cpu"].items():
        assert torch.equal(stages["cuda"][name].cpu(), ref), name


@pytest.mark.parametrize("kernel_transforms", [False, True])
def test_elic_roundtrips_exact_on_card(cuda, kernel_transforms):
    """The batched codec at batch 2 and the latency codec at batch 1 (N=64,
    M=160, K=4, 128x128 textured leaves): y_hat exact through the bytes,
    certified with no fallback on three graphs, the latency bytes equal to
    the batched codec's at the same settings."""
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.runtime import (FastElicGmmCodec,
                                            FastLatencyElicCodec)

    model = _elic(cuda, 64, 160, 4)
    x = torch.from_numpy(np.stack([textured_leaves(128, 128, seed=500001 + i)
                                   for i in range(2)])).to(cuda)
    codec = FastElicGmmCodec(model, lanes=128,
                             kernel_transforms=kernel_transforms)
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    assert len(out["streams"]) == 11
    assert torch.equal(codec.decode_y_hat(codec.from_bytes(data, y_shape),
                                          y_shape), out["y_hat"])
    x_hat = codec.decode_bytes(data, y_shape)
    assert x_hat.shape == x.shape and bool(torch.isfinite(x_hat).all())
    lat = FastLatencyElicCodec(model, lanes=128,
                               kernel_transforms=kernel_transforms)
    x1 = x[:1].contiguous()
    l_data, l_shape = _certified(lat, x1)
    l_xhat = lat.decode_bytes(l_data, l_shape).clone()
    assert not lat._fallback_digests and len(lat._graphs) == 3
    e_data, e_out = codec.encode_to_bytes(x1)
    assert l_data == e_data
    y_graph = lat._decode_y(lat._passes(lat.from_bytes(l_data, l_shape)),
                            l_shape)
    assert torch.equal(y_graph, e_out["y_hat"]) and int(lat._err) == 0
    assert torch.equal(lat.decode_bytes(l_data, l_shape), l_xhat)


def test_elic_latency_graphs_launch_as_the_eager_run(cuda):
    """Each of the three ELIC graphs captured the launches its direction
    makes eagerly: the eager encode + decode of the same functions launches
    each kernel as often as the graphs together; the coder 1 + 10 times a
    direction, the rows-chain conv 50."""
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.runtime import FastLatencyElicCodec, latency_codec

    model = _elic(cuda, 64, 160, 4)
    x = torch.from_numpy(textured_leaves(128, 128, seed=500001)[None]).to(cuda)
    lat = FastLatencyElicCodec(model, lanes=128, kernel_transforms=True)
    data, y_shape = _certified(lat, x)
    lat.decode_bytes(data, y_shape)
    graphs = {d: g.launches for (d, _), g in lat._graphs.items()}
    assert graphs["encode"]["encode_scan"] == 1
    assert graphs["encode"]["encode_scan_gmm"] == 10
    assert graphs["decode_y"]["decode_scan"] == 1
    assert graphs["decode_y"]["decode_scan_gmm"] == 10
    assert graphs["encode"]["conv2d_nhwc"] == graphs["decode_y"][
        "conv2d_nhwc"] == 50
    assert graphs["g_s"]["conv2d_nhwc_bf16"] > 0
    before = latency_codec._launch_counts()
    e_data, _ = lat._batched.encode_to_bytes(x)
    lat._batched.decode_bytes(e_data, y_shape)
    eager = {k: v - before[k] for k, v in latency_codec._launch_counts().items()}
    assert e_data == data
    assert eager == {k: sum(g[k] for g in graphs.values()) for k in eager}


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("w,n", [(4096, 2 * 4096 - 1000), (128, 5000),
                                 (37, 3000)])
def test_k1_coder_instances_match_plain(cuda, w, n, mode):
    """The encoder's and the decoder's K=1 instances (a GSM pass: scales
    [n, 1], zero means, unit weights) against their plain versions, the
    launches counted on the K=1 instance."""
    rs = np.random.RandomState(w + mode)
    scales = torch.from_numpy(rs.uniform(0.11, 20, (n, 1)).astype(
        np.float32)).to(cuda)
    params = (scales, torch.zeros_like(scales), torch.ones_like(scales))
    lo, num_bins = -48, 97
    v = np.clip(np.round(rs.normal(0, 6, n)), lo, lo + num_bins - 1)
    v[:3], v[3:6] = lo, lo + num_bins - 1
    values = torch.from_numpy(v.astype(np.int32)).to(cuda)
    before = (rans_kernels.encode_scan_gmm.launches_k1,
              rans_kernels.decode_scan_gmm.launches_k1)
    got = rans_kernels.encode_scan_gmm(values, *params, lo, num_bins, mode, w)
    ref = rans_kernels.encode_scan_gmm_plain(values, *params, lo, num_bins,
                                             mode, w)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    stream, n_words = il.pack_words(*got[1:])
    t, _ = il.layout(n, w)
    active = il.active_mask(n, t, w, cuda)
    sym = rans_kernels.decode_scan_gmm(got[0], stream[: int(n_words)],
                                       *params, active, lo, num_bins, mode)
    sym_p = rans_kernels.decode_scan_gmm_plain(got[0], stream, *params,
                                               active, lo, num_bins, mode)
    assert torch.equal(sym, sym_p)
    assert torch.equal(il.from_lanes(sym, n), values)
    assert (rans_kernels.encode_scan_gmm.launches_k1,
            rans_kernels.decode_scan_gmm.launches_k1) == \
        (before[0] + 1, before[1] + 1)


def _gsm(dev, n):
    """A Cheng2020AnchorCheckerboard from seed 0 after
    update(update_quantiles=True) on ``dev``."""
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboard

    model = Cheng2020AnchorCheckerboard(N=n, seed=0, device=dev)
    model.update(update_quantiles=True)
    return model


def test_gsm_rows_chain_on_card_equals_the_cpu_plain_version(cuda):
    """The GSM codec's shared stages on the card against the CPU (the conv
    kernel's plain version) on the same z bins and anchor symbols: h_s,
    both passes' clamped scales and means (the non-anchor pass on
    sym0 + mu0) bit for bit. No softmax enters this chain (ROADMAP C11)."""
    import copy

    from flashgmm_tpu_torch.runtime import FastCheckerboardGsmCodec

    cpu_model = _gsm("cpu", 64)
    codecs = {dev: FastCheckerboardGsmCodec(m, lanes=256) for dev, m in (
        ("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to(cuda)))}
    rs = np.random.RandomState(3)
    z_max = codecs["cpu"]._z_maxbin.numpy()
    z_bin = torch.from_numpy(np.stack([rs.randint(0, z_max + 1)
                                       for _ in range(2 * 6)]).reshape(
        2, 2, 3, 64).astype(np.int32))
    sym0 = torch.from_numpy(rs.randint(-6, 7, (2, 8, 6, 64)).astype(np.int32))
    stages = {}
    with torch.inference_mode():
        for dev, c in codecs.items():
            side = c._side(z_bin.to(c.device))
            (s0, _, _), mu0 = c._params0(side[0])
            (s1, _, _), mu1 = c._params1(side[1], sym0.to(c.device), mu0)
            stages[dev] = {"h_s": side, "scales0": s0, "means0": mu0,
                           "scales1": s1, "means1": mu1}
    for name, ref in stages["cpu"].items():
        assert torch.equal(stages["cuda"][name].cpu(), ref), name


@pytest.mark.parametrize("kernel_transforms", [False, True])
def test_gsm_roundtrips_exact_on_card(cuda, kernel_transforms):
    """The GSM codec at batch 2 (N=64, 128x128 textured leaves): y_hat
    exact through the bytes, four GMM coder launches on the K=1 instances,
    24 rows-chain convs."""
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.runtime import FastCheckerboardGsmCodec

    model = _gsm(cuda, 64)
    x = torch.from_numpy(np.stack([textured_leaves(128, 128, seed=500001 + i)
                                   for i in range(2)])).to(cuda)
    codec = FastCheckerboardGsmCodec(model, lanes=256, cap_divisor=1,
                                     kernel_transforms=kernel_transforms)
    wrappers = (rans_kernels.encode_scan_gmm, rans_kernels.decode_scan_gmm)
    before = [(f.launches, f.launches_k1) for f in wrappers]
    conv_before = conv_kernel.conv2d_nhwc.launches
    data, out = codec.encode_to_bytes(x)
    y_shape = tuple(out["y_hat"].shape)
    x_hat = codec.decode_bytes(data, y_shape)
    assert [(f.launches - a, f.launches_k1 - b)
            for f, (a, b) in zip(wrappers, before)] == [(2, 2), (2, 2)]
    assert conv_kernel.conv2d_nhwc.launches - conv_before == 24
    assert torch.equal(codec.decode_y_hat(codec.from_bytes(data, y_shape),
                                          y_shape), out["y_hat"])
    assert x_hat.shape == x.shape and bool(torch.isfinite(x_hat).all())


def test_gsm_card_bytes_decode_on_the_cpu(cuda):
    """Bytes written by the GSM codec on the card decode with the port on
    the CPU to the card's y_hat, bit for bit: the rows chain is the conv
    kernel's fmaf chain on both (its plain version on the CPU) and the row
    entries are gmm_entry's on both, with no softmax between (the
    flagship's weights are a softmax, whose CUDA and CPU roundings differ:
    ROADMAP C11). The CPU's own bytes of the same image may differ (its
    bf16 g_a is not cuDNN's), and decode there too."""
    import copy

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.runtime import FastCheckerboardGsmCodec

    cpu_model = _gsm("cpu", 64)
    codecs = {dev: FastCheckerboardGsmCodec(m, lanes=256, cap_divisor=4)
              for dev, m in (("cpu", cpu_model),
                             ("cuda", copy.deepcopy(cpu_model).to(cuda)))}
    x = torch.from_numpy(np.stack([textured_leaves(128, 128, seed=500001 + i)
                                   for i in range(2)]))
    data, out = codecs["cuda"].encode_to_bytes(x.to(cuda))
    y_shape = tuple(out["y_hat"].shape)
    cpu = codecs["cpu"]
    y_cpu = cpu.decode_y_hat(cpu.from_bytes(data, y_shape), y_shape)
    assert torch.equal(y_cpu, out["y_hat"].cpu())
    c_data, c_out = cpu.encode_to_bytes(x)
    assert torch.equal(codecs["cuda"].decode_y_hat(
        codecs["cuda"].from_bytes(c_data, y_shape), y_shape).cpu(),
        c_out["y_hat"])


# -- reference-format coding and the coding softmax -------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_boundary_rows_and_softmax_kernels_equal_plain(cuda, mode, k):
    """The reference format's boundary rows (uint16, XLA's saturating
    convert) and the coding softmax against their plain versions, on the
    card and on the CPU, edge parameters included."""
    from flashgmm_tpu_torch.ans.gaussian_cdf import (gmm_boundary_rows,
                                                     gmm_boundary_rows_plain,
                                                     gmm_softmax,
                                                     gmm_softmax_plain)

    for edge in (False, True):
        s, m, w = _rows_params(20000, k, mode, edge)
        w[:8] = torch.tensor([2.0, -0.5, float("nan"), 0.7] * 2)[:, None]
        params = [t.to(cuda) for t in (s, m, w)]
        before = rows_kernel.gmm_boundary_rows.launches
        got = gmm_boundary_rows(*params, -48, 97, mode)
        assert rows_kernel.gmm_boundary_rows.launches == before + 1
        assert got.dtype == torch.uint16 and got.shape == (20000, 98)
        ref = gmm_boundary_rows_plain(*params, -48, 97, mode).cpu()
        cpu = gmm_boundary_rows_plain(s, m, w, -48, 97, mode)
        assert np.array_equal(got.cpu().numpy(), ref.numpy())
        assert np.array_equal(ref.numpy(), cpu.numpy())
    rs = np.random.RandomState(mode + 10 * k)
    logits = torch.from_numpy(rs.normal(0, 4, (3, 7, 5, k, 37)).astype(
        np.float32))
    logits[0, 0, 0, 0, :3] = torch.tensor([80.0, -80.0, 1e-40])
    before = rows_kernel.gmm_softmax.launches
    got = gmm_softmax(logits.to(cuda))
    assert rows_kernel.gmm_softmax.launches == before + 1
    for ref in (gmm_softmax_plain(logits.to(cuda)).cpu(),
                gmm_softmax_plain(logits)):
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gaussian_rows_kernel_equals_plain(cuda, mode):
    """The search coder's single-Gaussian rows (the boundary-rows kernel at
    K = 1) against their plain version on the card and on the CPU, over
    scales from the lower bound 0.11 to 256, and a mbt2018-mean search
    round trip of the card's strings on the CPU."""
    from flashgmm_tpu_torch.ans.gaussian_cdf import (
        gaussian_boundary_rows, gaussian_boundary_rows_plain)
    from flashgmm_tpu_torch.entropy_models import GaussianConditional

    rs = np.random.RandomState(mode)
    s = np.exp(rs.uniform(np.log(0.11), np.log(256), 30000))
    s[:4] = (0.11, 1.0, 256.0, 2.0)
    s = torch.from_numpy(s.astype(np.float32))
    for max_bs in (8, 64):
        before = rows_kernel.gaussian_boundary_rows.launches
        got = gaussian_boundary_rows(s.to(cuda), -max_bs, 2 * max_bs + 1,
                                     mode)
        assert rows_kernel.gaussian_boundary_rows.launches == before + 1
        assert got.dtype == torch.uint16
        for ref in (gaussian_boundary_rows_plain(s.to(cuda), -max_bs,
                                                 2 * max_bs + 1, mode).cpu(),
                    gaussian_boundary_rows_plain(s, -max_bs, 2 * max_bs + 1,
                                                 mode)):
            assert np.array_equal(got.cpu().numpy(), ref.numpy())
    with pytest.raises(TypeError):
        rows_kernel.gaussian_boundary_rows(s.to(cuda).double(), -8, 17)
    with pytest.raises(ValueError):
        rows_kernel.gaussian_boundary_rows(s, -8, 17)  # not CUDA

    y = torch.from_numpy(rs.normal(0, 6, (1, 8, 8, 32)).astype(np.float32))
    scales = torch.from_numpy(rs.uniform(0.11, 20, (1, 8, 8, 32))
                              .astype(np.float32))
    means = torch.zeros_like(y)
    gc = GaussianConditional()
    strings, abs_max = gc.compress_search(y.to(cuda), scales.to(cuda),
                                          means.to(cuda))
    back = gc.decompress_search(strings, scales, abs_max, means)
    assert torch.equal(back, torch.round(y))


def test_boundary_rows_and_softmax_refuse_what_they_do_not_take(cuda):
    s = torch.ones(8, 4, device=cuda)
    with pytest.raises(TypeError):
        rows_kernel.gmm_boundary_rows(s.double(), s.double(), s.double(),
                                      -48, 97)
    with pytest.raises(ValueError):
        rows_kernel.gmm_boundary_rows(s.cpu(), s.cpu(), s.cpu(), -48, 97)
    with pytest.raises(ValueError):
        rows_kernel.gmm_softmax(torch.ones(2, 4, 3))  # not CUDA
    with pytest.raises(TypeError):
        rows_kernel.gmm_softmax(torch.ones(2, 4, 3, device=cuda).double())
    with pytest.raises(ValueError):
        rows_kernel.gmm_softmax(torch.ones(2, 9, 3, device=cuda))  # K > 8


def _feed_transforms(codec, ys):
    """Make ``codec``'s g_a and h_a return the tensors ``ys`` holds (moved
    to its device), so two codecs code the same latents."""
    real = codec._transform

    def transform(mod, x):
        if mod is codec._g_a:
            return ys["y"].to(codec.device)
        if mod is codec._h_a:
            return ys["z"].to(codec.device)
        return real(mod, x)
    codec._transform = transform


@pytest.mark.parametrize("which", ["flagship", "elic"])
def test_batched_bytes_of_one_image_equal_on_card_and_cpu(cuda, which):
    """ROADMAP C11 closed: given the same latents y and z, the batched
    codec writes the same bytes on the card and on the CPU (the rows chain
    is the conv kernel's fmaf chain on both, and the weights the coding
    softmax's), and each decodes the other's."""
    import copy

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.runtime import (FastCheckerboardGmmCodec,
                                            FastElicGmmCodec)

    if which == "flagship":
        cpu_model = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, seed=0,
                                                     device="cpu")
        cpu_model.update(update_quantiles=True)
        make = lambda m: FastCheckerboardGmmCodec(m, lanes=256)  # noqa: E731
    else:
        cpu_model = _elic("cpu", 64, 160, 4)
        make = lambda m: FastElicGmmCodec(m, lanes=128)  # noqa: E731
    codecs = {"cpu": make(cpu_model),
              "cuda": make(copy.deepcopy(cpu_model).to(cuda))}
    x = torch.from_numpy(textured_leaves(128, 128, seed=500001)[None])
    card = codecs["cuda"]
    with torch.inference_mode():
        y = card._transform(card._g_a, x.to(cuda))
        ys = {"y": y, "z": card._transform(card._h_a, y)}
    for c in codecs.values():
        _feed_transforms(c, ys)
    data = {dev: c.encode_to_bytes(x.to(c.device)) for dev, c in codecs.items()}
    assert data["cuda"][0] == data["cpu"][0]
    y_shape = tuple(data["cpu"][1]["y_hat"].shape)
    for dev, c in codecs.items():
        other = data["cpu" if dev == "cuda" else "cuda"]
        y_dec = c.decode_y_hat(c.from_bytes(other[0], y_shape), y_shape)
        assert torch.equal(y_dec.cpu(), other[1]["y_hat"].cpu()), dev


def _reference_models(dev):
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboard,
                                           Cheng2020AnchorCheckerboardGMMv2)

    flagship = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, seed=0,
                                                device="cpu")
    gsm = Cheng2020AnchorCheckerboard(N=64, seed=0, device="cpu")
    models = {"flagship": flagship, "elic": _elic("cpu", 64, 160, 4),
              "gsm": gsm}
    for m in (flagship, gsm):
        m.update(update_quantiles=True)
    return models


@pytest.mark.parametrize("host_math", ["0", "1"])
def test_reference_format_roundtrips_on_card_and_decodes_on_the_cpu(
        cuda, host_math, monkeypatch):
    """model.compress on the card (the flagship and ELIC in the given
    mode, the GSM model on its scale table): decompress's y_hat equals
    compress's, x_hat in [0, 1]; the same models on the CPU decode the
    card's strings to the card's y_hat; the boundary rows and the softmax
    launched a GMM pass each in device-rows mode."""
    import copy

    from flashgmm_tpu_torch.datasets import textured_leaves

    monkeypatch.setenv("FLASHGMM_HOST_MATH", host_math)
    x = torch.from_numpy(textured_leaves(128, 128, seed=500002)[None])
    for name, cpu_model in _reference_models("cpu").items():
        if name == "gsm" and host_math == "1":
            continue  # the table path has one mode
        card = copy.deepcopy(cpu_model).to(cuda)
        passes = {"flagship": 2, "elic": 10, "gsm": 0}[name]
        before = (rows_kernel.gmm_boundary_rows.launches,
                  rows_kernel.gmm_softmax.launches)
        out = card.compress(x.to(cuda))
        after = (rows_kernel.gmm_boundary_rows.launches,
                 rows_kernel.gmm_softmax.launches)
        assert (after[0] - before[0], after[1] - before[1]) == (
            passes if host_math == "0" else 0, passes), name
        y_hat = card.latent_codec.decompress(out["strings"],
                                             out["shape"])["y_hat"]
        assert torch.equal(y_hat, out["y_hat"]), name
        x_hat = card.decompress(out["strings"], out["shape"])["x_hat"]
        assert x_hat.shape == x.shape and 0 <= float(x_hat.min()) \
            and float(x_hat.max()) <= 1, name
        y_cpu = cpu_model.latent_codec.decompress(out["strings"],
                                                  out["shape"])["y_hat"]
        assert torch.equal(y_cpu, out["y_hat"].cpu()), name


def _zero_noise(monkeypatch):
    """The training noise as zeros in both the card's and the CPU's run."""
    from flashgmm_tpu_torch.entropy_models import entropy_models
    from flashgmm_tpu_torch.latent_codecs import checkerboard

    def zeros(shape, generator, like):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(entropy_models, "uniform_noise", zeros)
    monkeypatch.setattr(checkerboard, "uniform_noise", zeros)


def _train_pair(cuda):
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2

    cpu = Cheng2020AnchorCheckerboardGMMv2(N=32, K=2, seed=0, device="cpu")
    card = Cheng2020AnchorCheckerboardGMMv2(N=32, K=2, seed=0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 64, 64, 3).astype(
        np.float32))
    return cpu, card, x


def test_train_step_on_card_matches_the_cpu(cuda, monkeypatch):
    """The narrow flagship (N=32, K=2) on a 2 x 64x64 batch, TF32 off, the
    noise zero: the RD loss within rtol 1e-4 of the CPU's and each net
    gradient (after the guard and the clip, as the step applies it) within
    1e-4 of its largest CPU entry; then one whole ``train_step`` on each,
    its four returned terms within rtol 1e-4. Parameters after the step
    are not compared: Adam's first update is about lr * sign(g), and a
    gradient entry near zero may take either sign on card and CPU."""
    from flashgmm_tpu_torch.losses import rate_distortion_loss
    from flashgmm_tpu_torch.optimizers import net_aux_partition
    from flashgmm_tpu_torch.parallel import (make_train_state,
                                             set_guarded_grads, train_step)

    _zero_noise(monkeypatch)
    cpu, card, x = _train_pair(cuda)
    grads, losses = [], []
    for model, xd in ((cpu, x), (card, x.to(cuda))):
        net, _ = net_aux_partition(model)
        out = model(xd, training=True, generator=None)
        loss = rate_distortion_loss(out, xd)["loss"]
        set_guarded_grads(loss, list(net.values()), 1.0)
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.cpu() for k, p in net.items()})
        model.zero_grad(set_to_none=True)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    for name, ref in grads[0].items():
        got = grads[1][name]
        assert bool(torch.isfinite(got).all()), name
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * max(
            float(ref.abs().max()), 1e-12), msg=name)
    outs = []
    for model, xd in ((cpu, x), (card, x.to(cuda))):
        opt_net, opt_aux = make_train_state(model)
        outs.append(train_step(model, opt_net, opt_aux, xd, None))
    for key in outs[0]:
        np.testing.assert_allclose(float(outs[1][key]), float(outs[0][key]),
                                   rtol=1e-4, err_msg=key)


def test_train_step_guard_on_card(cuda):
    """A batch holding a NaN on the card: every parameter stays finite, and
    both optimizers count the step."""
    from flashgmm_tpu_torch.parallel import make_train_state, train_step

    _, card, x = _train_pair(cuda)
    opt_net, opt_aux = make_train_state(card)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = x.to(cuda)
    out = train_step(card, opt_net, opt_aux, x, gen)
    assert all(np.isfinite(float(v)) for v in out.values())
    bad = x.clone()
    bad[1, 3, 9, 0] = float("nan")
    out = train_step(card, opt_net, opt_aux, bad, gen)
    assert not np.isfinite(float(out["loss"]))
    for name, p in card.named_parameters():
        assert bool(torch.isfinite(p).all()), name
    for opt in (opt_net, opt_aux):
        assert {int(s["step"]) for s in opt.state.values()} == {2}


@pytest.mark.parametrize("arch", ["mbt2018-mean-vbr", "mbt2018-vbr"])
def test_vbr_roundtrip_on_card_decodes_on_the_cpu(cuda, arch):
    """A VBR model at N=32, M=48 (mbt2018-mean-vbr with the variable-step
    bottleneck) at gain level 7 and at inputscale 0.45: compress on the
    card, decompress_y there equal to compress's y_hat, h_s's three convs on
    the rows-chain conv; the same model on the CPU (the same z step)
    decodes the card's strings to the card's y symbols, and for
    mbt2018-vbr, whose offsets run on the host, to its y_hat bit for
    bit."""
    import copy

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import vbr

    if arch == "mbt2018-mean-vbr":
        cpu_model = vbr.MeanScaleHyperpriorVbr(32, 48, vr_entbttlnck=True,
                                               device="cpu")
    else:
        cpu_model = vbr.JointAutoregressiveHierarchicalPriorsVbr(
            32, 48, device="cpu")
    cpu_model.eval()
    card = copy.deepcopy(cpu_model).to(cuda)
    x = torch.from_numpy(textured_leaves(128, 128, seed=600000)[None])

    def symbols(model, out, scale):
        params = model._vbr_side_params(out["strings"][1], out["shape"],
                                        model._z_qs(scale))
        gc = model.gaussian_conditional
        return gc.decompress(out["strings"][0], gc.build_indexes(
            model._split(params)[0] * scale)).cpu()

    for s, inputscale in ((7, 0), (1, 0.45)):
        scale = card._get_scale(s, inputscale)
        card.update(force=True, scale=scale)
        cpu_model.update(force=True, scale=scale.cpu())
        if arch == "mbt2018-mean-vbr":
            assert card._zqstep(scale) == cpu_model._zqstep(scale.cpu())
        before = conv_kernel.conv2d_nhwc.launches
        out = card.compress(x.to(cuda), s=s, inputscale=inputscale)
        assert conv_kernel.conv2d_nhwc.launches - before == 3
        assert torch.equal(card.decompress_y(out["strings"], out["shape"],
                                             s=s, inputscale=inputscale),
                           out["y_hat"])
        y_cpu = cpu_model.decompress_y(out["strings"], out["shape"], s=s,
                                       inputscale=inputscale)
        if arch == "mbt2018-vbr":
            assert torch.equal(y_cpu, out["y_hat"].cpu())
        else:
            assert torch.equal(symbols(cpu_model, out, scale.cpu()),
                               symbols(card, out, scale))
            torch.testing.assert_close(y_cpu, out["y_hat"].cpu(), rtol=0,
                                       atol=1e-5)


def test_video_roundtrip_on_card_decodes_on_the_cpu(cuda):
    """ssf2020 (seed-initialised, its full width) on a 3-frame GOP of
    128x128 frames: compress on the card, each hyperprior's scale and mean
    decoders on the rows-chain conv (6 launches a hyperprior); the card's
    decompress gives the encoder's reconstructions and its decompress_y
    the encoder's y_hat of every branch, bit for bit; a CPU copy decodes
    the card's strings to the same y_hat of every branch bit for bit, and
    to frames within 1e-4 of the card's."""
    import copy

    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models.video import ScaleSpaceFlow

    cpu_model = ScaleSpaceFlow(seed=3, device="cpu").eval()
    cpu_model.update(force=True, update_quantiles=True)
    card = copy.deepcopy(cpu_model).to(cuda)
    big = textured_leaves(144, 144, seed=600002)
    frames = [torch.from_numpy(big[None, 2 * i:2 * i + 128, i:i + 128].copy())
              for i in range(3)]
    before = conv_kernel.conv2d_nhwc.launches
    strings, shapes, details = card.compress([f.to(cuda) for f in frames],
                                             details=True)
    assert conv_kernel.conv2d_nhwc.launches - before == 6 * 5
    dec = card.decompress(strings, shapes)
    for got, want in zip(dec, details["x_hat"]):
        assert torch.equal(got, want)
    y_card = card.decompress_y(strings, shapes)
    y_cpu = cpu_model.decompress_y(strings, shapes)
    for got, want, enc in zip(y_cpu, y_card, details["y_hat"]):
        assert set(got) == set(want) == set(enc)
        for branch in got:
            assert torch.equal(want[branch], enc[branch])
            assert torch.equal(got[branch], want[branch].cpu())
    for got, want in zip(cpu_model.decompress(strings, shapes), dec):
        torch.testing.assert_close(got, want.cpu(), rtol=0, atol=1e-4)


def test_hrtzxf2022_roundtrip_on_card_decodes_on_the_cpu(cuda):
    """hrtzxf2022-pcc-rec on the shipped weights, one synthetic cloud of
    1024 points: compress on the card (TF32 allowed by the caller: the
    codec pins its settings), decompress twice on the card, equal bit for
    bit, 1026 points; a CPU copy decodes the card's strings to the card's
    symbols (the EntropyBottleneck values of the features and the latent
    positions), and to a cloud within 1e-6 chamfer of the card's; none of
    the port's hand kernels launches on this path."""
    import copy

    from flashgmm_tpu_torch.losses import chamfer_distance
    from flashgmm_tpu_torch.zoo import image_models

    cpu_model = image_models("hrtzxf2022-pcc-rec", 1, pretrained=True,
                             device="cpu").eval()
    cpu_model.update(force=True, update_quantiles=True)
    card = copy.deepcopy(cpu_model).to(cuda)
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.rand(1, 1024, 3).astype(np.float32) * 0.5 + 0.25)
    before = conv_kernel.conv2d_nhwc.launches
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        c = card.compress(x.to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    a = card.decompress(c["strings"], c["shape"])["x_hat"]
    b = card.decompress(c["strings"], c["shape"])["x_hat"]
    assert conv_kernel.conv2d_nhwc.launches == before
    assert torch.equal(a, b) and tuple(a.shape) == (1, 1026, 3)

    def symbols(model):
        lc = model.latent_codec
        return [lc["feat"].entropy_bottleneck.decompress(c["strings"][0][0],
                                                         c["shape"][0]),
                lc["xyz"].entropy_bottleneck.decompress(c["strings"][1][0],
                                                        c["shape"][1])]
    for got, want in zip(symbols(cpu_model), symbols(card)):
        assert torch.equal(got, want.cpu())
    x_cpu = cpu_model.decompress(c["strings"], c["shape"])["x_hat"]
    assert float(chamfer_distance(x_cpu, a.cpu())) < 1e-6


@pytest.mark.parametrize("case", ["real", "random_jax", "random_card"])
@pytest.mark.parametrize("kernel_transforms", [False, True])
def test_tiled_synthesis_matches_direct_on_card(cuda, kernel_transforms,
                                                case):
    """Tiled g_s (``runtime/tiled.py``, halo 8) of the flagship at N=192 on
    the card, on both transform routes, within 2e-2 of the direct g_s with
    under 5 % of the pixels more than 1e-6 apart (the JAX test's bounds,
    tests/test_fast_codec.py:209-225), the kernel route launching the bf16
    conv for each tile. Cases: "real", the synthetic weights and the y_hat
    of a 640x384 textured-leaves image ([1, 40, 24, 192]) by tiles of 8
    latent rows; "random_jax", the JAX test's own case: the model
    seed-initialised (seed 0, no weights loaded) and
    ``np.random.RandomState(7).rand`` as the latent, at its shape [1, 24, 8,
    192] by tiles of 4 rows; "random_card", that model and latent at the
    real case's shape [1, 40, 24, 192] by tiles of 8 rows."""
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec
    from flashgmm_tpu_torch.runtime.tiled import make_tiled_gs
    from flashgmm_tpu_torch.zoo import load_npz

    model = Cheng2020AnchorCheckerboardGMMv2(N=192, K=4, seed=0,
                                             device=cuda)
    if case == "real":
        load_npz(model, Path(__file__).resolve().parent.parent / "weights"
                 / "ckbd_gmm_n192_k4_synthetic.npz")
    model.update(update_quantiles=True)
    codec = FastCheckerboardGmmCodec(model, lanes=256,
                                     kernel_transforms=kernel_transforms)
    (h, w), tile_h = ((24, 8), 4) if case == "random_jax" else ((40, 24), 8)
    with torch.inference_mode():
        if case == "real":
            x = torch.from_numpy(textured_leaves(640, 384, seed=500006)[None])
            y = codec.encode(x.to(cuda))["y_hat"]
        else:
            y = torch.from_numpy(np.random.RandomState(7).rand(
                1, h, w, 192).astype(np.float32)).to(cuda)
        direct = torch.clamp(codec._transform(codec._g_s, y), 0, 1)
        before = conv_kernel.conv2d_nhwc_bf16.launches
        tiled = make_tiled_gs(codec, tile_h=tile_h, halo=8)(y)
        launched = conv_kernel.conv2d_nhwc_bf16.launches - before
    assert tuple(y.shape) == (1, h, w, 192)
    assert tiled.shape == direct.shape == (1, 16 * h, 16 * w, 3)
    diff = (tiled - direct).abs()
    assert float(diff.max()) <= 2e-2
    assert float((diff > 1e-6).float().mean()) < 0.05
    assert (launched > 0) == kernel_transforms


@pytest.fixture
def cards(cuda):
    """Every card of the host; skips below two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def _per_card_bf16_launches(monkeypatch):
    """Count the bf16 conv's calls by the device of their input."""
    by_card = {}
    original = conv_kernel.conv2d_nhwc_bf16

    def counted(x, *args, **kwargs):
        by_card[str(x.device)] = by_card.get(str(x.device), 0) + 1
        return original(x, *args, **kwargs)

    counted.launches = 0
    monkeypatch.setattr(conv_kernel, "conv2d_nhwc_bf16", counted)
    return by_card


@pytest.mark.parametrize("kernel_transforms", [False, True])
def test_mesh_codec_across_cards(cards, kernel_transforms, monkeypatch):
    """The flagship (N=64, seed weights) coded over every card
    (``use_mesh``): y_hat exact through the mesh's bytes, the one card's
    bytes decoding on the mesh and the other way round, portable=False
    exact on its mesh; on the kernel route every card launches the bf16
    conv. The bytes need not equal one card's: cuDNN rounds a card's
    share of the batch otherwise than the whole batch (ROADMAP C15)."""
    from flashgmm_tpu_torch.datasets import textured_leaves
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.parallel import make_mesh
    from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec

    model = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, seed=0,
                                             device=cards[0])
    model.update(update_quantiles=True)
    x = torch.from_numpy(np.stack([textured_leaves(128, 128, seed=500001 + i)
                                   for i in range(2 * len(cards))]))
    x = x.to(cards[0])
    kw = dict(lanes=256, kernel_transforms=kernel_transforms)
    mesh = make_mesh()
    with torch.inference_mode():
        one = FastCheckerboardGmmCodec(model, **kw)
        d1, o1 = one.encode_to_bytes(x)
        by_card = _per_card_bf16_launches(monkeypatch)
        codec = FastCheckerboardGmmCodec(model, **kw).use_mesh(mesh)
        dm, om = codec.encode_to_bytes(x)
        y_shape = tuple(om["y_hat"].shape)
        assert torch.equal(codec.decode_y_hat(codec.from_bytes(dm, y_shape),
                                              y_shape), om["y_hat"])
        assert torch.equal(codec.decode_y_hat(codec.from_bytes(d1, y_shape),
                                              y_shape), o1["y_hat"])
        assert torch.equal(one.decode_y_hat(one.from_bytes(dm, y_shape),
                                            y_shape), om["y_hat"])
        x_hat = codec.decode_bytes(dm, y_shape)
        spmd = FastCheckerboardGmmCodec(model, **kw).use_mesh(
            mesh, portable=False)
        dn, on = spmd.encode_to_bytes(x)
        assert torch.equal(spmd.decode_y_hat(spmd.from_bytes(dn, y_shape),
                                             y_shape), on["y_hat"])
    assert x_hat.shape == x.shape and x_hat.device == cards[0]
    assert bool(torch.isfinite(x_hat).all())
    if kernel_transforms:
        assert set(by_card) == {str(d) for d in cards}, by_card
    else:
        assert not by_card


def test_spatial_forward_across_cards(cards):
    """The flagship's forward (N=64, seed weights) height-sharded over
    every card, one 64-row unit a card and more: the JAX test's bounds
    against the whole forward on the first card; make_mesh refuses one
    card more than the host has."""
    from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
    from flashgmm_tpu_torch.parallel import (make_mesh,
                                             make_spatial_sharded_forward)

    n = len(cards)
    model = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, seed=0,
                                             device=cards[0])
    model.update(update_quantiles=True)
    x = torch.from_numpy(np.random.RandomState(5).rand(
        1, 64 * (2 * n + 1), 64, 3).astype(np.float32)).to(cards[0])
    with torch.no_grad():
        got = make_spatial_sharded_forward(
            model, make_mesh(n, data=1, spatial=n))(x)
        ref = model(x, training=False)
    assert got["x_hat"].device == cards[0]
    assert float(((got["x_hat"] - ref["x_hat"]).abs() > 2e-5)
                 .float().mean()) < 0.02

    def bits(out):
        return sum(float(-torch.log2(v).sum())
                   for v in out["likelihoods"].values())

    assert abs(bits(got) - bits(ref)) / bits(ref) < 1e-3
    with pytest.raises(RuntimeError, match="requested"):
        make_mesh(n + 1)


def test_train_step_across_cards(cards):
    """``data_parallel_train_step`` over every card, one spawned process a
    card over NCCL (tests/torch_port_ddp_ranks.py; TF32 off): the narrow
    flagship (N=32, K=2) on global batches of 8 64x64 images, 3 steps; the
    replicas bitwise equal after every step, and each step's terms within
    rtol 1e-4 of one card's ``train_step`` on the whole batch (the bound of
    the card-against-CPU step above); ``init_from_env`` refuses more ranks
    than cards."""
    import torch_port_ddp_ranks as ranks

    got = ranks.run_ranks(len(cards), ranks.flagship_job, 3, device="cuda",
                          timeout=300)
    ref = ranks.one_process(cards[0], 3, len(cards))
    for rank in got:
        assert rank["equal"] == [True] * 3 and rank["finite"]
        for t, r in zip(rank["terms"], ref["terms"]):
            for k in r:
                np.testing.assert_allclose(t[k], r[k], rtol=1e-4, err_msg=k)
    with pytest.raises(AssertionError, match="ranks on"):
        ranks.run_ranks(len(cards) + 1, ranks.flagship_job, 1, device="cuda",
                        timeout=120)

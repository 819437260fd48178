"""Batched on-device codec for the checkerboard-GMM flagship model (port of
flashgmm_tpu/runtime/fast_codec.py:133-677, ``FastCheckerboardGmmCodec``).

Encode: g_a -> h_a -> z quantized against the EntropyBottleneck tables ->
z pass; then the shared stages side (h_s) -> params0 -> anchor pass ->
params1 (5x5 checkerboard context) -> non-anchor pass. Decode runs the same
order and ends in g_s. The y passes never build CDF rows: the encoder
evaluates each symbol's (start, freq) inside its kernel
(``rans_kernels.encode_scan_gmm``) and the decoder evaluates the rows'
entries at the probes of its search (``rans_kernels.decode_scan_gmm``),
both from the same entry arithmetic.
Only the stream words cross to the host. The byte format is the interleaved one of docs/bitstream.md §2, with the JAX
package's lanes, stream caps, StreamOverflow fallback and NHWC-ravel symbol
order, so the bytes of either package decode in the other when their rows
agree.

Correctness by construction: the encoder and the decoder call the SAME
functions (``_side``, ``_params0``, ``_params1``) on tensors of the same
shapes. Their convs go through the hand conv kernel in float32, whose bits
depend on nothing but the input neighbourhood and the weights (its CPU
twin is the same fmaf chain), and every row entry, the encoder's bounds
and the decoder's probes alike, is one elementwise function of its
symbol's parameters with fixed roundings (``csrc/gmm_entry.cuh`` and its
plain twin). So both directions compute identical integers.
g_a, h_a and g_s never need bit-equality (their outputs are rounded or are
pixels) and run in bfloat16 by default: as library convs, or with
``kernel_transforms=True`` (the reference's
``FLASHGMM_PALLAS_CONV_TRANSFORMS=1``) with their stride-1 convs of at least
64 channels, and the fused subpel convs of g_s, on the bf16 conv kernel
(``layers.route_bf16_kernel``).

``FastCheckerboardGsmCodec`` is the same codec for the single-Gaussian
``Cheng2020AnchorCheckerboard`` (reference :680-826).

``_FastCodec`` holds what this codec shares with ELIC's
(``runtime/fast_elic.py``): the transforms, the z pass, the y passes'
coder calls and the bytes of any list of passes with their packed layout.
"""

import copy
from typing import NamedTuple

import numpy as np
import torch

from flashgmm_tpu_torch.ans import interleaved as il
from flashgmm_tpu_torch.ans import rans_kernels
from flashgmm_tpu_torch.ans.gaussian_cdf import get_approx_mode
from flashgmm_tpu_torch.layers import (route_bf16_kernel, run_canonical,
                                      run_transform)


_PASSES = ("z", "y0", "y1")


def _u32_bits(v):
    """int64 values in [0, 2^32) as int32 of the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


class StreamOverflow(RuntimeError):
    """Capped encode buffer exceeded (pathological input); retry with
    ``encode(x, full=True)``."""


class PassStream(NamedTuple):
    states: torch.Tensor  # int64 [W], values < 2^32
    stream: torch.Tensor  # int32 [cap], u16 values
    n_words: torch.Tensor  # int64 scalar


def _pack_pass(states, words, emits, cap_divisor: int) -> PassStream:
    """An encoded pass's words packed into its stream, capped at
    ``T*W // cap_divisor`` words. ``n_words`` above the cap signals
    overflow (the caller re-encodes uncapped)."""
    t, w = words.shape
    stream, n_words = il.pack_words(words, emits)
    return PassStream(states, stream[:max(t * w // cap_divisor, w)], n_words)


def _encode_pass(start, freq, w: int, cap_divisor: int = 4) -> PassStream:
    """Encode one symbol stream of materialized (start, freq) (the z pass)
    through the rANS encode kernel."""
    n = start.shape[0]
    t, _ = il.layout(n, w)
    active = il.active_mask(n, t, w, start.device)
    return _pack_pass(*rans_kernels.encode_scan(
        il.to_lanes(start, w), il.to_lanes(freq, w), active), cap_divisor)


def _decode_pass(ps: PassStream, rows, n: int, lo: int, w: int, err=None):
    """Decode n symbols with materialized rows [n, L] (the z pass) through
    the rANS decode kernel. Padding lanes get valid monotone dummy rows so
    every lane's math stays in range. ``err``: the decoder's deferred error
    flag (``rans_kernels.decode_scan``)."""
    t, pad = il.layout(n, w)
    active = il.active_mask(n, t, w, rows.device)
    L = rows.shape[-1]
    if pad:
        dummy = torch.clamp(torch.arange(L, dtype=torch.int32,
                                         device=rows.device)
                            * (65536 // (L - 1)), 0, 65536)
        rows = torch.cat([rows.to(torch.int32), dummy.expand(pad, L)])
    symbols = rans_kernels.decode_scan(ps.states, ps.stream,
                                       rows.reshape(t, w, L), active, lo,
                                       err=err)
    return il.from_lanes(symbols, n)


def _gmm_pass_params(ckbd, gmm, y_ctx, side):
    """A checkerboard pass's entropy parameters -> per-symbol [n, K]
    (scales, means, weights), NHWC-ravel symbol order (reference
    :333-353): the aggregation network on the rows chain, then the GMM
    codec's chunking and its coding softmax (``gmm_softmax``: the card's
    weights equal the CPU's)."""
    p = run_canonical(ckbd.entropy_parameters, ckbd.merge(y_ctx, side))
    scales, means, weights = gmm._chunk(p)
    weights = gmm._reshape_gmm_weight(weights, exact=True)
    K = gmm.K

    def flat(v):
        b, h, w2, km = v.shape
        v = v.reshape(b, h, w2, K, km // K).transpose(3, 4)
        return v.reshape(-1, K)

    return torch.clamp(flat(scales), 0.11, 256.0), flat(means), flat(weights)


class _FastCodec:
    """What the batched codecs share (the flagship's and ELIC's): the
    transforms' snapshots and their input, the z pass over the
    EntropyBottleneck's tables, the y passes' coder calls, and the bytes of
    any list of passes (docs/bitstream.md §2: per pass u32 n_words, u32 x W
    states, u16 x n_words words) with their packed single-transfer layout.

    A codec says how many passes it has and their capacities
    (``_pass_caps``), and how its streams and its encoder's output hold
    them (``_passes``, ``_streams``, ``_out_passes``)."""

    def __init__(self, model, hyper, lanes, max_abs, cap_divisor,
                 bf16_transforms, kernel_transforms):
        self.lanes = int(lanes)
        self.max_abs = int(max_abs)  # symbols clamped to [-max_abs, max_abs]
        self.cap_divisor = int(cap_divisor)
        self.mode = get_approx_mode()
        self.model = model
        self._hyper = hyper
        self._eb = hyper.entropy_bottleneck
        self.device = self._eb.quantiles.device
        # snapshots of the transforms, like the reference's nnx.split
        self._dtype = torch.bfloat16 if bf16_transforms else torch.float32
        self._g_a, self._h_a, self._g_s = (
            copy.deepcopy(m).to(self._dtype).requires_grad_(False)
            for m in (model.g_a, hyper.h_a, model.g_s))
        if kernel_transforms:
            if not bf16_transforms:
                raise ValueError("kernel_transforms needs bf16_transforms: "
                                 "the conv kernel's transform route is bf16")
            for m in (self._g_a, self._h_a, self._g_s):
                route_bf16_kernel(m)
        if self._eb.quantized_cdf.numel() == 0:
            raise ValueError("EntropyBottleneck tables are empty: run "
                             "model.update() before building the codec")
        self._z_rows, self._z_off, self._z_maxbin = self._z_tables()
        self._med = self._eb._get_medians()[:, 0, 0].detach().float()
        # decode_bytes' host staging buffer and the event of its last copy
        self._staging = None
        self._staged = None

    # -- shared pieces -------------------------------------------------------

    def _transform(self, mod, x):
        """mod on x in the transforms' type, at canonical strides under
        pinned library settings (``layers.run_transform``): the bytes of
        two callers differed by their batch-1 strides (ROADMAP C9)."""
        return run_transform(mod, x, self._dtype)

    def _z_tables(self):
        """(rows [C, L] int32, offsets [C], max_bin [C]) from EB buffers."""
        cdf = self._eb.quantized_cdf.to(torch.int32)
        lengths = self._eb.cdf_length.to(torch.int32)
        j = torch.arange(cdf.shape[1], dtype=torch.int32, device=cdf.device)
        rows = torch.where(j[None, :] < lengths[:, None], cdf, 65536)
        return rows, self._eb.offset.to(torch.int32), lengths - 2

    def _lo_bins(self):
        return -(self.max_abs + 1), 2 * (self.max_abs + 1) + 1

    def _encode_z(self, z):
        """z quantized against the EntropyBottleneck's tables and its pass
        encoded: (z_bin int32, PassStream). z is ~10% of the payload; not
        worth the overflow risk of capping."""
        z_bin = torch.round(z - self._med).to(torch.int32) - self._z_off
        z_bin = torch.minimum(torch.clamp_min(z_bin, 0), self._z_maxbin)
        zb = z_bin.reshape(-1).long()
        ch = torch.arange(zb.shape[0], device=zb.device) % z.shape[-1]
        z_start = self._z_rows[ch, zb]
        z_freq = self._z_rows[ch, zb + 1] - z_start
        return z_bin, _encode_pass(z_start, z_freq, self.lanes, 1)

    def _decode_z(self, ps, b, h, w, err=None):
        """The z pass of a latent y [b, h, w, .] decoded: z_bin [b, h/4,
        w/4, C_z]."""
        zh, zw, cz = h // 4, w // 4, self._z_channels()
        n_z = b * zh * zw * cz
        rows_z = self._z_rows[None].expand(b * zh * zw, cz, -1)
        return _decode_pass(ps, rows_z.reshape(n_z, -1), n_z, 0, self.lanes,
                            err).reshape(b, zh, zw, cz)

    def _z_hat(self, z_bin):
        """Dequantized z, the rows chain's input."""
        return (z_bin + self._z_off).float() + self._med

    def _encpass(self, params, sym_flat, cap_divisor):
        """Encode one y pass, each symbol's (start, freq) evaluated by the
        encoder from its pass's parameters."""
        lo, num_bins = self._lo_bins()
        return _pack_pass(*rans_kernels.encode_scan_gmm(
            sym_flat, *params, lo, num_bins, self.mode, self.lanes),
            cap_divisor)

    def _decpass(self, ps, params, n, err=None):
        """Decode one y pass of n symbols whose rows are the guarded GMM
        rows of its parameters, evaluated on demand by the decoder. Padding
        lanes are inactive and need no parameters."""
        lo, num_bins = self._lo_bins()
        t, _ = il.layout(n, self.lanes)
        active = il.active_mask(n, t, self.lanes, params[0].device)
        symbols = rans_kernels.decode_scan_gmm(ps.states, ps.stream, *params,
                                               active, lo, num_bins, self.mode,
                                               err=err)
        return il.from_lanes(symbols, n)

    def _z_channels(self):
        return self._eb.channels

    @staticmethod
    def _y_shape_parts(y_shape):
        if len(y_shape) == 4:
            return tuple(y_shape)
        h, w, c = y_shape
        return 1, h, w, c

    @torch.inference_mode()
    def decode(self, streams, y_shape):
        """Streams -> reconstructed images [B, H, W, 3] in [0, 1]."""
        y_hat = self.decode_y_hat(streams, y_shape)
        return torch.clamp(self._transform(self._g_s, y_hat), 0.0, 1.0)

    # -- bytes -------------------------------------------------------------------

    def to_bytes(self, out) -> bytes:
        """Fetch the encoder's passes and pack them (docs/bitstream.md §2):
        per pass u32 n_words, u32 x W states, u16 x n_words words."""
        return self._bytes_of(self._out_passes(out))

    def _bytes_of(self, passes) -> bytes:
        """``to_bytes`` of PassStreams in byte order."""
        parts = []
        for p in passes:
            n = int(p.n_words)
            if n > p.stream.shape[0]:
                raise StreamOverflow(
                    f"pass stream overflow ({n} > {p.stream.shape[0]} words);"
                    " re-encode with encode(x, full=True)")
            parts.append(np.uint32(n).tobytes())
            parts.append(p.states.cpu().numpy().astype(np.uint32).tobytes())
            parts.append(p.stream[:n].cpu().numpy().astype(np.uint16).tobytes())
        return b"".join(parts)

    def _parse(self, data: bytes, y_shape):
        """The passes of ``to_bytes`` output on the host: [(n_words, states
        u32 [W], words u16 [n_words], cap)], ``cap`` the stream length
        ``from_bytes`` gives the pass (an overflow pass, n_words above its
        capped length: the uncapped one)."""
        passes, off = [], 0
        for cap in self._pass_caps(y_shape):
            n = int(np.frombuffer(data, np.uint32, 1, off)[0])
            off += 4
            states = np.frombuffer(data, np.uint32, self.lanes, off)
            off += self.lanes * 4
            words = np.frombuffer(data, np.uint16, n, off)
            off += n * 2
            if n > cap:
                cap = max(cap * self.cap_divisor, -(-n // self.lanes) * self.lanes)
            passes.append((n, states, words, cap))
        return passes

    def from_bytes(self, data: bytes, y_shape):
        """Parse ``to_bytes`` output back into pass streams on the device,
        one pageable copy a tensor (the overflow path of ``decode_bytes``)."""
        passes = []
        for n, states, words, cap in self._parse(data, y_shape):
            stream = np.zeros((cap,), np.int32)
            stream[:n] = words
            passes.append(PassStream(
                torch.from_numpy(states.astype(np.int64)).to(self.device),
                torch.from_numpy(stream).to(self.device),
                torch.tensor(n, dtype=torch.int64, device=self.device)))
        return self._streams(passes)

    # -- the packed single-transfer decode path (reference :583-635) ------------

    def packed_layout(self, caps):
        """(offsets, sizes) in u32 words of each pass inside the packed
        buffer for stream capacities ``caps`` (one a pass, in byte order):
        a pass is [n_words, W states, cap/2 words of two u16], the first
        u16 of a word in its low half (the reference's ``_packed_layout``)."""
        if any(c % 2 for c in caps):
            raise ValueError(f"packed layout: odd stream capacity in {caps}")
        sizes = [1 + self.lanes + c // 2 for c in caps]
        return [sum(sizes[:i]) for i in range(len(sizes))], sizes

    def pack(self, data: bytes, y_shape):
        """``to_bytes`` output in the packed layout, in a host buffer this
        codec reuses (pinned on a CUDA codec): (int32 buffer, caps), caps
        the passes' stream lengths. The caller moves the buffer with one
        ``copy_staged``, which must come before the next ``pack``."""
        passes = self._parse(data, y_shape)
        caps = tuple(p[3] for p in passes)
        offs, sizes = self.packed_layout(caps)
        buf = self._staging_buffer(sum(sizes))
        u32 = buf.numpy().view(np.uint32)
        w = self.lanes
        for (n, states, words, cap), slot in zip(passes, offs):
            u32[slot] = n
            u32[slot + 1:slot + 1 + w] = states
            u16 = u32[slot + 1 + w:slot + 1 + w + cap // 2].view(np.uint16)
            u16[:n] = words
            u16[n:] = 0
        return buf, caps

    def _staging_buffer(self, words: int):
        """The reused host staging buffer, ``words`` int32 long, once the
        device has finished reading its previous contents (the event
        ``copy_staged`` recorded). Pinned for a CUDA codec, so the copy is
        asynchronous; a failed allocation raises."""
        if self._staged is not None:
            self._staged.synchronize()
            self._staged = None
        if self._staging is None or self._staging.numel() < words:
            cuda = self.device.type == "cuda"
            self._staging = torch.empty(max(words, 1), dtype=torch.int32,
                                        pin_memory=cuda)
        return self._staging[:words]

    def copy_staged(self, host, dst=None):
        """One host-to-device copy of the staged buffer ``host`` (from
        ``pack``) into ``dst`` (a new device buffer if None), not waiting
        for it; the next ``pack`` waits for it to finish. Returns dst."""
        if dst is None:
            dst = torch.empty(host.shape, dtype=torch.int32, device=self.device)
        dst.copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            self._staged = torch.cuda.Event()
            self._staged.record()
        return dst

    def unpack(self, packed, caps):
        """The packed device buffer as the codec's streams: each pass's
        states int64, its stream int32 of u16 words zero-padded to its cap,
        n_words int64 (device ops only; the reference's ``_unpack_jit``)."""
        offs, _ = self.packed_layout(caps)
        w = self.lanes
        passes = []
        for slot, cap in zip(offs, caps):
            states = packed[slot + 1:slot + 1 + w].long() & il.MASK32
            u32 = packed[slot + 1 + w:slot + 1 + w + cap // 2]
            stream = torch.stack([u32 & il.MASK16, (u32 >> 16) & il.MASK16],
                                 dim=1).reshape(-1)
            passes.append(PassStream(states, stream, packed[slot].long()))
        return self._streams(passes)

    def pack_device(self, passes, out=None):
        """The encoder's PassStreams (in byte order) in the packed layout of
        their stream lengths, by device ops only (no host round trip): the
        buffer the bytes would give when no pass overflowed, since the
        encoder's streams are zero past n_words. Into ``out`` if given
        (int32 of the layout's size), else a new buffer."""
        caps = tuple(p.stream.shape[0] for p in passes)
        offs, sizes = self.packed_layout(caps)
        dev = passes[0].states.device
        if out is None:
            out = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
        w = self.lanes
        for p, slot, cap in zip(passes, offs, caps):
            out[slot:slot + 1] = _u32_bits(p.n_words.reshape(1))
            out[slot + 1:slot + 1 + w] = _u32_bits(p.states)
            s = p.stream.long()
            out[slot + 1 + w:slot + 1 + w + cap // 2] = _u32_bits(
                s[0::2] | (s[1::2] << 16))
        return out

    def decode_bytes(self, data: bytes, y_shape):
        """Bytes -> reconstructed images, with one host-to-device transfer:
        the passes packed into one pinned buffer, copied once, and unpacked
        on the device. An overflow file (a pass longer than its capped
        stream) takes the unpacked path, as in the reference."""
        host, caps = self.pack(data, y_shape)
        if caps != tuple(self._pass_caps(y_shape)):
            return self.decode(self.from_bytes(data, y_shape), y_shape)
        return self.decode(self.unpack(self.copy_staged(host), caps), y_shape)

    def encode_to_bytes(self, x):
        """encode + to_bytes with the automatic overflow fallback."""
        out = self.encode(x)
        try:
            return self.to_bytes(out), out
        except StreamOverflow:
            out = self.encode(x, full=True)
            return self.to_bytes(out), out

    def num_bytes(self, out) -> int:
        return sum(int(p.n_words) * 2 + self.lanes * 4
                   for p in self._out_passes(out))


class FastCheckerboardGmmCodec(_FastCodec):
    """Batched encode/decode around a Cheng2020AnchorCheckerboardGMMv2 (run
    ``model.update()`` first). Works on the model's device.

    ``lanes`` (W) is not written into the bytes: a decoder must use the
    encoder's. The default is the JAX package's (128); the batched
    benchmark configuration uses 4096.

    ``kernel_transforms=True`` sends the bf16 transforms' eligible convs
    through the bf16 conv kernel (off by default, as the reference's
    ``FLASHGMM_PALLAS_CONV_TRANSFORMS``). It changes pixels and the
    quantized latents by bf16 roundings, never the rows chain, the coder
    or the byte format."""

    def __init__(self, model, lanes: int = 128, max_abs: int = 47,
                 cap_divisor: int = 4, bf16_transforms: bool = True,
                 kernel_transforms: bool = False):
        lc = model.latent_codec.latent_codec
        super().__init__(model, lc["hyper"], lanes, max_abs, cap_divisor,
                         bf16_transforms, kernel_transforms)
        self._ckbd = lc["y"]
        self._gmm = self._ckbd.latent_codec["y"]

    # -- shared pieces -------------------------------------------------------

    def _gmm_pass_params(self, y_ctx, side):
        """EP -> per-symbol [N, K] (scales, means, weights), NHWC-ravel
        symbol order (reference :333-353)."""
        return _gmm_pass_params(self._ckbd, self._gmm, y_ctx, side)

    def _side(self, z_bin):
        """SHARED enc/dec: dequantize z and run h_s (rows chain)."""
        return self._ckbd.unembed(run_canonical(self._hyper.h_s,
                                                self._z_hat(z_bin)))

    def _params0(self, side0):
        """SHARED enc/dec: anchor-pass GMM parameters (context is zero)."""
        return self._gmm_pass_params(torch.zeros_like(side0), side0)

    def _params1(self, side1, sym0):
        """SHARED enc/dec: non-anchor-pass GMM parameters conditioned on the
        decoded anchors (integer symbols -> deterministic input)."""
        y_hat_ = torch.stack([sym0.float(), torch.zeros_like(sym0, dtype=torch.float32)])
        ctx = self._ckbd.unembed(run_canonical(
            self._ckbd.context_prediction, self._ckbd.embed(y_hat_)))[1]
        return self._gmm_pass_params(ctx, side1)

    # -- orchestration ---------------------------------------------------------

    @torch.inference_mode()
    def encode(self, x, full: bool = False):
        """x: [B, H, W, 3] float in [0, 1] on the codec's device. Returns
        {"z", "y0", "y1": PassStream, "y_hat": [B, H/16, W/16, N]}.

        ``full=True`` disables the stream cap (the overflow fallback)."""
        ps_z, ps0, ps1, _, _, y_hat = self._encode(
            x, 1 if full else self.cap_divisor)
        return {"z": ps_z, "y0": ps0, "y1": ps1, "y_hat": y_hat}

    def _encode(self, x, cd):
        """The encode core, y passes capped at 1/``cd``: (z, y0, y1
        PassStreams, anchor and non-anchor symbols int32 [B, H/16, W/32,
        N], y_hat). Waits for nothing, so a CUDA graph can capture it."""
        y = self._transform(self._g_a, x)
        z = self._transform(self._h_a, y)
        z_bin, ps_z = self._encode_z(z)

        sym = torch.clamp(torch.round(self._ckbd.unembed(y)).to(torch.int32),
                          -self.max_abs, self.max_abs)  # [2, b, h, w/2, c]
        y_hat = self._ckbd.embed(sym.float())

        side = self._side(z_bin)
        ps0 = self._encpass(self._params0(side[0]), sym[0].reshape(-1), cd)
        ps1 = self._encpass(self._params1(side[1], sym[0]),
                            sym[1].reshape(-1), cd)
        return ps_z, ps0, ps1, sym[0], sym[1], y_hat

    @torch.inference_mode()
    def decode_y_hat(self, streams, y_shape, err=None):
        """Streams -> y_hat [B, H/16, W/16, N]. Without ``err`` a decoder
        that reads past its stream raises at once; with it (int32 [1] on
        the device) the three decoders OR 1 into it and nothing waits for
        the device (``rans_kernels.decode_scan``)."""
        b, h, w, c = self._y_shape_parts(y_shape)
        z_bin = self._decode_z(streams["z"], b, h, w, err)
        side = self._side(z_bin)
        n = b * h * (w // 2) * c
        sym0 = self._decpass(streams["y0"], self._params0(side[0]), n,
                             err).reshape(b, h, w // 2, c)
        sym1 = self._decpass(streams["y1"], self._params1(side[1], sym0), n,
                             err).reshape(b, h, w // 2, c)
        return self._ckbd.embed(torch.stack([sym0, sym1]).float())

    def stream_capacities(self, y_shape):
        """(cap_z, cap_y) capped stream lengths for latent y_shape =
        (h, w, c) or (b, h, w, c)."""
        b, h, w, c = self._y_shape_parts(y_shape)
        n_y = b * h * (w // 2) * c
        n_z = b * (h // 4) * (w // 4) * self._z_channels()
        t_y, _ = il.layout(n_y, self.lanes)
        t_z, _ = il.layout(n_z, self.lanes)
        return (t_z * self.lanes,  # z is never capped
                max(t_y * self.lanes // self.cap_divisor, self.lanes))

    # -- the passes: z, y0, y1 ---------------------------------------------------

    def _pass_caps(self, y_shape):
        cap_z, cap_y = self.stream_capacities(y_shape)
        return cap_z, cap_y, cap_y

    @staticmethod
    def _passes(streams):
        """{"z", "y0", "y1": PassStream} -> the passes in byte order."""
        return tuple(streams[name] for name in _PASSES)

    _out_passes = _passes

    @staticmethod
    def _streams(passes):
        return dict(zip(_PASSES, passes))


class FastCheckerboardGsmCodec(FastCheckerboardGmmCodec):
    """Batched encode/decode around a Cheng2020AnchorCheckerboard, the
    single-Gaussian (GSM) counterpart of the flagship (port of
    flashgmm_tpu/runtime/fast_codec.py:680-826). Run ``model.update()``
    first. Options, byte format (three passes: z, y0, y1), lanes, stream
    caps and the StreamOverflow fallback are the flagship codec's.

    Each y symbol is coded as a K = 1 mixture of zero mean and unit weight
    under its pass's clamped scale (the rANS kernels' K = 1 instances), so
    the rows are zero-mean and the symbols mean-centred: ``sym =
    clamp(round(y - mu), +-max_abs)`` with mu the pass's means, and ``y_hat
    = sym + mu``. The encoder therefore quantizes each pass only after its
    parameters, and the non-anchor pass's context reads ``sym0 + mu0``, not
    an integer: the encoder and the decoder agree because mu0 comes from the
    same rows-chain convs (``run_canonical``, bit for bit the same on both
    sides), and no softmax enters the chain, so the card's and the CPU's
    parameters, and bytes, are equal too."""

    def __init__(self, model, lanes: int = 128, max_abs: int = 47,
                 cap_divisor: int = 4, bf16_transforms: bool = True,
                 kernel_transforms: bool = False):
        super().__init__(model, lanes, max_abs, cap_divisor, bf16_transforms,
                         kernel_transforms)
        self._gc = self._ckbd.latent_codec["y"]  # GaussianConditionalLatentCodec
        self._unit = {}  # n -> (zero means, unit weights), float32 [n, 1]

    def _gsm_pass_params(self, y_ctx, side):
        """A pass's entropy parameters -> ((scales clamped, zero means,
        unit weights) float32 [n, 1] in NHWC-ravel symbol order, means mu
        [b, h, w/2, c]) (reference :702-707)."""
        p = run_canonical(self._ckbd.entropy_parameters,
                          self._ckbd.merge(y_ctx, side))
        scales, mu = self._gc._chunk(p)
        scales = torch.clamp(scales.reshape(-1, 1), 0.11, 256.0)
        n = scales.shape[0]
        if n not in self._unit:
            self._unit[n] = (torch.zeros_like(scales), torch.ones_like(scales))
        return (scales, *self._unit[n]), mu

    def _params0(self, side0):
        """SHARED enc/dec: anchor-pass parameters and means (context is
        zero)."""
        return self._gsm_pass_params(torch.zeros_like(side0), side0)

    def _params1(self, side1, sym0, mu0):
        """SHARED enc/dec: non-anchor-pass parameters and means, conditioned
        on the reconstructed anchors sym0 + mu0."""
        y_hat0 = sym0.float() + mu0
        y_hat_ = torch.stack([y_hat0, torch.zeros_like(y_hat0)])
        ctx = self._ckbd.unembed(run_canonical(
            self._ckbd.context_prediction, self._ckbd.embed(y_hat_)))[1]
        return self._gsm_pass_params(ctx, side1)

    def _quantize(self, y_half, mu):
        return torch.clamp(torch.round(y_half - mu).to(torch.int32),
                           -self.max_abs, self.max_abs)

    def _embed(self, sym0, sym1, mu0, mu1):
        return self._ckbd.embed(torch.stack([sym0.float() + mu0,
                                             sym1.float() + mu1]))

    def _encode(self, x, cd):
        """The encode core, y passes capped at 1/``cd``: (z, y0, y1
        PassStreams, anchor and non-anchor symbols int32 [B, H/16, W/32,
        N], y_hat)."""
        y = self._transform(self._g_a, x)
        z = self._transform(self._h_a, y)
        z_bin, ps_z = self._encode_z(z)
        y_ = self._ckbd.unembed(y)  # [2, b, h, w/2, c]

        side = self._side(z_bin)
        params0, mu0 = self._params0(side[0])
        sym0 = self._quantize(y_[0], mu0)
        ps0 = self._encpass(params0, sym0.reshape(-1), cd)
        params1, mu1 = self._params1(side[1], sym0, mu0)
        sym1 = self._quantize(y_[1], mu1)
        ps1 = self._encpass(params1, sym1.reshape(-1), cd)
        return ps_z, ps0, ps1, sym0, sym1, self._embed(sym0, sym1, mu0, mu1)

    @torch.inference_mode()
    def decode_y_hat(self, streams, y_shape, err=None):
        """Streams -> y_hat [B, H/16, W/16, N] (see the flagship's)."""
        b, h, w, c = self._y_shape_parts(y_shape)
        z_bin = self._decode_z(streams["z"], b, h, w, err)
        side = self._side(z_bin)
        n = b * h * (w // 2) * c
        params0, mu0 = self._params0(side[0])
        sym0 = self._decpass(streams["y0"], params0, n,
                             err).reshape(b, h, w // 2, c)
        params1, mu1 = self._params1(side[1], sym0, mu0)
        sym1 = self._decpass(streams["y1"], params1, n,
                             err).reshape(b, h, w // 2, c)
        return self._embed(sym0, sym1, mu0, mu1)

"""Batched on-device codec for Elic2022GMM, ELIC's SCCTX (port of
flashgmm_tpu/runtime/fast_elic.py, ``FastElicGmmCodec``).

Five uneven channel groups, each coded in two checkerboard passes: ten GMM
passes and the z pass, eleven streams. Encode: g_a -> h_a -> z quantized
against the EntropyBottleneck tables -> z pass; then the shared stages
side (h_s) -> for each group k in order: the channel context of the
groups before it with the side parameters (``_ctxparams``), then for each
of its two passes the spatial context and the parameter aggregation
(``_pass_params``) -> the pass. Decode runs the same order and ends in
g_s. As on the flagship path, no rows are built: the GMM encoder evaluates
each symbol's (start, freq), the GMM decoder the entries its search probes.

Correctness by construction, as in ``FastCheckerboardGmmCodec``: encoder
and decoder call the same stage functions on tensors of the same shapes;
every conv of the rows chain (h_s's transposed convs as zero-inserted
"same" convs, the channel contexts, the spatial contexts and the
aggregation networks) goes through the hand conv kernel in float32, one
fmaf chain an output; every row entry is one elementwise function of its
symbol's parameters. The bytes are the JAX class's format (per pass u32
n_words, u32 x W states, u16 x n_words words; z first, then each group's
anchor and non-anchor pass), with its lanes, caps and StreamOverflow
fallback.
"""

import torch

from flashgmm_tpu_torch.ans import interleaved as il
from flashgmm_tpu_torch.layers import run_canonical

from .fast_codec import _FastCodec, _gmm_pass_params


class FastElicGmmCodec(_FastCodec):
    """Batched encode/decode around an Elic2022GMM (run ``model.update()``
    first), on the model's device. Defaults are the JAX class's: lanes=512,
    max_abs=47, cap_divisor=1 (a stream is never capped).
    ``kernel_transforms=True`` sends the bf16 transforms' eligible convs
    through the bf16 conv kernel, as in ``FastCheckerboardGmmCodec``."""

    def __init__(self, model, lanes: int = 512, max_abs: int = 47,
                 cap_divisor: int = 1, bf16_transforms: bool = True,
                 kernel_transforms: bool = False):
        lc = model.latent_codec.latent_codec
        super().__init__(model, lc["hyper"], lanes, max_abs, cap_divisor,
                         bf16_transforms, kernel_transforms)
        self._cg = lc["y"]
        self.groups = list(self._cg.groups)
        self._ckbds = [self._cg.latent_codec[f"y{k}"]
                       for k in range(len(self.groups))]

    # -- the shared stages ---------------------------------------------------

    def _side(self, z_bin):
        """SHARED enc/dec: z_hat -> h_s on the rows chain, [B, h, w, 2N]."""
        return run_canonical(self._hyper.h_s, self._z_hat(z_bin))

    def _embed_group(self, k, sym0, sym1):
        """Group k's integer symbols of both passes -> its y_hat."""
        return self._ckbds[k].embed(torch.stack([sym0, sym1]).float())

    def _embed_full(self, syms):
        """Every group's y_hat, concatenated: [B, h, w, M]."""
        return torch.cat([self._embed_group(k, syms[2 * k], syms[2 * k + 1])
                          for k in range(len(self.groups))], dim=-1)

    def _ctxparams(self, side_all, prev_syms, k):
        """SHARED enc/dec: group k's context parameters, the channel context
        of groups < k (on the rows chain) beside the side parameters.
        prev_syms: (sym0_0, sym1_0, ..., sym0_{k-1}, sym1_{k-1})."""
        y_hat_prev = [self._embed_group(j, prev_syms[2 * j],
                                        prev_syms[2 * j + 1])
                      for j in range(k)]
        return self._cg._get_ctx_params(k, side_all, y_hat_prev,
                                        run=run_canonical)

    def _pass_params(self, k, side_i, sym0=None):
        """SHARED enc/dec: GMM parameters of group k's pass i, whose half of
        the context parameters is ``side_i``: the spatial context over the
        anchors ``sym0`` (None for the anchor pass: a zero context), then
        the aggregation network -> [n, K] scales, means and weights."""
        ckbd = self._ckbds[k]
        if sym0 is None:
            ctx = side_i.new_zeros(side_i.shape[:-1]
                                   + (ckbd.context_prediction.out_ch,))
        else:
            y_hat_ = torch.stack([sym0.float(),
                                  torch.zeros_like(sym0, dtype=torch.float32)])
            ctx = ckbd.unembed(run_canonical(ckbd.context_prediction,
                                             ckbd.embed(y_hat_)))[1]
        return _gmm_pass_params(ckbd, ckbd.latent_codec["y"], ctx, side_i)

    # -- orchestration ---------------------------------------------------------

    @torch.inference_mode()
    def encode(self, x, full: bool = False):
        """x: [B, H, W, 3] float in [0, 1] on the codec's device. Returns
        {"streams": [z, y0 anchor, y0 non-anchor, ..., y4 non-anchor]
        PassStreams, "y_hat": [B, H/16, W/16, M]}. ``full=True`` disables
        the stream cap (the overflow fallback)."""
        streams, _, y_hat = self._encode(x, 1 if full else self.cap_divisor)
        return {"streams": streams, "y_hat": y_hat}

    def _encode(self, x, cd):
        """The encode core, y passes capped at 1/``cd``: (the eleven
        PassStreams, the symbols int32 [B, h, w/2, g_k] of each pass in
        coding order, y_hat). Waits for nothing, so a CUDA graph can
        capture it."""
        y = self._transform(self._g_a, x)
        z = self._transform(self._h_a, y)
        z_bin, ps_z = self._encode_z(z)
        syms = []
        for ckbd, yk in zip(self._ckbds, self._cg._split(y)):
            sym = torch.clamp(torch.round(ckbd.unembed(yk)).to(torch.int32),
                              -self.max_abs, self.max_abs)
            syms += [sym[0], sym[1]]

        side_all = self._side(z_bin)
        streams = [ps_z]
        for k, ckbd in enumerate(self._ckbds):
            side = ckbd.unembed(self._ctxparams(side_all, syms[:2 * k], k))
            sym0, sym1 = syms[2 * k], syms[2 * k + 1]
            streams.append(self._encpass(self._pass_params(k, side[0]),
                                         sym0.reshape(-1), cd))
            streams.append(self._encpass(self._pass_params(k, side[1], sym0),
                                         sym1.reshape(-1), cd))
        return streams, syms, self._embed_full(syms)

    @torch.inference_mode()
    def decode_y_hat(self, streams, y_shape, err=None):
        """The eleven streams -> y_hat [B, H/16, W/16, M]. ``err``: the
        decoders' deferred error flag, as in
        ``FastCheckerboardGmmCodec.decode_y_hat``."""
        b, h, w, _ = self._y_shape_parts(y_shape)
        side_all = self._side(self._decode_z(streams[0], b, h, w, err))
        syms = []
        for k, (ckbd, gk) in enumerate(zip(self._ckbds, self.groups)):
            side = ckbd.unembed(self._ctxparams(side_all, syms, k))
            n = b * h * (w // 2) * gk
            sym0 = self._decpass(streams[1 + 2 * k], self._pass_params(
                k, side[0]), n, err).reshape(b, h, w // 2, gk)
            sym1 = self._decpass(streams[2 + 2 * k], self._pass_params(
                k, side[1], sym0), n, err).reshape(b, h, w // 2, gk)
            syms += [sym0, sym1]
        return self._embed_full(syms)

    def stream_capacities(self, y_shape):
        """The eleven streams' lengths for latent y_shape = (h, w, c) or
        (b, h, w, c): z's uncapped, then each group's two passes capped at
        1/cap_divisor (at least W)."""
        b, h, w, _ = self._y_shape_parts(y_shape)
        n_z = b * (h // 4) * (w // 4) * self._z_channels()
        caps = [il.layout(n_z, self.lanes)[0] * self.lanes]
        for gk in self.groups:
            t, _ = il.layout(b * h * (w // 2) * gk, self.lanes)
            cap = max(t * self.lanes // self.cap_divisor, self.lanes)
            caps += [cap, cap]
        return caps

    # -- the passes: z, then each group's two -----------------------------------

    _pass_caps = stream_capacities

    @staticmethod
    def _passes(streams):
        return tuple(streams)

    @staticmethod
    def _streams(passes):
        return list(passes)

    @staticmethod
    def _out_passes(out):
        return tuple(out["streams"])

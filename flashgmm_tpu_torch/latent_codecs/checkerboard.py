"""Two-pass checkerboard context codec (port of
flashgmm_tpu/latent_codecs/checkerboard.py: the container, the
checkerboard packing helpers, the training forwards "onepass", "twopass"
and "twopass_faster", :22-189, and the reference format's two dense
passes, :191-232). All tensors NHWC.

In ``compress`` and ``decompress`` the context and the entropy network run
on the rows chain (``layers.run_canonical``: the f32 conv kernel's fixed
reduction order, its plain version on the CPU), so the encoder and the
decoder get the same parameters bit for bit, on the card and on the CPU.
"""

import torch
from torch import nn

from flashgmm_tpu_torch.entropy_models.entropy_models import uniform_noise
from flashgmm_tpu_torch.layers import run_canonical
from flashgmm_tpu_torch.ops import quantize_ste
from flashgmm_tpu_torch.registry import register_module

from .base import LatentCodec

_FORWARDS = ("onepass", "twopass", "twopass_faster")


def _checkerboard_mask(h, w, parity: str, dtype=torch.float32, device=None):
    """[H, W] mask with ones at the given parity's positions.

    'even' = positions where (i + j) is even ((0,0), (0,2), (1,1), ...).
    """
    ii = torch.arange(h, device=device)[:, None]
    jj = torch.arange(w, device=device)[None, :]
    even = ((ii + jj) % 2) == 0
    mask = even if parity == "even" else ~even
    return mask.to(dtype)


def _interleave_rows(even_rows, odd_rows):
    """Reassemble alternating rows: out[0::2] = even_rows, out[1::2] = odd."""
    b, h_half, w, c = even_rows.shape
    h2 = odd_rows.shape[1]
    if h_half == h2:
        out = torch.stack([even_rows, odd_rows], dim=2)  # [B, H/2, 2, W, C]
        return out.reshape(b, h_half * 2, w, c)
    out = even_rows.new_zeros((b, h_half + h2, w, c))
    out[:, 0::2] = even_rows
    out[:, 1::2] = odd_rows
    return out


@register_module("CheckerboardLatentCodec")
class CheckerboardLatentCodec(LatentCodec):
    def __init__(self, latent_codec=None, entropy_parameters=None,
                 context_prediction=None, anchor_parity: str = "even",
                 forward_method: str = "onepass"):
        super().__init__()
        if forward_method not in _FORWARDS:
            raise ValueError(f"Unknown forward method: {forward_method!r}")
        self.forward_method = forward_method
        self.anchor_parity = anchor_parity
        self.non_anchor_parity = {"odd": "even", "even": "odd"}[anchor_parity]
        self.entropy_parameters = entropy_parameters
        self.context_prediction = context_prediction
        self.latent_codec = nn.ModuleDict(dict(latent_codec or {}))

    def _mask(self, y, parity: str):
        """Zero out positions of the given parity ('all' zeroes everything)."""
        if parity == "all":
            return torch.zeros_like(y)
        h, w = y.shape[1], y.shape[2]
        keep = _checkerboard_mask(h, w, {"even": "odd", "odd": "even"}[parity],
                                  y.dtype, y.device)
        return y * keep[None, :, :, None]

    def _keep_only(self, y, step: str):
        parity = self.non_anchor_parity if step == "anchor" else self.anchor_parity
        return self._mask(y, parity)

    def forward(self, y, side_params, training: bool = True, generator=None):
        """The training forward named by ``forward_method``: {"likelihoods":
        {"y"}, "y_hat"}, both of y's shape."""
        if self.forward_method == "twopass":
            return self._forward_twopass(y, side_params, training, generator)
        if self.forward_method == "twopass_faster":
            return self._forward_twopass_faster(y, side_params, training,
                                                generator)
        return self._forward_onepass(y, side_params, training, generator)

    def _forward_onepass(self, y, side_params, training, generator):
        """One entropy-parameter pass over the whole latent (reference
        :154-171): y_hat is y with uniform noise when training, else
        round(y); the context sees y_hat at the anchors only, and the
        likelihoods are those of y given it."""
        if training:
            y_hat = y + uniform_noise(y.shape, generator, y)
        else:
            y_hat = torch.round(y)
        y_ctx = self._keep_only(self.context_prediction(y_hat), "non_anchor")
        params = self.entropy_parameters(self.merge(y_ctx, side_params))
        y_out = self.latent_codec["y"](y, params, training=training,
                                       generator=generator)
        return {"likelihoods": {"y": y_out["likelihoods"]["y"]},
                "y_hat": y_hat}

    def _zero_context(self, y):
        return y.new_zeros(tuple(y.shape[:-1])
                           + (self.context_prediction.out_ch,))

    def _forward_twopass(self, y, side_params, training, generator):
        """Two entropy-parameter passes (reference :134-162): the anchors
        are rounded around the first pass's means with a straight-through
        gradient, the second pass is conditioned on them, and the latent
        codec gives the likelihoods of y under each position's own pass's
        parameters."""
        codec = self.latent_codec["y"]

        def step(y_ctx, step_name):
            params = self.entropy_parameters(self.merge(y_ctx, side_params))
            params = self._keep_only(params, step_name)
            y_i = self._keep_only(y, step_name)
            _, means = codec._chunk(params)
            y_hat_i = self._keep_only(quantize_ste(y_i - means) + means,
                                      step_name)
            return y_hat_i, params

        y_hat_anchors, params_a = step(self._zero_context(y), "anchor")
        y_hat_non, params_n = step(self.context_prediction(y_hat_anchors),
                                   "non_anchor")
        params = (self._keep_only(params_a, "anchor")
                  + self._keep_only(params_n, "non_anchor"))
        y_out = codec(y, params, training=training, generator=generator)
        return {"likelihoods": {"y": y_out["likelihoods"]["y"]},
                "y_hat": y_hat_anchors + y_hat_non}

    def _forward_twopass_faster(self, y, side_params, training, generator):
        """Two entropy-parameter passes with fewer redundant ops (reference
        :164-189): the anchors are rounded around the first pass's means
        with a straight-through gradient; the latent codec runs once, on the
        second pass's parameters, and its y_hat is kept at the
        non-anchors."""
        codec = self.latent_codec["y"]
        params = self.entropy_parameters(
            self.merge(self._zero_context(y), side_params))
        _, means = codec._chunk(self._keep_only(params, "anchor"))
        y_hat_anchors = self._keep_only(quantize_ste(y - means) + means,
                                        "anchor")
        y_ctx = self._keep_only(self.context_prediction(y_hat_anchors),
                                "non_anchor")
        params = self.entropy_parameters(self.merge(y_ctx, side_params))
        y_out = codec(y, params, training=training, generator=generator)
        y_hat = self._keep_only(y_out["y_hat"], "non_anchor") + y_hat_anchors
        return {"likelihoods": {"y": y_out["likelihoods"]["y"]},
                "y_hat": y_hat}

    def unembed(self, y):
        """[B, H, W, C] -> [2, B, H, W/2, C]: chunk 0 = anchors, 1 = non."""
        even_rows = y[:, 0::2]
        odd_rows = y[:, 1::2]
        if self.anchor_parity == "even":
            a = _interleave_rows(even_rows[:, :, 0::2], odd_rows[:, :, 1::2])
            n = _interleave_rows(even_rows[:, :, 1::2], odd_rows[:, :, 0::2])
        else:
            a = _interleave_rows(even_rows[:, :, 1::2], odd_rows[:, :, 0::2])
            n = _interleave_rows(even_rows[:, :, 0::2], odd_rows[:, :, 1::2])
        return torch.stack([a, n], dim=0)

    def embed(self, y_):
        """Inverse of :meth:`unembed`: [2, B, H, W/2, C] -> [B, H, W, C]."""
        if y_.shape[0] != 2:
            raise ValueError(f"embed expects [2, B, H, W/2, C], got {tuple(y_.shape)}")
        a, n = y_[0], y_[1]
        b, h, w_half, c = a.shape
        out = a.new_zeros((b, h, w_half * 2, c))
        if self.anchor_parity == "even":
            out[:, 0::2, 0::2] = a[:, 0::2]
            out[:, 1::2, 1::2] = a[:, 1::2]
            out[:, 0::2, 1::2] = n[:, 0::2]
            out[:, 1::2, 0::2] = n[:, 1::2]
        else:
            out[:, 0::2, 1::2] = a[:, 0::2]
            out[:, 1::2, 0::2] = a[:, 1::2]
            out[:, 0::2, 0::2] = n[:, 0::2]
            out[:, 1::2, 1::2] = n[:, 1::2]
        return out

    def merge(self, *args):
        return torch.cat(args, dim=-1)

    # -- reference-format coding: two dense passes ---------------------------

    def _pass_params(self, i, y_hat_, side_i):
        """Pass i's entropy parameters: the context of the anchors in
        ``y_hat_`` [2, B, H, W/2, C] (zero for the anchor pass), beside the
        side parameters, through the entropy network; all on the rows
        chain."""
        if i == 0:
            y_ctx = side_i.new_zeros(tuple(side_i.shape[:-1])
                                     + (self.context_prediction.out_ch,))
        else:
            y_ctx = self.unembed(run_canonical(self.context_prediction,
                                               self.embed(y_hat_)))[i]
        return run_canonical(self.entropy_parameters,
                             self.merge(y_ctx, side_i))

    def compress(self, y, side_params):
        """y [B, H, W, C] -> {"strings": the two passes' containers,
        "shape": (H, W, C), "y_hat"}: the anchors coded first, then the
        non-anchors conditioned on them."""
        b, h, w, c = y.shape
        y_hat_ = y.new_zeros((2, b, h, w // 2, c))
        side_params_ = self.unembed(side_params)
        y_ = self.unembed(y)
        y_strings_ = [None, None]
        for i in range(2):
            params_i = self._pass_params(i, y_hat_, side_params_[i])
            y_out = self.latent_codec["y"].compress(y_[i], params_i)
            y_hat_[i] = y_out["y_hat"]
            [y_strings_[i]] = y_out["strings"]
        y_hat = self.embed(y_hat_)
        return {"strings": y_strings_, "shape": tuple(y_hat.shape[1:]),
                "y_hat": y_hat}

    def decompress(self, strings, shape, side_params):
        """{"y_hat" [B, H, W, C]} of the two passes' containers."""
        h, w, c = shape
        b = side_params.shape[0]
        y_hat_ = side_params.new_zeros((2, b, h, w // 2, c))
        side_params_ = self.unembed(side_params)
        for i in range(2):
            params_i = self._pass_params(i, y_hat_, side_params_[i])
            y_out = self.latent_codec["y"].decompress([strings[i]],
                                                      (h, w // 2), params_i)
            y_hat_[i] = y_out["y_hat"]
        return {"y_hat": self.embed(y_hat_)}

"""Two-pass checkerboard context codec (port of
flashgmm_tpu/latent_codecs/checkerboard.py: the container, the
checkerboard packing helpers and the "onepass" training forward, :22-171;
"twopass", which serves the GSM model, waits for ROADMAP item 8). All
tensors NHWC.
"""

import torch
from torch import nn

from flashgmm_tpu_torch.entropy_models.entropy_models import uniform_noise


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


class CheckerboardLatentCodec(nn.Module):
    def __init__(self, latent_codec=None, entropy_parameters=None,
                 context_prediction=None, anchor_parity: str = "even",
                 forward_method: str = "onepass"):
        super().__init__()
        if forward_method != "onepass":
            raise ValueError(f"forward_method {forward_method!r}: the port "
                             "has the one-pass forward only")
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
        """One entropy-parameter pass over the whole latent (reference
        :154-171): y_hat is y with uniform noise when training, else
        round(y); the context sees y_hat at the anchors only, and the GMM
        likelihoods are those of y given it. Returns {"likelihoods": {"y"},
        "y_hat"}."""
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

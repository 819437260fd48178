"""Gaussian conditional codec for a latent ``y`` given ``ctx_params`` (port
of flashgmm_tpu/latent_codecs/gaussian_conditional.py:16-75): chunks the
entropy parameters channel-last into scales and means and gives the
training forward's y likelihoods through ``GaussianConditional``. The
single-Gaussian codec (``runtime/fast_codec.py::FastCheckerboardGsmCodec``)
codes ``y`` from the same parameters. ``compress`` and ``decompress`` need
the scale tables and the reference-format host coder, which wait for
ROADMAP item 9.
"""

import torch
from torch import nn

from flashgmm_tpu_torch.entropy_models import GaussianConditional
from flashgmm_tpu_torch.ops import quantize_ste

_CHUNKS = (("scales",), ("means",), ("scales", "means"), ("means", "scales"))


class GaussianConditionalLatentCodec(nn.Module):
    """``quantizer``: "noise" (y_hat is the GaussianConditional's: y with
    uniform noise when training, rounded around the means when not) or
    "ste" (y rounded around the means with a straight-through gradient; the
    likelihoods stay those of the GaussianConditional's own quantization).
    ``chunks`` names the parameters' channel chunks in order. Keyword
    arguments go to ``GaussianConditional`` (``scale_bound``,
    ``tail_mass``, ``likelihood_bound``)."""

    def __init__(self, gaussian_conditional=None, entropy_parameters=None,
                 quantizer: str = "noise", chunks=("scales", "means"),
                 **kwargs):
        super().__init__()
        if quantizer not in ("noise", "ste"):
            raise ValueError(f"unknown quantizer {quantizer!r}")
        if tuple(chunks) not in _CHUNKS:
            raise ValueError(f"unknown chunks {chunks!r}")
        self.quantizer = quantizer
        self.gaussian_conditional = (gaussian_conditional
                                     or GaussianConditional(**kwargs))
        self.entropy_parameters = entropy_parameters
        self.chunks = tuple(chunks)

    def _apply_ep(self, ctx_params):
        if self.entropy_parameters is None:
            return ctx_params
        return self.entropy_parameters(ctx_params)

    def _chunk(self, params):
        """(scales, means) of the channel-last parameters; None for a
        parameter ``chunks`` does not name."""
        if len(self.chunks) == 1:
            return (params, None) if self.chunks == ("scales",) \
                else (None, params)
        a, b = torch.chunk(params, 2, dim=-1)
        return (a, b) if self.chunks == ("scales", "means") else (b, a)

    def forward(self, y, ctx_params, training: bool = True, generator=None):
        """{"likelihoods": {"y"}, "y_hat"} of y [B, H, W, M] under the
        parameters the entropy network makes of ``ctx_params``."""
        scales_hat, means_hat = self._chunk(self._apply_ep(ctx_params))
        gc = self.gaussian_conditional
        y_hat, y_likelihoods = gc(y, scales_hat, means_hat, training=training,
                                  generator=generator)
        if self.quantizer == "ste":
            y_hat = quantize_ste(y - means_hat) + means_hat
        return {"likelihoods": {"y": y_likelihoods}, "y_hat": y_hat}

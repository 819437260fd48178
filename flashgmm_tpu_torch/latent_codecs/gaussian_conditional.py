"""Gaussian conditional codec for a latent ``y`` given ``ctx_params`` (port
of flashgmm_tpu/latent_codecs/gaussian_conditional.py): chunks the entropy
parameters channel-last into scales and means, gives the training
forward's y likelihoods through ``GaussianConditional`` and codes y in the
reference format over its scale table (``compress``/``decompress``,
:68-87; run the model's ``update()`` first). The single-Gaussian codec
(``runtime/fast_codec.py::FastCheckerboardGsmCodec``) codes ``y`` from the
same parameters.
"""

import torch

from flashgmm_tpu_torch.entropy_models import GaussianConditional
from flashgmm_tpu_torch.layers import run_canonical
from flashgmm_tpu_torch.ops import quantize_ste
from flashgmm_tpu_torch.registry import register_module

from .base import LatentCodec

_CHUNKS = (("scales",), ("means",), ("scales", "means"), ("means", "scales"))


@register_module("GaussianConditionalLatentCodec")
class GaussianConditionalLatentCodec(LatentCodec):
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

    def _apply_ep(self, ctx_params, run=None):
        """The entropy network on ``ctx_params`` (none: the parameters
        themselves); ``run(module, x)`` runs it (coding passes
        ``layers.run_canonical``), default ``module(x)``."""
        if self.entropy_parameters is None:
            return ctx_params
        if run is None:
            return self.entropy_parameters(ctx_params)
        return run(self.entropy_parameters, ctx_params)

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

    def compress(self, y, ctx_params):
        """y [B, H, W, M] -> {"strings": [one string an image], "shape":
        (H, W), "y_hat"}: round(y - means) under each scale's table entry;
        y_hat is decoded from the strings, as in the reference."""
        scales_hat, means_hat = self._chunk(self._apply_ep(ctx_params,
                                                           run_canonical))
        gc = self.gaussian_conditional
        indexes = gc.build_indexes(scales_hat)
        y_strings = gc.compress(y, indexes, means_hat)
        y_hat = gc.decompress(y_strings, indexes, means=means_hat)
        return {"strings": [y_strings], "shape": tuple(y.shape[1:3]),
                "y_hat": y_hat}

    def decompress(self, strings, shape, ctx_params):
        (y_strings,) = strings
        scales_hat, means_hat = self._chunk(self._apply_ep(ctx_params,
                                                           run_canonical))
        gc = self.gaussian_conditional
        y_hat = gc.decompress(y_strings, gc.build_indexes(scales_hat),
                              means=means_hat)
        if tuple(y_hat.shape[1:3]) != tuple(shape):
            raise ValueError(f"decoded {tuple(y_hat.shape[1:3])}, expected "
                             f"{tuple(shape)}")
        return {"y_hat": y_hat}

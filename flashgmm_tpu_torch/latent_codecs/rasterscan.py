"""Raster-scan autoregressive latent codec (port of
flashgmm_tpu/latent_codecs/rasterscan.py; CompressAI's
latent_codecs/rasterscan.py:54-340).

The training forward is one dense pass through the masked context conv on
the device; real coding is the host loop of ``runtime/rasterscan.py``. Run
the model's ``update()`` first; ``params`` (the hyper side parameters)
must be computed alike on both sides, as the models do on the rows chain.
"""

import torch

from flashgmm_tpu_torch.entropy_models import GaussianConditional
from flashgmm_tpu_torch.registry import register_module
from flashgmm_tpu_torch.runtime import rasterscan

from .base import LatentCodec


@register_module("RasterScanLatentCodec")
class RasterScanLatentCodec(LatentCodec):
    def __init__(self, gaussian_conditional=None, entropy_parameters=None,
                 context_prediction=None, **kwargs):
        super().__init__()
        self.gaussian_conditional = gaussian_conditional or GaussianConditional()
        self.entropy_parameters = entropy_parameters
        self.context_prediction = context_prediction

    @property
    def kernel_size(self):
        return self.context_prediction.weight.shape[-1]

    def forward(self, y, params, training: bool = True, generator=None):
        """{"likelihoods": {"y"}, "y_hat"}: y with uniform noise from
        ``generator`` when training (else rounded), its context and the
        side parameters through the entropy network, y's likelihoods under
        the (scales, means) it makes."""
        gc = self.gaussian_conditional
        y_hat = gc.quantize(y, "noise" if training else "dequantize",
                            generator=generator)
        ctx_params = self.context_prediction(y_hat)
        gaussian_params = self.entropy_parameters(
            torch.cat([params, ctx_params], dim=-1))
        scales_hat, means_hat = torch.chunk(gaussian_params, 2, dim=-1)
        _, y_likelihoods = gc(y, scales_hat, means_hat, training=training,
                              generator=generator)
        return {"likelihoods": {"y": y_likelihoods}, "y_hat": y_hat}

    def _pieces(self):
        return rasterscan.host_pieces(self.gaussian_conditional,
                                      self.context_prediction,
                                      self.entropy_parameters)

    def compress(self, y, params):
        """{"strings": [[one string an image]], "shape": (H, W), "y_hat"
        (as the decoder reconstructs it, on y's device)}."""
        strings, y_hat = rasterscan.raster_scan_compress(y, params,
                                                         self._pieces())
        return {"strings": [strings], "shape": tuple(y.shape[1:3]),
                "y_hat": y_hat}

    def decompress(self, strings, shape, params, **kwargs):
        (y_strings,) = strings
        c = self.context_prediction.in_ch
        return {"y_hat": rasterscan.raster_scan_decompress(
            y_strings, params, self._pieces(), (shape[0], shape[1], c))}

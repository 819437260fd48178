"""GMM conditional codec (port of
flashgmm_tpu/latent_codecs/gaussian_mixture_conditional.py:22-87): chunks
the entropy parameters into (scales, means, weights) thirds,
softmax-normalizes the K mixture weights, and gives the training forward's
y likelihoods through ``GaussianMixtureConditional``. The fast codecs code
``y`` from the same parameters.
"""

import torch
from torch import nn

from flashgmm_tpu_torch.entropy_models import GaussianMixtureConditional
from flashgmm_tpu_torch.ops import quantize_ste


class GaussianMixtureConditionalLatentCodec(nn.Module):
    """``quantizer``: "noise" (the likelihood of y with uniform noise when
    training, rounded when not) or "weighted_mean_ste" (y rounded around
    the mixture's weighted mean with a straight-through gradient, the means
    re-centred on it)."""

    def __init__(self, K: int = 4, entropy_parameters=None,
                 quantizer: str = "noise"):
        super().__init__()
        if quantizer not in ("noise", "weighted_mean_ste"):
            raise ValueError(f"unknown quantizer {quantizer!r}")
        self.K = int(K)
        self.quantizer = quantizer
        self.gaussian_mixture_conditional = GaussianMixtureConditional(K=self.K)
        self.entropy_parameters = entropy_parameters

    def _apply_ep(self, ctx_params):
        if self.entropy_parameters is None:
            return ctx_params
        return self.entropy_parameters(ctx_params)

    def _chunk(self, params):
        """(scales, means, weights) thirds of the channel-last parameters."""
        return torch.chunk(params, 3, dim=-1)

    def _reshape_gmm_weight(self, weight):
        """Softmax over the K mixture components (channel-last [.., K*M])."""
        b, h, w, km = weight.shape
        weight = weight.reshape(b, h, w, self.K, km // self.K)
        weight = torch.softmax(weight, dim=-2)
        return weight.reshape(b, h, w, km)

    def _weighted_mean_recenter(self, means_hat, weights):
        """(weighted mean over K [.., M], means re-centred on it [.., K*M])."""
        b, h, w, km = means_hat.shape
        shape = (b, h, w, self.K, km // self.K)
        means_e = means_hat.reshape(shape)
        weighted_sum = torch.sum(means_e * weights.reshape(shape), dim=-2)
        means_e = means_e - weighted_sum.unsqueeze(-2)
        return weighted_sum, means_e.reshape(b, h, w, km)

    def forward(self, y, ctx_params, training: bool = True, generator=None):
        """{"likelihoods": {"y"}, "y_hat"} of y [B, H, W, M] under the
        parameters the entropy network makes of ``ctx_params``."""
        scales_hat, means_hat, weights = self._chunk(self._apply_ep(ctx_params))
        weights = self._reshape_gmm_weight(weights)
        gmm = self.gaussian_mixture_conditional
        if self.quantizer == "weighted_mean_ste":
            weighted_sum, means_hat = self._weighted_mean_recenter(means_hat,
                                                                   weights)
            y = quantize_ste(y - weighted_sum) + weighted_sum
        y_hat, y_likelihoods = gmm(y, scales_hat, means_hat, weights,
                                   training=training, generator=generator)
        return {"likelihoods": {"y": y_likelihoods}, "y_hat": y_hat}

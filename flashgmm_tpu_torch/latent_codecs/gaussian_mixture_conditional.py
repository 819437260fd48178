"""GMM conditional codec (port of
flashgmm_tpu/latent_codecs/gaussian_mixture_conditional.py): chunks the
entropy parameters into (scales, means, weights) thirds, softmax-normalizes
the K mixture weights, gives the training forward's y likelihoods through
``GaussianMixtureConditional`` and codes y in the reference format
(``compress``/``decompress``, :84-116). The fast codecs code ``y`` from the
same parameters.

Every coding path takes its weights from ``gmm_softmax``
(``ans/gaussian_cdf.py``; a kernel on the card), whose fixed roundings give
the card's weights the CPU's bits, so a stream written on either decodes on
the other; the training forward keeps ``torch.softmax`` for its gradient.
"""

import torch

from flashgmm_tpu_torch.ans.gaussian_cdf import gmm_softmax
from flashgmm_tpu_torch.entropy_models import GaussianMixtureConditional
from flashgmm_tpu_torch.layers import run_canonical
from flashgmm_tpu_torch.ops import quantize_ste
from flashgmm_tpu_torch.registry import register_module

from .base import LatentCodec


@register_module("GaussianMixtureConditionalLatentCodec")
class GaussianMixtureConditionalLatentCodec(LatentCodec):
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
        """(scales, means, weights) thirds of the channel-last parameters."""
        return torch.chunk(params, 3, dim=-1)

    def _reshape_gmm_weight(self, weight, exact: bool = False):
        """Softmax over the K mixture components (channel-last [.., K*M]):
        ``torch.softmax`` (differentiable), or with ``exact`` the coding
        paths' ``gmm_softmax``, the same bits on the CPU and the card."""
        b, h, w, km = weight.shape
        weight = weight.reshape(b, h, w, self.K, km // self.K)
        weight = gmm_softmax(weight) if exact else torch.softmax(weight,
                                                                 dim=-2)
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

    def _coding_params(self, ctx_params):
        """(scales, means, weights) of a coding pass: the entropy network on
        the rows chain, the weights from ``gmm_softmax``."""
        scales, means, weights = self._chunk(self._apply_ep(ctx_params,
                                                            run_canonical))
        return scales, means, self._reshape_gmm_weight(weights, exact=True)

    def compress(self, y, ctx_params):
        """One image's y [1, H, W, M] -> {"strings": [(string, abs_max,
        zero_bitmap)], "shape": (H, W), "y_hat"}. With "weighted_mean_ste"
        the symbols are round(y - weighted mean) and y_hat is those
        integers, as in the JAX package (its decompress adds the weighted
        mean back)."""
        scales, means, weights = self._coding_params(ctx_params)
        gmm = self.gaussian_mixture_conditional
        if self.quantizer == "weighted_mean_ste":
            weighted_sum, means = self._weighted_mean_recenter(means, weights)
            y = quantize_ste(y - weighted_sum)
        y_strings, y_hat = gmm.compress(y, scales, means, weights)
        return {"strings": [y_strings], "shape": tuple(y.shape[1:3]),
                "y_hat": y_hat}

    def decompress(self, strings, shape, ctx_params):
        """{"y_hat" [1, H, W, M]} of the container ``strings`` =
        [(string, abs_max, zero_bitmap)]."""
        (y_strings,) = strings
        scales, means, weights = self._coding_params(ctx_params)
        gmm = self.gaussian_mixture_conditional
        weighted_sum = None
        if self.quantizer == "weighted_mean_ste":
            weighted_sum, means = self._weighted_mean_recenter(means, weights)
        y_hat = gmm.decompress(*y_strings, scales, means, weights)
        if weighted_sum is not None:
            y_hat = y_hat + weighted_sum
        if tuple(y_hat.shape[1:3]) != tuple(shape):
            raise ValueError(f"decoded {tuple(y_hat.shape[1:3])}, expected "
                             f"{tuple(shape)}")
        return {"y_hat": y_hat}

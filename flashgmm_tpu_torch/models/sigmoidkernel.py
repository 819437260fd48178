"""Sigmoid-kernel mixture CDF compressor (port of
flashgmm_tpu/models/sigmoidkernel.py; CompressAI's
models/sigmoidkernel.py:16-78): an experimental likelihood computed
directly from a mixture of sigmoid kernels, over the Cheng2020Attention
transforms. Its forward and likelihood only: the reference has no coding
path for it.
"""

import torch
import torch.nn.functional as F

from flashgmm_tpu_torch.entropy_models.entropy_models import uniform_noise
from flashgmm_tpu_torch.layers import Conv2d, LeakyReLU, Sequential
from flashgmm_tpu_torch.ops import lower_bound
from flashgmm_tpu_torch.registry import register_model

from .google import _generator
from .waseda import Cheng2020Attention


@register_model("sigmoid-cdf")
class SigmoidCDFCompressor(Cheng2020Attention):
    def __init__(self, N=192, K=4, *, seed: int = 0, device="cuda",
                 generator=None, **kwargs):
        g = _generator(seed, generator)
        super().__init__(N=N, device="cpu", generator=g, **kwargs)
        self.K = int(K)
        # the entropy parameters emit (a, b, w) triplets a mixture component
        self.entropy_parameters = Sequential(
            Conv2d(N * 12 // 3, N * 10 // 3, 1, generator=g), LeakyReLU(),
            Conv2d(N * 10 // 3, N * 8 // 3, 1, generator=g), LeakyReLU(),
            Conv2d(N * 8 // 3, 3 * self.K * N, 1, generator=g),
        )
        self.to(device)

    def _sigmoid_kernel_likelihood(self, y_hat, params):
        """P(y) = sum_k w_k [sigma(a_k (y + 0.5) + b_k) - sigma(a_k (y - 0.5)
        + b_k)], slopes a_k = softplus, weights w_k = softmax over k."""
        m = y_hat.shape[-1]
        p = params.reshape(tuple(params.shape[:-1]) + (3, self.K, m))
        a = F.softplus(p[..., 0, :, :])  # slopes > 0
        b = p[..., 1, :, :]
        w = torch.softmax(p[..., 2, :, :], dim=-2)
        v = y_hat.unsqueeze(-2)
        upper = torch.sigmoid(a * (v + 0.5) + b)
        lower = torch.sigmoid(a * (v - 0.5) + b)
        return lower_bound(torch.sum(w * (upper - lower), dim=-2), 1e-9)

    def forward(self, x, training: bool = True, generator=None):
        """The noise of z, then of y, from ``generator``."""
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        params = self.h_s(z_hat)
        if training:
            y_hat = y + uniform_noise(y.shape, generator, y)
        else:
            y_hat = torch.round(y)
        ctx_params = self.context_prediction(y_hat)
        gaussian_params = self.entropy_parameters(
            torch.cat([params, ctx_params], dim=-1))
        y_likelihoods = self._sigmoid_kernel_likelihood(y_hat,
                                                        gaussian_params)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def compress(self, x):
        raise NotImplementedError("sigmoid-cdf has a forward and likelihood "
                                  "only, as in the reference")

    def decompress(self, strings, shape, **kwargs):
        raise NotImplementedError("sigmoid-cdf has a forward and likelihood "
                                  "only, as in the reference")

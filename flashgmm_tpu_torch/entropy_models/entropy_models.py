"""Entropy models (port of flashgmm_tpu/entropy_models/entropy_models.py):
the ``EntropyModel`` base (quantization and the likelihood's lower bound),
the ``EntropyBottleneck`` (the factorized prior of the hyper branch: its
forward, aux loss and integer tables), and the forward of
``GaussianConditional`` and ``GaussianMixtureConditional`` (the y
likelihoods of the training forward). The scale tables and the
reference-format coders are later work (ROADMAP items 8 and 9).

The channel dimension is last (NHWC) at the boundary; internally the
EntropyBottleneck's per-channel monotone MLP runs on [C, f, N] tensors.
The likelihoods are plain differentiable float32 torch ops. ``update``
alone computes with XLA's CPU arithmetic written out in torch ops
(``xla_math``; the channel matmuls as XLA's FMA chain), so the integer CDF
tables equal the JAX package's bit for bit when both start from the same
quantiles, on the CPU and the card.

Noise quantization draws from an explicit ``torch.Generator`` (on the
tensor's device), never from torch's global generator.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flashgmm_tpu_torch.ans.pmf_to_cdf import pmf_to_quantized_cdf
from flashgmm_tpu_torch.ops import lower_bound

from . import xla_math


def _channel_matmul(m, v):
    """einsum('cij,cjn->cin') as XLA's CPU dot computes it: the products of
    j = 0, 1, ... accumulated in order, each through an FMA."""
    acc = m[:, :, 0:1] * v[:, 0:1, :]
    for j in range(1, m.shape[2]):
        acc = xla_math._fma(m[:, :, j:j + 1], v[:, j:j + 1, :].double(), acc)
    return acc


def _sigmoid_np(x):
    # clip: sigmoid saturates to 0/1 far before |x|=50; avoids exp overflow
    return 1.0 / (1.0 + np.exp(-np.clip(x, -50.0, 50.0)))


def uniform_noise(shape, generator, like):
    """U[-0.5, 0.5) noise of ``like``'s type and device from ``generator``."""
    if generator is None:
        raise ValueError("noise quantization needs a torch.Generator")
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device) - 0.5


class EntropyModel(nn.Module):
    """Base entropy model: quantization and the likelihood's lower bound
    (reference :93-155)."""

    def __init__(self, likelihood_bound: float = 1e-9,
                 entropy_coder_precision: int = 16):
        super().__init__()
        self.entropy_coder_precision = int(entropy_coder_precision)
        self.likelihood_bound = float(likelihood_bound)
        self.use_likelihood_bound = likelihood_bound > 0

    def _likelihood_lower_bound(self, likelihood):
        if self.use_likelihood_bound:
            return lower_bound(likelihood, self.likelihood_bound)
        return likelihood

    def quantize(self, inputs, mode: str, means=None, generator=None):
        """"noise": inputs + U[-0.5, 0.5) from ``generator``; "dequantize":
        round(inputs - means) + means; "symbols": round(inputs - means) as
        int32."""
        if mode not in ("noise", "dequantize", "symbols"):
            raise ValueError(f'Invalid quantization mode: "{mode}"')
        if mode == "noise":
            return inputs + uniform_noise(inputs.shape, generator, inputs)
        outputs = inputs if means is None else inputs - means
        outputs = torch.round(outputs)
        if mode == "dequantize":
            return outputs if means is None else outputs + means
        return outputs.to(torch.int32)

    @staticmethod
    def dequantize(inputs, means=None, dtype=torch.float32):
        if means is not None:
            return inputs.to(means.dtype) + means
        return inputs.to(dtype)


class EntropyBottleneck(EntropyModel):
    """Ballé factorized prior with per-channel quantized CDF tables."""

    def __init__(self, channels: int, *, tail_mass: float = 1e-9,
                 init_scale: float = 10, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 entropy_coder_precision: int = 16, generator=None):
        super().__init__(entropy_coder_precision=entropy_coder_precision)
        self.channels = int(channels)
        self.filters = tuple(int(f) for f in filters)
        self.init_scale = float(init_scale)
        self.tail_mass = float(tail_mass)

        filters_full = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1 / (len(self.filters) + 1))
        self._num_layers = len(self.filters) + 1
        for i in range(self._num_layers):
            init = float(np.log(np.expm1(1 / scale / filters_full[i + 1])))
            shape = (channels, filters_full[i + 1], filters_full[i])
            setattr(self, f"matrix{i}",
                    nn.Parameter(torch.full(shape, init)))
            bias = torch.rand((channels, filters_full[i + 1], 1),
                              generator=generator) - 0.5
            setattr(self, f"bias{i}", nn.Parameter(bias))
            if i < len(self.filters):
                setattr(self, f"factor{i}", nn.Parameter(
                    torch.zeros((channels, filters_full[i + 1], 1))))

        init_q = torch.tensor([-self.init_scale, 0.0, self.init_scale])
        self.quantiles = nn.Parameter(init_q.repeat(channels, 1, 1))
        target = float(np.log(2 / self.tail_mass - 1))
        self.register_buffer("target", torch.tensor([-target, 0.0, target]),
                             persistent=False)
        # filled by update()
        for name in ("_offset", "_quantized_cdf", "_cdf_length"):
            self.register_buffer(name, torch.zeros(0, dtype=torch.int32),
                                 persistent=False)

    @property
    def offset(self):
        return self._offset

    @property
    def quantized_cdf(self):
        return self._quantized_cdf

    @property
    def cdf_length(self):
        return self._cdf_length

    def _get_medians(self):
        return self.quantiles[:, :, 1:2]

    def _logits_cumulative(self, inputs, stop_gradient: bool = False):
        """Monotone MLP over [C, 1, N] -> [C, 1, N], float32 torch ops."""
        logits = inputs
        for i in range(self._num_layers):
            matrix = getattr(self, f"matrix{i}")
            bias = getattr(self, f"bias{i}")
            if stop_gradient:
                matrix, bias = matrix.detach(), bias.detach()
            logits = torch.einsum("cij,cjn->cin", F.softplus(matrix), logits)
            logits = logits + bias
            if i < len(self.filters):
                factor = getattr(self, f"factor{i}")
                if stop_gradient:
                    factor = factor.detach()
                logits = logits + torch.tanh(factor) * torch.tanh(logits)
        return logits

    def _likelihood(self, inputs, stop_gradient: bool = False):
        lower = self._logits_cumulative(inputs - 0.5, stop_gradient)
        upper = self._logits_cumulative(inputs + 0.5, stop_gradient)
        likelihood = torch.sigmoid(upper) - torch.sigmoid(lower)
        return likelihood, lower, upper

    def forward(self, x, training: bool = True, generator=None):
        """x [B, H, W, C] -> (x_hat, likelihoods), both [B, H, W, C]:
        uniform noise from ``generator`` when training, else rounded around
        the medians."""
        c = x.shape[-1]
        values = x.movedim(-1, 0).reshape(c, 1, -1)  # [C, 1, B*H*W]
        outputs = self.quantize(values, "noise" if training else "dequantize",
                                self._get_medians(), generator)
        likelihood, _, _ = self._likelihood(outputs)
        likelihood = self._likelihood_lower_bound(likelihood)
        shape = (c,) + tuple(x.shape[:-1])
        return (outputs.reshape(shape).movedim(0, -1),
                likelihood.reshape(shape).movedim(0, -1))

    def loss(self):
        """Aux loss driving the quantiles to the tail-mass targets (the
        MLP's parameters get no gradient from it)."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        return torch.abs(logits - self.target).sum()

    def _logits_cumulative_xla(self, inputs):
        """``_logits_cumulative`` as XLA's CPU computes it (``update``)."""
        logits = inputs
        for i in range(self._num_layers):
            matrix = getattr(self, f"matrix{i}")
            logits = _channel_matmul(xla_math.softplus(matrix), logits)
            logits = logits + getattr(self, f"bias{i}")
            if i < len(self.filters):
                factor = getattr(self, f"factor{i}")
                logits = logits + xla_math.tanh(factor) * xla_math.tanh(logits)
        return logits

    def _likelihood_xla(self, inputs):
        lower = self._logits_cumulative_xla(inputs - 0.5)
        upper = self._logits_cumulative_xla(inputs + 0.5)
        likelihood = xla_math.logistic(upper) - xla_math.logistic(lower)
        return likelihood, lower, upper

    @torch.no_grad()
    def _update_quantiles(self, search_radius=1e5, rtol=1e-4, atol=1e-3,
                          max_steps=200):
        """Vectorized bisection for the three target quantiles of every
        channel (the reference's ``_solve_quantiles``, :227)."""
        shape = (self.channels, 1, self.target.shape[-1])
        t = self.target[None, None, :].expand(shape)
        low = torch.full(shape, -search_radius, device=t.device)
        high = torch.full(shape, search_radius, device=t.device)
        low = torch.where(t <= self._logits_cumulative_xla(high), low, high)
        high = torch.where(self._logits_cumulative_xla(low) <= t, high, low)
        for _ in range(max_steps):
            if bool(torch.all(torch.abs(low - high)
                              <= atol + rtol * torch.abs(high))):
                break
            mid = (low + high) / 2
            f_mid = self._logits_cumulative_xla(mid)
            low, high = (torch.where(f_mid <= t, mid, low),
                         torch.where(f_mid >= t, mid, high))
        else:
            raise RuntimeError("EntropyBottleneck: quantile bisection did "
                               f"not converge in {max_steps} steps")
        self.quantiles.copy_((low + high) / 2)

    def _pmf_to_cdf(self, pmf, tail_mass, pmf_length, max_length):
        cdf = np.zeros((len(pmf_length), max_length + 2), dtype=np.int32)
        for i, p in enumerate(pmf):
            prob = np.concatenate([p[: pmf_length[i]], tail_mass[i]])
            _cdf = pmf_to_quantized_cdf(prob, self.entropy_coder_precision)
            cdf[i, : _cdf.shape[0]] = _cdf
        return cdf

    @torch.no_grad()
    def update(self, force: bool = False,
               update_quantiles: bool = False) -> bool:
        """Build the quantized CDF tables (reference :378)."""
        if self._offset.numel() > 0 and not force:
            return False
        if update_quantiles:
            self._update_quantiles()

        quantiles = self.quantiles.detach().cpu().numpy()
        medians = quantiles[:, 0, 1]
        minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int32),
                         0, None)
        maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int32),
                         0, None)
        pmf_start = medians - minima
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())

        samples = np.arange(max_length, dtype=np.float32)
        # float64 here (float32 - int32 promotes), rounded to float32 on the
        # way to the device as in the reference
        samples = samples[None, :] + pmf_start[:, None, None]  # [C, 1, L]
        pmf, lower, upper = self._likelihood_xla(torch.from_numpy(
            samples.astype(np.float32)).to(self.quantiles.device))
        pmf = pmf.cpu().numpy()[:, 0, :]
        lower = lower.cpu().numpy()
        upper = upper.cpu().numpy()
        tail_mass = _sigmoid_np(lower[:, 0, :1]) + _sigmoid_np(-upper[:, 0, -1:])

        quantized_cdf = self._pmf_to_cdf(pmf, tail_mass, pmf_length, max_length)
        dev = self.quantiles.device
        self._quantized_cdf = torch.from_numpy(quantized_cdf).to(dev)
        self._offset = torch.from_numpy(-minima.astype(np.int32)).to(dev)
        self._cdf_length = torch.from_numpy(
            (pmf_length + 2).astype(np.int32)).to(dev)
        return True


class GaussianConditional(EntropyModel):
    """Scale (+ mean) Gaussian conditional, forward part (reference
    :438-540; its scale table and coders wait for ROADMAP items 8 and 9)."""

    def __init__(self, scale_bound: float = 0.11, tail_mass: float = 1e-9,
                 **kwargs):
        super().__init__(**kwargs)
        if scale_bound <= 0:
            raise ValueError("Invalid parameters")
        self.scale_bound = float(scale_bound)
        self.tail_mass = float(tail_mass)

    def lower_bound_scale(self, scales):
        return lower_bound(scales, self.scale_bound)

    @staticmethod
    def _standardized_cumulative(inputs):
        # 0.5 * erfc(-x / sqrt(2)): erfc keeps its precision in the tails
        return 0.5 * torch.erfc(-(2 ** -0.5) * inputs)

    def _likelihood(self, inputs, scales, means=None):
        values = inputs - means if means is not None else inputs
        scales = self.lower_bound_scale(scales)
        values = torch.abs(values)
        upper = self._standardized_cumulative((0.5 - values) / scales)
        lower = self._standardized_cumulative((-0.5 - values) / scales)
        return upper - lower

    def forward(self, inputs, scales, means=None, training: bool = True,
                generator=None):
        outputs = self.quantize(inputs, "noise" if training else "dequantize",
                                means, generator)
        likelihood = self._likelihood(outputs, scales, means)
        return outputs, self._likelihood_lower_bound(likelihood)


class GaussianMixtureConditional(GaussianConditional):
    """K-component Gaussian mixture conditional, the FlashGMM entropy
    model: its training likelihood, vectorised over K (reference
    :603-640). The codecs code y with the GMM rows instead
    (``ans/gaussian_cdf.py``, the rANS kernels)."""

    def __init__(self, K: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.K = int(K)

    def _likelihood(self, inputs, scales, means, weights):
        """inputs [..., M]; scales, means, weights [..., K*M], channel-last
        with component k at channels k*M .. (k+1)*M - 1."""
        m = inputs.shape[-1]
        shape = tuple(scales.shape[:-1]) + (self.K, m)
        scales = self.lower_bound_scale(scales.reshape(shape))
        values = torch.abs(inputs.unsqueeze(-2) - means.reshape(shape))
        upper = self._standardized_cumulative((0.5 - values) / scales)
        lower = self._standardized_cumulative((-0.5 - values) / scales)
        return torch.sum(weights.reshape(shape) * (upper - lower), dim=-2)

    def forward(self, inputs, scales, means, weights, training: bool = True,
                generator=None):
        outputs = self.quantize(inputs, "noise" if training else "dequantize",
                                None, generator)
        likelihood = self._likelihood(outputs, scales, means, weights)
        return outputs, self._likelihood_lower_bound(likelihood)

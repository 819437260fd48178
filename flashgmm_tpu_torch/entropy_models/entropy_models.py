"""EntropyBottleneck: the factorized prior of the hyper branch (port of
flashgmm_tpu/entropy_models/entropy_models.py:256-470, forward math and
``update`` only; training and the reference-format coders are later work).

The channel dimension is last (NHWC) at the boundary; internally the
per-channel monotone MLP runs on [C, f, N] tensors. Its float math is XLA's
CPU arithmetic written out in torch ops (``xla_math``; the channel matmuls
as XLA's FMA chain), so the integer CDF tables equal the JAX package's bit
for bit when both start from the same quantiles, on the CPU and the card.
"""

from typing import Tuple

import numpy as np
import torch
from torch import nn

from flashgmm_tpu_torch.ans.pmf_to_cdf import pmf_to_quantized_cdf

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


class EntropyBottleneck(nn.Module):
    """Ballé factorized prior with per-channel quantized CDF tables."""

    def __init__(self, channels: int, *, tail_mass: float = 1e-9,
                 init_scale: float = 10, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 entropy_coder_precision: int = 16, generator=None):
        super().__init__()
        self.channels = int(channels)
        self.filters = tuple(int(f) for f in filters)
        self.init_scale = float(init_scale)
        self.tail_mass = float(tail_mass)
        self.entropy_coder_precision = int(entropy_coder_precision)

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

    def _logits_cumulative(self, inputs):
        """Monotone MLP over [C, 1, N] -> [C, 1, N]."""
        logits = inputs
        for i in range(self._num_layers):
            matrix = getattr(self, f"matrix{i}")
            logits = _channel_matmul(xla_math.softplus(matrix), logits)
            logits = logits + getattr(self, f"bias{i}")
            if i < len(self.filters):
                factor = getattr(self, f"factor{i}")
                logits = logits + xla_math.tanh(factor) * xla_math.tanh(logits)
        return logits

    def _likelihood(self, inputs):
        lower = self._logits_cumulative(inputs - 0.5)
        upper = self._logits_cumulative(inputs + 0.5)
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
        low = torch.where(t <= self._logits_cumulative(high), low, high)
        high = torch.where(self._logits_cumulative(low) <= t, high, low)
        for _ in range(max_steps):
            if bool(torch.all(torch.abs(low - high)
                              <= atol + rtol * torch.abs(high))):
                break
            mid = (low + high) / 2
            f_mid = self._logits_cumulative(mid)
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
        pmf, lower, upper = self._likelihood(torch.from_numpy(
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

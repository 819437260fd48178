"""Variable-bitrate entropy models (port of
flashgmm_tpu/entropy_models/entropy_models_vbr.py; CompressAI's
entropy_models/entropy_models_vbr.py:51-648).

A quantization step ``qs`` joins quantize, dequantize and the tables, so
one model serves several rates (Kamisli et al., DCC 2024).

``EntropyBottleneckVbr.update_variable`` builds the tables of a step the
way the JAX package does: its sample points in float64 where numpy
promotes them (``minima * qs`` is int32 times a Python float), rounded to
float32 on their way to the density MLP, which runs with XLA's CPU
arithmetic (``_logits_cumulative_xla``), and the PMF's sigmoids in numpy.
Given the same quantiles and the same float32 ``qs`` the tables equal the
JAX package's, on the CPU and on the card.

A division by ``qs`` divides by a tensor on the operand's device: PyTorch's
CUDA division by a Python number multiplies by its reciprocal, which may
round otherwise than the JAX package's float32 division.
"""

import numpy as np
import torch

from . import entropy_models as _em
from .entropy_models import (EntropyBottleneck, EntropyModel,
                             GaussianConditional, _sigmoid_np)


def _over(x, qs):
    """x / qs in float32, a true division on x's device."""
    if not isinstance(qs, torch.Tensor):
        qs = torch.tensor(float(qs), dtype=x.dtype, device=x.device)
    return x / qs


class _VariableStep:
    """quantize_variable / dequantize_variable, shared by both VBR models
    (reference :19-44, :132-160)."""

    def quantize_variable(self, inputs, mode: str, means=None, qs=None,
                          generator=None):
        """``qs`` None: ``quantize``. "noise": inputs + U[-0.5, 0.5) * qs;
        "dequantize": round((inputs - means) / qs) * qs + means; "symbols":
        round((inputs - means) / qs) as int32."""
        if qs is None:
            return self.quantize(inputs, mode, means, generator)
        if mode == "noise":
            return inputs + _em.uniform_noise(inputs.shape, generator,
                                              inputs) * qs
        outputs = inputs if means is None else inputs - means
        if mode == "dequantize":
            outputs = torch.round(_over(outputs, qs)) * qs
            return outputs if means is None else outputs + means
        if mode != "symbols":
            raise ValueError(f'Invalid quantization mode: "{mode}"')
        return torch.round(_over(outputs, qs)).to(torch.int32)

    def dequantize_variable(self, inputs, means=None, qs=None):
        if qs is None:
            return self.dequantize(inputs, means)
        outputs = inputs.to(torch.float32) * qs
        return outputs if means is None else outputs + means


class EntropyBottleneckVbr(_VariableStep, EntropyBottleneck):
    """EntropyBottleneck with a variable quantization step."""

    def quantize_variable(self, inputs, mode: str, means=None, qs=None,
                          generator=None):
        """Also "ste": the "dequantize" value with an identity gradient."""
        if qs is None or mode != "ste":
            return super().quantize_variable(inputs, mode, means, qs,
                                             generator)
        outputs = inputs if means is None else inputs - means
        rounded = torch.round(_over(outputs, qs)) * qs
        return outputs + (rounded - outputs).detach() \
            + (means if means is not None else 0.0)

    def _likelihood_variable(self, values, qs):
        half = qs / 2.0
        lower = self._logits_cumulative(values - half)
        upper = self._logits_cumulative(values + half)
        return torch.sigmoid(upper) - torch.sigmoid(lower)

    def forward(self, x, training: bool = True, generator=None, qs=None,
                ste: bool = False):
        """``qs`` None: the EntropyBottleneck's forward. Else x [B, H, W, C]
        quantized at step ``qs`` around the medians ("ste" if ``ste``,
        noise from ``generator`` when training, else rounded) and its
        likelihoods over bins of width ``qs``."""
        if qs is None:
            return super().forward(x, training=training, generator=generator)
        c = x.shape[-1]
        values = x.movedim(-1, 0).reshape(c, 1, -1)
        mode = "ste" if ste else ("noise" if training else "dequantize")
        outputs = self.quantize_variable(values, mode, self._get_medians(),
                                         qs=qs,
                                         generator=_em.noise_along(generator,
                                                                   -1))
        likelihood = self._likelihood_lower_bound(
            self._likelihood_variable(outputs, qs))
        shape = (c,) + tuple(x.shape[:-1])
        return (outputs.reshape(shape).movedim(0, -1),
                likelihood.reshape(shape).movedim(0, -1))

    @torch.no_grad()
    def update_variable(self, force: bool = False, qs=1.0) -> bool:
        """The tables of step ``qs`` (a float32 value: a Python float or a
        one-element tensor; reference :70-95)."""
        if self._offset.numel() > 0 and not force:
            return False
        qs = float(np.asarray(qs.detach().cpu() if isinstance(qs, torch.Tensor)
                              else qs).reshape(()))

        quantiles = self.quantiles.detach().cpu().numpy()
        medians = quantiles[:, 0, 1]
        minima = np.clip(np.ceil((medians - quantiles[:, 0, 0]) / qs)
                         .astype(np.int32), 0, None)
        maxima = np.clip(np.ceil((quantiles[:, 0, 2] - medians) / qs)
                         .astype(np.int32), 0, None)

        # float64: int32 * float promotes; rounded to float32 below, where
        # the reference's jnp.asarray rounds them
        pmf_start = medians - minima * qs
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())

        samples = np.arange(max_length, dtype=np.float32) * qs
        samples = samples[None, :] + pmf_start[:, None, None]

        half = qs / 2.0
        dev = self.quantiles.device
        lower, upper = (self._logits_cumulative_xla(torch.from_numpy(
            (samples + d).astype(np.float32)).to(dev)).cpu().numpy()
            for d in (-half, half))
        pmf = (_sigmoid_np(upper) - _sigmoid_np(lower))[:, 0, :]
        tail_mass = _sigmoid_np(lower[:, 0, :1]) + _sigmoid_np(-upper[:, 0, -1:])

        quantized_cdf = self._pmf_to_cdf(pmf, tail_mass, pmf_length, max_length)
        self._quantized_cdf = torch.from_numpy(quantized_cdf).to(dev)
        self._offset = torch.from_numpy(-minima.astype(np.int32)).to(dev)
        self._cdf_length = torch.from_numpy(
            (pmf_length + 2).astype(np.int32)).to(dev)
        return True

    def compress(self, x, qs=None):
        """``qs`` None: the EntropyBottleneck's. Else the symbols
        round((z - medians) / qs), in float32 on z's device, under each
        channel's table of ``update_variable(qs=qs)``."""
        if qs is None:
            return super().compress(x)
        shape = tuple(x.shape)
        symbols = self.quantize_variable(x, "symbols", self._medians(shape),
                                         qs=qs)
        return EntropyModel.compress(self, symbols.to(torch.float32),
                                     self._build_indexes(shape, x.device))

    def decompress(self, strings, size, qs=None):
        """``qs`` None: the EntropyBottleneck's. Else symbols * qs +
        medians, [len(strings), *size, C] on the quantiles' device."""
        if qs is None:
            return super().decompress(strings, size)
        shape = (len(strings), *size, self._quantized_cdf.shape[0])
        values = EntropyModel.decompress(
            self, strings, self._build_indexes(shape, self.quantiles.device))
        return self.dequantize_variable(values, self._medians(shape), qs)


class GaussianConditionalVbr(_VariableStep, GaussianConditional):
    """GaussianConditional with a quantization step (reference :127-160).
    The VBR models scale their inputs and scales by the gain instead; the
    JAX package's tests use this class."""

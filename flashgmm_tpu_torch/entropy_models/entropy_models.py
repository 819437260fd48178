"""Entropy models (port of flashgmm_tpu/entropy_models/entropy_models.py):
the ``EntropyModel`` base (quantization, the likelihood's lower bound and
the table path of the reference format), the ``EntropyBottleneck`` (the
factorized prior of the hyper branch: its forward, aux loss, integer tables
and coding), ``GaussianConditional`` (its forward, its scale table and
table-path coding, and the single-Gaussian search coding of mbt2018-mean's
``coder="search"``) and ``GaussianMixtureConditional`` (its forward, and
the reference format's GMM coding).

Reference-format coding runs the host coder ``csrc/rans.cpp`` (the port's
build, ``ans/cext.py``) over numpy buffers, with the JAX package's
container, symbol order (NCHW flatten on the table path; ``(b, c, h, w)``
over the nonzero channels on the GMM path), environment switches and
refusals. After ``flashgmm_tpu_torch.set_entropy_coder("rangecoder")`` (or
with ``entropy_coder="rangecoder"``) the table path and the rows path run
the numpy range coder instead (``ans/range_coder.py``). The GMM path has two modes: device rows (the default), each
symbol's uint16 boundary row computed on the tensors' device with XLA's CPU
roundings (``ans/gaussian_cdf.py::gmm_boundary_rows``; on the card its
kernel) and the serial chain on the host; and host math
(``FLASHGMM_HOST_MATH=1``), the host evaluating the reference's float32
CDFs, whose streams are byte-identical to the original C++ coder's.
``APPROX_MODE`` picks the CDF approximation and ``USE_SIMD`` the
reference's host-math variant, as in the JAX package.

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

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flashgmm_tpu_torch.ans import RansDecoder, RansEncoder, cext
# the module, not its names: gaussian_cdf imports this package's xla_math
from flashgmm_tpu_torch.ans import gaussian_cdf
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


def _nchw_flatten(x: np.ndarray) -> np.ndarray:
    """[B, H, W, C] -> [B, C*H*W] in NCHW element order (the reference's
    symbol order)."""
    return np.transpose(x, (0, 3, 1, 2)).reshape(x.shape[0], -1)


def _nchw_unflatten(x: np.ndarray, shape_bhwc) -> np.ndarray:
    b, h, w, c = shape_bhwc
    return np.transpose(x.reshape(b, c, h, w), (0, 2, 3, 1))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class _EntropyCoder(RansEncoder, RansDecoder):
    """The coding backend (reference :48-82): "rans", the host rANS coder
    (``ans/cext.py``), or "rangecoder", the numpy range coder
    (``ans/range_coder.py``), which codes the table path and the rows path;
    host-math GMM calls stay on the host rANS coder, as in the JAX package.
    ``method=None`` takes the registry's choice
    (``flashgmm_tpu_torch.set_entropy_coder``)."""

    def __init__(self, method: str = None):
        if method is None:
            import flashgmm_tpu_torch

            method = flashgmm_tpu_torch.get_entropy_coder()
        if method == "rangecoder":
            from flashgmm_tpu_torch.ans import range_coder

            self._table = range_coder
        elif method == "rans":
            self._table = None
        else:
            raise ValueError(f'Unknown entropy coder "{method}"')
        self.name = method

    def encode_with_indexes(self, *args):
        if self._table is not None:
            return self._table.encode_with_indexes(*args)
        return super().encode_with_indexes(*args)

    def decode_with_indexes(self, *args):
        if self._table is not None:
            return self._table.decode_with_indexes(*args)
        return super().decode_with_indexes(*args)

    def encode_rows(self, values, rows, lo):
        """Search-path coding over per-symbol boundary rows (GSM/GMM)."""
        if self._table is not None:
            return self._table.encode_rows(values, rows, lo)
        return super().encode_rows(values, rows, lo)

    def decode_rows(self, encoded, rows, lo):
        if self._table is not None:
            return self._table.decode_rows(encoded, rows, lo)
        return super().decode_rows(encoded, rows, lo)


def _sigmoid_np(x):
    # clip: sigmoid saturates to 0/1 far before |x|=50; avoids exp overflow
    return 1.0 / (1.0 + np.exp(-np.clip(x, -50.0, 50.0)))


class RankNoise:
    """The training noise of one rank's rows of a global batch split evenly
    over ``world`` ranks in rank order, accepted wherever a generator is:
    every draw is of the global shape (the local one with its batch axis
    ``axis`` times ``world``) from ``generator``, seeded alike on every
    rank, and keeps this rank's slice of that axis. So each rank's noise is
    its rows of the noise one process draws on the whole batch, and every
    rank's generator advances as that process's does (JAX draws from one
    key over the global array). The EntropyBottleneck draws over
    [C, 1, B*H*W], whose batch axis is the last."""

    def __init__(self, generator, rank: int, world: int, axis: int = 0):
        self.generator = generator
        self.rank, self.world, self.axis = int(rank), int(world), int(axis)

    def along(self, axis: int):
        """The same noise source with the batch on ``axis``."""
        return RankNoise(self.generator, self.rank, self.world, axis)

    def global_shape(self, shape):
        shape = list(shape)
        shape[self.axis] *= self.world
        return tuple(shape)

    def rows(self, noise):
        """This rank's slice of a draw of ``global_shape``."""
        n = noise.shape[self.axis] // self.world
        return noise.narrow(self.axis, self.rank * n, n)


def noise_along(generator, axis: int):
    """``generator`` for a draw whose batch axis is ``axis``."""
    return generator.along(axis) if isinstance(generator, RankNoise) \
        else generator


def uniform_noise(shape, generator, like):
    """U[-0.5, 0.5) noise of ``like``'s type and device from ``generator``
    (a ``torch.Generator`` or a :class:`RankNoise`)."""
    if generator is None:
        raise ValueError("noise quantization needs a torch.Generator")
    if isinstance(generator, RankNoise):
        return generator.rows(uniform_noise(generator.global_shape(shape),
                                            generator.generator, like))
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device) - 0.5


class EntropyModel(nn.Module):
    """Base entropy model: quantization, the likelihood's lower bound and
    table-based coding (reference :93-224)."""

    def __init__(self, likelihood_bound: float = 1e-9,
                 entropy_coder: str = None,
                 entropy_coder_precision: int = 16):
        super().__init__()
        self.entropy_coder = _EntropyCoder(entropy_coder)
        self.entropy_coder_precision = int(entropy_coder_precision)
        self.likelihood_bound = float(likelihood_bound)
        self.use_likelihood_bound = likelihood_bound > 0
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

    def _pmf_to_cdf(self, pmf, tail_mass, pmf_length, max_length):
        """Quantize each row's PMF and tail mass to an integer CDF."""
        cdf = np.zeros((len(pmf_length), max_length + 2), dtype=np.int32)
        for i, p in enumerate(pmf):
            prob = np.concatenate([p[: pmf_length[i]], tail_mass[i]])
            _cdf = pmf_to_quantized_cdf(prob, self.entropy_coder_precision)
            cdf[i, : _cdf.shape[0]] = _cdf
        return cdf

    def _check_tables(self):
        if self._quantized_cdf.numel() == 0:
            raise ValueError("Uninitialized CDFs. Run update() first")
        if self._quantized_cdf.dim() != 2:
            raise ValueError(
                f"Invalid CDF size {tuple(self._quantized_cdf.shape)}")
        if self._offset.numel() == 0 or self._cdf_length.numel() == 0:
            raise ValueError("Uninitialized offsets. Run update() first")

    def _tables(self):
        return (_host(self._quantized_cdf).astype(np.int32),
                _host(self._cdf_length).astype(np.int32).ravel(),
                _host(self._offset).astype(np.int32).ravel())

    def compress(self, inputs, indexes, means=None):
        """[B, H, W, C] inputs -> one byte string an image: the symbols
        round(inputs - means), quantized on the inputs' device, coded on the
        host under the CDF rows ``indexes`` names, in NCHW order."""
        symbols = self.quantize(inputs, "symbols", means)
        if inputs.dim() < 2:
            raise ValueError("Invalid `inputs` size; expected >= 2 dims.")
        if tuple(inputs.shape) != tuple(indexes.shape):
            raise ValueError("`inputs` and `indexes` should have the same size.")
        self._check_tables()

        symbols_np = _nchw_flatten(_host(symbols))
        indexes_np = _nchw_flatten(_host(indexes).astype(np.int32))
        tables = self._tables()
        return [self.entropy_coder.encode_with_indexes(
            symbols_np[i], indexes_np[i], *tables)
            for i in range(symbols_np.shape[0])]

    def decompress(self, strings, indexes, dtype=torch.float32, means=None):
        """Byte strings -> [B, H, W, C] values under the CDF rows
        ``indexes`` names, dequantized around ``means``, on the device of
        ``means`` (else of ``indexes``)."""
        if not isinstance(strings, (tuple, list)):
            raise ValueError("Invalid `strings` parameter type.")
        if len(strings) != indexes.shape[0]:
            raise ValueError("Invalid strings or indexes parameters")
        if indexes.dim() < 2:
            raise ValueError("Invalid `indexes` size; expected >= 2 dims.")
        self._check_tables()

        indexes_host = _host(indexes).astype(np.int32)
        indexes_np = _nchw_flatten(indexes_host)
        tables = self._tables()
        outputs = np.empty_like(indexes_np, dtype=np.int32)
        for i, s in enumerate(strings):
            outputs[i] = self.entropy_coder.decode_with_indexes(
                s, indexes_np[i], *tables)
        outputs = _nchw_unflatten(outputs, indexes_host.shape)
        device = (means if means is not None else indexes).device
        return self.dequantize(torch.from_numpy(np.ascontiguousarray(outputs))
                               .to(device), means, dtype)


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
                                self._get_medians(),
                                noise_along(generator, -1))
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

    @staticmethod
    def _build_indexes(shape_bhwc, device):
        b, h, w, c = shape_bhwc
        return torch.arange(c, dtype=torch.int32, device=device).expand(
            b, h, w, c)

    def _medians(self, shape_bhwc):
        return self._get_medians().detach()[:, 0, 0].expand(shape_bhwc)

    def compress(self, x):
        """z [B, H, W, C] -> one byte string an image, round(z - medians)
        (on z's device) under each channel's table (reference :411-424)."""
        indexes = self._build_indexes(tuple(x.shape), x.device)
        return super().compress(x, indexes, self._medians(tuple(x.shape)))

    def decompress(self, strings, size):
        """Byte strings -> z_hat [len(strings), *size, C]; size = (H, W)."""
        shape = (len(strings), *size, self._quantized_cdf.shape[0])
        indexes = self._build_indexes(shape, self.quantiles.device)
        return super().decompress(strings, indexes, torch.float32,
                                  self._medians(shape))


class GaussianConditional(EntropyModel):
    """Scale (+ mean) Gaussian conditional (reference :438-555): its forward,
    and table-path coding over a scale table, each symbol coded under the
    table entry of its scale (``build_indexes``). ``update`` computes the
    tables with XLA's CPU float32 erfc and ndtri (``xla_math``), so they
    equal the JAX package's integer tables."""

    def __init__(self, scale_table=None, scale_bound: float = 0.11,
                 tail_mass: float = 1e-9, **kwargs):
        super().__init__(**kwargs)
        if not isinstance(scale_table, (type(None), list, tuple)):
            raise ValueError(
                f'Invalid type for scale_table "{type(scale_table)}"')
        if isinstance(scale_table, (list, tuple)) and len(scale_table) < 1:
            raise ValueError(f'Invalid scale_table length "{len(scale_table)}"')
        if scale_table and (scale_table != sorted(scale_table)
                            or any(s <= 0 for s in scale_table)):
            raise ValueError(f'Invalid scale_table "({scale_table})"')
        self.tail_mass = float(tail_mass)
        if scale_bound is None and scale_table:
            scale_bound = float(scale_table[0])
        if scale_bound <= 0:
            raise ValueError("Invalid parameters")
        self.scale_bound = float(scale_bound)
        self.register_buffer("scale_table", torch.tensor(
            [float(v) for v in (scale_table or ())], dtype=torch.float32),
            persistent=False)

    def lower_bound_scale(self, scales):
        return lower_bound(scales, self.scale_bound)

    @staticmethod
    def _standardized_cumulative(inputs):
        # 0.5 * erfc(-x / sqrt(2)): erfc keeps its precision in the tails
        return 0.5 * torch.erfc(-(2 ** -0.5) * inputs)

    @staticmethod
    def _standardized_cumulative_xla(inputs):
        """``_standardized_cumulative`` as the JAX package computes it on the
        CPU, op by op: the multiply, XLA's erfc, the multiply."""
        return 0.5 * xla_math.erfc(-(2 ** -0.5) * inputs)

    @staticmethod
    def _standardized_quantile(quantile):
        return float(xla_math.ndtri(torch.tensor(quantile,
                                                 dtype=torch.float32)))

    def update_scale_table(self, scale_table, force: bool = False) -> bool:
        if self._offset.numel() > 0 and not force:
            return False
        self.scale_table = torch.tensor([float(v) for v in scale_table],
                                        dtype=torch.float32,
                                        device=self.scale_table.device)
        self.update()
        return True

    @torch.no_grad()
    def update(self):
        """The integer CDF tables of the scale table (reference :493-521)."""
        multiplier = -self._standardized_quantile(self.tail_mass / 2)
        scale_table = _host(self.scale_table).astype(np.float32)
        pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())

        samples = np.abs(np.arange(max_length, dtype=np.int32)
                         - pmf_center[:, None]).astype(np.float32)
        samples_scale = scale_table[:, None].astype(np.float32)
        upper = self._standardized_cumulative_xla(
            torch.from_numpy((0.5 - samples) / samples_scale)).numpy()
        lower = self._standardized_cumulative_xla(
            torch.from_numpy((-0.5 - samples) / samples_scale)).numpy()
        pmf = upper - lower
        tail_mass = 2 * lower[:, :1]

        quantized_cdf = self._pmf_to_cdf(pmf, tail_mass, pmf_length, max_length)
        dev = self.scale_table.device
        self._quantized_cdf = torch.from_numpy(quantized_cdf).to(dev)
        self._offset = torch.from_numpy(-pmf_center.astype(np.int32)).to(dev)
        self._cdf_length = torch.from_numpy(
            (pmf_length + 2).astype(np.int32)).to(dev)

    def build_indexes(self, scales):
        """Each scale's table index: the last entry, less one for every
        table entry below the last that the (lower-bounded) scale does not
        exceed (reference :531-538)."""
        scales = self.lower_bound_scale(scales)
        table = self.scale_table.to(scales.device)
        below = (scales[..., None] <= table[:-1]).sum(dim=-1)
        return (len(table) - 1 - below).to(torch.int32)

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

    # -- table-free search coding (reference :544-601) -------------------------
    # the single-Gaussian rows on the scales' device, the serial chain on
    # the host; the bins' bucket is part of the format (lo = -max_bs)

    _BINS_BUCKET = 8

    def _max_bs(self, abs_max: int) -> int:
        return -(-int(abs_max) // self._BINS_BUCKET) * self._BINS_BUCKET

    @staticmethod
    def _gaussian_rows(scales_flat, max_bs: int) -> np.ndarray:
        """uint16 rows [n, 2*max_bs + 2] on the host of one image's float32
        [n] scales, computed on their device (the kernel on the card)."""
        return gaussian_cdf.gaussian_boundary_rows(
            scales_flat.contiguous(), -max_bs, 2 * max_bs + 1,
            gaussian_cdf.get_approx_mode()).cpu().numpy()

    def _scales_nchw(self, scales):
        """Lower-bounded scales [B, H, W, C] -> float32 [B, C*H*W] in NCHW
        order, on their device."""
        s = self.lower_bound_scale(scales).float()
        return s.permute(0, 3, 1, 2).reshape(s.shape[0], -1)

    def compress_search(self, inputs, scales, means=None):
        """Table-free encode of [B, H, W, C] inputs: the symbols
        round(inputs - means) in NCHW order under each scale's Gaussian rows
        -> (one string an image, abs_max)."""
        symbols_np = _nchw_flatten(_host(self.quantize(inputs, "symbols",
                                                       means)))
        abs_max = max(int(np.abs(symbols_np).max()), 1) + 1
        max_bs = self._max_bs(abs_max)
        flat = self._scales_nchw(scales)
        strings = [self.entropy_coder.encode_rows(
            symbols_np[i], self._gaussian_rows(flat[i], max_bs), -max_bs)
            for i in range(symbols_np.shape[0])]
        return strings, abs_max

    def decompress_search(self, strings, scales, abs_max: int, means=None):
        """Strings of :meth:`compress_search` -> [B, H, W, C] values
        dequantized around ``means``, on the scales' device."""
        b, h, w, c = scales.shape
        max_bs = self._max_bs(abs_max)
        flat = self._scales_nchw(scales)
        outputs = np.empty((b, c * h * w), dtype=np.int32)
        for i, s in enumerate(strings):
            outputs[i] = self.entropy_coder.decode_rows(
                s, self._gaussian_rows(flat[i], max_bs), -max_bs)
        outputs = _nchw_unflatten(outputs, (b, h, w, c))
        return self.dequantize(torch.from_numpy(np.ascontiguousarray(outputs))
                               .to(scales.device), means)


class GaussianMixtureConditional(GaussianConditional):
    """K-component Gaussian mixture conditional, the FlashGMM entropy
    model: its training likelihood, vectorised over K (reference
    :603-640), and the reference format's table-free coding of one image
    (:642-777): device rows or host math (see the module's docstring). The
    fast codecs code y with the GMM rows of the interleaved format instead
    (``ans/gaussian_cdf.py``, the rANS kernels)."""

    # the JAX package pads N and the bins to buckets to bound its
    # recompilation; the bins' bucket is part of the format (lo = -max_bs)
    _N_BUCKET = 4096
    _BINS_BUCKET = 8

    def __init__(self, K: int = 3, scale_table=None, **kwargs):
        super().__init__(scale_table, **kwargs)
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

    # -- reference-format coding ---------------------------------------------

    def _reshape_entropy_parameters(self, scales, means, weights, nonzero):
        """[B, H, W, K*M] parameters -> float32 [num_symbols, K] on their
        device, in the reference's (b, c, h, w) symbol order over the
        channels ``nonzero`` (reference :810-828); scales clamped to
        [0.11, 256]."""
        idx = torch.as_tensor(nonzero, dtype=torch.long, device=scales.device)

        def prep(p):
            b, h, w, km = p.shape
            p = p.permute(0, 3, 1, 2).reshape(b, self.K, km // self.K, h * w)
            p = p[:, :, idx].permute(1, 0, 2, 3).reshape(self.K, -1)
            return p.t().float().contiguous()  # [N, K]

        return (torch.clamp(prep(scales), 0.11, 256.0), prep(means),
                prep(weights))

    def _boundary_rows(self, scales, means, weights, max_bs: int):
        """uint16 rows [N, 2*max_bs + 2] on the host, computed on the
        parameters' device (the kernel on the card), N padded to the JAX
        package's bucket."""
        n = scales.shape[0]
        n_pad = -(-max(n, 1) // self._N_BUCKET) * self._N_BUCKET

        def pad(p, fill):
            return torch.cat([p, p.new_full((n_pad - n, self.K), fill)])

        rows = gaussian_cdf.gmm_boundary_rows(
            pad(scales, 1.0), pad(means, 0.0), pad(weights, 1.0 / self.K),
            -max_bs, 2 * max_bs + 1, gaussian_cdf.get_approx_mode())
        return rows[:n].cpu().numpy()

    def _round_max_bs(self, abs_max: int) -> int:
        max_bs = abs_max + 1
        return -(-max_bs // self._BINS_BUCKET) * self._BINS_BUCKET

    @staticmethod
    def _host_math() -> bool:
        """FLASHGMM_HOST_MATH=1: the host evaluates the reference's exact
        float32 CDFs (streams byte-identical to the original C++ coder's)."""
        return os.environ.get("FLASHGMM_HOST_MATH") == "1"

    def compress(self, y, scales, means, weights):
        """One image's y [1, H, W, M] under [1, H, W, K*M] parameters ->
        ((string, abs_max, zero_bitmap int32 [M]), y_hat = round(y) on y's
        device) (reference :833-870)."""
        if y.shape[0] != 1:
            # the reference container is one image a call: its zero_bitmap
            # is squeezed to [C] and nonzero() indices are channel ids
            raise ValueError(
                "reference-format GMM compress codes ONE image per call "
                f"(got batch={y.shape[0]}); loop over the batch, or use "
                "runtime.FastCheckerboardGmmCodec for batched coding")
        y_host = _host(y)
        abs_max = max(abs(int(y_host.max())), abs(int(y_host.min()))) + 1
        abs_max = max(abs_max, 1)

        y_quantized = np.round(y_host)
        zero_bitmap = (np.abs(y_quantized).sum(axis=(0, 1, 2)) != 0).astype(
            np.int32)
        nonzero = np.nonzero(zero_bitmap)[0]
        symbols = np.transpose(y_quantized, (0, 3, 1, 2))[:, nonzero].reshape(
            -1).astype(np.int32)
        params = self._reshape_entropy_parameters(scales, means, weights,
                                                  nonzero)
        max_bs = self._round_max_bs(abs_max)
        if self._host_math():
            rv = cext.encode_gmm_host(symbols, *(p.cpu().numpy()
                                                 for p in params),
                                      gaussian_cdf.get_approx_mode())
        else:
            rows = self._boundary_rows(*params, max_bs)
            rv = self.entropy_coder.encode_rows(symbols, rows, -max_bs)
        y_hat = torch.from_numpy(y_quantized.astype(np.float32)).to(y.device)
        return (rv, abs_max, torch.from_numpy(zero_bitmap)), y_hat

    def decompress(self, strings, abs_max, zero_bitmap, scales, means,
                   weights):
        """A string of :meth:`compress` -> y_hat [1, H, W, M] on the
        parameters' device (reference :872-910)."""
        if scales.shape[0] != 1:
            raise ValueError(
                "reference-format GMM decompress codes ONE image per call "
                f"(got batch={scales.shape[0]}); see compress()")
        zero_bitmap = _host(zero_bitmap)
        nonzero = np.nonzero(zero_bitmap)[0]
        b, h, w, _ = scales.shape
        params = self._reshape_entropy_parameters(scales, means, weights,
                                                  nonzero)
        max_bs = self._round_max_bs(int(abs_max))
        if self._host_math():
            symbols = cext.decode_gmm_host(
                strings, *(_host(p) for p in params), max_bs,
                gaussian_cdf.get_approx_mode())
        else:
            rows = self._boundary_rows(*params, max_bs)
            symbols = self.entropy_coder.decode_rows(strings, rows, -max_bs)
        symbols = symbols.reshape(b, len(nonzero), h, w)
        y_hat = np.zeros((b, zero_bitmap.shape[0], h, w), np.float32)
        y_hat[:, nonzero] = symbols.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(y_hat, (0, 2, 3, 1)))).to(scales.device)

"""Variable-bitrate models (port of flashgmm_tpu/models/vbr.py; CompressAI's
models/vbr.py:25-982).

One model covers the 8-lambda quality sweep through learned per-level gains
(``Gain``: inverse quantization steps) and a quantization-offset MLP
(``QuantABCD``; Kamisli, Racape and Choi, DCC 2024). ``stage=1`` runs the
base (fixed-rate) model; ``stage=2`` the VBR path at gain level ``s``, or
at the continuous scale ``inputscale`` when it is non-zero.

Reference-format coding (``update(scale=...)`` first, for the variable-step
bottleneck) keeps the JAX package's arithmetic where the bytes depend on
it:
- the z step ``qs`` (``vr_entbttlnck=True``) is computed on the host
  (:meth:`ScaleHyperpriorVbr._zqstep`) as XLA's CPU code computes the
  reference's small eager MLP: each linear layer's products accumulated in
  order through FMAs, its bias added apart, then XLA's softplus; ``update``,
  ``compress`` and ``decompress`` get the same float on the card and on
  the CPU;
- y is coded as ``gc.compress(y * scale, indexes, means * scale)``, h_s
  runs on the rows chain (``layers.run_canonical``) in both directions and
  g_a, h_a and g_s as transforms (``layers.run_transform``);
- mbt2018-vbr's context shift ``ctx_scl`` (``scale_to_context`` of 1/s)
  and its quantization offsets run in numpy on the host inside the raster
  scan (``runtime/rasterscan.py``), with float32 ``[in, out]`` weights, so
  its encoder and decoder reconstruct the same y_hat on any device.
The two hyperprior models' offsets run on the tensors' device after
decoding, as in the reference.

``compress`` returns ``y_hat`` beside the reference's keys, and
``decompress_y`` gives the decoder's y_hat alone. ``Gain`` is a parameter
that gets no gradient (the gain is detached wherever it is read).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flashgmm_tpu_torch.entropy_models import EntropyBottleneckVbr, xla_math
from flashgmm_tpu_torch.layers import (linear, pinned_library_settings,
                                       run_canonical, run_transform)
from flashgmm_tpu_torch.ops import lower_bound, quantize_ste
from flashgmm_tpu_torch.registry import register_model
from flashgmm_tpu_torch.runtime import rasterscan
from flashgmm_tpu_torch.runtime.rasterscan import to_host

from .base import get_scale_table
from .google import (JointAutoregressiveHierarchicalPriors,
                     MeanScaleHyperprior, ScaleHyperprior, _decoded,
                     _generator)

VBR_LMBDAS = [0.0018, 0.0035, 0.0067, 0.0130, 0.025, 0.0483, 0.0932, 0.18]
VBR_GAINS = [0.10000, 0.13944, 0.19293, 0.26874, 0.37268, 0.51801, 0.71957, 1.0]


class _MLP(nn.Module):
    """Linear layers with a ReLU between each two, optionally a softplus
    after the last."""

    def __init__(self, dims, final_softplus: bool = False, *, generator=None):
        super().__init__()
        self.linears = nn.ModuleList(
            [linear(i, o, generator) for i, o in zip(dims[:-1], dims[1:])])
        self.final_softplus = final_softplus

    def forward(self, x):
        n = len(self.linears)
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < n - 1:
                x = torch.relu(x)
        return F.softplus(x) if self.final_softplus else x


def _host_linears(mlp):
    """[(weight [in, out], bias)] of an _MLP's layers as C-contiguous
    float32 numpy arrays (the JAX package's kernel layout)."""
    return [(np.ascontiguousarray(to_host(lin.weight).T), to_host(lin.bias))
            for lin in mlp.linears]


def _xla_linear(v, w, b):
    """v [in] @ w [in, out] + b, float32, as XLA's CPU code computes an
    eager nnx.Linear of one row: the products of k = 0, 1, ... accumulated
    in order, each after the first through an FMA, then the bias added in
    its own rounding."""
    acc = torch.from_numpy(w[0]) * v[0]
    for k in range(1, w.shape[0]):
        acc = xla_math._fma(torch.from_numpy(w[k]), float(v[k]), acc)
    return acc + torch.from_numpy(b)


@register_model("bmshj2018-hyperprior-vbr")
class ScaleHyperpriorVbr(ScaleHyperprior):
    """The scale hyperprior with VBR gains (CompressAI models/vbr.py:25+);
    ``vr_entbttlnck=True`` codes z with the variable-step
    ``EntropyBottleneckVbr`` at the step ``gayn2zqstep`` makes of the
    gain."""

    _base = ScaleHyperprior

    def __init__(self, N, M, vr_entbttlnck: bool = False, *, seed: int = 0,
                 device="cuda", generator=None, **kwargs):
        g = _generator(seed, generator)
        self._base.__init__(self, N, M, device="cpu", generator=g, **kwargs)
        self._init_vbr(N, g, vr_entbttlnck)
        self.to(device)

    def _init_vbr(self, N, g, vr_entbttlnck):
        self.lmbda = list(VBR_LMBDAS)
        self.levels = len(self.lmbda)
        self.Gain = nn.Parameter(torch.tensor(VBR_GAINS, dtype=torch.float32))
        # the quantization offset from (stdev, gain)
        self.QuantABCD = _MLP([2, 12, 12, 1], generator=g)
        self.no_quantoffset = False
        self.vr_entbttlnck = bool(vr_entbttlnck)
        if self.vr_entbttlnck:
            self.entropy_bottleneck = EntropyBottleneckVbr(N, generator=g)
            self.gayn2zqstep = _MLP([1, 10, 10, 1], final_softplus=True,
                                    generator=g)

    # -- the gain and what it sets -----------------------------------------

    def _get_scale(self, s: int = 1, inputscale=0):
        """|Gain[s]| (s clamped to the levels), detached, or ``inputscale``
        as float32 when it is non-zero: a 0-d tensor on the model's
        device."""
        s = min(max(int(s), 0), self.levels - 1)
        if inputscale:
            return torch.tensor(float(inputscale), dtype=torch.float32,
                                device=self.Gain.device)
        return torch.abs(self.Gain[s]).detach()

    def _zqstep_t(self, scale):
        """The training forward's z step: gayn2zqstep(1 / scale), at least
        0.5, differentiable in the MLP's parameters."""
        return lower_bound(self.gayn2zqstep(
            torch.reshape(1.0 / scale, (1, 1)))[0, 0], 0.5)

    @torch.no_grad()
    def _zqstep(self, scale) -> float:
        """The coding z step as a Python float (a float32 value), on the
        host: the reference's float32 1 / scale through gayn2zqstep with
        XLA's CPU arithmetic (:func:`_xla_linear`, ``xla_math.softplus``),
        then at least 0.5."""
        v = torch.from_numpy(np.float32(1.0)
                             / np.asarray([float(scale)], np.float32))
        layers = _host_linears(self.gayn2zqstep)
        for i, (w, b) in enumerate(layers):
            v = _xla_linear(v, w, b)
            if i < len(layers) - 1:
                v = torch.clamp_min(v, 0.0)
        return max(float(xla_math.softplus(v)[0]), 0.5)

    def _z_qs(self, scale):
        return self._zqstep(scale) if self.vr_entbttlnck else None

    def _quant_offsets(self, q_abs, q_stdev, scale):
        """-QuantABCD(stdev, gain); zero where the value quantized to 0."""
        inp = torch.stack([q_stdev, scale.expand(q_stdev.shape)], dim=-1)
        q_off = -self.QuantABCD(inp)[..., 0]
        return torch.where(q_abs < 1e-4, torch.zeros_like(q_off), q_off)

    def _offset_y_hat(self, y_zm_sc, scales_hat, scale, rescale):
        """The training forward's y_hat (less the means) of the gain-scaled
        y - means: sign * (round(|.|) + offset) / gain, the rounding with a
        straight-through gradient."""
        signs = torch.sign(y_zm_sc).detach()
        q_abs = quantize_ste(torch.abs(y_zm_sc))
        q_stdev = self.gaussian_conditional.lower_bound_scale(
            scales_hat * scale)
        return signs * (q_abs + self._quant_offsets(q_abs, q_stdev, scale)) \
            * rescale

    def _coded_offsets(self) -> bool:
        return not self.no_quantoffset

    def _reconstruct(self, q_val, scales_hat, scale):
        """The coding y_hat (less the means) of the symbols ``q_val``
        (float32): sign * (|q| + offset) / gain, the offsets under the
        pinned library settings, as ``decompress`` computes it."""
        rescale = 1.0 / scale
        if not self._coded_offsets():
            return q_val * rescale
        q_abs = torch.abs(q_val)
        q_stdev = self.gaussian_conditional.lower_bound_scale(
            scales_hat * scale)
        with pinned_library_settings():
            q_offsets = self._quant_offsets(q_abs, q_stdev, scale)
        return torch.sign(q_val) * (q_abs + q_offsets) * rescale

    # -- the training forward ----------------------------------------------

    def _z_forward(self, z, scale, training, generator):
        """(z_hat, z likelihoods): the variable-step bottleneck at the z
        step, else z rounded around the medians with a straight-through
        gradient."""
        eb = self.entropy_bottleneck
        if self.vr_entbttlnck:
            return eb(z, training=training, generator=generator,
                      qs=self._zqstep_t(scale))
        _, z_likelihoods = eb(z, training=training, generator=generator)
        z_offset = eb._get_medians()[:, 0, 0]
        return quantize_ste(z - z_offset) + z_offset, z_likelihoods

    def forward(self, x, training: bool = True, generator=None,
                stage: int = 2, s: int = 1, inputscale=0):
        """{"x_hat" (not clamped), "likelihoods": {"y", "z"}}; the noise of
        z, then of y, from ``generator``."""
        if stage == 1:
            return self._base.forward(self, x, training=training,
                                      generator=generator)
        scale = self._get_scale(s, inputscale)
        rescale = 1.0 / scale
        y = self.g_a(x)
        z = self.h_a(torch.abs(y))
        z_hat, z_likelihoods = self._z_forward(z, scale, training, generator)
        scales_hat = self.h_s(z_hat)
        if self.no_quantoffset:
            y_hat = quantize_ste(y * scale) * rescale
        else:
            y_hat = self._offset_y_hat(y * scale, scales_hat, scale, rescale)
        _, y_likelihoods = self.gaussian_conditional(
            y * scale, scales_hat * scale, training=training,
            generator=generator)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    # -- reference-format coding -------------------------------------------

    @torch.no_grad()
    def update(self, scale_table=None, force: bool = False,
               scale=None) -> bool:
        """The GaussianConditional's tables over ``scale_table`` (default
        ``get_scale_table()``), and the bottleneck's: at the z step of
        ``scale`` with the variable-step bottleneck, else its own."""
        if scale_table is None:
            scale_table = get_scale_table()
        updated = self.gaussian_conditional.update_scale_table(scale_table,
                                                               force=force)
        eb = self.entropy_bottleneck
        if isinstance(eb, EntropyBottleneckVbr) and scale is not None:
            updated |= eb.update_variable(force=force,
                                          qs=self._zqstep(scale))
        else:
            updated |= eb.update(force=force)
        return updated

    def _vbr_side_params(self, z_strings, shape, qs):
        """``_side_params`` at the z step ``qs`` (None: the unit step)."""
        if qs is None:
            return self._side_params(z_strings, shape)
        z_hat = self.entropy_bottleneck.decompress(z_strings, tuple(shape),
                                                   qs=qs)
        return run_canonical(self.h_s, z_hat)

    def _vbr_compress_z(self, x, scale):
        """``_compress_z`` at the z step of ``scale``."""
        qs = self._z_qs(scale)
        if qs is None:
            return self._compress_z(x)
        y = run_transform(self.g_a, x)
        z = run_transform(self.h_a, self._hyper_input(y))
        shape = tuple(z.shape[1:3])
        z_strings = self.entropy_bottleneck.compress(z, qs=qs)
        return y, z_strings, shape, self._vbr_side_params(z_strings, shape, qs)

    def _split(self, params):
        """(scales, means) of h_s's output; no means here."""
        return params, None

    @torch.inference_mode()
    def compress(self, x, stage: int = 2, s: int = 1, inputscale=0):
        """{"strings": [y strings, z strings], "shape", "s", "y_hat"} of x
        [1, H, W, 3] at gain level ``s`` (or ``inputscale``)."""
        if stage == 1:
            return self._base.compress(self, x)
        scale = self._get_scale(s, inputscale)
        y, z_strings, shape, params = self._vbr_compress_z(x, scale)
        scales_hat, means_hat = self._split(params)
        gc = self.gaussian_conditional
        means_sc = None if means_hat is None else means_hat * scale
        indexes = gc.build_indexes(scales_hat * scale)
        y_strings = gc.compress(y * scale, indexes, means_sc)
        q_val = gc.quantize(y * scale, "symbols", means_sc).to(torch.float32)
        y_hat = self._reconstruct(q_val, scales_hat, scale)
        if means_hat is not None:
            y_hat = y_hat + means_hat
        return {"strings": [y_strings, z_strings], "shape": shape, "s": s,
                "y_hat": y_hat}

    @torch.inference_mode()
    def decompress_y(self, strings, shape, stage: int = 2, s: int = 1,
                     inputscale=0):
        """The y_hat that compress's ``strings`` and ``shape`` decode to."""
        if stage == 1:
            return self._base.decompress_y(self, strings, shape)
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("expected [y strings, z strings]")
        scale = self._get_scale(s, inputscale)
        params = self._vbr_side_params(strings[1], shape, self._z_qs(scale))
        scales_hat, means_hat = self._split(params)
        gc = self.gaussian_conditional
        q_val = gc.decompress(strings[0], gc.build_indexes(scales_hat * scale))
        y_hat = self._reconstruct(q_val, scales_hat, scale)
        return y_hat if means_hat is None else y_hat + means_hat

    @torch.inference_mode()
    def decompress(self, strings, shape, stage: int = 2, s: int = 1,
                   inputscale=0):
        """{"x_hat" [1, H, W, 3] clamped to [0, 1]}."""
        return _decoded(self.g_s, self.decompress_y(strings, shape, stage, s,
                                                    inputscale))


@register_model("mbt2018-mean-vbr")
class MeanScaleHyperpriorVbr(ScaleHyperpriorVbr, MeanScaleHyperprior):
    """The mean-scale hyperprior with VBR gains (CompressAI models/vbr.py:
    306+): the means are taken out before the gain scaling."""

    _base = MeanScaleHyperprior

    def forward(self, x, training: bool = True, generator=None,
                stage: int = 2, s: int = 1, inputscale=0):
        if stage == 1:
            return self._base.forward(self, x, training=training,
                                      generator=generator)
        scale = self._get_scale(s, inputscale)
        rescale = 1.0 / scale
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, z_likelihoods = self._z_forward(z, scale, training, generator)
        scales_hat, means_hat = torch.chunk(self.h_s(z_hat), 2, dim=-1)
        y_hat = self._offset_y_hat((y - means_hat) * scale, scales_hat, scale,
                                   rescale) + means_hat
        _, y_likelihoods = self.gaussian_conditional(
            y * scale, scales_hat * scale, means_hat * scale,
            training=training, generator=generator)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def _split(self, params):
        return torch.chunk(params, 2, dim=-1)

    def _coded_offsets(self) -> bool:
        return True  # the reference's mean-scale decoder always adds them


@register_model("mbt2018-vbr")
class JointAutoregressiveHierarchicalPriorsVbr(
        ScaleHyperpriorVbr, JointAutoregressiveHierarchicalPriors):
    """mbt2018 with VBR gains (CompressAI models/vbr.py:507-982): the
    spatial context is also conditioned on the gain (``scale_to_context``
    of 1/s), and the symbols are coded in the gain-scaled domain with
    quantization offsets. The stage-2 training forward takes the reference
    port's dense one-pass approximation of the recursive pass; compress and
    decompress run the gain-scaled raster scan on the host."""

    _base = JointAutoregressiveHierarchicalPriors

    def __init__(self, N=192, M=192, *, seed: int = 0, device="cuda",
                 generator=None, **kwargs):
        g = _generator(seed, generator)
        self._base.__init__(self, N, M, device="cpu", generator=g)
        self._init_vbr(N, g, False)
        self.scl2ctx = True
        self.scale_to_context = linear(1, 2 * M, g)
        self.to(device)

    def forward(self, x, training: bool = True, generator=None,
                stage: int = 2, s: int = 1, inputscale=0):
        if stage == 1:
            return self._base.forward(self, x, training=training,
                                      generator=generator)
        scale = self._get_scale(s, inputscale)
        rescale = 1.0 / scale
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, z_likelihoods = self._z_forward(z, scale, training, generator)
        params = self.h_s(z_hat)
        # the dense approximation: the context of the gain-quantized y
        ctx = self.context_prediction(quantize_ste(y * scale) * rescale)
        if self.scl2ctx:
            ctx = ctx + self.scale_to_context(
                torch.reshape(1.0 / scale, (1, 1))).reshape(1, 1, 1, -1)
        scales_hat, means_hat = torch.chunk(
            self.entropy_parameters(torch.cat([params, ctx], dim=-1)), 2,
            dim=-1)
        y_hat = self._offset_y_hat((y - means_hat) * scale, scales_hat, scale,
                                   rescale) + means_hat
        _, y_likelihoods = self.gaussian_conditional(
            y * scale, scales_hat * scale, means_hat * scale,
            training=training, generator=generator)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    @torch.no_grad()
    def _ctx_scl(self, s: float) -> np.ndarray:
        """scale_to_context([[1 / s]]) on the host: 1 / s in float64
        rounded to float32 (the reference's jnp.asarray), the one product,
        then the bias in its own rounding."""
        v = np.float32(1.0 / s)
        w = to_host(self.scale_to_context.weight)[:, 0]  # [2M]
        return v * w + to_host(self.scale_to_context.bias)

    def _vbr_host_args(self, scale) -> dict:
        """The raster scan's ``vbr`` dict at ``scale`` (a float32 value):
        Python-float scale and rescale, the context shift and the offsets'
        numpy function over float32 [in, out] weights, computed once on
        the host for both directions."""
        s = float(scale)
        mlp_layers = _host_linears(self.QuantABCD)

        def offset_fn(q_stdev, s_):
            v = np.stack([q_stdev, np.full_like(q_stdev, s_)], axis=-1)
            for i, (w, b) in enumerate(mlp_layers):
                v = v @ w + b
                if i < len(mlp_layers) - 1:
                    v = np.maximum(v, 0)
            return -v[..., 0]

        return {"scale": s,
                "rescale": 1.0 / s,
                "ctx_scl": self._ctx_scl(s) if self.scl2ctx else 0.0,
                "offset_fn": None if self.no_quantoffset else offset_fn,
                "scale_bound": self.gaussian_conditional.scale_bound}

    @torch.inference_mode()
    def compress(self, x, stage: int = 2, s: int = 1, inputscale=0):
        """{"strings": [[y string an image], z strings], "shape", "s",
        "y_hat"}."""
        if stage == 1:
            return self._base.compress(self, x)
        scale = self._get_scale(s, inputscale)
        vbr = self._vbr_host_args(scale)
        y, z_strings, shape, params = self._compress_z(x)
        y_strings, y_hat = rasterscan.raster_scan_compress(
            y, params, self._host_ar_pieces(), vbr)
        return {"strings": [y_strings, z_strings], "shape": shape, "s": s,
                "y_hat": y_hat}

    @torch.inference_mode()
    def decompress_y(self, strings, shape, stage: int = 2, s: int = 1,
                     inputscale=0):
        if stage == 1:
            return self._base.decompress_y(self, strings, shape)
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("expected [y strings, z strings]")
        scale = self._get_scale(s, inputscale)
        params = self._side_params(strings[1], shape)
        return rasterscan.raster_scan_decompress(
            strings[0], params, self._host_ar_pieces(),
            (shape[0] * 4, shape[1] * 4, self.M), self._vbr_host_args(scale))

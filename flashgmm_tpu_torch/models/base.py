"""Model base classes (port of flashgmm_tpu/models/base.py): ``update``
(the EntropyBottlenecks' tables and the Gaussian conditionals' scale
tables), the aux loss, the g_a -> latent codec -> g_s forward, and the
reference format's ``compress``/``decompress`` of one image."""

import math

import torch
from torch import nn

from flashgmm_tpu_torch.entropy_models import (EntropyBottleneck,
                                               GaussianConditional)
from flashgmm_tpu_torch.entropy_models import xla_math
from flashgmm_tpu_torch.layers import run_transform

SCALES_MIN = 0.11
SCALES_MAX = 256
SCALES_LEVELS = 64


def get_scale_table(min=SCALES_MIN, max=SCALES_MAX, levels=SCALES_LEVELS):
    """``levels`` log-spaced scales from ``min`` to ``max`` (reference
    :21-27), the JAX package's float32 values: its linspace as XLA's CPU
    code computes it (the divide by ``levels - 1`` a multiply by its float32
    reciprocal c, ``start * (1 - i*c) + i * (stop*c)`` with the second
    product fused into an FMA, the end point exact), then XLA's exp."""
    start = torch.tensor(math.log(min), dtype=torch.float32)
    stop = torch.tensor(math.log(max), dtype=torch.float32)
    div = levels - 1
    c = torch.tensor(1.0 / div, dtype=torch.float32)
    i = torch.arange(div, dtype=torch.float32)
    out = xla_math._fma(i, (stop * c).double(), start * (1.0 - i * c))
    return [float(s) for s in xla_math.exp(torch.cat([out, stop[None]]))]


class CompressionModel(nn.Module):
    """Base class for models containing entropy-coded bottlenecks."""

    def update(self, scale_table=None, force: bool = False,
               update_quantiles: bool = False) -> bool:
        """Build the entropy models' integer tables after training: each
        EntropyBottleneck's, and each GaussianConditional's over
        ``scale_table`` (default :func:`get_scale_table`) (reference
        :43-53)."""
        if scale_table is None:
            scale_table = get_scale_table()
        updated = False
        for module in self.modules():
            if isinstance(module, EntropyBottleneck):
                updated |= module.update(force=force,
                                         update_quantiles=update_quantiles)
            elif isinstance(module, GaussianConditional):
                updated |= module.update_scale_table(scale_table, force=force)
        return updated

    def aux_loss(self):
        """Sum of the EntropyBottlenecks' quantile losses."""
        losses = [m.loss() for m in self.modules()
                  if isinstance(m, EntropyBottleneck)]
        return sum(losses) if losses else torch.zeros(())


class SimpleVAECompressionModel(CompressionModel):
    """x -> g_a -> latent codec -> g_s -> x_hat."""

    def forward(self, x, training: bool = True, generator=None):
        """The training forward. x: images [B, H, W, 3] (NHWC, as the
        port's codecs take them), float in [0, 1]. ``training``: uniform
        noise from ``generator`` (a ``torch.Generator`` on x's device) in
        place of rounding. Returns {"x_hat" [B, H, W, 3] (not clamped),
        "likelihoods": {"y", "z"}}, each likelihood of its latent's shape.
        Every conv runs ``F.conv2d`` in float32, differentiable."""
        y = self.g_a(x)
        y_out = self.latent_codec(y, training=training, generator=generator)
        x_hat = self.g_s(y_out["y_hat"])
        return {"x_hat": x_hat, "likelihoods": y_out["likelihoods"]}

    @torch.inference_mode()
    def compress(self, x):
        """The reference format (run ``update()`` first): x [1, H, W, 3] ->
        {"strings", "shape", "y_hat"}. g_a and h_a run in float32 at
        canonical strides under pinned library settings; every conv that
        makes an entropy parameter runs on the rows chain, so
        ``decompress`` recomputes the encoder's parameters bit for bit, on
        the card or on the CPU."""
        return self.latent_codec.compress(run_transform(self.g_a, x))

    @torch.inference_mode()
    def decompress(self, strings, shape):
        """{"x_hat" [1, H, W, 3] clamped to [0, 1]} of compress's
        ``strings`` and ``shape``."""
        y_out = self.latent_codec.decompress(strings, shape)
        return {"x_hat": torch.clamp(run_transform(self.g_s, y_out["y_hat"]),
                                     0.0, 1.0)}

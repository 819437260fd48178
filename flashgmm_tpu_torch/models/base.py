"""Model base classes (port of flashgmm_tpu/models/base.py:37-70):
``update``, the aux loss and the g_a -> latent codec -> g_s forward."""

import torch
from torch import nn

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck


class CompressionModel(nn.Module):
    """Base class for models containing entropy-coded bottlenecks."""

    def update(self, force: bool = False,
               update_quantiles: bool = False) -> bool:
        """Build the EntropyBottleneck CDF tables after training (the
        Gaussian scale tables of the reference-format coder are not part of
        the port yet)."""
        updated = False
        for module in self.modules():
            if isinstance(module, EntropyBottleneck):
                updated |= module.update(force=force,
                                         update_quantiles=update_quantiles)
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

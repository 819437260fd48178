"""Model base class (port of flashgmm_tpu/models/base.py: ``update``)."""

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

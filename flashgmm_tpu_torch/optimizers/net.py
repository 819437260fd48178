"""One "net" optimizer over every parameter, with no aux split (port of
flashgmm_tpu/optimizers/net.py; CompressAI's compressai/optimizers/net.py):
for models without EntropyBottleneck quantiles, or with the aux loss folded
into the main one."""

from flashgmm_tpu_torch.registry import register_optimizer

from .net_aux import make_adam


@register_optimizer("net_optimizer")
def net_optimizer(model, conf: dict):
    """{"net": Adam over all parameters} from ``{"net": {"type": "Adam",
    "lr": ...}}``."""
    return {"net": make_adam(model.parameters(), conf["net"])}

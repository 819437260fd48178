"""The net/aux parameter split (port of flashgmm_tpu/optimizers/net_aux.py;
CompressAI's compressai/optimizers/net_aux.py:39-80).

The "net" optimizer trains every parameter except the EntropyBottlenecks'
``quantiles``; the "aux" optimizer trains the quantiles alone, whose loss
(``model.aux_loss()``) does not depend on the data. Both are
``torch.optim.Adam`` at optax's defaults (b1 0.9, b2 0.999, eps 1e-8, no
weight decay), which are torch's.
"""

import torch


def _is_quantiles(name: str) -> bool:
    return "quantiles" in name.split(".")


def net_aux_partition(model):
    """({name: parameter} of "net", {name: parameter} of "aux"), in
    ``model.named_parameters()`` order: "aux" holds every parameter with a
    path component ``quantiles``, "net" every other."""
    net, aux = {}, {}
    for name, p in model.named_parameters():
        (aux if _is_quantiles(name) else net)[name] = p
    return net, aux


def make_adam(params, opt_conf: dict, **group):
    """``torch.optim.Adam`` over ``params`` from ``{"type": "Adam", "lr":
    ...}``; ``group`` adds keys to the one parameter group."""
    if opt_conf.get("type", "Adam") != "Adam":
        raise ValueError(f"Unsupported optimizer {opt_conf['type']}")
    return torch.optim.Adam([{"params": list(params), **group}],
                            lr=opt_conf.get("lr", 1e-4))


def net_aux_optimizer(model, conf: dict):
    """{"net": Adam, "aux": Adam} from

        {"net": {"type": "Adam", "lr": 1e-4}, "aux": {"type": "Adam", "lr": 1e-3}}
    """
    net, aux = net_aux_partition(model)
    return {"net": make_adam(net.values(), conf["net"]),
            "aux": make_adam(aux.values(), conf["aux"])}

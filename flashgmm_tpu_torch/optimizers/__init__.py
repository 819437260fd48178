from .net import net_optimizer
from .net_aux import net_aux_optimizer, net_aux_partition

__all__ = ["net_aux_optimizer", "net_aux_partition", "net_optimizer"]

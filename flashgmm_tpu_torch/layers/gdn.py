"""Generalized Divisive Normalization for NHWC tensors (port of
flashgmm_tpu/layers/gdn.py).

``gamma`` is stored as an ``[out, in]`` matrix in reparametrized space, as in
the reference, so the JAX package's parameters load unchanged. The channel
mix ``x^2 @ gamma^T`` accumulates in float32 whatever the input type.
"""

import torch
import torch.nn.functional as F
from torch import nn

from flashgmm_tpu_torch.ops.parametrizers import NonNegativeParametrizer


class GDN(nn.Module):
    r"""y[i] = x[i] / sqrt(beta[i] + sum_j gamma[j,i] * x[j]^2)
    (``inverse=True``: times the square root)."""

    def __init__(self, in_channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse = bool(inverse)
        self.beta_reparam = NonNegativeParametrizer(minimum=float(beta_min))
        self.gamma_reparam = NonNegativeParametrizer()
        beta = torch.ones(in_channels)
        self.beta = nn.Parameter(self.beta_reparam.init(beta))
        gamma = gamma_init * torch.eye(in_channels)
        self.gamma = nn.Parameter(self.gamma_reparam.init(gamma))

    def forward(self, x):
        beta = self.beta_reparam(self.beta)
        gamma = self.gamma_reparam(self.gamma)
        norm = F.linear((x * x).float(), gamma.float()) + beta.float()
        norm = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
        return x * norm.to(x.dtype)

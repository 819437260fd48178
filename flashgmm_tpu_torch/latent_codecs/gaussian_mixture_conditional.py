"""GMM conditional codec container (port of
flashgmm_tpu/latent_codecs/gaussian_mixture_conditional.py:22-56): chunks
the entropy parameters into (scales, means, weights) thirds and
softmax-normalizes the K mixture weights. The training likelihood is later
work; the fast codec codes ``y`` from these parameters.
"""

import torch
from torch import nn


class GaussianMixtureConditionalLatentCodec(nn.Module):
    def __init__(self, K: int = 4):
        super().__init__()
        self.K = int(K)

    def _chunk(self, params):
        """(scales, means, weights) thirds of the channel-last parameters."""
        return torch.chunk(params, 3, dim=-1)

    def _reshape_gmm_weight(self, weight):
        """Softmax over the K mixture components (channel-last [.., K*M])."""
        b, h, w, km = weight.shape
        weight = weight.reshape(b, h, w, self.K, km // self.K)
        weight = torch.softmax(weight, dim=-2)
        return weight.reshape(b, h, w, km)

"""PointNet point-cloud compression (port of flashgmm_tpu/models/
pointcloud/sfu_pointnet.py; CompressAI's models/pointcloud/sfu.py
"sfu-pcc-rec-pointnet"): a shared per-point MLP and a global max-pool make
one latent vector a cloud, an EntropyBottleneck codes it, an MLP decoder
emits N x 3 points. Trained with the chamfer RD loss
(``losses.ChamferPccRateDistortionLoss``).

Built on the CPU from a ``torch.Generator`` (``generator``, else one
seeded with ``seed``), then moved to ``device``. ``compress`` and
``decompress`` run under the pinned library settings (no TF32).
"""

import torch

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.layers import pinned_library_settings
from flashgmm_tpu_torch.layers.pointcloud import PointNetSetMLP, SharedMLP
from flashgmm_tpu_torch.registry import register_model

from ..base import CompressionModel


def _generator(seed, generator):
    return generator if generator is not None \
        else torch.Generator().manual_seed(int(seed))


class _PointNetFamily(CompressionModel):
    """The forward and the coding of the models with one latent vector a
    cloud: ``_encode_latent(points)`` -> [B, C], ``_decode(y_hat, B)`` ->
    [B, N, 3]. The EntropyBottleneck sees the latent as [B, 1, 1, C]."""

    def forward(self, points, training: bool = True, generator=None):
        """points [B, N, 3] in [0, 1] -> {"x_hat", "likelihoods": {"y"}}
        (uniform noise from ``generator`` when ``training``)."""
        y = self._encode_latent(points)
        y_hat, y_likelihoods = self.entropy_bottleneck(
            y[:, None, None, :], training=training, generator=generator)
        return {"x_hat": self._decode(y_hat[:, 0, 0, :], y.shape[0]),
                "likelihoods": {"y": y_likelihoods}}

    @torch.inference_mode()
    def compress(self, points):
        """{"strings": [one string a cloud], "shape": (1, 1)} (run
        ``update()`` first)."""
        with pinned_library_settings():
            y = self._encode_latent(points)
            strings = self.entropy_bottleneck.compress(y[:, None, None, :])
        return {"strings": [strings], "shape": (1, 1)}

    @torch.inference_mode()
    def decompress(self, strings, shape):
        """{"x_hat" [B, N, 3]} of compress's strings."""
        with pinned_library_settings():
            y_hat = self.entropy_bottleneck.decompress(
                strings[0], tuple(shape))[:, 0, 0, :]
            return {"x_hat": self._decode(y_hat, y_hat.shape[0])}


@register_model("sfu-pcc-rec-pointnet")
class PointNetReconstructionPccModel(_PointNetFamily):
    def __init__(self, num_points: int = 1024, latent_dim: int = 512, *,
                 seed: int = 0, device="cuda", generator=None, **kwargs):
        super().__init__()
        g = _generator(seed, generator)
        self.num_points = int(num_points)
        self.latent_dim = int(latent_dim)
        self.g_a = PointNetSetMLP([3, 64, 64, 128, 256, latent_dim],
                                  generator=g)
        self.g_s = SharedMLP([latent_dim, 512, 1024, num_points * 3],
                             final_act=False, generator=g)
        self.entropy_bottleneck = EntropyBottleneck(latent_dim, generator=g)
        self.to(device)

    def _encode_latent(self, points):
        return self.g_a(points)

    def _decode(self, y_hat, batch):
        return self.g_s(y_hat[:, None, :])[:, 0].reshape(
            batch, self.num_points, 3)

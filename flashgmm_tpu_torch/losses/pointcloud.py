"""Point-cloud losses (port of flashgmm_tpu/losses/pointcloud.py;
CompressAI's losses/pointcloud/{chamfer,hrtzxf2022}.py): the chamfer
distance over [B, N, 3] clouds through full pairwise distances, and the
density-preserving RD loss of He2022.

The pairwise distances run in full float32 on the card
(``layers.pointcloud.f32_einsum``): the argmin of the density loss picks
indices from them.
"""

import math

import torch

from flashgmm_tpu_torch.layers.pointcloud import f32_einsum
from flashgmm_tpu_torch.registry import register_criterion


def _pairwise_sqdist(a, b):
    aa = (a * a).sum(-1)
    bb = (b * b).sum(-1)
    ab = f32_einsum("bnc,bmc->bnm", a, b)
    return torch.clamp(aa[:, :, None] + bb[:, None, :] - 2 * ab, min=0.0)


def chamfer_distance(a, b):
    """Symmetric squared-L2 chamfer between [B, Na, 3] and [B, Nb, 3]."""
    d = _pairwise_sqdist(a, b)
    return d.amin(2).mean() + d.amin(1).mean()


def chamfer_with_index(a, b):
    """(chamfer, idx2): idx2 [B, Nb] is each b-point's nearest a-point
    (the first of equal ones)."""
    d = _pairwise_sqdist(a, b)
    return d.amin(2).mean() + d.amin(1).mean(), torch.argmin(d, dim=1)


def _bpp(likelihoods, num_points):
    return sum(torch.log(lk).sum() / (-math.log(2) * num_points)
               for lk in likelihoods)


@register_criterion("RateDistortionLoss_hrtzxf2022")
class RateDistortionLossHrtzxf2022:
    """The density-preserving RD loss (He2022): a multi-scale chamfer, the
    density terms (mean distance and upsample count at each reconstructed
    point's nearest ground-truth point), the point count, the latent
    positions and the rate, each weighted by ``lmbda[name]``."""

    LMBDA_DEFAULT = {
        "bpp": 1.0,
        "chamfer": 1e4,
        "chamfer_layers": (1.0, 0.1, 0.1),
        "latent_xyzs": 1e2,
        "mean_distance": 5e1,
        "pts_num": 5e-3,
        "upsample_num": 1.0,
    }

    def __init__(self, lmbda=None, latent_xyzs_codec_mode="learned"):
        self.lmbda = dict(self.LMBDA_DEFAULT)
        if lmbda:
            self.lmbda.update(lmbda)
        self.latent_xyzs_codec_mode = latent_xyzs_codec_mode

    def __call__(self, output, target):
        if isinstance(target, dict):
            target = target["pos"]
        b, n_pts, _ = target.shape
        out = {}

        gt_xyzs_ = output["gt_xyz_"]
        xyzs_hat_ = output["xyz_hat_"]
        num_layers = len(gt_xyzs_)
        chamfer_, idx_ = [], []
        for i in range(num_layers):
            ch, idx2 = chamfer_with_index(gt_xyzs_[i],
                                          xyzs_hat_[num_layers - i - 1])
            chamfer_.append(ch)
            idx_.append(idx2)
        out["chamfer_loss"] = sum(
            w * c for w, c in zip(self.lmbda["chamfer_layers"], chamfer_))
        out["rec_loss"] = chamfer_[0]

        mdis_terms, unum_terms = [], []
        for i in range(num_layers):
            mdis_i = output["gt_mean_distance_"][i]
            dnum_i = output["gt_downsample_num_"][i]
            if i < num_layers - 1:
                mdis_i = torch.gather(mdis_i, 1, idx_[i + 1])
                dnum_i = torch.gather(dnum_i, 1, idx_[i + 1])
            j = num_layers - i - 1
            mdis_terms.append(
                (output["mean_distance_hat_"][j] - mdis_i).abs().mean())
            unum_terms.append(
                (output["upsample_num_hat_"][j] - dnum_i).abs().mean())
        out["mean_distance_loss"] = sum(mdis_terms)
        out["upsample_num_loss"] = sum(unum_terms)

        out["pts_num_loss"] = sum(
            (output["upsample_num_hat_"][num_layers - i - 1].sum()
             - gt_xyzs_[i].shape[1] * b).abs()
            for i in range(num_layers))

        if self.latent_xyzs_codec_mode == "learned":
            out["latent_xyzs_loss"] = (
                (output["gt_latent_xyz"] - output["latent_xyz_hat"]) ** 2
            ).mean()
        else:
            out["latent_xyzs_loss"] = torch.zeros((), device=target.device)

        out["bpp_loss"] = _bpp(output["likelihoods"].values(), b * n_pts)
        out["loss"] = sum(self.lmbda[k] * out[f"{k}_loss"]
                          for k in self.lmbda if f"{k}_loss" in out)
        return out


@register_criterion("ChamferPccRateDistortionLoss")
class ChamferPccRateDistortionLoss:
    """lambda * chamfer + bits per point."""

    def __init__(self, lmbda: float = 1.0):
        self.lmbda = lmbda

    def __call__(self, output, target):
        bpp = _bpp(output["likelihoods"].values(),
                   target.shape[0] * target.shape[1])
        dist = chamfer_distance(output["x_hat"], target)
        return {"loss": self.lmbda * dist + bpp, "bpp_loss": bpp,
                "chamfer_loss": dist}

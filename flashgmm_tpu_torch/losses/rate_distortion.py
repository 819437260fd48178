"""Rate-distortion loss (port of flashgmm_tpu/losses/rate_distortion.py;
CompressAI's compressai/losses/rate_distortion.py:40-74):
``loss = lambda * 255^2 * MSE + bpp`` with
``bpp = sum(log(likelihoods)) / (-ln 2 * num_pixels)``; with the
"ms-ssim" metric ``lambda * (1 - MS-SSIM) + bpp``. Images are NHWC."""

import math

import torch

from flashgmm_tpu_torch.registry import register_criterion


def rate_distortion_loss(output, target, lmbda: float = 1e-2,
                         metric: str = "mse"):
    """output: {"x_hat": [N, H, W, C], "likelihoods": {...}}; target:
    [N, H, W, C]. Returns {"loss", "bpp_loss", f"{metric}_loss"}, each a
    0-d tensor."""
    n, h, w, _ = target.shape
    num_pixels = n * h * w

    bpp_loss = sum(
        torch.sum(torch.log(lk)) / (-math.log(2) * num_pixels)
        for lk in output["likelihoods"].values()
    )

    if metric == "mse":
        dist = torch.mean((output["x_hat"] - target) ** 2)
        rd = lmbda * 255**2 * dist + bpp_loss
    elif metric == "ms-ssim":
        from flashgmm_tpu_torch.utils.metrics import ms_ssim

        dist = 1 - ms_ssim(output["x_hat"], target)
        rd = lmbda * dist + bpp_loss
    else:
        raise NotImplementedError(f"{metric} loss not implemented")

    return {
        "loss": rd,
        "bpp_loss": bpp_loss,
        f"{metric}_loss": dist,
    }


def video_rate_distortion_loss(output, frames, lmbda: float = 1e-2):
    """The multi-frame RD loss of the video models (ssf2020; the JAX
    package's losses/rate_distortion.py:45-69, the reference's
    examples/train_video.py:73-190): the distortion is the mean over the
    frames of each frame's MSE, the rate the bits of every likelihood
    tensor of every frame over one frame's pixels. ``output`` is
    ScaleSpaceFlow's forward ({"x_hat": [frame, ...], "likelihoods":
    [{branch: {"y", "z"}}, ...]}), ``frames`` the list of [N, H, W, 3]
    targets. Returns {"loss", "bpp_loss", "mse_loss"}, 0-d tensors."""
    n, h, w, _ = frames[0].shape
    num_pixels = n * h * w

    bpp_loss = sum(
        torch.sum(torch.log(lk)) / (-math.log(2) * num_pixels)
        for frame_lk in output["likelihoods"]
        for branch in frame_lk.values()
        for lk in branch.values()
    )
    mse_loss = sum(
        torch.mean((x_hat - x) ** 2)
        for x_hat, x in zip(output["x_hat"], frames)
    ) / len(frames)
    return {
        "loss": lmbda * 255**2 * mse_loss + bpp_loss,
        "bpp_loss": bpp_loss,
        "mse_loss": mse_loss,
    }


@register_criterion("RateDistortionLoss")
class RateDistortionLoss:
    def __init__(self, lmbda: float = 1e-2, metric: str = "mse"):
        if metric not in ("mse", "ms-ssim"):
            raise NotImplementedError(f"{metric} loss not implemented")
        self.lmbda = lmbda
        self.metric = metric

    def __call__(self, output, target):
        return rate_distortion_loss(output, target, self.lmbda, self.metric)

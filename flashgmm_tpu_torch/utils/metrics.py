"""Image quality metrics (PSNR, SSIM, MS-SSIM) in float32 PyTorch, NHWC
(port of flashgmm_tpu/utils/metrics.py).

The SSIM window is a depthwise 11x11 Gaussian conv in float32; the
variance terms (``filt(a * a) - mu^2``) cancel, so a reduced-precision
conv (TF32, bf16) would corrupt them (the JAX package pins its conv to
``Precision.HIGHEST`` for that reason). PyTorch runs a depthwise conv of
this size on its own float32 kernels, not on the tensor cores.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a, b, max_val: float = 1.0):
    mse = torch.mean((a - b) ** 2)
    return 20 * math.log10(max_val) - 10 * torch.log10(mse)


def _fspecial_gauss(size: int = 11, sigma: float = 1.5):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = np.outer(g, g)
    return torch.from_numpy((g / g.sum()).astype(np.float32))


def _ssim_components(a, b, max_val=1.0, k1=0.01, k2=0.03):
    """Returns (the mean luminance-contrast-structure map, the mean
    contrast-structure map) of NHWC a and b, over the "valid" window
    positions."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    c = a.shape[-1]
    kernel = _fspecial_gauss().to(a.device)[None, None].repeat(c, 1, 1, 1)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = filt(a * a) - mu_aa
    s_bb = filt(b * b) - mu_bb
    s_ab = filt(a * b) - mu_ab

    cs = (2 * s_ab + c2) / (s_aa + s_bb + c2)
    ssim = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs
    return ssim.mean(), cs.mean()


def ssim(a, b, max_val: float = 1.0):
    s, _ = _ssim_components(a, b, max_val)
    return s


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(a, b, max_val: float = 1.0):
    """Multi-scale SSIM (Wang et al. 2003), up to 5 scales: fewer for small
    images, since each scale needs the 11x11 window, with the weights
    renormalized; each scale's value clipped at 1e-6 before the weighted
    product."""
    min_dim = min(a.shape[1], a.shape[2])
    levels = len(_MSSSIM_WEIGHTS)
    while levels > 1 and (min_dim >> (levels - 1)) < 11:
        levels -= 1
    vals = []
    for i in range(levels):
        s, cs = _ssim_components(a, b, max_val)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            # 2x2 average-pool downsampling
            n, h, w, c = a.shape
            h2, w2 = (h // 2) * 2, (w // 2) * 2
            a = a[:, :h2, :w2].reshape(n, h // 2, 2, w // 2, 2, c).mean((2, 4))
            b = b[:, :h2, :w2].reshape(n, h // 2, 2, w // 2, 2, c).mean((2, 4))
    vals = torch.stack(vals)
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                           device=vals.device)
    if levels < len(_MSSSIM_WEIGHTS):
        weights = weights / weights.sum()
    return torch.prod(torch.clamp(vals, min=1e-6) ** weights)

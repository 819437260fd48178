"""Colour-space transforms (BT.601) over NHWC tensors (port of
flashgmm_tpu/transforms/functional.py; CompressAI's
compressai/transforms/functional.py:26-130).

The JAX package upsamples chroma with ``jax.image.resize``; at the x2 of
4:2:0 its "bilinear" is ``F.interpolate(mode="bilinear",
align_corners=False)`` (at the edges both weigh the one sample inside the
image alone) and its "nearest" is ``F.interpolate(mode="nearest")`` (output
i reads input i // 2).
"""

import torch
import torch.nn.functional as F

YCBCR_WEIGHTS = {"ITU-R_BT.601": (0.299, 0.587, 0.114)}


def rgb2ycbcr(rgb):
    """[..., 3] RGB in [0, 1] -> YCbCr in [0, 1] (BT.601 full range)."""
    r, g, b = torch.split(rgb, 1, dim=-1)
    kr, kg, kb = YCBCR_WEIGHTS["ITU-R_BT.601"]
    y = kr * r + kg * g + kb * b
    cb = 0.5 * (b - y) / (1 - kb) + 0.5
    cr = 0.5 * (r - y) / (1 - kr) + 0.5
    return torch.cat([y, cb, cr], dim=-1)


def ycbcr2rgb(ycbcr):
    """[..., 3] YCbCr in [0, 1] -> RGB in [0, 1] (BT.601 full range)."""
    y, cb, cr = torch.split(ycbcr, 1, dim=-1)
    kr, kg, kb = YCBCR_WEIGHTS["ITU-R_BT.601"]
    r = y + (2 - 2 * kr) * (cr - 0.5)
    b = y + (2 - 2 * kb) * (cb - 0.5)
    g = (y - kr * r - kb * b) / kg
    return torch.cat([r, g, b], dim=-1)


def yuv_444_to_420(yuv, mode: str = "avg_pool"):
    """[N, H, W, 3] (or a (y, u, v) tuple) -> (y [N, H, W, 1],
    u [N, H/2, W/2, 1], v [N, H/2, W/2, 1]), chroma averaged over 2x2."""
    if mode not in ("avg_pool",):
        raise ValueError(f'Invalid downsampling mode "{mode}".')
    if isinstance(yuv, tuple):
        y, u, v = yuv
    else:
        y, u, v = torch.split(yuv, 1, dim=-1)

    def down(x):
        n, h, w, c = x.shape
        return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))

    return (y, down(u), down(v))


def yuv_420_to_444(yuv, mode: str = "bilinear", return_tuple: bool = False):
    """(y, u, v) planes -> [N, H, W, 3] (or the tuple), chroma upsampled by
    2."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f'Invalid upsampling mode "{mode}".')
    y, u, v = yuv
    kw = {"align_corners": False} if mode == "bilinear" else {}

    def up(x):
        return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                             mode=mode, **kw).permute(0, 2, 3, 1)

    u, v = up(u), up(v)
    if return_tuple:
        return y, u, v
    return torch.cat([y, u, v], dim=-1)

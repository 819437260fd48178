"""Core tensor ops (port of flashgmm_tpu/ops/ops.py).

Tensors are NHWC at every public boundary of the port, as in the JAX
package; padding helpers operate on the H/W axes accordingly.
"""

import torch


def quantize_ste(x):
    """Round with straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def compute_padding(in_h: int, in_w: int, *, out_h=None, out_w=None,
                    min_div=1):
    """Returns (pad, unpad) tuples ``(left, right, top, bottom)``."""
    if out_h is None:
        out_h = (in_h + min_div - 1) // min_div * min_div
    if out_w is None:
        out_w = (in_w + min_div - 1) // min_div * min_div

    if out_h % min_div != 0 or out_w % min_div != 0:
        raise ValueError(
            f"Padded output height and width are not divisible by "
            f"min_div={min_div}.")

    left = (out_w - in_w) // 2
    right = out_w - in_w - left
    top = (out_h - in_h) // 2
    bottom = out_h - in_h - top
    return (left, right, top, bottom), (-left, -right, -top, -bottom)


def pad_image(x, pad):
    """Replication-pad an NHWC image by ``(left, right, top, bottom)``."""
    left, right, top, bottom = pad
    nchw = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                   (left, right, top, bottom),
                                   mode="replicate")
    return nchw.permute(0, 2, 3, 1)


def unpad_image(x, unpad):
    """Undo :func:`pad_image` given the (negative) unpad tuple."""
    left, right, top, bottom = unpad
    h, w = x.shape[1], x.shape[2]
    return x[:, -top: h + bottom, -left: w + right, :]

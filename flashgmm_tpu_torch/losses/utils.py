"""Loss helpers (port of flashgmm_tpu/losses/utils.py; CompressAI's
compressai/losses/utils.py): the per-likelihood-tensor bit and bpp
breakdown that composite losses log."""

import torch


def compute_rate_loss(likelihoods, batch_size, num_pixels_per_item):
    """Per-name bit and bpp losses and their totals.

    ``likelihoods``: {name: tensor}; returns
    {"bit_<name>_loss", "bpp_<name>_loss", ..., "bit_loss", "bpp_loss"}.
    """
    out_bit = {
        f"bit_{name}_loss": torch.sum(torch.log2(lk)) / -batch_size
        for name, lk in likelihoods.items()
    }
    out_bpp = {
        f"bpp_{name}_loss": v / num_pixels_per_item
        for name, v in zip(likelihoods.keys(), out_bit.values())
    }
    out = {**out_bit, **out_bpp}
    out["bit_loss"] = sum(out_bit.values())
    out["bpp_loss"] = out["bit_loss"] / num_pixels_per_item
    return out

"""A PyTorch (CompressAI/FlashGMM) checkpoint into the port's modules (the
port's own copy of flashgmm_tpu/zoo/torch_convert.py:27-175).

The port's modules are torch-shaped already (conv weights OIHW, GDN's
``beta`` and ``gamma`` as stored), so what is left is the path mapping:
the port keeps the JAX package's paths, whose ``Sequential`` adds a
``layers`` level and whose ``latent_codec`` containers nest one
``latent_codec`` dict level that the reference registers with
``save_direct=True`` (reference latent_codecs/base.py:50-76), so it is
absent from the checkpoint's keys; ChannelGroupsLatentCodec's is an
``nn.ModuleDict`` there (channel_groups.py:84) and stays. Transposed-conv
weights are [in, out, kh, kw] in both. Also reproduced: the reference's legacy
key renames (zoo/pretrained.py:39-62), and the entropy models' integer
tables (the EntropyBottleneck's, and a GaussianConditional's scale table
and tables where the checkpoint holds them), resized to the checkpoint's
shapes (models/utils.py:66-131).
"""

import re

import numpy as np
import torch

from flashgmm_tpu_torch.entropy_models import (EntropyBottleneck,
                                               GaussianConditional)
from flashgmm_tpu_torch.latent_codecs import ChannelGroupsLatentCodec
from flashgmm_tpu_torch.layers import GDN, Conv2d, ConvTranspose2d, MaskedConv2d


def rename_legacy_keys(state_dict):
    """Legacy CompressAI checkpoint key renames (zoo/pretrained.py:39-62)."""
    out = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "")  # DataParallel prefix
        for i in range(4):
            k = re.sub(rf"_biases\.{i}$", f"_bias{i}", k)
            k = re.sub(rf"_matrices\.{i}$", f"_matrix{i}", k)
            k = re.sub(rf"_factors\.{i}$", f"_factor{i}", k)
        out[k] = v
    return out


def torch_path(path: str, kept=()) -> str:
    """A port module path -> the checkpoint's: the ``layers`` levels and
    every ``latent_codec`` level but the first dropped, except where the
    path up to that level is in ``kept`` (a ChannelGroupsLatentCodec's
    ``<path>.latent_codec``)."""
    parts = path.split(".") if path else []
    return ".".join(
        p for i, p in enumerate(parts)
        if p != "layers" and not (p == "latent_codec" and i > 0
                                  and ".".join(parts[:i + 1]) not in kept))


def _as_tensor(v):
    return v.detach().cpu() if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.asarray(v))


def load_torch_state_dict(model, state_dict, strict: bool = True):
    """Load a torch state dict (tensors or numpy arrays) into the port's
    ``model``. ``strict``: a parameter missing from it raises KeyError.
    Returns the checkpoint's keys that no parameter or table took."""
    sd = rename_legacy_keys(dict(state_dict))
    used = set()

    def take(key):
        if key not in sd:
            if strict:
                raise KeyError(f"Missing torch key: {key}")
            return None
        used.add(key)
        return _as_tensor(sd[key])

    def fill(param, key):
        v = take(key)
        if v is None:
            return
        if tuple(v.shape) != tuple(param.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(v.shape)}, "
                             f"the port's {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(v.to(param.dtype))

    kept = {f"{path}.latent_codec" for path, node in model.named_modules()
            if isinstance(node, ChannelGroupsLatentCodec)}
    for path, node in model.named_modules():
        prefix = torch_path(path, kept)
        key = (lambda name: f"{prefix}.{name}" if prefix else name)
        if isinstance(node, (Conv2d, ConvTranspose2d)):  # MaskedConv2d too
            fill(node.weight, key("weight"))
            if node.bias is not None:
                fill(node.bias, key("bias"))
            if isinstance(node, MaskedConv2d):
                used.add(key("mask"))  # a buffer; the port's is built
        elif isinstance(node, GDN):
            fill(node.beta, key("beta"))
            fill(node.gamma, key("gamma"))
        elif isinstance(node, EntropyBottleneck):
            for i in range(node._num_layers):
                fill(getattr(node, f"matrix{i}"), key(f"_matrix{i}"))
                fill(getattr(node, f"bias{i}"), key(f"_bias{i}"))
                if i < len(node.filters):
                    fill(getattr(node, f"factor{i}"), key(f"_factor{i}"))
            fill(node.quantiles, key("quantiles"))
            _load_tables(node, key, sd, take, node.quantiles.device)
            used.add(key("target"))
        elif isinstance(node, GaussianConditional):
            dev = node.scale_table.device
            if key("scale_table") in sd:
                node.scale_table = take(key("scale_table")).float().to(dev)
            _load_tables(node, key, sd, take, dev)
            used.add(key("scale_bound"))
    return [k for k in sd if k not in used]


def _load_tables(node, key, sd, take, dev):
    """An entropy model's integer tables where the checkpoint holds them,
    resized to its shapes (an empty one is left alone)."""
    for name in ("_offset", "_quantized_cdf", "_cdf_length"):
        if key(name) in sd:
            v = take(key(name))
            if v.numel():
                setattr(node, name, v.to(torch.int32).to(dev))

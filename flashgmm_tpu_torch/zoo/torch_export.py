"""The port's models -> PyTorch (CompressAI/FlashGMM) state dicts (port of
flashgmm_tpu/zoo/torch_export.py).

Inverse of :mod:`flashgmm_tpu_torch.zoo.torch_convert`: walks the model's
modules and emits ``{torch_key: np.ndarray}`` in the reference's layouts,
so the reference PyTorch network can run weights trained in this package.
The port's modules are torch-shaped already (conv weights OIHW, transposed
convs IOHW, GDN's ``beta`` and ``gamma`` as stored), so what is left is the
path mapping (``torch_convert.torch_path``: the ``layers`` levels and the
nested ``latent_codec`` levels dropped, a ChannelGroupsLatentCodec's kept).

The export includes the entropy models' integer tables (``_offset``,
``_quantized_cdf``, ``_cdf_length``) as materialized, empty before
``update()``, matching the reference's post-``update()`` checkpoint
convention (utils/update_model/__main__.py).
"""

import numpy as np
import torch

from flashgmm_tpu_torch.entropy_models import (EntropyBottleneck,
                                               GaussianConditional)
from flashgmm_tpu_torch.latent_codecs import ChannelGroupsLatentCodec
from flashgmm_tpu_torch.layers import GDN, Conv2d, ConvTranspose2d

from .torch_convert import torch_path


def _np(v):
    return v.detach().cpu().numpy()


def export_torch_state_dict(model):
    """Returns ``{torch_key: np.ndarray}`` for ``model``'s parameters and
    entropy tables."""
    sd = {}
    kept = {f"{path}.latent_codec" for path, node in model.named_modules()
            if isinstance(node, ChannelGroupsLatentCodec)}
    for path, node in model.named_modules():
        prefix = torch_path(path, kept)

        def put(suffix, arr):
            sd[f"{prefix}.{suffix}" if prefix else suffix] = arr

        if isinstance(node, (Conv2d, ConvTranspose2d)):  # MaskedConv2d too
            put("weight", _np(node.weight))
            if node.bias is not None:
                put("bias", _np(node.bias))
        elif isinstance(node, GDN):
            put("beta", _np(node.beta))
            put("gamma", _np(node.gamma))
        elif isinstance(node, EntropyBottleneck):
            for i in range(node._num_layers):
                put(f"_matrix{i}", _np(getattr(node, f"matrix{i}")))
                put(f"_bias{i}", _np(getattr(node, f"bias{i}")))
                if i < len(node.filters):
                    put(f"_factor{i}", _np(getattr(node, f"factor{i}")))
            put("quantiles", _np(node.quantiles))
            _put_em_buffers(node, put)
        elif isinstance(node, GaussianConditional):
            put("scale_table", _np(node.scale_table))
            _put_em_buffers(node, put)
    return sd


def _put_em_buffers(node, put):
    # always emitted (possibly size-0): the reference's load_state_dict
    # resizes registered buffers from these keys and KeyErrors if any is
    # missing for a module with other keys present (models/utils.py:74)
    for name in ("_offset", "_quantized_cdf", "_cdf_length"):
        put(name, _np(getattr(node, name)).astype(np.int32))


def load_into_torch_model(torch_model, state_dict, strict_params: bool = True):
    """Load an exported dict into a reference PyTorch module.

    Buffers absent from the export (masks, LowerBound bounds, EB ``target``)
    keep the torch module's constructor values, which are definitionally
    identical. With ``strict_params`` every torch *parameter* must be
    covered by the export or a KeyError is raised. Returns the exported
    keys the module does not have."""
    tsd = torch_model.state_dict()
    param_names = {n for n, _ in torch_model.named_parameters()}
    missing = [n for n in param_names if n not in state_dict]
    if strict_params and missing:
        raise KeyError(f"export does not cover torch params: {missing[:8]}")
    new = {}
    for k, v in state_dict.items():
        if k not in tsd:
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        new[k] = t.to(tsd[k].dtype) if tsd[k].dtype.is_floating_point else t
    # CompressionModel.load_state_dict resizes registered CDF buffers
    torch_model.load_state_dict(new, strict=False)
    return [k for k in state_dict if k not in tsd]

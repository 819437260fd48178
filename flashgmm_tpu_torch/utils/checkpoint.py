"""Checkpoints: the model's and the optimizers' ``state_dict``s in one
``torch.save`` file, plus ``<path>.meta.json`` (port of
flashgmm_tpu/utils/checkpoint.py; the reference saves torch state dicts
too, train_ckbd_gmm.py:364-369, 583-597). The JAX package writes orbax
checkpoints, which need JAX, so the two formats do not cross; weights move
between the packages as ``.npz`` (``zoo.load_npz``).

Entropy tables that ``model.update()`` materialized survive a load into a
freshly built model, as in the JAX package (its checkpoint.py:54-81): the
tables are non-persistent buffers, outside ``state_dict``, so the file
keeps every non-empty non-persistent buffer apart (``"tables"``) and a load
puts each back at its saved shape.
"""

import json
import os
from pathlib import Path

import torch


def _tables(model):
    """{name: buffer} of the non-empty non-persistent buffers."""
    out = {}
    for mod_name, mod in model.named_modules():
        for name in mod._non_persistent_buffers_set:
            buf = mod._buffers.get(name)
            if buf is not None and buf.numel() > 0:
                out[f"{mod_name}.{name}" if mod_name else name] = buf
    return out


def save_checkpoint(path, model, opt_net=None, opt_aux=None, meta=None,
                    scheduler=None):
    """Write ``path`` (one file, replaced atomically) and, with ``meta``,
    ``<path>.meta.json``."""
    path = Path(path).absolute()
    tree = {"model": model.state_dict(), "tables": _tables(model)}
    for key, obj in (("opt_net", opt_net), ("opt_aux", opt_aux),
                     ("scheduler", scheduler)):
        if obj is not None:
            tree[key] = obj.state_dict()
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(str(path) + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_checkpoint(path, model, opt_net=None, opt_aux=None, scheduler=None):
    """Restore in place (strictly: every parameter present, none left
    over), tensors onto the model's device; returns the meta dict (empty if
    there is none)."""
    path = Path(path).absolute()
    dev = next(model.parameters()).device
    tree = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(tree["model"], strict=True)
    modules = dict(model.named_modules())
    for name, buf in tree["tables"].items():
        mod_name, _, attr = name.rpartition(".")
        mod = modules[mod_name]
        if attr not in mod._non_persistent_buffers_set:
            raise KeyError(f"{name}: not a non-persistent buffer of the model")
        mod._buffers[attr] = buf
    for key, obj in (("opt_net", opt_net), ("opt_aux", opt_aux),
                     ("scheduler", scheduler)):
        if obj is not None and key in tree:
            obj.load_state_dict(tree[key])
    meta_path = str(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}

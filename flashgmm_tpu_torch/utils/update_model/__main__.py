"""Post-training model update: materialize the entropy coder's tables
(port of flashgmm_tpu/utils/update_model/__main__.py; CompressAI's
``python -m compressai.utils.update_model``, utils/update_model/
__main__.py:29-172): load a port checkpoint, run
``model.update(force=True, update_quantiles=True)`` (unless
``--no-update``), and save it again as ``<stem>-<hash>``.

The hash is the first 8 hex digits of the sha256 of the port's state: each
state-dict entry and each entropy table, in name order, as its name, dtype,
shape and bytes. The JAX package hashes ``str(nnx.state(model))``, so the
two names never match, and the two checkpoint formats do not cross either.

Usage:
    python -m flashgmm_tpu_torch.utils.update_model ckpt_file \\
        -a mbt2018-mean -N 128 -M 192 [--device cpu] [-d outdir]
"""

import argparse
import hashlib
import inspect
import sys
from pathlib import Path

import torch


def setup_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("filepath", type=str, help="checkpoint path")
    p.add_argument("-a", "--architecture", required=True)
    p.add_argument("-N", type=int, default=192)
    p.add_argument("-M", type=int, default=320)
    p.add_argument("-K", type=int, default=4)
    p.add_argument("-d", "--dir", type=str, help="output directory")
    p.add_argument("--name", type=str, help="output name stem")
    p.add_argument("--no-update", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the update runs on (default: cuda)")
    return p.parse_args(argv)


def state_hash(model) -> str:
    """8 hex digits of the sha256 of the model's state dict and entropy
    tables."""
    from flashgmm_tpu_torch.utils.checkpoint import _tables

    h = hashlib.sha256()
    state = dict(model.state_dict())
    state.update(_tables(model))
    for name in sorted(state):
        t = state[name].detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:8]


def main(argv=None):
    args = setup_args(argv)

    from flashgmm_tpu_torch import models  # noqa: F401  (fills the registry)
    from flashgmm_tpu_torch.registry import MODELS
    from flashgmm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    cls = MODELS[args.architecture]
    params = inspect.signature(cls.__init__).parameters
    kwargs = {k: getattr(args, k) for k in ("N", "M", "K") if k in params}
    model = cls(**kwargs, device=args.device)
    load_checkpoint(args.filepath, model)

    if not args.no_update:
        model.update(force=True, update_quantiles=True)

    outdir = Path(args.dir or Path(args.filepath).parent)
    stem = args.name or Path(args.filepath).name
    outpath = outdir / f"{stem}-{state_hash(model)}"
    save_checkpoint(outpath, model)
    print(f"Saved updated model to {outpath}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

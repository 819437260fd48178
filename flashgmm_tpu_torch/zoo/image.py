"""The model zoo: each architecture's configuration at each quality (port
of flashgmm_tpu/zoo/image.py; CompressAI's zoo/image.py:54-260).

There is no download: trained weights are local files under ``weights/``
(the JAX package's ``.npz``), listed in ``local_weights``. ``create_model``
builds an (architecture, quality) at its widths and loads a weights file:
a ``.npz`` through ``zoo.load_npz``, a CompressAI ``.pth``/``.pt`` through
``zoo.torch_convert``, anything else as the port's own checkpoint
(``utils/checkpoint.py``; the JAX package takes an orbax directory there).
A VBR architecture has one quality: one model serves its 8 gains. The
video model (ssf2020) takes no widths: its qualities are checkpoints. A
point-cloud entry is a dict of constructor keywords: its quality is a
checkpoint, and the PointNet codec's quality 1 is as wide as its shipped
weights (``latent_dim=256``; the JAX zoo builds it at the default 512,
which its shipped file does not fit).
"""

import inspect
from pathlib import Path

from flashgmm_tpu_torch import models  # noqa: F401  (fills the registry)
from flashgmm_tpu_torch.registry import MODELS

_FACTORIZED = {1: (128, 192), 2: (128, 192), 3: (128, 192), 4: (128, 192),
               5: (128, 256), 6: (192, 320), 7: (192, 320), 8: (192, 320)}
_CHENG = {1: (128,), 2: (128,), 3: (128,), 4: (192,), 5: (192,), 6: (192,)}
_ELIC = {q: (192, 320) for q in range(1, 7)}

# (quality -> constructor args), the reference's cfgs
cfgs = {
    "bmshj2018-factorized": dict(_FACTORIZED),
    "bmshj2018-factorized-relu": dict(_FACTORIZED),
    "bmshj2018-hyperprior": dict(_FACTORIZED),
    "mbt2018-mean": {1: (128, 192), 2: (128, 192), 3: (128, 192),
                     4: (128, 192), 5: (192, 320), 6: (192, 320),
                     7: (192, 320), 8: (192, 320)},
    "mbt2018": {1: (192, 192), 2: (192, 192), 3: (192, 192), 4: (192, 192),
                5: (192, 320), 6: (192, 320), 7: (192, 320), 8: (192, 320)},
    "cheng2020-anchor": dict(_CHENG),
    "cheng2020-attn": dict(_CHENG),
    "cheng2020-anchor-checkerboard": dict(_CHENG),
    "cheng2020-anchor-checkerboard-gmm": dict(_CHENG),
    "elic2022-official": dict(_ELIC),
    "elic2022-gaussian": dict(_ELIC),
    # VBR: ONE model serves the whole rate range; the gain index s is an
    # argument of its forward and coding
    "bmshj2018-hyperprior-vbr": {1: (192, 320)},
    "mbt2018-mean-vbr": {1: (192, 320)},
    "mbt2018-vbr": {1: (192, 320)},
    # video: one architecture at its published widths; a quality is a
    # checkpoint
    "ssf2020": {q: () for q in range(1, 10)},
    # point cloud: keyword arguments; a quality is a checkpoint
    "hrtzxf2022-pcc-rec": {1: {}},
    "sfu-pcc-rec-pointnet": {1: {"latent_dim": 256}},
}

model_architectures = dict(MODELS)

# Weights trained in the repository, keyed (architecture, quality); the
# quality slots follow the reference's rate order.
_REPO_ROOT = Path(__file__).resolve().parents[2]
local_weights = {
    ("cheng2020-anchor-checkerboard-gmm", 4):
        "weights/ckbd_gmm_n192_k4_q2.npz",          # lambda=0.0025
    ("cheng2020-anchor-checkerboard-gmm", 5):
        "weights/ckbd_gmm_n192_k4_synthetic.npz",   # lambda=0.0067
    ("cheng2020-anchor-checkerboard-gmm", 6):
        "weights/ckbd_gmm_n192_k4_q6.npz",          # lambda=0.013
    ("elic2022-official", 4):
        "weights/elic_gmm_n192_m320_k4_q4.npz",     # lambda=0.0025
    ("elic2022-official", 5):
        "weights/elic_gmm_n192_m320_k4_synthetic.npz",
    ("elic2022-official", 6):
        "weights/elic_gmm_n192_m320_k4_q6.npz",     # lambda=0.013
    ("mbt2018-mean-vbr", 1):
        "weights/mshp_vbr_n192_m320_synthetic.npz",  # ONE model, 8 gains
    ("ssf2020", 5):
        "weights/ssf2020_synthetic.npz",
    ("bmshj2018-factorized", 4):
        "weights/factorized_n128_m192_synthetic.npz",
    ("mbt2018-mean", 3): "weights/mshp_n128_m192_synthetic.npz",
    ("bmshj2018-hyperprior", 3): "weights/bmshj_hp_n128_m192_synthetic.npz",
    # point-cloud codecs (results/synthetic/pointcloud_*.json)
    ("hrtzxf2022-pcc-rec", 1): "weights/pcc_hrtzxf2022_synthetic.npz",
    ("sfu-pcc-rec-pointnet", 1): "weights/pcc_pointnet_synthetic.npz",
}

# Slots that join the table when their weight file is present; 3-tuple
# keys carry the metric, resolved before (architecture, quality).
_PENDING_SLOTS = {
    ("mbt2018-mean", 4): "weights/mshp_n128_m192_q4.npz",
    ("bmshj2018-hyperprior", 4): "weights/bmshj_hp_n128_m192_q4.npz",
    ("cheng2020-anchor-checkerboard", 3): "weights/ckbd_gc_n128_synthetic.npz",
    ("cheng2020-anchor-checkerboard", 2): "weights/ckbd_gc_n128_q2.npz",
    ("cheng2020-anchor-checkerboard-gmm", 5, "ms-ssim"):
        "weights/ckbd_gmm_n192_k4_q5_msssim.npz",
}
for _k, _rel in _PENDING_SLOTS.items():
    if (_REPO_ROOT / _rel).exists():
        local_weights[_k] = _rel


def _local_weights_path(architecture: str, quality: int,
                        metric: str = "mse"):
    rel = local_weights.get((architecture, quality, metric))
    if rel is None and metric == "mse":
        rel = local_weights.get((architecture, quality))
    if rel is None:
        return None
    p = _REPO_ROOT / rel
    return str(p) if p.exists() else None


def load_weights(model, weights_path) -> None:
    """``weights_path`` into ``model``: ``.npz`` (the JAX package's
    weights), ``.pth``/``.pt`` (a CompressAI state dict) or the port's own
    checkpoint."""
    path = str(weights_path)
    if path.endswith(".npz"):
        from .npz import load_npz

        load_npz(model, path)
    elif path.endswith((".pth", ".pt", ".pth.tar")):
        from .torch_convert import load_checkpoint_file

        load_checkpoint_file(model, path, strict=False)
    else:
        from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint

        load_checkpoint(path, model)


def create_model(architecture: str, quality: int = 1, metric: str = "mse",
                 weights_path: str = None, K: int = 4, *, seed: int = 0,
                 device="cuda", **kwargs):
    """A zoo model at its (architecture, quality) widths on ``device``,
    with ``weights_path`` loaded if given."""
    if architecture not in cfgs:
        raise ValueError(f'Unknown architecture "{architecture}"')
    if quality not in cfgs[architecture]:
        raise ValueError(
            f'Invalid quality "{quality}" for {architecture}, '
            f"expected one of {sorted(cfgs[architecture])}")
    cls = MODELS[architecture]
    params = inspect.signature(cls.__init__).parameters
    cfg = cfgs[architecture][quality]
    ckwargs = dict(cfg) if isinstance(cfg, dict) else {}
    ckwargs.update(kwargs)
    for name, val in zip(("N", "M"), () if isinstance(cfg, dict) else cfg):
        if name in params:
            ckwargs[name] = val
    if "K" in params:
        ckwargs.setdefault("K", K)
    if "vr_entbttlnck" in params:
        # the shipped VBR weights train the variable-step z bottleneck
        ckwargs.setdefault("vr_entbttlnck", True)
    model = cls(**ckwargs, seed=seed, device=device)
    if weights_path:
        load_weights(model, weights_path)
    return model


def image_models(architecture, quality=1, metric="mse", pretrained=False,
                 weights_path=None, **kwargs):
    """CompressAI-style zoo entry point (zoo/__init__.py:43-70).

    ``pretrained=True`` takes the weights of ``local_weights`` (the local
    stand-in for the reference's URLs); ``weights_path=`` loads any other
    local file."""
    if pretrained and weights_path is None:
        weights_path = _local_weights_path(architecture, quality, metric)
        if weights_path is None:
            raise RuntimeError(
                f"No shipped weights for ({architecture}, quality={quality}, "
                f"{metric}); available: "
                f"{sorted(str(k) for k in local_weights)}; or pass "
                "weights_path= with a local checkpoint")
    return create_model(architecture, quality, metric, weights_path, **kwargs)


# VBR models: one model spans the 8-lambda sweep (s = 0..7)
cfgs_vbr = {
    "bmshj2018-hyperprior-vbr": (192, 320),
    "mbt2018-mean-vbr": (192, 320),
}

# the video zoo (ssf2020): a quality is a checkpoint of one architecture
cfgs_video = {
    "ssf2020": {q: () for q in range(1, 10)},
}

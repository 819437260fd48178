"""Shared by tests/test_torch_port_image_models.py and
tests/test_torch_port_cheng_models.py: each image model built by JAX with
``nnx.Rngs(0)`` at the golden widths of tests/test_golden.py (N=32, M=48,
K=2, groups [8, 8, 32]), its parameters carried to the port through
``zoo.load_jax_params``, and the checks both files run on such a pair (see
their docstrings). ``vbr_pair`` builds the VBR models' pairs the same way
(tests/test_torch_port_vbr*.py)."""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

import flashgmm_tpu.models  # noqa: F401  (fills the JAX registry)
import flashgmm_tpu_torch.models  # noqa: F401  (fills the port's registry)
from flashgmm_tpu.registry import MODELS as J_MODELS
from flashgmm_tpu.runtime.rasterscan import \
    raster_scan_decompress_single_stream as j_raster_decode
from flashgmm_tpu_torch.registry import MODELS as T_MODELS
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(2)

EXPECTED = os.path.join(os.path.dirname(__file__), "expected")
ATOL = 5e-4  # x_hat, after g_s (measured: at most 1.6e-4, the attention)
RTOL_NET = 2e-4  # the likelihoods above 1e-6
RTOL_GOLDEN = 2e-3  # test_golden.py's
FLIPS = 0.01  # the share of y symbols that may differ from JAX's

RASTER = ("mbt2018", "cheng2020-anchor", "cheng2020-attn")


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


def _kwargs(cls):
    params = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in (("N", 32), ("M", 48), ("K", 2),
                              ("groups", [8, 8, 32])) if k in params}


_PAIRS = {}

# the VBR models: (architecture, vr_entbttlnck), and the (s, inputscale)
# levels their tests take
VBR_CASES = [("bmshj2018-hyperprior-vbr", False),
             ("bmshj2018-hyperprior-vbr", True),
             ("mbt2018-mean-vbr", False), ("mbt2018-mean-vbr", True),
             ("mbt2018-vbr", False)]
VBR_LEVELS = [(0, 0), (3, 0), (7, 0), (1, 1.6)]


def pair(arch, coder=None):
    """(JAX model, port model on its parameters), built once a module."""
    key = (arch, coder)
    if key not in _PAIRS:
        kw = _kwargs(J_MODELS[arch])
        if coder is not None:
            kw["coder"] = coder
        jm = J_MODELS[arch](**kw, rngs=nnx.Rngs(0))
        tm = T_MODELS[arch](**kw, device="cpu")
        tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
        _PAIRS[key] = (jm, tm.eval())
    return _PAIRS[key]


def vbr_pair(arch, vr=False):
    """(JAX VBR model, port model on its parameters) at N=32, M=48,
    ``vr_entbttlnck=vr`` where the architecture has it; built once a
    module."""
    key = ("vbr", arch, vr)
    if key not in _PAIRS:
        cls = J_MODELS[arch]
        kw = {"vr_entbttlnck": vr} \
            if "vr_entbttlnck" in inspect.signature(cls.__init__).parameters \
            else {}
        jm = cls(32, 48, rngs=nnx.Rngs(0), **kw)
        tm = T_MODELS[arch](32, 48, device="cpu", **kw)
        tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
        _PAIRS[key] = (jm, tm.eval())
    return _PAIRS[key]


def _golden_image():
    return np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)


def check_eval_forward(arch):
    jm, tm = pair(arch)
    x = _golden_image()
    jo = jm(jnp.asarray(x), training=False)
    with torch.no_grad():
        to = tm(torch.from_numpy(x), training=False)
    np.testing.assert_allclose(to["x_hat"].numpy(), np.asarray(jo["x_hat"]),
                               rtol=0, atol=ATOL)
    assert set(to["likelihoods"]) == set(jo["likelihoods"])
    for name, lk in to["likelihoods"].items():
        got, ref = lk.numpy(), np.asarray(jo["likelihoods"][name])
        assert got.shape == ref.shape, name
        mask = ref > 1e-6
        assert mask.mean() > 0.5, name
        np.testing.assert_allclose(got[mask], ref[mask], rtol=RTOL_NET,
                                   err_msg=name)

    bpp = sum(float(torch.sum(-torch.log2(lk)))
              for lk in to["likelihoods"].values()) / (64 * 64)
    mse = float(torch.mean((to["x_hat"] - torch.from_numpy(x)) ** 2))
    with open(os.path.join(EXPECTED, f"arch_ee_{arch}.json")) as f:
        expected = json.load(f)
    np.testing.assert_allclose(bpp, expected["bpp"], rtol=RTOL_GOLDEN)
    np.testing.assert_allclose(mse, expected["mse"], rtol=RTOL_GOLDEN)


def _jax_y_hat(arch, jm, out):
    """The y_hat JAX's decoder makes of JAX's compress output (its
    decompress up to g_s)."""
    strings, shape = out["strings"], out["shape"]
    if "y_hat" in out:  # the latent codecs' compress decodes it
        return np.asarray(out["y_hat"])
    eb = jm.entropy_bottleneck
    if arch == "bmshj2018-factorized":
        return np.asarray(eb.decompress(strings[0], shape))
    params = jm.h_s(eb.decompress(strings[1], shape))
    gc = jm.gaussian_conditional
    if arch in RASTER:
        pieces = jm._host_ar_pieces()
        h, w = shape[0] * 4, shape[1] * 4
        return np.stack([j_raster_decode(s, np.asarray(params)[i], *pieces,
                                         (h, w, jm.M))
                         for i, s in enumerate(strings[0])])
    if arch == "bmshj2018-hyperprior":
        return np.asarray(gc.decompress(strings[0], gc.build_indexes(params)))
    scales, means = jnp.split(params, 2, axis=-1)
    if jm.coder == "search":
        return np.asarray(gc.decompress_search(
            strings[0], jnp.clip(scales, 0.11, 256), out["abs_max"],
            means=means))
    return np.asarray(gc.decompress(strings[0], gc.build_indexes(scales),
                                    means=means))


_GC_TABLES = {}


def _update_jax(jm):
    """JAX's ``update(force=True)``, its GaussianConditionals' tables built
    once a process: each has the default scale table, so the first one's
    tables are every one's (JAX takes seconds a table set)."""
    from flashgmm_tpu.entropy_models import (EntropyBottleneck,
                                             GaussianConditional)
    from flashgmm_tpu.models.base import get_scale_table, iter_entropy_modules

    names = ("scale_table", "_quantized_cdf", "_offset", "_cdf_length")
    for m in iter_entropy_modules(jm):
        if isinstance(m, EntropyBottleneck):
            m.update(force=True)
        elif isinstance(m, GaussianConditional):
            if not _GC_TABLES:
                m.update_scale_table(get_scale_table(), force=True)
                _GC_TABLES.update((n, getattr(m, n).value) for n in names)
            for n in names:
                getattr(m, n).value = _GC_TABLES[n]


def check_reference_coding(arch, coder=None):
    jm, tm = pair(arch, coder)
    _update_jax(jm)
    tm.update(force=True)
    x = _golden_image()
    to = tm.compress(torch.from_numpy(x))
    kw = {"abs_max": to["abs_max"]} if "abs_max" in to else {}
    assert torch.equal(tm.decompress_y(to["strings"], to["shape"], **kw),
                       to["y_hat"])
    x_hat = tm.decompress(to["strings"], to["shape"], **kw)["x_hat"]
    assert x_hat.shape == (1, 64, 64, 3)
    assert float(x_hat.min()) >= 0.0 and float(x_hat.max()) <= 1.0

    jo = jm.compress(jnp.asarray(x))
    assert len(to["strings"]) == len(jo["strings"])
    if arch != "bmshj2018-factorized":  # z: the last strings
        assert to["strings"][-1] == jo["strings"][-1]
    if coder == "search":
        assert abs(to["abs_max"] - jo["abs_max"]) <= 1
    y_j = _jax_y_hat(arch, jm, jo)
    y_t = to["y_hat"].numpy()
    assert y_j.shape == y_t.shape
    flips = int((np.abs(y_j - y_t) > 0.5).sum())
    assert flips <= FLIPS * y_t.size, (flips, y_t.size)


def check_training_forward(arch):
    _, tm = pair(arch)
    x = torch.from_numpy(np.random.RandomState(8).rand(1, 64, 64, 3)
                         .astype(np.float32))
    outs = [tm(x, training=True, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    for name in ("y", "z"):
        assert torch.equal(outs[0]["likelihoods"][name],
                           outs[1]["likelihoods"][name])
    rate = sum(-torch.log2(v).sum() for v in outs[0]["likelihoods"].values())
    (rate / x[0, ..., 0].numel()
     + ((outs[0]["x_hat"] - x) ** 2).mean()).backward()
    grads = [p.grad for p in tm.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    for part in (tm.g_a, tm.h_s, tm.g_s):
        assert any(p.grad is not None and float(p.grad.abs().sum()) > 0
                   for p in part.parameters())
    tm.zero_grad(set_to_none=True)

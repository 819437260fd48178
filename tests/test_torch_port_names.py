"""Every public name of the JAX package has a counterpart in the port.

For each module of ``flashgmm_tpu/`` the port's module at the same path
under ``flashgmm_tpu_torch/`` must bind every public top-level name that the
JAX module defines: its functions, classes and assigned names, and, in an
``__init__.py``, the names it imports from inside its package (its
re-exports). The port's module may bind a name any way, an import
included. A name with no counterpart must be in ``NO_PORT`` with what does
its job in the port, and a module with no counterpart in
``NO_PORT_MODULES``. Both lists are held current: an entry the port now
binds, or a name the JAX package no longer has, fails.

AST only: neither package is imported, so the whole file takes about a
second.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "flashgmm_tpu"
PORT_ROOT = REPO / "flashgmm_tpu_torch"

_SUBPACKAGES = "subpackages import on use: import flashgmm_tpu_torch.<name>"
_NO_MESH = ("parallel.train_step on one card; the mesh serves only the TPU "
            "(ROADMAP §A)")
_NNX_FILTER = ("an nnx filter; optimizers/net_aux.py::net_aux_partition "
               "splits the parameters")
_TRANSFORM = ("layers.run_transform runs a transform; "
              "layers.route_bf16_kernel sends its convs to the bf16 kernel")
_STRICT_LOAD = ("zoo.load_npz, strict on purpose (ROADMAP §C, departures "
                "kept); zoo.save_npz_weights writes the format")
_DIVMOD = ("a TPU workaround for 32-bit division; ans/interleaved.py::"
           "divmod_rans and the CUDA coders divide natively")

# (module path under the package, name): what does its job in the port
NO_PORT = {
    **{("__init__.py", name): _SUBPACKAGES
       for name in ("datasets", "entropy_models", "latent_codecs", "layers",
                    "losses", "models", "ops", "optimizers", "registry",
                    "transforms", "zoo")},
    ("ans/__init__.py", "rans_numpy"):
        "flashgmm_tpu_torch.ans.rans_numpy, imported on use; the host coder "
        "never falls back to it",
    ("ans/__init__.py", "use_cext"):
        "no numpy fallback, on purpose: ans.cext builds or every call raises",
    ("ans/interleaved.py", "divmod_u32_u16"): _DIVMOD,
    ("ans/interleaved.py", "divmod_u32_u16_fast"): _DIVMOD,
    ("entropy_models/entropy_models.py", "QuantilesParam"): _NNX_FILTER,
    ("models/base.py", "iter_entropy_modules"):
        "the port walks self.modules()",
    ("parallel/__init__.py", "data_parallel_train_step"): _NO_MESH,
    ("parallel/__init__.py", "make_mesh"): _NO_MESH,
    ("parallel/__init__.py", "shard_batch"): _NO_MESH,
    ("parallel/train.py", "data_parallel_train_step"): _NO_MESH,
    ("parallel/train.py", "AUX_FILTER"): _NNX_FILTER,
    ("parallel/train.py", "NET_FILTER"): _NNX_FILTER,
    ("registry/registry.py", "T"): "a TypeVar of the annotations",
    ("runtime/fast_codec.py", "apply_transform"): _TRANSFORM,
    ("runtime/fast_codec.py", "conv_backend_ctx"): _TRANSFORM,
    ("runtime/fast_codec.py", "conv_ctx_wrap"): _TRANSFORM,
    ("zoo/__init__.py", "load_npz_weights"): _STRICT_LOAD,
    ("zoo/npz.py", "load_npz_weights"): _STRICT_LOAD,
}

# the JAX package's modules that serve only the TPU (ROADMAP §A)
NO_PORT_MODULES = {
    "ans/pallas_coder.py": "the CUDA rANS encoder and decoder, "
                           "ans/rans_kernels.py over csrc/rans_kernels.cu",
    "ops/pallas_conv.py": "the f32 and bf16 CUDA convs behind "
                          "ops/conv_kernel.py",
    "parallel/inference.py": "one H100 takes the batch whole; "
                             "runtime/tiled.py bounds a large decode's memory",
    "parallel/mesh.py": "one H100: no mesh",
    "runtime/latency_probe.py": "CUDA events (chip_smoke.cuda_ms) and "
                                "utils/profiler.py",
}

MODULES = sorted(str(p.relative_to(JAX_ROOT))
                 for p in JAX_ROOT.rglob("*.py"))


def _statements(body):
    """Top-level statements, those inside top-level if/try blocks too."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _statements(
                node.body + node.orelse + node.finalbody
                + [s for h in node.handlers for s in h.body])
        else:
            yield node


def _imported(node):
    return {(a.asname or a.name).split(".")[0] for a in node.names}


def _bound(path: Path, own_package: str = None):
    """Names a module binds at top level. With ``own_package`` (the JAX
    side) its imports count only in an ``__init__.py`` and only from inside
    the package; without it (the port side) every import counts."""
    names = set()
    for node in _statements(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            if own_package is None:
                names |= _imported(node)
            elif (path.name == "__init__.py"
                  and isinstance(node, ast.ImportFrom)
                  and (node.level > 0 or (node.module or "").split(".")[0]
                       == own_package)):
                names |= _imported(node)
    return names


def _public(names):
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_port(module):
    port = PORT_ROOT / module
    if module in NO_PORT_MODULES:
        assert NO_PORT_MODULES[module].strip()
        assert not port.exists(), (
            f"{module} has a port now: take it out of NO_PORT_MODULES")
        return
    assert port.exists(), f"{module}: no port and no NO_PORT_MODULES entry"
    missing = _public(_bound(JAX_ROOT / module, "flashgmm_tpu")) - _bound(port)
    unexplained = sorted(n for n in missing
                         if not NO_PORT.get((module, n), "").strip())
    assert not unexplained, (
        f"{module}: {unexplained} have no counterpart in the port and no "
        "reason in NO_PORT")


def test_no_port_list_is_current():
    stale = []
    for module, name in sorted(NO_PORT):
        if name not in _bound(JAX_ROOT / module, "flashgmm_tpu"):
            stale.append(f"{module}::{name} is gone from the JAX package")
        elif name in _bound(PORT_ROOT / module):
            stale.append(f"{module}::{name} has a port now")
    assert not stale, "; ".join(stale)
    assert len(MODULES) > 100

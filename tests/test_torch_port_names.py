"""Every public name of the JAX package has a counterpart in the port, and
every public method of a class both packages define.

For each module of ``flashgmm_tpu/`` the port's module at the same path
under ``flashgmm_tpu_torch/`` must bind every public top-level name that the
JAX module defines: its functions, classes and assigned names, and, in an
``__init__.py``, the names it imports from inside its package (its
re-exports). The port's module may bind a name any way, an import
included. A name with no counterpart must be in ``NO_PORT`` with what does
its job in the port, and a module with no counterpart in
``NO_PORT_MODULES``. Both lists are held current: an entry the port now
binds, or a name the JAX package no longer has, fails.

Methods: for each class the JAX package defines that the port defines
too (at the same module path, or by the same name anywhere in the port
when that name is unique there), the port's class must bind every public
method of the JAX class, each side's bases within its package included (a
class-level assignment binds a name on the port's side). A method with no
counterpart must be in ``NO_PORT_METHODS`` with its reason, held current as
``NO_PORT`` is.

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
    "runtime/latency_probe.py": "CUDA events (chip_smoke.cuda_ms) and "
                                "utils/profiler.py",
}

# (module path, "Class.method"): why the port's class has no such method
NO_PORT_METHODS = {
    ("runtime/latency_elic.py", "FastLatencyElicCodec.use_mesh"):
        "its CUDA graphs are one card's; FastElicGmmCodec.use_mesh codes "
        "batches over a mesh",
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


def _classes(root: Path):
    """{(module path, name): ClassDef} of a package's top-level classes."""
    return {(str(p.relative_to(root)), node.name): node
            for p in sorted(root.rglob("*.py"))
            for node in ast.parse(p.read_text()).body
            if isinstance(node, ast.ClassDef)}


JAX_CLASSES = _classes(JAX_ROOT)
PORT_CLASSES = _classes(PORT_ROOT)


def _find(classes, module, name):
    """The key of class ``name`` as seen from ``module``: the class there,
    else the package's only class of that name, else None (outside the
    package)."""
    if (module, name) in classes:
        return (module, name)
    found = [k for k in classes if k[1] == name]
    return found[0] if len(found) == 1 else None


def _methods(classes, key, assigned: bool):
    """The names a class binds in its body, its bases' within the package
    included: its functions, and with ``assigned`` its class-level
    assignments."""
    node = classes[key]
    names = set()
    for st in node.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(st.name)
        elif assigned and isinstance(st, ast.Assign):
            names |= {t.id for t in st.targets if isinstance(t, ast.Name)}
    for base in node.bases:
        name = base.id if isinstance(base, ast.Name) else getattr(
            base, "attr", None)
        base_key = name and _find(classes, key[0], name)
        if base_key and base_key != key:
            names |= _methods(classes, base_key, assigned)
    return names


SHARED_CLASSES = sorted(
    (key, port) for key in JAX_CLASSES
    if (port := _find(PORT_CLASSES, *key)) is not None)


@pytest.mark.parametrize("key,port", SHARED_CLASSES,
                         ids=[f"{k[0]}::{k[1]}" for k, _ in SHARED_CLASSES])
def test_every_public_method_has_a_port(key, port):
    module, name = key
    missing = _public(_methods(JAX_CLASSES, key, False)) \
        - _methods(PORT_CLASSES, port, True)
    unexplained = sorted(
        m for m in missing
        if not NO_PORT_METHODS.get((module, f"{name}.{m}"), "").strip())
    assert not unexplained, (
        f"{module}::{name}: methods {unexplained} have no counterpart in the "
        f"port's {port[0]}::{port[1]} and no reason in NO_PORT_METHODS")


def test_no_port_methods_list_is_current():
    stale = []
    for module, qual in sorted(NO_PORT_METHODS):
        name, method = qual.split(".")
        port = _find(PORT_CLASSES, module, name)
        if (module, name) not in JAX_CLASSES or method not in _methods(
                JAX_CLASSES, (module, name), False):
            stale.append(f"{module}::{qual} is gone from the JAX package")
        elif port is not None and method in _methods(PORT_CLASSES, port,
                                                     True):
            stale.append(f"{module}::{qual} has a port now")
    assert not stale, "; ".join(stale)
    assert len(SHARED_CLASSES) > 100

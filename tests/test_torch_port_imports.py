"""The port never imports JAX: neither its package nor chip_smoke.py.

Run in a fresh interpreter, importing every module of flashgmm_tpu_torch
and chip_smoke, then listing what got imported. The machine with the card
has no JAX, and importing anything under flashgmm_tpu imports it.
"""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import flashgmm_tpu_torch
for m in pkgutil.walk_packages(flashgmm_tpu_torch.__path__, "flashgmm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "flashgmm_tpu"))
print("MODULES:%d" % len([k for k in sys.modules if k.startswith("flashgmm_tpu_torch")]))
print("BAD:" + ",".join(bad))
"""


def test_port_and_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(":", 1) for line in out.stdout.splitlines()
                 if line.startswith(("MODULES:", "BAD:")))
    assert int(lines["MODULES"]) >= 20
    assert lines["BAD"] == "", f"JAX-side modules imported: {lines['BAD']}"


def test_smoke_refuses_without_a_card():
    """No CUDA device: chip_smoke exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT)})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("module", [
    "flashgmm_tpu_torch.zoo.torch_convert",
    "flashgmm_tpu_torch.models.base",
    "flashgmm_tpu_torch.entropy_models.entropy_models",
    "flashgmm_tpu_torch.models.elic_gmm",
    "flashgmm_tpu_torch.runtime.fast_elic",
    "flashgmm_tpu_torch.runtime.latency_elic",
    "flashgmm_tpu_torch.models.sensetime",
    "flashgmm_tpu_torch.models.waseda",
    "flashgmm_tpu_torch.latent_codecs.gaussian_conditional",
    "flashgmm_tpu_torch.runtime.fast_codec",
    "flashgmm_tpu_torch.ans",
    "flashgmm_tpu_torch.ans.cext",
    "flashgmm_tpu_torch.ans.gaussian_cdf",
    "flashgmm_tpu_torch.ans.rows_kernel",
    "flashgmm_tpu_torch.ans.pmf_to_cdf",
    "flashgmm_tpu_torch.entropy_models.xla_math",
    "flashgmm_tpu_torch.latent_codecs.gaussian_mixture_conditional",
    "flashgmm_tpu_torch.latent_codecs.checkerboard",
    "flashgmm_tpu_torch.latent_codecs.hyper",
    "flashgmm_tpu_torch.latent_codecs.hyperprior",
    "flashgmm_tpu_torch.latent_codecs.channel_groups",
    "flashgmm_tpu_torch.layers.layers",
    "flashgmm_tpu_torch.runtime.latency_codec",
    "flashgmm_tpu_torch._build",
])
def test_forward_and_converter_modules_import_no_jax(module):
    """The CompressAI state-dict converter, the training forward's modules,
    the ELIC model and codecs, the single-Gaussian models and codec, and
    the reference format's modules (the host coder's binding, the rows and
    softmax, the latent codecs' compress and decompress), each imported
    alone in a fresh interpreter."""
    probe = (f"import importlib, sys; importlib.import_module({module!r}); "
             "print(','.join(sorted(k for k in sys.modules if k.split('.')[0] "
             "in ('jax', 'jaxlib', 'flax', 'flashgmm_tpu'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout

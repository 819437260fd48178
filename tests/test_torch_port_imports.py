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
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "flashgmm_tpu"))
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
    "flashgmm_tpu_torch.registry",
    "flashgmm_tpu_torch.losses.rate_distortion",
    "flashgmm_tpu_torch.losses.utils",
    "flashgmm_tpu_torch.utils.metrics",
    "flashgmm_tpu_torch.utils.checkpoint",
    "flashgmm_tpu_torch.utils.logging",
    "flashgmm_tpu_torch.optimizers",
    "flashgmm_tpu_torch.parallel.train",
    "flashgmm_tpu_torch.datasets.image",
    "flashgmm_tpu_torch.datasets.loader",
    "flashgmm_tpu_torch.datasets.utils",
    "flashgmm_tpu_torch.examples.train",
    "flashgmm_tpu_torch.models.google",
    "flashgmm_tpu_torch.models.chandelier",
    "flashgmm_tpu_torch.models.sigmoidkernel",
    "flashgmm_tpu_torch.latent_codecs.base",
    "flashgmm_tpu_torch.latent_codecs.entropy_bottleneck",
    "flashgmm_tpu_torch.latent_codecs.rasterscan",
    "flashgmm_tpu_torch.runtime.rasterscan",
    "flashgmm_tpu_torch.zoo.image",
    "flashgmm_tpu_torch.utils.eval_model.__main__",
    "flashgmm_tpu_torch.utils.update_model.__main__",
    "flashgmm_tpu_torch.entropy_models.entropy_models_vbr",
    "flashgmm_tpu_torch.latent_codecs.gain",
    "flashgmm_tpu_torch.latent_codecs.gain.hyper",
    "flashgmm_tpu_torch.latent_codecs.gain.hyperprior",
    "flashgmm_tpu_torch.models.vbr",
    "flashgmm_tpu_torch.transforms",
    "flashgmm_tpu_torch.transforms.functional",
    "flashgmm_tpu_torch.transforms.transforms",
    "flashgmm_tpu_torch.models.video",
    "flashgmm_tpu_torch.models.video.google",
    "flashgmm_tpu_torch.datasets.rawvideo",
    "flashgmm_tpu_torch.datasets.video",
    "flashgmm_tpu_torch.examples.train_video",
    "flashgmm_tpu_torch.utils.video",
    "flashgmm_tpu_torch.utils.video.eval_model",
    "flashgmm_tpu_torch.utils.video.eval_model.__main__",
    "flashgmm_tpu_torch.layers.pointcloud",
    "flashgmm_tpu_torch.layers.pointcloud.pointnet",
    "flashgmm_tpu_torch.layers.pointcloud.pointnet2",
    "flashgmm_tpu_torch.layers.pointcloud.hrtzxf2022",
    "flashgmm_tpu_torch.models.pointcloud",
    "flashgmm_tpu_torch.models.pointcloud.hrtzxf2022",
    "flashgmm_tpu_torch.models.pointcloud.sfu_pointnet",
    "flashgmm_tpu_torch.models.pointcloud.sfu_pointnet2",
    "flashgmm_tpu_torch.losses.pointcloud",
    "flashgmm_tpu_torch.transforms.point",
    "flashgmm_tpu_torch.datasets.pointcloud",
    "flashgmm_tpu_torch.examples.train_pointcloud",
])
def test_forward_and_converter_modules_import_no_jax(module):
    """The CompressAI state-dict converter, the training forward's modules,
    the ELIC model and codecs, the single-Gaussian models and codec, and
    the reference format's modules (the host coder's binding, the rows and
    softmax, the latent codecs' compress and decompress), and the training
    path's (losses, metrics, optimizers, the train step, datasets,
    checkpoints, logging and the trainer CLI), the image-model line's
    (the models, the raster scan, the zoo and the evaluation CLIs), and the
    variable-bitrate line's (the VBR entropy models, the gain codecs and
    the VBR models), and the video line's (the colour transforms, ssf2020,
    the video datasets, the video trainer and the video evaluation CLI),
    and the point-cloud line's (the layers, the four codecs, the losses,
    the point transforms and datasets, and the point-cloud trainer), each
    imported alone in a fresh interpreter."""
    probe = (f"import importlib, sys; importlib.import_module({module!r}); "
             "print(','.join(sorted(k for k in sys.modules if k.split('.')[0] "
             "in ('jax', 'jaxlib', 'flax', 'optax', 'flashgmm_tpu'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


LAST_MODULES = [
    "flashgmm_tpu_torch",
    "flashgmm_tpu_torch.typing",
    "flashgmm_tpu_torch.layers.basic",
    "flashgmm_tpu_torch.ans.rans_numpy",
    "flashgmm_tpu_torch.ans.range_coder",
    "flashgmm_tpu_torch.runtime.tiled",
    "flashgmm_tpu_torch.standalone",
    "flashgmm_tpu_torch.standalone.export",
    "flashgmm_tpu_torch.standalone.format",
    "flashgmm_tpu_torch.standalone.build",
    "flashgmm_tpu_torch.standalone.__main__",
    "flashgmm_tpu_torch.examples.codec",
    "flashgmm_tpu_torch.zoo.torch_export",
    "flashgmm_tpu_torch.utils.profiler",
    "flashgmm_tpu_torch.utils.bench",
    "flashgmm_tpu_torch.utils.bench.codecs",
    "flashgmm_tpu_torch.utils.bench.__main__",
    "flashgmm_tpu_torch.utils.find_close.__main__",
    "flashgmm_tpu_torch.utils.plot.__main__",
    "flashgmm_tpu_torch.utils.video.bench.__main__",
    "flashgmm_tpu_torch.utils.video.plot.__main__",
]

# the last public names (ROADMAP A8), each where the JAX package exports it
LAST_NAMES = [
    ("flashgmm_tpu_torch.zoo", "save_npz_weights"),
    ("flashgmm_tpu_torch.zoo.npz", "save_npz_weights"),
    ("flashgmm_tpu_torch.layers", "GDN1"),
    ("flashgmm_tpu_torch.layers.gdn", "GDN1"),
    ("flashgmm_tpu_torch.layers", "SpectralConv2d"),
    ("flashgmm_tpu_torch.layers", "SpectralConvTranspose2d"),
    ("flashgmm_tpu_torch.layers", "leaky_relu"),
    ("flashgmm_tpu_torch.datasets.synthetic", "make_pool"),
    ("flashgmm_tpu_torch.datasets.synthetic", "random_crop"),
    ("flashgmm_tpu_torch.models", "get_scale_table"),
    ("flashgmm_tpu_torch.ans.gaussian_cdf", "gaussian_cdf"),
    ("flashgmm_tpu_torch.ans.gaussian_cdf", "MAX_CDF_VALUE"),
    ("flashgmm_tpu_torch.ans.interleaved", "M_TOTAL"),
]


def test_last_modules_import_no_jax():
    """The last modules (the entropy-coder registry, the numpy coders,
    tiled synthesis, the standalone codec's export, bitstream and build,
    the .fgm CLI, the state-dict export, the profiler and the host tool
    CLIs), then the last public names (``LAST_NAMES``), imported one after
    another in a fresh interpreter, each followed by a look at what got
    imported."""
    probe = ("import importlib, sys\n"
             "def bad():\n"
             "    return ','.join(sorted(k for k in sys.modules if "
             "k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', "
             "'flashgmm_tpu')))\n"
             f"for m in {LAST_MODULES!r}:\n"
             "    importlib.import_module(m)\n"
             "    print(m, bad())\n"
             f"for m, name in {LAST_NAMES!r}:\n"
             "    getattr(importlib.import_module(m), name)\n"
             "    print(m, name, bad())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")[:len(LAST_MODULES) + len(LAST_NAMES)]
    assert lines == [f"{m} " for m in LAST_MODULES] + [
        f"{m} {name} " for m, name in LAST_NAMES], out.stdout

CLI_PROBE = """
import os, runpy, sys, tempfile
import numpy as np
d = tempfile.mkdtemp()
from flashgmm_tpu_torch.datasets import save_image
save_image(os.path.join(d, "a.ppm"), np.full((64, 64, 3), 0.5, np.float32))
sys.argv = ["eval_model", "random", d, "-a", "bmshj2018-hyperprior", "-N", "8",
            "-M", "8", "--real", "--device", "cpu"]
try:
    runpy.run_module("flashgmm_tpu_torch.utils.eval_model", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
from flashgmm_tpu_torch.models import ScaleHyperprior
from flashgmm_tpu_torch.utils.checkpoint import save_checkpoint
save_checkpoint(os.path.join(d, "ckpt"), ScaleHyperprior(8, 8, device="cpu"))
sys.argv = ["update_model", os.path.join(d, "ckpt"), "-a",
            "bmshj2018-hyperprior", "-N", "8", "-M", "8", "--device", "cpu"]
try:
    runpy.run_module("flashgmm_tpu_torch.utils.update_model", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print("BAD:" + ",".join(sorted(k for k in sys.modules if k.split(".")[0]
                               in ("jax", "jaxlib", "flax", "optax", "flashgmm_tpu"))))
"""


def test_eval_and_update_clis_run_without_jax():
    """``python -m flashgmm_tpu_torch.utils.eval_model`` and ``...
    .update_model`` run to their end on the CPU (as ``-m`` runs them) in a
    fresh interpreter, importing no JAX-side module."""
    out = subprocess.run([sys.executable, "-c", CLI_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"bpp"' in out.stdout and "Saved updated model" in out.stdout
    bad = [line for line in out.stdout.splitlines() if line.startswith("BAD:")]
    assert bad == ["BAD:"], bad


VIDEO_CLI_PROBE = """
import os, runpy, sys, tempfile
import numpy as np
d = tempfile.mkdtemp()
path = os.path.join(d, "flat_128x128_30fps_420_8bit.yuv")
np.full(128 * 128 * 3 // 2, 128, np.uint8).tofile(path)
sys.argv = ["eval_model", path, "-f", "1", "--real", "--device", "cpu"]
try:
    runpy.run_module("flashgmm_tpu_torch.utils.video.eval_model",
                     run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print("BAD:" + ",".join(sorted(k for k in sys.modules if k.split(".")[0]
                               in ("jax", "jaxlib", "flax", "optax", "flashgmm_tpu"))))
"""


def test_video_eval_cli_runs_without_jax():
    """``python -m flashgmm_tpu_torch.utils.video.eval_model`` runs to its
    end on the CPU (as ``-m`` runs it; one seed-initialised keyframe of a
    flat 128x128 sequence, really coded) in a fresh interpreter, importing
    no JAX-side module."""
    out = subprocess.run([sys.executable, "-c", VIDEO_CLI_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"bpp"' in out.stdout and '"real coding"' not in out.stdout
    assert "ssf2020 real coding" in out.stdout
    bad = [line for line in out.stdout.splitlines() if line.startswith("BAD:")]
    assert bad == ["BAD:"], bad


CODEC_CLI_PROBE = """
import os, runpy, sys, tempfile
import numpy as np
d = tempfile.mkdtemp()
from flashgmm_tpu_torch.datasets import save_image
save_image(os.path.join(d, "a.ppm"), np.full((64, 64, 3), 0.5, np.float32))
w = os.path.join("weights", "factorized_n128_m192_synthetic.npz")
for argv in (["encode", os.path.join(d, "a.ppm"), "-o", os.path.join(d, "a.fgm"),
              "-a", "bmshj2018-factorized", "--weights", w, "--device", "cpu"],
             ["decode", os.path.join(d, "a.fgm"), "-o", os.path.join(d, "b.ppm"),
              "--weights", w, "--device", "cpu"]):
    sys.argv = ["codec"] + argv
    try:
        runpy.run_module("flashgmm_tpu_torch.examples.codec", run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
assert os.path.getsize(os.path.join(d, "b.ppm")) == 64 * 64 * 3 + 13
print("BAD:" + ",".join(sorted(k for k in sys.modules if k.split(".")[0]
                               in ("jax", "jaxlib", "flax", "optax", "flashgmm_tpu"))))
"""


def test_codec_cli_runs_without_jax():
    """``python -m flashgmm_tpu_torch.examples.codec`` encodes and decodes a
    .fgm file on the CPU (as ``-m`` runs it) in a fresh interpreter,
    importing no JAX-side module."""
    out = subprocess.run([sys.executable, "-c", CODEC_CLI_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "bpp)" in out.stdout and "decoded" in out.stdout
    bad = [line for line in out.stdout.splitlines() if line.startswith("BAD:")]
    assert bad == ["BAD:"], bad

"""The port's evaluation CLIs and zoo against the JAX package's, on the CPU.

- eval_model: both CLIs' ``main(argv)`` over one temporary directory of
  two 64x64 binary PPMs (textured leaves), from a ``.pth`` that JAX's
  ``zoo/torch_export.export_torch_state_dict`` writes of a model built
  with ``nnx.Rngs(0)`` (the ``torch`` source; the port with ``--device
  cpu``). With ``--real`` the reports agree within 1 % in bpp, 0.05 dB in
  PSNR and 1e-3 in MS-SSIM; in entropy estimation the bpp within 1e-3
  relative (the same PSNR and MS-SSIM bounds).
- update_model: the file it writes reloads into a fresh model that codes
  the same bytes as the updated model it was made from.
- zoo: ``image_models("mbt2018-mean", 3, pretrained=True)`` loads
  weights/mshp_n128_m192_synthetic.npz in both packages, and the eval
  forwards agree within ATOL.
"""

import contextlib
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import flashgmm_tpu.models  # noqa: F401  (fills the JAX registry)
from flashgmm_tpu.registry import MODELS as J_MODELS
from flashgmm_tpu.utils.eval_model.__main__ import main as j_eval_main
from flashgmm_tpu.zoo.torch_export import export_torch_state_dict
from flashgmm_tpu_torch.datasets import save_image, textured_leaves
from flashgmm_tpu_torch.utils.checkpoint import save_checkpoint
from flashgmm_tpu_torch.utils.eval_model.__main__ import main as t_eval_main
from flashgmm_tpu_torch.utils.update_model.__main__ import main as t_update_main

torch.set_num_threads(2)

ATOL = 5e-4  # the zoo's eval forwards' x_hat
WIDTHS = {"mbt2018-mean": ["-N", "32", "-M", "48"],
          "bmshj2018-factorized": ["-N", "32", "-M", "48"]}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    for seed in (500002, 500003):
        save_image(d / f"leaves_{seed}.ppm", textured_leaves(64, 64, seed=seed))
    return d


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{arch: .pth file} of JAX models at N=32, M=48, nnx.Rngs(0)."""
    d = tmp_path_factory.mktemp("pth")
    out = {}
    for arch in WIDTHS:
        jm = J_MODELS[arch](N=32, M=48, rngs=nnx.Rngs(0))
        sd = {k: torch.from_numpy(np.array(v))
              for k, v in export_torch_state_dict(jm).items()}
        out[arch] = d / f"{arch}.pth"
        torch.save(sd, out[arch])
    return out


def _report(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("arch,real", [("mbt2018-mean", True),
                                       ("mbt2018-mean", False),
                                       ("bmshj2018-factorized", True)])
def test_eval_cli_reports_agree_with_jax(images, exported, arch, real):
    argv = ["torch", str(images), "-a", arch, *WIDTHS[arch], "-p",
            str(exported[arch])] + (["--real"] if real else [])
    ref = _report(j_eval_main, argv)
    got = _report(t_eval_main, argv + ["--device", "cpu"])
    assert got["name"] == ref["name"] == arch
    assert got["description"] == ref["description"]
    assert set(got["results"]) == set(ref["results"])
    r, g = ref["results"], got["results"]
    np.testing.assert_allclose(g["bpp"], r["bpp"], rtol=1e-2 if real else 1e-3)
    assert abs(g["psnr-rgb"] - r["psnr-rgb"]) <= 0.05
    assert abs(g["ms-ssim-rgb"] - r["ms-ssim-rgb"]) <= 1e-3


def test_update_cli_file_codes_the_same_bytes(images, tmp_path):
    from flashgmm_tpu_torch.datasets import load_image
    from flashgmm_tpu_torch.models import MeanScaleHyperprior

    model = MeanScaleHyperprior(32, 48, seed=4, device="cpu").eval()
    src = tmp_path / "mshp"
    save_checkpoint(src, model)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_update_main([str(src), "-a", "mbt2018-mean", "-N", "32",
                              "-M", "48", "--device", "cpu"]) == 0
    written = [p for p in tmp_path.iterdir()
               if p.name.startswith("mshp-") and len(p.name) == len("mshp-") + 8]
    assert len(written) == 1 and str(written[0]) in buf.getvalue()

    model.update(force=True, update_quantiles=True)
    fresh = MeanScaleHyperprior(32, 48, seed=9, device="cpu").eval()
    from flashgmm_tpu_torch.utils.checkpoint import load_checkpoint

    load_checkpoint(written[0], fresh)
    x = torch.from_numpy(load_image(sorted(images.iterdir())[0]))[None]
    a, b = model.compress(x), fresh.compress(x)
    assert a["strings"] == b["strings"]


def test_zoo_loads_the_same_weights_in_both_packages():
    from flashgmm_tpu.zoo import image_models as j_image_models
    from flashgmm_tpu_torch.zoo import image_models, models

    assert models is image_models
    jm = j_image_models("mbt2018-mean", 3, pretrained=True)
    tm = image_models("mbt2018-mean", 3, pretrained=True, device="cpu").eval()
    assert (tm.N, tm.M) == (jm.N, jm.M) == (128, 192)
    x = textured_leaves(64, 64, seed=500001)[None]
    jo = jm(jnp.asarray(x), training=False)
    with torch.no_grad():
        to = tm(torch.from_numpy(x), training=False)
    np.testing.assert_allclose(to["x_hat"].numpy(), np.asarray(jo["x_hat"]),
                               rtol=0, atol=ATOL)
    for name in ("y", "z"):
        ref = np.asarray(jo["likelihoods"][name])
        mask = ref > 1e-6
        np.testing.assert_allclose(to["likelihoods"][name].numpy()[mask],
                                   ref[mask], rtol=2e-4)


def test_zoo_refuses_unknown_slots():
    from flashgmm_tpu_torch.zoo import create_model, image_models

    with pytest.raises(ValueError):
        create_model("no-such-model", 1, device="cpu")
    with pytest.raises(ValueError):
        create_model("mbt2018-mean", 9, device="cpu")
    with pytest.raises(RuntimeError):
        image_models("mbt2018", 1, pretrained=True, device="cpu")
    assert Path(__file__).resolve().parents[1].joinpath(
        "weights", "mshp_n128_m192_q4.npz").exists()

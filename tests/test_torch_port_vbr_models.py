"""The three VBR models of the port against the JAX package's, on the CPU:
bmshj2018-hyperprior-vbr and mbt2018-mean-vbr (each with
``vr_entbttlnck`` off and on) and mbt2018-vbr, built by JAX with
``nnx.Rngs(0)`` at N=32, M=48 and carried to the port through
``zoo.load_jax_params`` (tests/torch_port_model_pairs.py's ``vbr_pair``),
at the gain levels s in {0, 3, 7} and at ``inputscale=1.6``. Reference
coding is in test_torch_port_vbr_coding.py. Held, on a 64x64 image from
``np.random.RandomState``:

- the stage-1 and stage-2 eval forwards: x_hat within ATOL (5e-4) of JAX's,
  each likelihood above 1e-6 within RTOL_NET (2e-4);
- the coding z step ``_zqstep`` and mbt2018-vbr's context shift
  ``_ctx_scl``, at the 8 gains and 40 scales in [0.05, 4]: equal to JAX's
  bit for bit;
- stage-1 coding through the base model's compress and decompress;
- the zoo: ``image_models("mbt2018-mean-vbr", 1, pretrained=True)`` loads
  the shipped weights strictly in both packages, and their stage-2 eval
  forwards at s=7 agree within ATOL on one 64x64 image.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_port_model_pairs import (ATOL, RTOL_NET, VBR_CASES, VBR_LEVELS,
                                    jax_params, vbr_pair)

torch.set_num_threads(2)

def _image(seed=7, hw=64):
    return np.random.RandomState(seed).rand(1, hw, hw, 3).astype(np.float32)


def _check_forward(jo, to):
    np.testing.assert_allclose(to["x_hat"].numpy(), np.asarray(jo["x_hat"]),
                               rtol=0, atol=ATOL)
    assert set(to["likelihoods"]) == set(jo["likelihoods"]) == {"y", "z"}
    for name, lk in to["likelihoods"].items():
        got, ref = lk.numpy(), np.asarray(jo["likelihoods"][name])
        assert got.shape == ref.shape, name
        mask = ref > 1e-6
        assert mask.mean() > 0.5, name
        np.testing.assert_allclose(got[mask], ref[mask], rtol=RTOL_NET,
                                   err_msg=name)


@pytest.mark.parametrize("arch,vr", VBR_CASES)
def test_eval_forwards_match_jax(arch, vr):
    jm, tm = vbr_pair(arch, vr)
    x = _image()
    with torch.no_grad():
        _check_forward(jm(jnp.asarray(x), training=False, stage=1),
                       tm(torch.from_numpy(x), training=False, stage=1))
        for s, inputscale in VBR_LEVELS:
            _check_forward(
                jm(jnp.asarray(x), training=False, stage=2, s=s,
                   inputscale=jnp.float32(inputscale) if inputscale else 0),
                tm(torch.from_numpy(x), training=False, stage=2, s=s,
                   inputscale=inputscale))


@pytest.mark.parametrize("arch,vr", [c for c in VBR_CASES if c[1]]
                         + [("mbt2018-vbr", False)])
def test_zqstep_and_ctx_scl_equal_jax_bitwise(arch, vr):
    jm, tm = vbr_pair(arch, vr)
    gains = np.asarray(jm.Gain.value)
    assert np.array_equal(tm.Gain.detach().numpy(), gains)
    scales = list(gains) + [np.float32(v) for v in
                            np.random.RandomState(3).uniform(0.05, 4, 40)]
    for scale in scales:
        scale = np.float32(scale)
        if vr:
            j_qs = float(np.asarray(jm._zqstep(jnp.asarray(scale))))
            assert tm._zqstep(torch.tensor(scale)) == j_qs, scale
        else:
            j_ctx = np.asarray(jm.scale_to_context(
                jnp.asarray([[1.0 / float(scale)]], jnp.float32))).reshape(-1)
            np.testing.assert_array_equal(tm._ctx_scl(float(scale)), j_ctx,
                                          err_msg=str(scale))


def test_stage1_coding_is_the_base_model():
    """stage=1 codes through the base model's compress and decompress."""
    _, tm = vbr_pair("mbt2018-mean-vbr", False)
    tm.update(force=True)
    x = torch.from_numpy(_image(seed=12))
    out = tm.compress(x, stage=1)
    assert torch.equal(tm.decompress_y(out["strings"], out["shape"], stage=1),
                       out["y_hat"])
    assert tm.decompress(out["strings"], out["shape"],
                         stage=1)["x_hat"].shape == (1, 64, 64, 3)


def test_zoo_shipped_vbr_weights_load_strictly_and_agree():
    from flashgmm_tpu.zoo import image_models as j_image_models
    from flashgmm_tpu_torch.zoo import cfgs, cfgs_vbr, image_models

    assert cfgs["mbt2018-mean-vbr"] == {1: (192, 320)}
    assert set(cfgs_vbr) == {"bmshj2018-hyperprior-vbr", "mbt2018-mean-vbr"}
    jm = j_image_models("mbt2018-mean-vbr", 1, pretrained=True)
    tm = image_models("mbt2018-mean-vbr", 1, pretrained=True,
                      device="cpu").eval()
    assert tm.vr_entbttlnck and jm.vr_entbttlnck
    with np.load(Path(__file__).resolve().parents[1] / "weights"
                 / "mshp_vbr_n192_m320_synthetic.npz") as data:
        keys = set(data.files)
    assert set(jax_params(jm)) == keys  # every parameter in the file
    assert len(tm.state_dict()) == len(keys)
    # Gain as stored (float16), not VBR_GAINS
    assert float(tm.Gain[1]) == float(np.float16(0.13944))
    x = _image(seed=5)
    with torch.no_grad():
        to = tm(torch.from_numpy(x), training=False, stage=2, s=7)
    jo = jm(jnp.asarray(x), training=False, stage=2, s=7)
    np.testing.assert_allclose(to["x_hat"].numpy(), np.asarray(jo["x_hat"]),
                               rtol=0, atol=ATOL)

"""The port held against the reference PyTorch network itself:
``tests/expected/reference/model_interop_ckbd.npz`` holds the reference
``Cheng2020AnchorCheckerboardGMMv2`` (N=64, K=4) state dict (``sd/*``) and
the tensors of each stage of its compress/decompress on one 256x384 image.
The port loads that state dict through ``zoo/torch_convert.py`` and
reproduces the stages, as tests/test_model_interop.py holds the JAX
package (the file is NCHW; the port is NHWC):

- z = h_a(g_a(x)) within 1e-3, with round(z - medians) equal (the coding
  contract);
- each checkerboard pass's GMM parameters (scales, means, softmaxed
  weights) within atol 2e-5, pass 1 conditioned on the file's pass-0 y_hat
  so that no rounding can cascade (measured, torch 2.13 CPU: at most
  2.7e-6);
- the file's x_hat from its y_hat through g_s, clamped to [0, 1], within
  1e-3 (measured 2.0e-4).

The file is not copied to the machine with the card, so this is a CPU
test only.
"""

import os

import numpy as np
import pytest
import torch

from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2
from flashgmm_tpu_torch.zoo.torch_convert import (load_torch_state_dict,
                                                  rename_legacy_keys,
                                                  torch_path)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "expected", "reference",
                      "model_interop_ckbd.npz")
PARAMS_ATOL = 2e-5


def nhwc(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1))))


def nchw(t):
    return np.transpose(t.detach().numpy(), (0, 3, 1, 2))


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("model interop goldens not recorded")
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def model(golden):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd/")}
    m = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, device="cpu")
    unused = load_torch_state_dict(m, sd)
    # what the port does not take: the GDN reparametrizations' constants,
    # the lower bounds' constants, and the GMM conditional's scale table
    # and tables (ROADMAP items 8 and 9)
    assert all(k.endswith(("pedestal", ".bound")) or "gaussian_mixture" in k
               for k in unused), unused
    return m


def test_every_parameter_comes_from_the_checkpoint(golden):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd/")}
    m = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, device="cpu")
    for p in m.parameters():
        torch.nn.init.constant_(p, float("nan"))
    load_torch_state_dict(m, sd)
    assert all(bool(torch.isfinite(p).all()) for p in m.parameters())
    eb = m.latent_codec.latent_codec["hyper"].entropy_bottleneck
    np.testing.assert_array_equal(
        eb.quantized_cdf.numpy(),
        sd["latent_codec.hyper.entropy_bottleneck._quantized_cdf"])
    # strict: a missing parameter raises
    del sd["g_a.0.conv1.weight"]
    with pytest.raises(KeyError, match="g_a.0.conv1.weight"):
        load_torch_state_dict(m, sd)


def test_key_mapping():
    assert torch_path("g_a.layers.0.conv1") == "g_a.0.conv1"
    assert torch_path("latent_codec.latent_codec.y.latent_codec.y."
                      "gaussian_mixture_conditional") == \
        "latent_codec.y.y.gaussian_mixture_conditional"
    assert rename_legacy_keys({"module.eb._biases.2": 1,
                               "eb._matrices.0": 2}) == {"eb._bias2": 1,
                                                         "eb._matrix0": 2}


def test_analysis_and_hyper(golden, model):
    with torch.no_grad():
        y = model.g_a(nhwc(golden["x"]))
        z = model.latent_codec.latent_codec["hyper"].h_a(y)
    med = golden["sd/latent_codec.hyper.entropy_bottleneck.quantiles"][:, 0, 1]
    med = med[None, :, None, None]
    assert np.array_equal(np.round(golden["z"] - med), np.round(nchw(z) - med))
    assert np.abs(golden["z"] - nchw(z)).max() < 1e-3


@pytest.mark.parametrize("i", [0, 1])
def test_pass_parameters(golden, model, i):
    lc = model.latent_codec.latent_codec
    ckbd = lc["y"]
    gmm = ckbd.latent_codec["y"]
    with torch.no_grad():
        side = ckbd.unembed(lc["hyper"].h_s(nhwc(golden["z_hat"])))[i]
        if i == 0:
            ctx = torch.zeros(side.shape[:-1] + (2 * 64,))
        else:
            y0 = nhwc(golden["pass0/y_hat"])
            ctx = ckbd.unembed(ckbd.context_prediction(ckbd.embed(
                torch.stack([y0, torch.zeros_like(y0)]))))[1]
        params = ckbd.entropy_parameters(ckbd.merge(ctx, side))
        scales, means, weights = gmm._chunk(params)
        weights = gmm._reshape_gmm_weight(weights)
    for name, got in (("scales", scales), ("means", means),
                      ("weights", weights)):
        ref = golden[f"pass{i}/{name}"]
        np.testing.assert_allclose(nchw(got), ref, atol=PARAMS_ATOL, rtol=0,
                                   err_msg=f"pass {i} {name}")


def test_synthesis(golden, model):
    with torch.no_grad():
        x_hat = torch.clamp(model.g_s(nhwc(golden["y_hat"])), 0.0, 1.0)
    assert np.abs(nchw(x_hat) - golden["x_hat"]).max() < 1e-3

"""The port's ELIC held against the reference PyTorch network itself:
``tests/expected/reference/model_interop_elic.npz`` holds the reference
``Elic2022GMM`` (N=64, M=160, K=4, groups [16, 16, 32, 64, 32]) state dict
(``sd/*``) and the tensors of each stage of its compress on one 256x384
image, with each of its ten passes' GMM parameters and symbols. The port
loads that state dict through ``zoo/torch_convert.py`` (the channel groups'
``latent_codec`` level kept, the transposed convs' weights as stored) and
reproduces, on the CPU (the file is NCHW; the port is NHWC):

- each pass's GMM parameters (scales clamped as the codec clamps them,
  means, softmaxed weights) through the batched codec's own rows-chain
  stages (h_s's transposed convs as zero-inserted "same" convs, the channel
  and spatial contexts and the aggregation networks through the conv
  kernel's plain version), from the file's z_hat, each pass conditioned on
  the file's symbols so that no rounding can cascade: within atol 1e-4
  (measured, torch 2.13 CPU: at most 3.2e-6);
- z = h_a(g_a(x)) within 1e-3 with round(z - medians) equal, and the
  file's x_hat from its y_hat through g_s within 1e-3.

The file is not copied to the machine with the card, so this is a CPU
test only.
"""

import os

import numpy as np
import pytest
import torch

from flashgmm_tpu_torch.layers import run_canonical
from flashgmm_tpu_torch.models import Elic2022GMM
from flashgmm_tpu_torch.runtime import FastElicGmmCodec
from flashgmm_tpu_torch.zoo.torch_convert import load_torch_state_dict

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "expected", "reference",
                      "model_interop_elic.npz")
GOLDEN_ATOL = 1e-4


def _nhwc(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1))))


@pytest.fixture(scope="module")
def reference():
    """The reference ELIC (N=64, M=160, K=4) loaded from its state dict, its
    codec, and the golden file."""
    if not os.path.exists(GOLDEN):
        pytest.skip("model interop goldens not recorded")
    golden = np.load(GOLDEN)
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd/")}
    m = Elic2022GMM(N=64, M=160, K=4, device="cpu")
    unused = load_torch_state_dict(m, sd)
    assert all(k.endswith(("pedestal", ".bound")) or "gaussian_mixture" in k
               for k in unused), unused
    return m, FastElicGmmCodec(m, lanes=64, bf16_transforms=False), golden


@pytest.fixture(scope="module")
def reference_params(reference):
    """Each pass's GMM parameters through the codec's rows-chain stages,
    from the file's z_hat, each pass conditioned on the file's symbols."""
    m, codec, golden = reference
    syms = [_nhwc(golden[f"pass{i}/y_hat"]).round().to(torch.int32)
            for i in range(int(golden["n_passes"]))]
    out = []
    with torch.no_grad():
        h_s = m.latent_codec.latent_codec["hyper"].h_s
        side_all = run_canonical(h_s, _nhwc(golden["z_hat"]))
        for k, ckbd in enumerate(codec._ckbds):
            side = ckbd.unembed(codec._ctxparams(side_all, syms[:2 * k], k))
            out.append(codec._pass_params(k, side[0]))
            out.append(codec._pass_params(k, side[1], syms[2 * k]))
    return out


@pytest.mark.parametrize("i", range(10))
def test_reference_pass_parameters(reference, reference_params, i):
    _, _, golden = reference
    got = reference_params[i]
    for name, g in zip(("scales", "means", "weights"), got):
        r = _nhwc(golden[f"pass{i}/{name}"])  # [1, h, w/2, K * g]
        b, h, w2, km = r.shape
        r = r.reshape(b, h, w2, 4, km // 4).transpose(3, 4).reshape(-1, 4)
        if name == "scales":
            r = torch.clamp(r, 0.11, 256.0)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=GOLDEN_ATOL,
                                   err_msg=f"pass {i} {name}")


def test_reference_analysis_and_synthesis(reference):
    m, _, golden = reference
    with torch.no_grad():
        y = m.g_a(_nhwc(golden["x"]))
        z = m.latent_codec.latent_codec["hyper"].h_a(y)
        x_hat = torch.clamp(m.g_s(_nhwc(golden["y_hat"])), 0.0, 1.0)
    med = golden["sd/latent_codec.hyper.entropy_bottleneck.quantiles"][:, 0, 1]
    z_ref = _nhwc(golden["z"]).numpy()
    assert np.array_equal(np.round(z_ref - med), np.round(z.numpy() - med))
    assert np.abs(z_ref - z.numpy()).max() < 1e-3
    assert np.abs(_nhwc(golden["x_hat"]).numpy() - x_hat.numpy()).max() < 1e-3

"""The last public names of the JAX package in the port, against the JAX
originals on the same weights and inputs (made from a numpy seed), on the
CPU at small sizes.

- ``GDN1`` both directions, ``SpectralConv2d`` and
  ``SpectralConvTranspose2d`` on parameters carried by
  ``zoo.load_jax_params`` (the spectral convs' complex
  ``kernel_transformed`` included): within ``ATOL_LAYER`` = 1e-5 (float32
  sums in another order; FFTs of another library).
- A spectral conv through the rows chain's ``canonical`` and the bf16
  route: the weight hook feeds both.
- ``make_pool`` and ``random_crop``: arrays equal to JAX's for a seed.
- ``gaussian_cdf`` for modes 0-2 and the ``APPROX_MODE`` default, against
  JAX's under ``jax.jit`` (how its rows use it): bit for bit;
  ``MAX_CDF_VALUE``, ``M_TOTAL``, ``leaky_relu`` and ``get_scale_table``
  equal to JAX's.
- ``save_npz_weights`` on four repository weight files (plain and
  transposed convs, GDN, the entropy bottleneck, linear layers and
  ``Gain``, a point-cloud codec): the file it writes from the loaded model
  has the repository file's keys and bit-equal float16 arrays, and the
  port's strict ``load_npz`` reads it back. JAX's ``load_npz_weights``
  loads every JAX ``Param`` from the file written from a seed-initialised
  port model of the same architecture (narrow: N=32, M=48, the golden
  widths of tests/torch_port_model_pairs.py; hrtzxf2022 at its defaults),
  and JAX's forward on it agrees with the port's within ``ATOL_FORWARD`` =
  2e-4 (tests/test_torch_port_forward.py's atol).
- A complex parameter is refused by ``save_npz_weights``: float16 would
  keep its real part alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.ans import gaussian_cdf as j_cdf
from flashgmm_tpu.ans import interleaved as j_il
from flashgmm_tpu.datasets import synthetic as j_synth
from flashgmm_tpu.layers import GDN1 as JGDN1
from flashgmm_tpu.layers import SpectralConv2d as JSpectralConv2d
from flashgmm_tpu.layers import SpectralConvTranspose2d as JSpectralConvT
from flashgmm_tpu.layers import leaky_relu as j_leaky_relu
from flashgmm_tpu.models import get_scale_table as j_get_scale_table
from flashgmm_tpu.registry import MODELS as J_MODELS
from flashgmm_tpu.zoo.npz import load_npz_weights
from flashgmm_tpu_torch.ans import gaussian_cdf as t_cdf
from flashgmm_tpu_torch.ans import interleaved as t_il
from flashgmm_tpu_torch.datasets import synthetic as t_synth
from flashgmm_tpu_torch.layers import GDN1 as TGDN1
from flashgmm_tpu_torch.layers import SpectralConv2d as TSpectralConv2d
from flashgmm_tpu_torch.layers import SpectralConvTranspose2d as TSpectralConvT
from flashgmm_tpu_torch.layers import leaky_relu as t_leaky_relu
from flashgmm_tpu_torch.layers import route_bf16_kernel, run_canonical
from flashgmm_tpu_torch.models import get_scale_table as t_get_scale_table
from flashgmm_tpu_torch.registry import MODELS as T_MODELS
from flashgmm_tpu_torch.zoo import (image_models, load_jax_params, load_npz,
                                    save_npz_weights)
from torch_port_model_pairs import _kwargs, jax_params
from torch_port_pcc import held_out

torch.set_num_threads(2)

ATOL_LAYER = 1e-5
ATOL_FORWARD = 2e-4


def _load_like(tm, jm):
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    return tm.eval()


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn1_matches_jax(inverse):
    rs = np.random.RandomState(3)
    c = 16
    jm = JGDN1(c, inverse=inverse)
    # away from the identity init, so that gamma mixes the channels
    jm.beta.set_value(jnp.asarray(rs.uniform(0.5, 1.5, c).astype(np.float32)))
    jm.gamma.set_value(jnp.asarray(
        rs.uniform(0.0, 0.3, (c, c)).astype(np.float32)))
    tm = _load_like(TGDN1(c, inverse=inverse), jm)
    x = rs.randn(2, 8, 8, c).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))),
                               rtol=0, atol=ATOL_LAYER)


SPECTRAL = {
    "conv s1": (JSpectralConv2d, TSpectralConv2d, (8, 12, 3, 1, 1)),
    "conv s2": (JSpectralConv2d, TSpectralConv2d, (8, 12, 5, 2, 2)),
    "transposed": (JSpectralConvT, TSpectralConvT, (8, 12, 5, 2, 2, 1)),
}


@pytest.mark.parametrize("case", sorted(SPECTRAL))
def test_spectral_conv_matches_jax(case):
    jcls, tcls, args = SPECTRAL[case]
    jm = jcls(*args, rngs=nnx.Rngs(0))
    tm = _load_like(tcls(*args), jm)
    k = args[2]
    assert tm.weight_transformed.dtype == torch.complex64
    assert tuple(tm.weight_transformed.shape[-2:]) == (k, k // 2 + 1)
    x = np.random.RandomState(4).randn(2, 10, 10, 8).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LAYER)


@pytest.mark.parametrize("transposed", [False, True])
def test_spectral_conv_weight_hook(transposed):
    """The rows chain's ``canonical`` (the hand conv's plain version on the
    CPU) and the bf16 route read the spectral weight through ``_weight``;
    a seed-initialised spectral conv rebuilds its spatial weight."""
    gen = torch.Generator().manual_seed(0)
    if transposed:
        m = TSpectralConvT(8, 12, 3, 2, 1, 1, generator=gen)
    else:
        m = TSpectralConv2d(8, 12, 3, 1, 1, generator=gen)
    assert not hasattr(m, "weight") and m._weight().shape[-2:] == (3, 3)
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 6, 6, 8)
                         .astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(run_canonical(m, x), m(x), rtol=0,
                                   atol=ATOL_LAYER)
    if transposed:
        return
    wide = TSpectralConv2d(64, 64, 3, 1, 1, generator=gen)
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 8, 8, 64)
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        want = wide(x).float()
        route_bf16_kernel(wide)
        assert wide.kernel_route
        got = wide(x).float()
    # one bf16 rounding of the output apart (the kernel's plain version
    # sums in float32, the library conv in bf16 on the CPU)
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_make_pool_and_random_crop_equal_jax():
    for kind in ("textured", "dead"):
        jp = j_synth.make_pool(3, 40, 48, seed0=11, kind=kind)
        tp = t_synth.make_pool(3, 40, 48, seed0=11, kind=kind)
        assert len(tp) == 3
        for a, b in zip(tp, jp):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    got = t_synth.random_crop(tp, 6, 32, np.random.RandomState(2))
    want = j_synth.random_crop(jp, 6, 32, np.random.RandomState(2))
    assert got.shape == (6, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", [0, 1, 2, None])
def test_gaussian_cdf_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("APPROX_MODE", "1")  # the default when mode is None
    x = (np.random.RandomState(8).randn(4096) * 3).astype(np.float32)
    x[:4] = [0.0, -0.0, 40.0, -40.0]
    want = np.asarray(jax.jit(lambda v: j_cdf.gaussian_cdf(v, mode))(
        jnp.asarray(x)))
    got = t_cdf.gaussian_cdf(torch.from_numpy(x), mode).numpy()
    np.testing.assert_array_equal(got, want)
    if mode is None:
        np.testing.assert_array_equal(
            got, t_cdf.gaussian_cdf(torch.from_numpy(x), 1).numpy())


def test_constants_and_reexports_equal_jax():
    assert t_cdf.MAX_CDF_VALUE == j_cdf.MAX_CDF_VALUE
    assert t_il.M_TOTAL == j_il.M_TOTAL
    x = np.random.RandomState(9).randn(64).astype(np.float32)
    np.testing.assert_array_equal(
        t_leaky_relu(torch.from_numpy(x), 0.2).numpy(),
        np.asarray(j_leaky_relu(jnp.asarray(x), 0.2)))
    assert t_get_scale_table() == j_get_scale_table()


# (architecture, quality): a repository weight file of each kind
SAVED = {
    "factorized": ("bmshj2018-factorized", 4),
    "hyperprior": ("bmshj2018-hyperprior", 3),
    "mbt2018-mean-vbr": ("mbt2018-mean-vbr", 1),
    "hrtzxf2022": ("hrtzxf2022-pcc-rec", 1),
}


def _seeded_pair(arch):
    """A seed-initialised port model and a JAX model of ``arch``, narrow."""
    kwargs = {} if arch == "hrtzxf2022-pcc-rec" else _kwargs(J_MODELS[arch])
    if arch.endswith("vbr"):
        kwargs["vr_entbttlnck"] = True
    return (T_MODELS[arch](**kwargs, seed=3, device="cpu").eval(),
            J_MODELS[arch](**kwargs, rngs=nnx.Rngs(0)))


def _forward(model, jax_model, arch):
    """x_hat of both models' eval forward on one input."""
    if arch == "hrtzxf2022-pcc-rec":
        x = held_out(1)
        jo = nnx.jit(lambda m, v: m(v, training=False))(jax_model,
                                                         jnp.asarray(x))
        kwargs = {}
    else:
        x = np.random.RandomState(10).rand(1, 64, 64, 3).astype(np.float32)
        kwargs = ({"stage": 2, "s": 7} if arch.endswith("vbr") else {})
        jo = jax_model(jnp.asarray(x), training=False, **kwargs)
    with torch.no_grad():
        to = model(torch.from_numpy(x), training=False, **kwargs)
    return to["x_hat"].numpy(), np.asarray(jo["x_hat"])


@pytest.mark.parametrize("case", sorted(SAVED))
def test_save_npz_weights_round_trips(case, tmp_path):
    from flashgmm_tpu_torch.zoo.image import _local_weights_path

    arch, quality = SAVED[case]
    repo_file = _local_weights_path(arch, quality)
    model = image_models(arch, quality, pretrained=True, device="cpu")
    out = tmp_path / "saved.npz"
    save_npz_weights(model, out)
    with np.load(repo_file) as want, np.load(out) as got:
        assert set(got.files) == set(want.files)
        for key in want.files:
            assert got[key].dtype == np.float16
            np.testing.assert_array_equal(got[key].view(np.uint16),
                                          want[key].view(np.uint16), key)
    again = image_models(arch, quality, device="cpu", seed=1)
    assert load_npz(again, out) == len(want.files)
    for key, value in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key

    # a seed-initialised port model's file, read by the JAX package
    seeded, jm = _seeded_pair(arch)
    save_npz_weights(seeded, out)
    load_npz(seeded, out)  # its float16-rounded values, as JAX reads them
    with np.load(out) as written:
        assert set(jax_params(jm)) == set(written.files)
        assert load_npz_weights(jm, str(out)) == len(written.files)
    got, want = _forward(seeded, jm, arch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FORWARD)


def test_save_npz_weights_refuses_complex(tmp_path):
    model = torch.nn.Sequential(TSpectralConv2d(4, 4, 3, 1, 1))
    out = tmp_path / "spectral.npz"
    with pytest.raises(ValueError, match="complex"):
        save_npz_weights(model, out)
    assert not out.exists()

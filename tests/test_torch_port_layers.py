"""The port's layers against the JAX package's, on the same weights.

Each JAX layer is built with nnx.Rngs, its parameters are flattened to
numpy and loaded into the port's layer through
``flashgmm_tpu_torch.zoo.load_jax_params`` (strict: every parameter maps),
and both run the same numpy input (NHWC, N=32 channels where it applies).

Tolerance: float32 convs in XLA and in torch sum in different orders, so
outputs differ by float32 rounding of sums of a few hundred O(1) terms:
atol 1e-4 on O(1) activations for single layers, 2e-4 for the residual
blocks (two to three convs plus GDN in a chain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import flashgmm_tpu.layers.layers as jl
from flashgmm_tpu.layers.gdn import GDN as JGDN
from flashgmm_tpu_torch import layers as tl
from flashgmm_tpu_torch.zoo import load_jax_params

torch.set_num_threads(1)

ATOL, ATOL_BLOCK = 1e-4, 2e-4


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.asarray(v.get_value())
            for path, v in flat}


def port_of(jmod, tmod):
    tmod.load_state_dict(load_jax_params(jax_params(jmod), tmod), strict=True)
    return tmod.eval()


def run_both(jmod, tmod, x, atol):
    ref = np.asarray(jmod(jnp.asarray(x)))
    with torch.no_grad():
        out = port_of(jmod, tmod)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,s,p,hw", [(5, 2, 2, (16, 16)), (3, 1, 1, (9, 11)),
                                      (3, 2, 1, (15, 13)), (1, 1, 0, (8, 8))])
def test_conv2d(k, s, p, hw):
    run_both(jl.Conv2d(6, 8, k, stride=s, padding=p, rngs=nnx.Rngs(k + s)),
             tl.Conv2d(6, 8, k, stride=s, padding=p), _x((2, *hw, 6)), ATOL)


def test_conv3x3_conv1x1_and_sequential_leaky():
    rngs = nnx.Rngs(3)
    jseq = jl.Sequential(jl.conv3x3(16, 32, rngs=rngs), jl.LeakyReLU(),
                         jl.conv1x1(32, 32, rngs=rngs), jl.LeakyReLU(),
                         jl.conv3x3(32, 32, stride=2, rngs=rngs))
    tseq = tl.Sequential(tl.conv3x3(16, 32), tl.LeakyReLU(),
                         tl.conv1x1(32, 32), tl.LeakyReLU(),
                         tl.conv3x3(32, 32, stride=2))
    run_both(jseq, tseq, _x((2, 8, 10, 16)), ATOL)


def test_pixel_shuffle_and_subpel():
    x = _x((2, 4, 5, 32))
    np.testing.assert_array_equal(
        tl.pixel_shuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jl.pixel_shuffle(jnp.asarray(x), 2)))
    run_both(jl.subpel_conv3x3(32, 16, 2, rngs=nnx.Rngs(1)),
             tl.subpel_conv3x3(32, 16, 2), x, ATOL)


@pytest.mark.parametrize("cls", ["MaskedConv2d", "CheckerboardMaskedConv2d"])
@pytest.mark.parametrize("mask_type", ["A", "B"])
def test_masked_convs(cls, mask_type):
    jmod = getattr(jl, cls)(32, 64, 5, 1, 2, mask_type=mask_type,
                            rngs=nnx.Rngs(2))
    tmod = getattr(tl, cls)(32, 64, 5, 1, 2, mask_type=mask_type)
    np.testing.assert_array_equal(
        tmod.mask.numpy()[0, 0], np.asarray(jmod.mask.get_value())[:, :, 0, 0])
    run_both(jmod, tmod, _x((2, 8, 8, 32)), ATOL)


def test_masked_conv_canonical_path():
    """The rows-chain forward (hand conv kernel; its plain version on CPU)
    applies the mask and matches the JAX layer as well."""
    jmod = jl.CheckerboardMaskedConv2d(32, 64, 5, 1, 2, rngs=nnx.Rngs(4))
    tmod = port_of(jmod, tl.CheckerboardMaskedConv2d(32, 64, 5, 1, 2))
    x = _x((2, 8, 8, 32))
    with torch.no_grad():
        out = tl.run_canonical(tmod, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jmod(jnp.asarray(x))), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn(inverse):
    jmod = JGDN(32, inverse=inverse)
    rs = np.random.RandomState(5)
    jmod.beta.set_value(jnp.asarray(rs.uniform(0.5, 1.5, 32).astype(np.float32)))
    jmod.gamma.set_value(jnp.asarray(
        rs.uniform(0.0, 0.3, (32, 32)).astype(np.float32)))
    run_both(jmod, tl.GDN(32, inverse=inverse), _x((2, 6, 7, 32)), ATOL)


@pytest.mark.parametrize("cin,stride", [(3, 2), (32, 2), (32, 1)])
def test_residual_block_with_stride(cin, stride):
    run_both(jl.ResidualBlockWithStride(cin, 32, stride=stride, rngs=nnx.Rngs(6)),
             tl.ResidualBlockWithStride(cin, 32, stride=stride),
             _x((2, 8, 8, cin)), ATOL_BLOCK)


@pytest.mark.parametrize("fused", [True, False])
def test_residual_block_upsample(fused, monkeypatch):
    monkeypatch.setattr(jl, "_FUSE_RBU", fused)
    run_both(jl.ResidualBlockUpsample(32, 32, 2, rngs=nnx.Rngs(7)),
             tl.ResidualBlockUpsample(32, 32, 2, fuse=fused),
             _x((2, 4, 6, 32)), ATOL_BLOCK)


@pytest.mark.parametrize("cin", [32, 16])
def test_residual_block(cin):
    run_both(jl.ResidualBlock(cin, 32, rngs=nnx.Rngs(8)),
             tl.ResidualBlock(cin, 32), _x((2, 6, 6, cin)), ATOL_BLOCK)


def test_ops_match_jax():
    from flashgmm_tpu import ops as jops
    from flashgmm_tpu_torch import ops as tops

    for kw in ({"min_div": 64}, {"out_h": 40, "out_w": 48}):
        assert tops.compute_padding(37, 45, **kw) == jops.compute_padding(37, 45, **kw)
    pad, unpad = tops.compute_padding(13, 10, min_div=8)
    x = _x((2, 13, 10, 3))
    padded = tops.pad_image(torch.from_numpy(x), pad)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jops.pad_image(jnp.asarray(x), pad)))
    np.testing.assert_array_equal(tops.unpad_image(padded, unpad).numpy(), x)
    v = torch.tensor([-1.5, -0.5, 0.4, 0.5, 2.5], requires_grad=True)
    q = tops.quantize_ste(v)
    np.testing.assert_array_equal(
        q.detach().numpy(), np.asarray(jops.quantize_ste(jnp.asarray(v.detach().numpy()))))
    q.sum().backward()  # straight-through: identity gradient
    np.testing.assert_array_equal(v.grad.numpy(), np.ones(5, np.float32))


@pytest.mark.parametrize("parity", ["even", "odd"])
def test_checkerboard_packing_matches_jax(parity):
    from flashgmm_tpu.latent_codecs.checkerboard import (
        CheckerboardLatentCodec as JCkbd,
        _checkerboard_mask as j_mask,
    )
    from flashgmm_tpu_torch.latent_codecs import CheckerboardLatentCodec
    from flashgmm_tpu_torch.latent_codecs.checkerboard import _checkerboard_mask

    np.testing.assert_array_equal(_checkerboard_mask(6, 8, parity).numpy(),
                                  np.asarray(j_mask(6, 8, parity)))
    jc = JCkbd(anchor_parity=parity)
    tc = CheckerboardLatentCodec(anchor_parity=parity)
    y = _x((2, 6, 8, 5))
    un = tc.unembed(torch.from_numpy(y))
    np.testing.assert_array_equal(un.numpy(), np.asarray(jc.unembed(jnp.asarray(y))))
    np.testing.assert_array_equal(tc.embed(un).numpy(), y)
    np.testing.assert_array_equal(
        tc.merge(un[0], un[1]).numpy(), np.asarray(jc.merge(jnp.asarray(un[0].numpy()),
                                                            jnp.asarray(un[1].numpy()))))


def test_gmm_chunk_and_weight_softmax_match_jax():
    from flashgmm_tpu.latent_codecs.gaussian_mixture_conditional import (
        GaussianMixtureConditionalLatentCodec as JGmm,
    )
    from flashgmm_tpu_torch.latent_codecs import GaussianMixtureConditionalLatentCodec

    p = _x((2, 3, 4, 3 * 4 * 8))
    jg, tg = JGmm(K=4), GaussianMixtureConditionalLatentCodec(K=4)
    for a, b in zip(tg._chunk(torch.from_numpy(p)), jg._chunk(jnp.asarray(p))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    w = p[..., :32]
    np.testing.assert_allclose(tg._reshape_gmm_weight(torch.from_numpy(w)).numpy(),
                               np.asarray(jg._reshape_gmm_weight(jnp.asarray(w))),
                               rtol=0, atol=1e-6)

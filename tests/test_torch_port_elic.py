"""The port's ELIC (Elic2022GMM) against the JAX package's: its layers, the
npz loader's transposed-conv kernels, the model's transforms and its eval
forward, at the JAX tests' size (N=32, M=64, K=2, groups [8, 8, 16, 16,
16], 64x64 images; tests/test_elic.py), on the CPU, on the same weights
(the JAX parameters through the port's npz converter) and the same numpy
inputs made from a seed.

Tolerances: float32 convs in XLA and in torch sum in different orders.
- ConvTranspose2d, library route and the rows chain's zero-inserted
  "same" conv through ``conv2d_nhwc_plain`` (the kernel's fmaf chain):
  atol 1e-5 against JAX and against ``F.conv_transpose2d``;
- the residual bottleneck block, the attention block and a channel ramp:
  atol 2e-5;
- g_a, h_a, h_s (on the rows chain) and g_s: atol 2e-4;
- the eval forward's likelihoods: rtol 1e-4 where above 1e-6, x_hat atol
  2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

import flashgmm_tpu.layers.layers as jl
from flashgmm_tpu.models.elic_gmm import Elic2022GMM as JElic
from flashgmm_tpu_torch import layers as tl
from flashgmm_tpu_torch.latent_codecs import ChannelGroupsLatentCodec
from flashgmm_tpu_torch.models import Elic2022GMM as TElic
from flashgmm_tpu_torch.zoo import load_jax_params, load_npz

torch.set_num_threads(1)

N, M, K, GROUPS = 32, 64, 2, [8, 8, 16, 16, 16]
ATOL_DECONV, ATOL_BLOCK, ATOL = 1e-5, 2e-5, 2e-4


def jax_params(mod):
    flat = nnx.to_flat_state(nnx.state(mod, nnx.Param))
    return {"/".join(str(p) for p in path): np.array(v.get_value())
            for path, v in flat}


def port_of(jmod, tmod):
    tmod.load_state_dict(load_jax_params(jax_params(jmod), tmod), strict=True)
    return tmod.eval()


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = JElic(N=N, M=M, K=K, groups=GROUPS, rngs=nnx.Rngs(0))
    tm = TElic(N=N, M=M, K=K, groups=GROUPS, device="cpu")
    port_of(jm, tm)
    return jm, tm


@pytest.mark.parametrize("k,s,hw", [(5, 2, (3, 5)), (3, 1, (6, 7))])
def test_conv_transpose(k, s, hw):
    """in != out; the library route and the rows chain's route (the
    zero-inserted "same" conv through the conv kernel's plain version)."""
    jmod = jl.ConvTranspose2d(12, 20, k, stride=s, padding=k // 2,
                              output_padding=s - 1, rngs=nnx.Rngs(k))
    tmod = port_of(jmod, tl.deconv(12, 20, kernel_size=k, stride=s))
    x = _x((2, *hw, 12), seed=k)
    ref = np.asarray(jmod(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        lib = F.conv_transpose2d(xt.permute(0, 3, 1, 2), tmod.weight,
                                 tmod.bias, s, k // 2, s - 1).permute(0, 2, 3, 1)
        got = tmod(xt)
        canon = tl.run_canonical(tmod, xt)
    assert got.shape == ref.shape == (2, s * hw[0], s * hw[1], 20)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_DECONV)
    np.testing.assert_allclose(lib.numpy(), ref, rtol=0, atol=ATOL_DECONV)
    np.testing.assert_allclose(canon.numpy(), lib.numpy(), rtol=0,
                               atol=ATOL_DECONV)


def test_canonical_deconv_refuses_other_geometry():
    with pytest.raises(ValueError, match="output_padding"):
        tl.run_canonical(tl.ConvTranspose2d(4, 4, 5, stride=2, padding=2),
                         torch.zeros(1, 2, 2, 4))


def test_relu_fuses_into_the_rows_chain_conv():
    """A ReLU after a conv on the rows chain fuses as slope 0: equal to
    relu(conv) (up to the sign of zero, which the kernel and its plain
    version share)."""
    seq = tl.Sequential(tl.conv3x3(8, 16), tl.ReLU(), tl.conv3x3(16, 8))
    x = torch.from_numpy(_x((1, 5, 6, 8)))
    with torch.no_grad():
        fused = tl.run_canonical(seq, x)
        h = torch.relu(tl.run_canonical(seq[0], x))
        apart = tl.run_canonical(seq[2], h)
        lib = seq(x)
    assert torch.equal(fused, apart)
    np.testing.assert_allclose(fused.numpy(), lib.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("block", ["rbb", "attention", "ramp"])
def test_blocks_match_jax(block):
    rngs = nnx.Rngs(7)
    if block == "rbb":
        jmod = jl.ResidualBottleneckBlock(32, 32, rngs=rngs)
        tmod = tl.ResidualBottleneckBlock(32, 32)
    elif block == "attention":
        jmod = jl.AttentionBlock(32, rngs=rngs)
        tmod = tl.AttentionBlock(32)
    else:  # ELIC's channel-context ramp: 5x5 convs, ReLUs, min_ch
        def jmake(i, o, *, rngs):
            return jl.Conv2d(i, o, 5, padding=2, rngs=rngs)

        def tmake(i, o, *, generator):
            return tl.Conv2d(i, o, 5, padding=2, generator=generator)

        jmod = jl.sequential_channel_ramp(16, 48, min_ch=32, make_layer=jmake,
                                          make_act=jl.ReLU, rngs=rngs)
        tmod = tl.sequential_channel_ramp(16, 48, min_ch=32, make_layer=tmake,
                                          make_act=tl.ReLU)
        assert [m.out_ch for m in tmod if isinstance(m, tl.Conv2d)] == \
            [m.out_ch for m in jmod if isinstance(m, jl.Conv2d)] == [32, 37, 48]
    x = _x((2, 6, 7, 16 if block == "ramp" else 32), seed=3)
    ref = np.asarray(jmod(jnp.asarray(x)))
    with torch.no_grad():
        got = port_of(jmod, tmod)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_BLOCK)


def test_merge_y_context_modes():
    cg_all = ChannelGroupsLatentCodec(groups=[2, 3, 4])
    cg_fl = ChannelGroupsLatentCodec(groups=[2, 3, 4, 5],
                                     context_mode="first_and_last")
    ys = [torch.full((1, 2, 2, c), float(c)) for c in (2, 3, 4)]
    assert cg_all._merge_y(ys).shape[-1] == 9
    assert torch.equal(cg_fl._merge_y(ys), torch.cat([ys[0], ys[2]], -1))
    assert cg_fl._merge_y(ys[:1]).shape[-1] == 2
    assert [t.shape[-1] for t in cg_fl._split(torch.zeros(1, 1, 1, 14))] == \
        [2, 3, 4, 5]


def test_npz_loader_maps_deconv_kernels(models, tmp_path):
    """A JAX ELIC saved as weights/*.npz are (float16 under nnx paths)
    loads strictly into the port; h_s's non-square transposed convs give
    the JAX layer's output, and the square one takes the transposed conv's
    layout, not the conv's."""
    jm, _ = models
    path = tmp_path / "w.npz"
    flat = {k: v.astype(np.float16) for k, v in jax_params(jm).items()}
    np.savez(path, **flat)
    tm = TElic(N=N, M=M, K=K, groups=GROUPS, device="cpu")
    assert load_npz(tm, path) == len(flat)
    jh = nnx.clone(jm.latent_codec["hyper"].h_s[2])  # 32 -> 48, k5, stride 2
    th = tm.latent_codec.latent_codec["hyper"].h_s[2]
    kernel = flat["latent_codec/latent_codec/hyper/h_s/layers/2/kernel"]
    np.testing.assert_array_equal(th.weight.detach().numpy(),
                                  kernel.astype(np.float32).transpose(2, 3, 0, 1))
    x = _x((1, 2, 3, N), seed=2)
    jh.kernel.value = jnp.asarray(kernel.astype(np.float32))
    jh.bias.value = jnp.asarray(flat["latent_codec/latent_codec/hyper/h_s/"
                                     "layers/2/bias"].astype(np.float32))
    with torch.no_grad():
        got = th(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jh(jnp.asarray(x))), rtol=0,
                               atol=ATOL_DECONV)
    # the square 32 -> 32 deconv, which the conv transpose would load
    # without an error
    square = flat["latent_codec/latent_codec/hyper/h_s/layers/0/kernel"]
    w0 = tm.latent_codec.latent_codec["hyper"].h_s[0].weight.detach().numpy()
    np.testing.assert_array_equal(
        w0, square.astype(np.float32).transpose(2, 3, 0, 1))
    assert not np.array_equal(
        w0, square.astype(np.float32).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("stage", ["g_a", "h_a", "h_s", "g_s"])
def test_transforms_match_jax(models, stage):
    """h_s on the rows chain (zero-inserted deconvs through the conv
    kernel's plain version), the others as the forward runs them."""
    jm, tm = models
    jhyper = jm.latent_codec["hyper"]
    thyper = tm.latent_codec.latent_codec["hyper"]
    rs = np.random.RandomState(11)
    if stage == "g_a":
        x, jmod, run = _images(2, 5), jm.g_a, tm.g_a
    elif stage == "h_a":
        x, jmod, run = rs.randn(2, 4, 4, M).astype(np.float32), jhyper.h_a, \
            thyper.h_a
    elif stage == "h_s":
        x = np.round(rs.randn(2, 2, 3, N) * 3).astype(np.float32)
        jmod = jhyper.h_s
        run = (lambda v: tl.run_canonical(thyper.h_s, v))
    else:
        x, jmod, run = np.round(rs.randn(2, 4, 4, M) * 2).astype(np.float32), \
            jm.g_s, tm.g_s
    ref = np.asarray(jmod(jnp.asarray(x)))
    with torch.no_grad():
        got = run(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_eval_forward_matches_jax(models):
    jm, tm = models
    x = _images(2, 3)
    graphdef, state = nnx.split(jm)
    jo = jax.jit(lambda st, v: nnx.merge(graphdef, st)(v, training=False))(
        state, jnp.asarray(x))
    with torch.no_grad():
        to = tm(torch.from_numpy(x), training=False)
    np.testing.assert_allclose(to["x_hat"].numpy(), np.asarray(jo["x_hat"]),
                               atol=ATOL, rtol=0)
    for name, shape in (("y", (2, 4, 4, M)), ("z", (2, 1, 1, N))):
        got = to["likelihoods"][name].numpy()
        ref = np.asarray(jo["likelihoods"][name])
        assert got.shape == ref.shape == shape
        mask = ref > 1e-6
        assert mask.mean() > 0.5
        np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-4, atol=0)


def test_training_forward_is_seeded_and_differentiable(models):
    _, tm = models
    x = torch.from_numpy(_images(1, 8))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        outs.append(tm(x, training=True, generator=g))
    for name in ("y", "z"):
        assert torch.equal(outs[0]["likelihoods"][name],
                           outs[1]["likelihoods"][name])
    rate = sum(-torch.log2(v).sum() for v in outs[0]["likelihoods"].values())
    (rate / x[0].numel() + F.mse_loss(outs[0]["x_hat"], x)).backward()
    grads = [p.grad for p in tm.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    assert tm.latent_codec.latent_codec["hyper"].h_s[0].weight.grad.abs().sum() > 0
    tm.zero_grad(set_to_none=True)

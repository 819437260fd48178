"""Tiled synthesis (flashgmm_tpu_torch/runtime/tiled.py) against the direct
g_s and against the JAX package's (flashgmm_tpu/runtime/tiled.py), at the
JAX test's sizes and bounds (tests/test_fast_codec.py:210-225): the
flagship at N=64, K=4 on JAX's weights, y of [1, 24, 8, 64], tile_h=4,
halo=8.

- Tiled against direct, every layer tiled (``g_s_tiled`` over the
  codec's whole transform, JAX's tiling), on the codec's bf16 transforms
  (the default), its float32 ones and the kernel route (on CPU tensors the
  bf16 conv's plain version): within ``ATOL`` = 2e-2, and under 5 % of
  pixels more than 1e-6 apart (JAX's bounds).
- The leading layers whose tiles would be small run whole, the rest tile
  by tile at their resolution: bitwise equal to the direct g_s on the CPU,
  and the tiles' calls see the scaled tile heights.
- A latent no taller than ``tile_h + 2 * halo`` passes through whole.
- The port's tiled output against JAX's ``make_tiled_gs`` on the same
  weights and y, both codecs on float32 transforms: within ``ATOL_JAX`` =
  2e-4, the float-stage atol of tests/test_torch_port_codec.py (float32
  conv chains summed in other orders).
"""

import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.ckbd_gmm import \
    Cheng2020AnchorCheckerboardGMMv2 as JModel
from flashgmm_tpu.runtime import FastCheckerboardGmmCodec as JCodec
from flashgmm_tpu_torch.models import Cheng2020AnchorCheckerboardGMMv2 as TModel
from flashgmm_tpu_torch.runtime import FastCheckerboardGmmCodec as TCodec
from flashgmm_tpu_torch.runtime import tiled as tiled_module
from flashgmm_tpu_torch.runtime.tiled import g_s_tiled, make_tiled_gs
from flashgmm_tpu_torch.zoo import load_jax_params
from torch_port_model_pairs import jax_params

torch.set_num_threads(2)

ATOL = 2e-2  # JAX's tiled-vs-direct bound
FRAC = 0.05  # share of pixels that may differ by more than 1e-6
ATOL_JAX = 2e-4  # the port against JAX, float32 transforms


@pytest.fixture(scope="module")
def models():
    jm = JModel(N=64, K=4, rngs=nnx.Rngs(0))
    jm.update(update_quantiles=True)
    tm = TModel(N=64, K=4, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update()
    return jm, tm.eval()


def _y(seed=7, h=24):
    return np.random.RandomState(seed).rand(1, h, 8, 64).astype(np.float32)


def _every_layer_tiled(codec, y, tile_h=4, halo=8):
    return g_s_tiled(
        lambda yt: torch.clamp(codec._transform(codec._g_s, yt), 0.0, 1.0),
        y, tile_h=tile_h, halo=halo)


@pytest.mark.parametrize("route", ["bf16", "float32", "kernel"])
def test_tiled_matches_direct(models, route):
    _, tm = models
    codec = TCodec(tm, lanes=64, cap_divisor=1,
                   bf16_transforms=route != "float32",
                   kernel_transforms=route == "kernel")
    y = torch.from_numpy(_y())
    with torch.inference_mode():
        direct = torch.clamp(codec._transform(codec._g_s, y), 0, 1)
        tiled = _every_layer_tiled(codec, y)
    assert tiled.shape == direct.shape == (1, 384, 128, 3)
    diff = (tiled - direct).abs()
    assert float(diff.max()) <= ATOL
    frac = float((diff > 1e-6).float().mean())
    assert frac < FRAC, f"{frac:.4f} of pixels differ beyond 1e-6"


def test_small_input_passthrough(models):
    _, tm = models
    codec = TCodec(tm, lanes=64, cap_divisor=1)
    y = torch.from_numpy(_y(seed=8, h=8))
    with torch.inference_mode():
        out = make_tiled_gs(codec, tile_h=16, halo=8)(y)
        direct = torch.clamp(codec._transform(codec._g_s, y), 0, 1)
    assert out.shape == (1, 128, 128, 3)
    torch.testing.assert_close(out, direct, rtol=0, atol=0)


def test_tiles_cover_the_output():
    """Each output row comes from the tile that owns its latent row: an
    identity-like transform shows the rows in order, the last tile short."""
    y = torch.arange(40, dtype=torch.float32).reshape(1, 40, 1, 1)

    def up(t):  # [B, h, 1, 1] -> [B, 2h, 2, 3], each latent row repeated
        return t.repeat_interleave(2, 1).repeat(1, 1, 2, 3)

    out = g_s_tiled(up, y, tile_h=6, halo=3, upsample=2)
    torch.testing.assert_close(out, up(y), rtol=0, atol=0)


def test_tiled_matches_jax(models):
    import jax.numpy as jnp

    from flashgmm_tpu.runtime.tiled import make_tiled_gs as j_make_tiled_gs

    jm, tm = models
    y = _y()
    ref = np.asarray(j_make_tiled_gs(
        JCodec(jm, lanes=64, cap_divisor=1, bf16_transforms=False),
        tile_h=4, halo=8)(jnp.asarray(y)))
    codec = TCodec(tm, lanes=64, cap_divisor=1, bf16_transforms=False)
    with torch.inference_mode():
        got = _every_layer_tiled(codec, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_JAX)


@pytest.mark.parametrize("route", ["bf16", "kernel"])
def test_small_layers_run_whole(models, route, monkeypatch):
    """At ``TILE_MIN_PIXELS`` = 2048 a tile of 20 latent rows x 8 holds 160, 640
    and 2560 pixels at 1x, 2x and 4x: RB0 to RBU3 (inputs at 1x and 2x) run
    whole, RB4 on (4x) tile by tile, each tile 16 core rows (4 latent rows
    at 4x) with a halo of 32."""
    _, tm = models
    codec = TCodec(tm, lanes=64, cap_divisor=1,
                   kernel_transforms=route == "kernel")
    y = torch.from_numpy(_y())
    heights = []
    run = codec._transform

    def spy(mod, x):
        heights.append((len(mod.layers), x.shape[1]))
        return run(mod, x)

    monkeypatch.setattr(tiled_module, "TILE_MIN_PIXELS", 2048)
    with torch.inference_mode():
        direct = torch.clamp(codec._transform(codec._g_s, y), 0, 1)
        codec._transform = spy
        tiled = make_tiled_gs(codec, tile_h=4, halo=8)(y)
    assert heights[:4] == [(1, 24), (1, 24), (1, 48), (1, 48)]
    # six tiles of the last four layers at 4x: rows [0, 48), [0, 64),
    # [0, 80), [16, 96), [32, 96), [48, 96)
    assert heights[4:] == [(4, 48), (4, 64), (4, 80), (4, 80), (4, 64),
                           (4, 48)]
    torch.testing.assert_close(tiled, direct, rtol=0, atol=0)

"""The port's rows-chain conv against the JAX package's Pallas conv.

flashgmm_tpu_torch.ops.conv_kernel.conv2d_nhwc on CPU tensors runs its plain
version (F.conv2d in float32 plus the fused epilogue). It is held against
flashgmm_tpu.ops.pallas_conv.conv2d_nhwc_pallas in interpret mode with
float32 compute, as tests/test_pallas_conv.py runs that kernel.

Tolerance: both sides accumulate float32 products in different orders, so
they may differ by a few float32 ulps of the largest partial sums:
max|port - jax| <= 1e-5 * (1 + max|jax|) (at most K*K*C_in = 1600 terms of
O(1) here, each sum rounding at 2^-24 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashgmm_tpu.ops.pallas_conv import conv2d_nhwc_pallas
from flashgmm_tpu_torch.ops import conv_kernel

torch.set_num_threads(1)

TOL = 1e-5


@pytest.mark.parametrize(
    "k,bias,leaky,res",
    [(1, True, False, False), (1, False, True, True), (3, True, True, False),
     (3, False, False, True), (5, True, True, True), (5, False, False, False)],
)
def test_conv_matches_pallas_interpret(k, bias, leaky, res):
    rs = np.random.RandomState(k * 8 + 4 * bias + 2 * leaky + res)
    n, h, w, ci, co = 2, 8, 16, 64, 64
    x = rs.randn(n, h, w, ci).astype(np.float32)
    wt = (rs.randn(k, k, ci, co) * 0.05).astype(np.float32)
    b = rs.randn(co).astype(np.float32) if bias else None
    r = rs.randn(n, h, w, co).astype(np.float32) if res else None

    ref = np.asarray(conv2d_nhwc_pallas(
        jnp.asarray(x), jnp.asarray(wt), None if b is None else jnp.asarray(b),
        activation="leaky_relu" if leaky else None,
        residual=None if r is None else jnp.asarray(r),
        interpret=True, compute_dtype=jnp.float32, out_dtype=jnp.float32))
    out = conv_kernel.conv2d_nhwc(
        torch.from_numpy(x), torch.from_numpy(wt),
        None if b is None else torch.from_numpy(b),
        negative_slope=0.01 if leaky else None,
        residual=None if r is None else torch.from_numpy(r)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    err = float(np.abs(out - ref).max())
    assert err <= TOL * (1 + float(np.abs(ref).max())), err


@pytest.mark.parametrize("shape", [(1, 3, 5, 7, 11), (2, 12, 8, 96, 40)])
def test_any_width_and_channels(shape):
    """The port's conv takes widths and channel counts the TPU kernel's
    eligibility rule (w % 8 == 0, C >= 64) refuses; the plain version is
    then held against torch's own conv in float64."""
    n, h, w, ci, co = shape
    rs = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rs.randn(n, h, w, ci).astype(np.float32))
    wt = torch.from_numpy((rs.randn(3, 3, ci, co) * 0.1).astype(np.float32))
    out = conv_kernel.conv2d_nhwc(x, wt, None, negative_slope=0.01)
    ref = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                     wt.double().permute(3, 2, 0, 1), padding=1)
    ref = torch.nn.functional.leaky_relu(ref, 0.01).permute(0, 2, 3, 1)
    assert out.shape == (n, h, w, co)
    assert float((out.double() - ref).abs().max()) <= TOL * (1 + float(ref.abs().max()))


def test_wrapper_refuses_bad_shapes():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        conv_kernel.conv2d_nhwc(x, torch.zeros(2, 2, 8, 8))  # even kernel
    with pytest.raises(ValueError):
        conv_kernel.conv2d_nhwc(x, torch.zeros(3, 3, 4, 8))  # C_in mismatch

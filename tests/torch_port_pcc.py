"""Shared pieces of the point-cloud parity tests: the held-out clouds of
tools/train_pointcloud_artifact.py, JAX modules with their parameters
moved off their initial values, and the port's counterpart of a JAX module
loaded with the same parameters."""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from flashgmm_tpu_torch.zoo import load_jax_params
from torch_port_model_pairs import jax_params


def synth_cloud(rs, n):
    """tools/train_pointcloud_artifact.py's synthetic shape surface."""
    kind = rs.randint(3)
    if kind == 0:
        v = rs.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    elif kind == 1:
        v = rs.uniform(-1, 1, size=(n, 3))
        face = rs.randint(3, size=n)
        sign = rs.choice([-1.0, 1.0], size=n)
        v[np.arange(n), face] = sign
    else:
        theta = rs.uniform(0, 2 * np.pi, size=n)
        z = rs.uniform(-1, 1, size=n)
        v = np.stack([np.cos(theta), np.sin(theta), z], axis=1)
    q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
    scale = rs.uniform(0.2, 0.45, size=3)
    v = (v @ q) * scale
    v += rs.normal(scale=0.004, size=v.shape)
    return (v + 0.5 + rs.uniform(-0.04, 0.04, size=3)).clip(0, 1)


def held_out(n_clouds=8, n=1024):
    """The artifact tool's held-out clouds: RandomState(999), one a batch,
    float32 [n_clouds, n, 3]."""
    rs = np.random.RandomState(999)
    return np.stack([synth_cloud(rs, n) for _ in range(n_clouds)]).astype(
        np.float32)


def perturb(jm, seed=0, sigma=0.1):
    """Adds N(0, sigma) to every parameter of the JAX module (so that zero
    biases and unit norms hide no fault); returns it."""
    state = nnx.state(jm, nnx.Param)
    flat = nnx.to_flat_state(state)
    rs = np.random.RandomState(seed)
    for _, v in flat:
        val = np.asarray(v.get_value())
        v.set_value(jnp.asarray(val + rs.normal(0, sigma, val.shape)
                                .astype(val.dtype)))
    nnx.update(jm, nnx.from_flat_state(flat))
    return jm


def load_like(tm, jm):
    """The port's module ``tm`` with ``jm``'s parameters (strictly)."""
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    return tm


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def nbits(obj):
    """Bits in a (nested) list of byte strings."""
    if isinstance(obj, (bytes, bytearray)):
        return 8 * len(obj)
    return sum(nbits(o) for o in obj)


def port_symbols(model, strings, shape):
    """The EntropyBottleneck values (symbols + medians) that the port
    model's strings decode to: the features' and the latent positions'
    for hrtzxf2022, the latent vector's for the PointNet family."""
    if isinstance(shape, list):
        lc = model.latent_codec
        return [lc["feat"].entropy_bottleneck.decompress(strings[0][0],
                                                         tuple(shape[0])),
                lc["xyz"].entropy_bottleneck.decompress(strings[1][0],
                                                        tuple(shape[1]))]
    return [model.entropy_bottleneck.decompress(strings[0], tuple(shape))]


def jax_symbols(jm, strings, shape):
    """The same through the JAX model's own tables."""
    if isinstance(shape, list):
        lc = jm.latent_codec
        return [np.asarray(lc["feat"].entropy_bottleneck.decompress(
                    strings[0][0], shape[0])),
                np.asarray(lc["xyz"].entropy_bottleneck.decompress(
                    strings[1][0], shape[1]))]
    return [np.asarray(jm.entropy_bottleneck.decompress(strings[0], shape))]

"""Reference-format coding of the three VBR models of the port against the
JAX package's, on the CPU, on the pairs of test_torch_port_vbr_models.py
(tests/torch_port_model_pairs.py's ``vbr_pair``: N=32, M=48, JAX's
``nnx.Rngs(0)`` parameters), at the gain levels s in {0, 3, 7} and at
``inputscale=1.6``, on a 64x64 image from ``np.random.RandomState``. After
``update(force=True, scale=...)`` in both packages (JAX's GaussianConditional
tables built once a process):

- with ``vr_entbttlnck``, the bottleneck's tables at the z step equal JAX's;
- the port's own ``decompress_y`` gives its compress's y_hat exactly and
  ``decompress`` an x_hat in [0, 1];
- the z strings equal JAX's;
- the y symbols differ from those JAX's compress codes in at most FLIPS
  (1 %) of them (the float stages agree within an atol, not bit for bit;
  for mbt2018-vbr, whose symbols the raster scan keeps inside, the decoded
  y_hat, where a flipped symbol moves a value by at least (1 - |offset|) /
  scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashgmm_tpu.runtime import rasterscan as j_raster
from torch_port_model_pairs import (FLIPS, VBR_CASES, VBR_LEVELS, _update_jax,
                                    vbr_pair)

torch.set_num_threads(2)


def _image(seed=11, hw=64):
    return np.random.RandomState(seed).rand(1, hw, hw, 3).astype(np.float32)


def _jax_symbols(arch, jm, out, scale, qs):
    """The y symbols (or, for mbt2018-vbr, y_hat) JAX's decoder makes of
    JAX's compress output."""
    strings, shape = out["strings"], out["shape"]
    eb, gc = jm.entropy_bottleneck, jm.gaussian_conditional
    z_hat = eb.decompress(strings[1], shape) if qs is None \
        else eb.decompress(strings[1], shape, qs=qs)
    params = jm.h_s(z_hat)
    if arch == "mbt2018-vbr":
        vbr = jm._vbr_host_args(scale)
        return np.stack([j_raster.raster_scan_decompress_single_stream(
            s, np.asarray(params)[i], *jm._host_ar_pieces(),
            (shape[0] * 4, shape[1] * 4, jm.M), vbr=vbr)
            for i, s in enumerate(strings[0])])
    scales = params if arch == "bmshj2018-hyperprior-vbr" \
        else jnp.split(params, 2, axis=-1)[0]
    return np.asarray(gc.decompress(strings[0],
                                    gc.build_indexes(scales * scale)))


def _port_symbols(arch, tm, out, scale):
    if arch == "mbt2018-vbr":
        return out["y_hat"].numpy()
    params = tm._vbr_side_params(out["strings"][1], out["shape"],
                                 tm._z_qs(scale))
    scales, _ = tm._split(params)
    gc = tm.gaussian_conditional
    return gc.decompress(out["strings"][0],
                         gc.build_indexes(scales * scale)).numpy()


@pytest.mark.parametrize("arch,vr", VBR_CASES)
def test_reference_coding_roundtrips_and_crosses_jax(arch, vr):
    jm, tm = vbr_pair(arch, vr)
    _update_jax(jm)
    x = _image()
    for s, inputscale in VBR_LEVELS:
        j_in = jnp.float32(inputscale) if inputscale else 0
        j_scale = jm._get_scale(s, j_in)
        t_scale = tm._get_scale(s, inputscale)
        assert float(t_scale) == float(np.asarray(j_scale))
        qs = None
        if vr:  # JAX's update: the GC tables (built above), then this
            qs = jm._zqstep(j_scale)
            jm.entropy_bottleneck.update_variable(force=True, qs=qs)
        tm.update(force=True, scale=t_scale)
        if vr:
            for name in ("_quantized_cdf", "_offset", "_cdf_length"):
                np.testing.assert_array_equal(
                    getattr(tm.entropy_bottleneck, name).numpy(),
                    np.asarray(getattr(jm.entropy_bottleneck, name).value))
        to = tm.compress(torch.from_numpy(x), s=s, inputscale=inputscale)
        assert to["s"] == s and set(to) == {"strings", "shape", "s", "y_hat"}
        assert torch.equal(tm.decompress_y(to["strings"], to["shape"], s=s,
                                           inputscale=inputscale),
                           to["y_hat"])
        x_hat = tm.decompress(to["strings"], to["shape"], s=s,
                              inputscale=inputscale)["x_hat"]
        assert x_hat.shape == (1, 64, 64, 3)
        assert float(x_hat.min()) >= 0.0 and float(x_hat.max()) <= 1.0

        jo = jm.compress(jnp.asarray(x), s=s, inputscale=j_in)
        assert to["strings"][1] == jo["strings"][1], (s, inputscale)
        y_j = _jax_symbols(arch, jm, jo, j_scale, qs)
        y_t = _port_symbols(arch, tm, to, t_scale)
        assert y_j.shape == y_t.shape
        flips = int((np.abs(y_j - y_t) > (0.25 / float(t_scale)
                                          if arch == "mbt2018-vbr"
                                          else 0.5)).sum())
        assert flips <= FLIPS * y_t.size, (s, inputscale, flips, y_t.size)

"""The Ballé/Minnen image-model line of the port against the JAX
package's, on the CPU: bmshj2018 (factorized, with GDN and with ReLU;
hyperprior), mbt2018-mean (the table and the search coder) and mbt2018
(the host raster scan). Cheng2020, the community ELIC and sigmoid-cdf are
in test_torch_port_cheng_models.py.

Each model is built by JAX with ``nnx.Rngs(0)`` at the golden widths of
tests/test_golden.py (N=32, M=48) and its parameters carried to the port
(tests/torch_port_model_pairs.py). Held:

- the eval forward on a 64x64 image from ``np.random.RandomState``: x_hat
  within ATOL (5e-4) of JAX's, each likelihood above 1e-6 within RTOL_NET
  (2e-4);
- bpp and MSE of that forward on test_golden.py's input within its rtol
  (2e-3) of tests/expected/arch_ee_{arch}.json, which is only read (the
  mirror of test_arch_entropy_estimation);
- reference-format coding (after ``update()``): the port's own
  ``decompress_y`` gives its compress's y_hat exactly, and ``decompress``
  an x_hat in [0, 1]; the z strings equal JAX's (the same quantiles, so
  the same tables); and the y symbols of JAX's compress, decoded by JAX,
  differ from the port's in at most FLIPS (1 %) of them (the float stages
  agree within an atol, not bit for bit: ROADMAP C2);
- the training forward: seeded by its generator, finite gradients reaching
  g_a, h_s and g_s.
"""

import pytest

from torch_port_model_pairs import (check_eval_forward,
                                    check_reference_coding,
                                    check_training_forward)


@pytest.mark.parametrize("arch", [
    "bmshj2018-factorized", "bmshj2018-factorized-relu",
    "bmshj2018-hyperprior", "mbt2018-mean", "mbt2018"])
def test_eval_forward_matches_jax_and_the_goldens(arch):
    check_eval_forward(arch)


@pytest.mark.parametrize("arch,coder", [
    ("bmshj2018-factorized", None), ("bmshj2018-hyperprior", None),
    ("mbt2018-mean", "table"), ("mbt2018-mean", "search"), ("mbt2018", None)])
def test_reference_coding_roundtrips_and_crosses_jax(arch, coder):
    check_reference_coding(arch, coder)


@pytest.mark.parametrize("arch", ["bmshj2018-hyperprior", "mbt2018-mean"])
def test_training_forward_is_seeded_and_differentiable(arch):
    check_training_forward(arch)

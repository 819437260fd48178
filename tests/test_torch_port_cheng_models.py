"""Cheng2020 (anchor and attention, the host raster scan), the community
ELIC (elic2022-chandelier) and sigmoid-cdf of the port against the JAX
package's, on the CPU, as test_torch_port_image_models.py holds the
Ballé/Minnen line (the same pairs and checks,
tests/torch_port_model_pairs.py; golden widths N=32, M=48, K=2, groups
[8, 8, 32]). sigmoid-cdf has a forward and likelihood only, as in the
reference: its compress refuses.
"""

import pytest
import torch

from torch_port_model_pairs import (check_eval_forward,
                                    check_reference_coding,
                                    check_training_forward, pair)


@pytest.mark.parametrize("arch", ["cheng2020-anchor", "cheng2020-attn",
                                  "elic2022-chandelier", "sigmoid-cdf"])
def test_eval_forward_matches_jax_and_the_goldens(arch):
    check_eval_forward(arch)


@pytest.mark.parametrize("arch", ["cheng2020-anchor", "cheng2020-attn",
                                  "elic2022-chandelier"])
def test_reference_coding_roundtrips_and_crosses_jax(arch):
    check_reference_coding(arch)


@pytest.mark.parametrize("arch", ["cheng2020-anchor", "sigmoid-cdf"])
def test_training_forward_is_seeded_and_differentiable(arch):
    check_training_forward(arch)


def test_sigmoid_cdf_refuses_to_code():
    _, tm = pair("sigmoid-cdf")
    with pytest.raises(NotImplementedError):
        tm.compress(torch.zeros(1, 64, 64, 3))

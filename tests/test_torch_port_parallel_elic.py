"""ELIC's batch-data-parallel coding (``FastElicGmmCodec.use_mesh``) on the
CPU, the checks of test_torch_port_parallel.py's codecs
(tests/torch_port_parallel_pairs.py) at tests/test_parallel.py's size: N=32,
M=64, K=2, groups [8, 8, 16, 16, 16], eight 64x64 images, a port mesh of 8
CPU slots against JAX's ``use_mesh`` on its 8 virtual devices. Exact: the
mesh's bytes equal the one device's, round-trip, cross topologies both
ways, and ``portable=False`` round-trips; y_hat within the parity tests'
flip bound of JAX's.
"""

import pytest
import torch

from flashgmm_tpu_torch import parallel as tpar

import torch_port_parallel_pairs as pp

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def coded(tmp_path_factory):
    return pp.code_batch(pp.codec_pair(
        "elic", tmp_path_factory.mktemp("elic") / "w.npz"),
        tpar.make_mesh(8, device="cpu"))


def test_mesh_encode_equals_one_device(coded):
    pp.check_mesh_encode_equals_one_device(coded)


def test_mesh_round_trip_exact(coded):
    pp.check_mesh_round_trip_exact(coded)


def test_streams_cross_topologies(coded):
    pp.check_streams_cross_topologies(coded)


def test_nonportable_round_trip_exact(coded):
    pp.check_nonportable_round_trip_exact(coded)


def test_mesh_y_hat_against_jax_use_mesh(coded):
    pp.check_mesh_y_hat_against_jax(coded)

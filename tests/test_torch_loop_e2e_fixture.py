"""The loop-closure slice, port against JAX ViewGraph (the checks of
test_torch_loop_e2e.py), with the repo's k=10, L=5 fixture vocabulary
(level-1 node ids split the ``node`` and ``epipolar`` gates)."""

import pytest
import torch

import test_torch_loop_e2e as slice_
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return slice_.run_both("fixture", tmp_path_factory.mktemp("vocab"))


def test_same_keyframes_and_loop_edges(both):
    slice_.check_same_keyframes_and_loop_edges(both)


def test_loop_edges_span_beyond_window(both):
    slice_.check_loop_edges_span_beyond_window(both)


def test_rotations_match_reference_and_ground_truth(both):
    slice_.check_rotations_match_reference_and_ground_truth(both)


def test_connections_carry_reference_pairs(both):
    slice_.check_connections_carry_reference_pairs(both)


def test_slice_reaches_the_node_and_epipolar_gates(both):
    slice_.check_slice_reaches_the_node_and_epipolar_gates(both)

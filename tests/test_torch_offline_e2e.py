"""The port's offline pipeline end to end on the 12-frame sequence of
tests/test_offline.py (``seqgen``, 640x480): keyframes and edges, the
rotations against ground truth (the reference's bounds: mean < 1 deg,
max < 2.5 deg) and against the JAX ``run_offline`` on the same frames,
run without x64 as its CLI does, so that both draw the same RANSAC
samples: the same keyframes and edges, mean rotation difference < 0.05
deg (0.015 on a CPU; the solves round differently, f64 against f32).
Loop closure and the CLI: test_torch_offline_loop.py."""

import jax
import numpy as np
import pytest
import torch

from irotavg_tpu import so3 as jso3
from irotavg_tpu.frontend import Camera as JaxCamera
from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu.pipeline import run_offline as jax_run_offline
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.pipeline import run_offline
from seqgen import make_sequence
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)


def _camera(K, cls=Camera):
    return cls(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
               height=480)


@pytest.fixture(scope="module")
def sequence():
    return make_sequence(n_frames=12, seed=1, step=0.3,
                         yaw_deg_per_frame=-1.0)


@pytest.fixture(scope="module")
def offline_run(sequence):
    frames, K, _ = sequence
    ext = ORBExtractor(n_features=1200, n_levels=8, device="cpu")
    return run_offline(frames, _camera(K), ext, batch=4, chunk=8,
                       min_matches=60, win_size=4)


def _aligned(Q):
    """Rotations relative to the first (gauge alignment)."""
    Q = np.asarray(Q, np.float64)
    return jso3.qmul(Q, np.tile(jso3.qinv_flipw(Q[0]), (len(Q), 1)))


def _err_deg(qa, qb):
    return np.degrees(np.asarray(jso3.qgeodesic(
        jso3.qnormalize(_aligned(qa)), jso3.qnormalize(_aligned(qb)))))


def test_offline_selects_keyframes_and_edges(offline_run):
    res = offline_run
    assert len(res.keyframes) >= 10
    # window density: roughly win_size edges per keyframe
    assert len(res.edges) >= 2 * (len(res.keyframes) - 2)
    assert (res.n_matches >= 60).all()
    assert res.loop_edges == 0 and not res.loop_mask.any()
    assert res.Q.shape == (len(res.keyframes), 4)
    for k in ("extract_s", "flow_s", "pairs_s", "solve_s", "total_s"):
        assert res.stats[k] >= 0.0


def test_offline_rotations_match_ground_truth(offline_run, sequence):
    res = offline_run
    R_gt = sequence[2]
    q_gt = np.stack([np.asarray(jso3.rotmat_to_quat(R_gt[i]))
                     for i in res.keyframes])
    err = _err_deg(res.Q, q_gt)
    assert err.mean() < 1.0, f"mean rotation error {err.mean():.2f} deg"
    assert err.max() < 2.5, f"max rotation error {err.max():.2f} deg"


def test_offline_matches_jax_run_offline(offline_run, sequence):
    frames, K, _ = sequence
    with jax.enable_x64(False):              # as the JAX CLI runs
        ref = jax_run_offline(frames, _camera(K, JaxCamera),
                              JaxORB(n_features=1200, n_levels=8), batch=4,
                              chunk=8, min_matches=60, win_size=4)
    res = offline_run
    assert list(res.keyframes) == list(ref.keyframes)
    np.testing.assert_array_equal(res.edges, np.asarray(ref.edges))
    common = sorted(set(ref.keyframes) & set(res.keyframes))
    qa = np.stack([res.Q[res.keyframes.index(i)] for i in common])
    qb = np.stack([np.asarray(ref.Q)[ref.keyframes.index(i)]
                   for i in common])
    err = _err_deg(qa, qb)
    assert err.mean() < 0.05, f"port/JAX divergence {err.mean():.3f} deg"

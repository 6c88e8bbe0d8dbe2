"""The per-keyframe slice end to end: the port's ViewGraph against the JAX
ViewGraph on one synthetic sequence (the port's CLI is held in
test_torch_cli.py).

Both packages draw the same RANSAC samples (the port derives the JAX
package's threefry keys; the JAX side runs without x64, as its CLI
does).  Their solves still round differently (the port's f64 against
f32), which can tip a near-tied RANSAC decision, so each connection's
pairs are compared by share: the same kept frames and connected view
pairs, at least a third of the connections carrying exactly the
reference's pairs, per-view rotations within 0.1 deg of the reference's
after gauge alignment, and the reference test's own bounds against
ground truth (test_engine_e2e.py:51-52).
"""

import jax
import numpy as np
import pytest
import torch

from irotavg_tpu import so3 as jso3
from irotavg_tpu.engine.viewgraph import ViewGraph as JaxViewGraph
from irotavg_tpu.frontend import Camera as JaxCamera
from irotavg_tpu.frontend import Frame as JaxFrame
from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu_torch.engine.viewgraph import ViewGraph
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from seqgen import make_sequence
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sequence():
    return make_sequence(n_frames=12, seed=1, step=0.3,
                         yaw_deg_per_frame=-1.0)


def _run(frames, vg, make_frame):
    kept = []
    for i, im in enumerate(frames):
        if vg.process_frame(make_frame(i, im), win_size=4):
            kept.append(i)
            vg.rot_avg(10)
    return kept


@pytest.fixture(scope="module")
def both(sequence):
    frames, K, R_gt = sequence
    kw = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
              height=480)
    jcam, jext = JaxCamera(**kw), JaxORB(n_features=1200, n_levels=8)
    jvg = JaxViewGraph(jcam, min_matches=60)
    with jax.enable_x64(False):              # as the JAX CLI runs
        jkept = _run(frames, jvg, lambda i, im: JaxFrame(i, im, jext, jcam))
    cam = Camera(**kw)
    ext = ORBExtractor(n_features=1200, n_levels=8, device="cpu")
    vg = ViewGraph(cam, min_matches=60, device="cpu")
    kept = _run(frames, vg, lambda i, im: Frame(i, im, ext, cam))
    return (jvg, jkept), (vg, kept), R_gt


def _gauge_err_deg(q_est, q_ref):
    qa = jso3.qmul(q_est, np.tile(jso3.qinv_flipw(q_est[0]), (len(q_est), 1)))
    qb = jso3.qmul(q_ref, np.tile(jso3.qinv_flipw(q_ref[0]), (len(q_ref), 1)))
    return np.degrees(np.asarray(jso3.qgeodesic(jso3.qnormalize(qa), qb)))


def test_same_keyframes_and_connections(both):
    (jvg, jkept), (vg, kept), _ = both
    assert kept == jkept
    assert sorted(vg.connections) == sorted(jvg.connections)


def test_connections_carry_reference_pairs(both):
    """With the same draws most connections keep exactly the reference's
    inlier pairs (15 of 38 on a CPU)."""
    (jvg, _), (vg, _), _ = both
    same = [np.array_equal(np.asarray(vg.connections[k].pairs),
                           np.asarray(jvg.connections[k].pairs))
            for k in vg.connections]
    assert sum(same) >= len(same) / 3, (sum(same), len(same))


def test_best_covisibility_matches_reference(both):
    """Same neighbours as the reference, ranked by the port's own match
    counts (the counts differ with the RANSAC draws)."""
    (jvg, _), (vg, _), _ = both
    for i in range(vg.num_views):
        nb = vg.best_covisibility(i, 10)
        assert set(nb) == set(jvg.best_covisibility(i, 10))
        counts = [vg.adjacency[i][v] for v in nb]
        assert counts == sorted(counts, reverse=True)
        assert vg.best_covisibility(i, 2) == nb[:2]


def test_rotations_match_reference_and_ground_truth(both):
    (jvg, jkept), (vg, kept), R_gt = both
    q_port = np.asarray(vg.ra.Q)
    q_ref = np.asarray(jvg.ra.Q)
    assert _gauge_err_deg(q_port, q_ref).max() < 0.1
    q_gt = np.stack([np.asarray(jso3.rotmat_to_quat(R_gt[i])) for i in kept])
    err = _gauge_err_deg(q_port, q_gt)
    assert err.mean() < 1.0, f"mean rotation error {err.mean():.2f} deg"
    assert err.max() < 2.5, f"max rotation error {err.max():.2f} deg"


def test_flip_assignment_matches_reference_scatter():
    """Duplicate targets: the port's deterministic rule (largest row wins)
    is what the reference's scatter does on the CPU."""
    import jax.numpy as jnp

    from irotavg_tpu_torch.geometry.fused import _flip_assignment

    rng = np.random.default_rng(0)
    m12 = rng.integers(-1, 20, 60).astype(np.int32)    # many duplicates
    n_prev = 25
    matched = m12 >= 0
    tgt = np.where(matched, m12, n_prev)
    rows = np.where(matched, np.arange(60, dtype=np.int32), np.int32(-1))
    ref = (jnp.full((n_prev + 1,), -1, jnp.int32)
           .at[tgt].set(rows, mode="drop")[:n_prev])
    got = _flip_assignment(torch.from_numpy(m12), n_prev)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

"""The port's two-view API and the fused module's two public programs
against the JAX package, on the same correspondences and frames.

``find_relative_pose`` / ``refine_pose`` run on the synthetic scenes of
``test_geometry.py`` (random 3-D points, known motion); the port's frames
are restored on the CPU from the same arrays.  ``fused_initial_pose`` and
``fused_refine_window`` run on three consecutive seqgen frames extracted
once by the JAX ORB extractor.  Both packages draw the same RANSAC
samples from the same seed (the JAX side runs without x64, as its CLIs
do); their solves still round differently (the port's f64 against f32).
``find_relative_pose``: equal accept flags, R within 0.01 deg of the JAX
package's, cheirality counts within 1%; ``refine_pose`` (a chain of
re-matches and solves): R within 0.1 deg, final pair counts within 2%;
R within 0.5 deg of the ground truth; the fused programs' tolerances
are in their test's docstring.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from irotavg_tpu.frontend import Camera as JCamera
from irotavg_tpu.frontend import Frame as JFrame
from irotavg_tpu.frontend import ORBExtractor as JORB
from irotavg_tpu.geometry import find_relative_pose as j_find
from irotavg_tpu.geometry import fused as jf
from irotavg_tpu.geometry import refine_pose as j_refine
from irotavg_tpu.matching import matchers as jm
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.geometry import fused as tf
from irotavg_tpu_torch.geometry.twoview import (
    find_relative_pose, refine_pose,
)
from seqgen import make_sequence
from test_geometry import CAM as JCAM
from test_geometry import _frames, _synth_views
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
R_TOL_DEG = 0.5                 # against the ground truth
FIND_R_TOL_DEG, FIND_N_TOL = 0.01, 0.01
REFINE_R_TOL_DEG, REFINE_N_TOL = 0.1, 0.02
# the fused programs with the same draws (see their test)
FUSED_R_TOL_DEG = 0.05
FUSED_N_TOL = 0.02


def _deg(Ra, Rb):
    return float(np.degrees(np.linalg.norm(
        (Rsc.from_matrix(np.asarray(Ra, np.float64))
         * Rsc.from_matrix(np.asarray(Rb, np.float64)).inv()).as_rotvec())))


def _port(fake):
    """A port Frame on the CPU holding a test_geometry FakeFrame's data."""
    n = len(fake.xu)
    x = np.asarray(fake.xu, np.float32)
    y = np.asarray(fake.yu, np.float32)
    arrays = dict(x=x, y=y, xu=x, yu=y, octave=fake.octave, angle=fake.angle,
                  response=np.ones(n, np.float32),
                  size=np.full(n, 31.0, np.float32), desc=fake.desc,
                  valid=fake.valid)
    return Frame.restore(0, CAM, arrays, device="cpu")


def test_degenerate_input_returns_none():
    f1, f2 = _frames((np.zeros(3), np.zeros(3)), (np.zeros(3), np.zeros(3)))
    pairs = np.stack([np.arange(3)] * 2, axis=1).astype(np.int32)
    assert j_find(f1, f2, pairs, JCAM) is None
    assert find_relative_pose(_port(f1), _port(f2), pairs, CAM) is None


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3])
def test_find_relative_pose_equals_jax(outlier_frac):
    pts1, pts2, R_gt, _, _ = _synth_views(outlier_frac=outlier_frac, seed=3)
    f1, f2 = _frames(pts1, pts2, seed=3)
    pairs = np.stack([np.arange(len(pts1[0]))] * 2, axis=1).astype(np.int32)
    with jax.enable_x64(False):
        ref = j_find(f1, f2, pairs, JCAM)
    got = find_relative_pose(_port(f1), _port(f2), pairs, CAM)
    assert ref is not None and got is not None
    assert _deg(got.R, ref.R) < FIND_R_TOL_DEG
    assert _deg(got.R, R_gt) < R_TOL_DEG
    assert abs(got.n_cheirality - ref.n_cheirality) <= \
        FIND_N_TOL * ref.n_cheirality
    assert got.inlier_mask.shape == (len(pairs),)
    assert got.inlier_mask.sum() == got.n_cheirality
    assert got.q.shape == (4,)


def test_refine_pose_grows_support_like_jax():
    pts1, pts2, R_gt, _, _ = _synth_views(n=400, noise_px=0.4, seed=11)
    f1, f2 = _frames(pts1, pts2, seed=11)
    p1, p2 = _port(f1), _port(f2)
    pairs0 = np.stack([np.arange(150)] * 2, axis=1).astype(np.int32)
    with jax.enable_x64(False):
        rel0_j = j_find(f1, f2, pairs0, JCAM)
        rel_j, pairs_j = j_refine(f1, f2, rel0_j, pairs0, JCAM,
                                  min_matches=100)
    rel0 = find_relative_pose(p1, p2, pairs0, CAM)
    rel, pairs = refine_pose(p1, p2, rel0, pairs0, CAM, min_matches=100)
    assert len(pairs_j) > len(pairs0) and len(pairs) > len(pairs0)
    assert len(pairs) >= rel0.inlier_mask.sum()
    assert rel.n_cheirality == len(pairs)
    assert abs(len(pairs) - len(pairs_j)) <= REFINE_N_TOL * len(pairs_j)
    assert _deg(rel.R, rel_j.R) < REFINE_R_TOL_DEG
    assert _deg(rel.R, R_gt) < R_TOL_DEG


def test_refine_pose_keeps_pose_without_growth():
    """All matches already in: no growth, the input pose comes back."""
    pts1, pts2, _, _, _ = _synth_views(n=200, noise_px=0.4, seed=4)
    f1, f2 = _frames(pts1, pts2, seed=4)
    p1, p2 = _port(f1), _port(f2)
    pairs = np.stack([np.arange(200)] * 2, axis=1).astype(np.int32)
    rel0 = find_relative_pose(p1, p2, pairs, CAM)
    rel0.n_cheirality = 10_000     # nothing can beat this count
    rel, out = refine_pose(p1, p2, rel0, pairs, CAM, min_matches=100)
    assert rel is rel0 and out is pairs


# -- fused_initial_pose / fused_refine_window on ORB frames ----------------


@pytest.fixture(scope="module")
def seq_frames():
    frames, K, _ = make_sequence(n_frames=3, seed=2, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    kw = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
              height=480)
    jcam = JCamera(**kw)
    ext = JORB(n_features=1000, n_levels=8)
    jfr = [JFrame(i, im, ext, jcam) for i, im in enumerate(frames)]
    keys = ("x", "y", "xu", "yu", "octave", "angle", "response", "size",
            "desc", "valid")
    cam = Camera(**kw)
    tfr = [Frame.restore(i, cam, {k: np.array(getattr(f, k)) for k in keys},
                         device="cpu") for i, f in enumerate(jfr)]
    consts = dict(
        cam=np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32),
        K_inv=np.linalg.inv(cam.K).astype(np.float32),
        sigma2=((1.2 ** np.arange(8)) ** 2).astype(np.float32),
        th_norm=np.float32(1.0 / cam.fx))
    return jfr, tfr, consts


def _t(f):
    return (f.dev("desc"), None, f.dev("valid"), f.dev("angle"),
            f.dev("xu"), f.dev("yu"), f.dev("octave"))


def _jax_initial_pose(jfr, c, seed, min_matches):
    _, jb, jc = jfr
    return jf.fused_initial_pose(
        jc.pm1, jc.dev("valid"), jc.dev("octave"), jc.dev("xu"),
        jc.dev("yu"), jb.pm1.T, jb.dev("valid"), jb.dev("octave"),
        jb.dev("xu"), jb.dev("yu"), np.float32(45.0), c["cam"],
        c["th_norm"], np.uint32(seed), 2 * min_matches, np.float32(0.9))


def _jax_two_programs(jfr, c, seed, m12_w2p, min_matches):
    ja, jb, jc = jfr
    ini = _jax_initial_pose(jfr, c, seed, min_matches)
    E0, R0, t0, _, m12_cp = ini[:5]
    ref, win = jf.fused_refine_window(
        jc.pm1, None, jc.dev("valid"), jc.dev("angle"), jc.dev("xu"),
        jc.dev("yu"), jc.dev("octave"),
        jb.pm1, None, jb.dev("valid"), jb.dev("angle"), jb.dev("xu"),
        jb.dev("yu"), jb.dev("octave"),
        ((ja.pm1, None, ja.dev("valid"), ja.dev("angle"), ja.dev("xu"),
          ja.dev("yu"), ja.dev("octave")),),
        m12_w2p.astype(np.int32), np.array([True]), E0, R0, t0, m12_cp,
        c["K_inv"], c["sigma2"], c["cam"], c["th_norm"], np.uint32(seed),
        min_matches, has_nodes=False)
    return ([np.asarray(v) for v in ini], [np.asarray(v) for v in ref],
            [np.asarray(v) for v in win])


def _port_two_programs(tfr, c, seed, m12_w2p, min_matches):
    ta, tb, tc = tfr
    cam = torch.from_numpy(c["cam"])
    th_norm = torch.tensor(c["th_norm"])
    ini = tf.fused_initial_pose(
        (tc.dev("desc"), tc.dev("valid"), tc.dev("octave"), tc.dev("xu"),
         tc.dev("yu")),
        (tb.dev("desc"), tb.dev("valid"), tb.dev("octave"), tb.dev("xu"),
         tb.dev("yu")),
        45.0, cam, th_norm, seed, 2 * min_matches, 0.9)
    E0, R0, t0, _, m12_cp = ini[:5]
    ref, win = tf.fused_refine_window(
        _t(tc), _t(tb), (_t(ta),), torch.from_numpy(m12_w2p), [True],
        E0, R0, t0, m12_cp, torch.from_numpy(c["K_inv"]),
        torch.from_numpy(c["sigma2"]), cam, th_norm, seed, min_matches)
    as_np = (lambda v: v.numpy() if torch.is_tensor(v) else np.asarray(v))
    return ([as_np(v) for v in ini], [as_np(v) for v in ref],
            [as_np(v) for v in win])


def test_fused_initial_pose_and_refine_window_like_jax(seq_frames):
    """Frame 2 against frame 1 (initial pose), then its refine and the
    window walk with frame 0 as the one candidate, for seeds 0..7, with
    the same draws in both packages.

    Per seed: equal accept / valid / success flags, the window pose within
    0.05 deg and its count within 2%, and ``local_rad`` (the mean
    displacement of the deterministic local matches of the trial that
    accepted) within 1e-4 relative of the JAX package's.  The JAX package
    is run as its CLIs run it, one compiled program; where the port's
    ``local_rad`` differs from that program's, the JAX package must
    disagree with itself: the same program run op by op
    (``jax.disable_jit``) must accept at another trial, and the port must
    equal that run's ``local_rad`` and cheirality count.  That happens at
    seed 6, whose first trial draws minimal samples with a correspondence
    twice (rank-deficient 8-point designs): the compiled program's
    Householder null vector of one of them (its direction in a
    two-dimensional null space is set by f32 rounding) wins, and op by op
    it does not.  With the same draws the two packages' RANSACs still
    differ by the rounding of their solves (the port's f64 against the
    JAX package's f32), so the initial and refined previous -> current
    poses are compared by their medians over the seeds: R within 0.05
    deg, counts within 2%; and each stage's matched rows equal the JAX
    package's exactly in at least half the seeds."""
    jfr, tfr, c = seq_frames
    min_matches = 100
    # the candidate's chain to the previous frame: frame 0 -> frame 1
    m12_w2p = jm.match_locally(jfr[0], jfr[1], radius=40.0).astype(
        np.int64)[None]
    assert (m12_w2p >= 0).sum() > 100
    d_init, d_ref, n_ref = [], [], []
    same_rows = np.zeros(3, int)
    n_seeds = 8
    for seed in range(n_seeds):
        with jax.enable_x64(False):
            ij, rj, wj = _jax_two_programs(jfr, c, seed, m12_w2p,
                                           min_matches)
        it, rt, wt = _port_two_programs(tfr, c, seed, m12_w2p, min_matches)
        # (E, R, t, n_che, m12, local_rad, rel_valid, accepted)
        assert (bool(it[6]), bool(it[7])) == (bool(ij[6]), bool(ij[7])) \
            == (True, True)
        rad, rad_j = float(it[5]), float(ij[5])
        if abs(rad - rad_j) > 1e-4 * rad_j:
            with jax.enable_x64(False), jax.disable_jit():
                oj = _jax_initial_pose(jfr, c, seed, min_matches)
            assert abs(float(oj[5]) - rad_j) > 1e-4 * rad_j, seed
            assert int(it[3]) == int(oj[3]), seed
            rad_j = float(oj[5])
        assert abs(rad - rad_j) <= 1e-4 * rad_j, seed
        assert float(it[5]) >= tf.GATE_PX
        d_init.append(_deg(it[1], ij[1]))
        # refined: (E, R, t, n, m12_pc), previous row -> current column
        assert int(rt[3]) >= min_matches and int((rt[4] >= 0).sum()) == \
            int(rt[3])
        d_ref.append(_deg(rt[1], rj[1]))
        n_ref.append(abs(int(rt[3]) - int(rj[3])) / int(rj[3]))
        # the window walk, one candidate: (E, R, t, n, m12, success)
        assert [bool(v) for v in wt[5]] == [bool(v) for v in wj[5]] \
            == [True]
        assert _deg(wt[1][0], wj[1][0]) < FUSED_R_TOL_DEG
        assert abs(int(wt[3][0]) - int(wj[3][0])) <= \
            FUSED_N_TOL * int(wj[3][0])
        same_rows += [np.array_equal(it[4], ij[4]),
                      np.array_equal(rt[4], rj[4]),
                      np.array_equal(wt[4], wj[4])]
    assert np.median(d_init) < FUSED_R_TOL_DEG
    assert np.median(d_ref) < FUSED_R_TOL_DEG
    assert np.median(n_ref) <= FUSED_N_TOL
    assert (same_rows >= n_seeds // 2).all(), same_rows

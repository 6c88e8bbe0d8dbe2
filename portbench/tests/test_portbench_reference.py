"""The reference on tiny cases whose answers are known."""

import math

import numpy as np

from gen import ring_orbit
from reference import rotavg, scene


def _random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _relative(Q, edges):
    Qi_inv = Q[edges[:, 0]].copy()
    Qi_inv[:, 3] *= -1
    return rotavg.qmul(Q[edges[:, 1]], Qi_inv)      # R_j R_i^-1


def test_init_mst_follows_the_tree_in_edge_order():
    rng = np.random.default_rng(1)
    Q = _random_rotations(rng, 4)
    Q[0] = (0, 0, 0, 1)
    edges = np.array([[0, 1], [1, 2], [2, 3], [0, 3]])
    QQ = _relative(Q, edges)
    QQ[3] = (0, 0, 0, 1)              # a wrong edge the sweep never uses
    start = np.zeros_like(Q)
    start[0] = Q[0]
    got = rotavg.init_mst(start, QQ, edges, 1)
    assert rotavg.geodesic_deg(got, Q).max() < 1e-9


def test_solve_recovers_noiseless_rotations():
    rng = np.random.default_rng(2)
    n = 12
    Q = _random_rotations(rng, n)
    Q[0] = (0, 0, 0, 1)
    edges = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                      if j - i <= 3])
    QQ = _relative(Q, edges)
    start = np.zeros_like(Q)
    start[0] = Q[0]
    start = rotavg.init_mst(start, QQ, edges, 1)
    # perturb the start: L1-RA and IRLS must bring it back
    noise = rotavg.exp_map(np.c_[rng.normal(scale=0.05, size=(n, 3)),
                                 np.zeros(n)])
    start[1:] = rotavg.qmul(start[1:], noise[1:])
    Q1, Qf, w = rotavg.solve(QQ, edges, start, 1, sigma=math.radians(5),
                             l1_iters=5, irls_iters=50, change_th=1e-9)
    assert rotavg.geodesic_deg(Qf, Q).max() < 1e-6
    assert np.allclose(w, 1 / math.radians(5) ** 2, rtol=1e-6)


def test_window_solve_keeps_views_outside_the_window():
    rng = np.random.default_rng(3)
    n = 8
    Q = _random_rotations(rng, n)
    edges = np.array([(i, i + 1) for i in range(n - 1)]
                     + [(i, i + 2) for i in range(n - 2)])
    QQ = _relative(Q, edges)
    start = Q.copy()
    start[5:] = _random_rotations(rng, 3)
    out = rotavg.window_solve(start, np.zeros(n, bool), edges, QQ, 3,
                              sigma=math.radians(5), l1_iters=100,
                              irls_iters=100, change_th=1e-9)
    assert np.array_equal(out[:5], start[:5])
    assert rotavg.geodesic_deg(out[5:], Q[5:]).max() < 1e-6
    # too few edges in the window: nothing moves
    few = rotavg.window_solve(start, np.zeros(n, bool), edges[:2], QQ[:2],
                              3, sigma=0.1, l1_iters=5, irls_iters=5,
                              change_th=1e-3)
    assert np.array_equal(few, start)


def test_transfer_lands_on_the_projection_of_a_panel_point():
    corners = np.array([[[-2.0, -1, 6], [2, -1, 6], [2, 1, 6], [-2, 1, 6]]])
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    R, C = ring_orbit.orbit(2, 60, 0.0, 0.0)
    Ra, Rb = np.eye(3), R[1]
    Ca, Cb = np.zeros(3), np.array([0.3, 0.0, 0.0])
    X = np.array([[0.5, 0.2, 6.0], [-1.0, -0.5, 6.0]])
    pa = X @ K.T
    pa = pa[:, :2] / pa[:, 2:]
    pb = (X - Cb) @ Rb.T @ K.T
    pb = pb[:, :2] / pb[:, 2:]
    got = scene.transfer(np.r_[pa, [[5.0, 5.0]]], K, Ra, Ca, Rb, Cb,
                         corners, 640, 480)
    assert np.abs(got[:2] - pb).max() < 1e-9
    assert np.isnan(got[2]).all()          # the ray misses the panel
    # the pose's epipolar lines pass through the true pixels: x_b ~ R x_a + t
    t = -Rb @ Cb
    assert scene.epipolar_px(pa, pb, Rb, t, K).max() < 1e-9
    assert scene.epipolar_px(pa, pb + [0.0, 3.0], Rb, t, K).min() > 0.1

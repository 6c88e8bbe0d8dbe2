"""Ground truth of a rendered ring-world frame, for the two-view checks.

Everything here follows from what the benchmark drew: the panels' corners,
each frame's world-to-camera rotation ``R`` and centre ``C``, and the
intrinsics ``K``.  A pixel of frame ``a`` is cast as a ray into the world
and meets the panel that the renderer painted there (the visible panel
painted last, nearest by mean depth, whose texture square holds the hit);
the hit point is projected into frame ``b``.
"""

from __future__ import annotations

import numpy as np

TEX_EDGE = 511.0 / 512.0   # the renderer's last texture sample, (S - 1) / S


def epipolar_px(pa, pb, R, t, K):
    """Distance in pixels of each ``pb (M, 2)`` from the epipolar line of
    its ``pa (M, 2)`` under the relative pose ``x_b ~ R x_a + t``."""
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ tx @ R @ Kinv
    ha = np.c_[pa, np.ones(len(pa))]
    hb = np.c_[pb, np.ones(len(pb))]
    lines = ha @ F.T
    return np.abs(np.sum(hb * lines, axis=1)) / np.linalg.norm(
        lines[:, :2], axis=1)


def _panel_order(corners, K, R, C, width, height):
    """Which panels a frame draws, and their painting rank."""
    cam = (corners - C) @ R.T                          # (P, 4, 3)
    proj = cam @ K.T
    proj = proj[..., :2] / proj[..., 2:3]
    drawn = (cam[..., 2] > 0.5).all(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        drawn &= ~(np.abs(proj) > 8 * max(width, height)).any((-2, -1))
    depth = cam[..., 2].mean(-1)
    rank = np.argsort(np.argsort(-depth, kind="stable"), kind="stable")
    return drawn, rank


def transfer(pts, K, R_a, C_a, R_b, C_b, corners, width, height):
    """Pixels ``pts (M, 2)`` of frame ``a`` carried to frame ``b`` through
    the painted panel: ``(M, 2)`` pixels, NaN where no panel was hit."""
    drawn, rank = _panel_order(corners, K, R_a, C_a, width, height)
    rays = np.linalg.solve(K, np.c_[pts, np.ones(len(pts))].T).T @ R_a
    c0 = corners[:, 0]
    a = corners[:, 1] - c0
    b = corners[:, 3] - c0
    best = np.full(len(pts), -1)
    hit = np.full((len(pts), 3), np.nan)
    for p in np.flatnonzero(drawn):
        # C_a + lam * ray = c0 + s a + t b
        M = np.stack([np.broadcast_to(a[p], rays.shape),
                      np.broadcast_to(b[p], rays.shape), -rays], -1)
        rhs = np.broadcast_to(C_a - c0[p], rays.shape)
        with np.errstate(all="ignore"):
            s, t, lam = np.linalg.solve(M, rhs[..., None])[..., 0].T
        on = ((lam > 0) & (s >= 0) & (s <= TEX_EDGE) & (t >= 0)
              & (t <= TEX_EDGE) & (rank[p] > best))
        best = np.where(on, rank[p], best)
        hit[on] = C_a + lam[on, None] * rays[on]
    xb = (hit - C_b) @ R_b.T @ K.T
    return xb[:, :2] / xb[:, 2:3]


def quat_to_rotmat(q):
    """``[x y z w]`` quaternion rows -> ``(N, 3, 3)`` rotation matrices."""
    q = np.atleast_2d(q) / np.linalg.norm(np.atleast_2d(q), axis=1,
                                          keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def angle_deg(Ra, Rb):
    """Angle in degrees of ``Ra Rb^T`` for stacks of rotations, from the
    chordal distance ``|Ra - Rb| = 2 sqrt(2) sin(angle / 2)``, which keeps
    its digits at small angles."""
    d = np.linalg.norm(Ra - Rb, axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(np.clip(d, 0.0, 1.0)))


def rotation_errors_deg(Q, R):
    """Each estimated world-to-camera rotation (``Q (N, 4)`` quaternion
    rows, edge convention ``R_j = R_ij R_i``) against the ground truth
    ``R (N, 3, 3)``, after the gauge that fits them best: the estimates
    are ``R_v G`` for one unknown ``G``, taken as the rotation nearest to
    ``sum R_v^T Q_v``."""
    M = quat_to_rotmat(Q)
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", R, M))
    G = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    return angle_deg(M, R @ G)

"""Plain NumPy/SciPy rotation averaging: the reference of every solve the
benchmark checks.

A transcription of the reference C++'s algorithms (ral/l1_irls.cpp):
``init_mst`` (:915-979, the spanning-tree sweep in edge order), L1-RA
(l1-magic's ``l1decode_pd`` on each tangent axis, :228-468 and :850-910)
and IRLS with the Geman-McClure weights (:560-760), on scipy's sparse
direct solver in f64.  The solver part is a frozen copy of the repository's
test oracle (``tests/ref_impl.py``).  Quaternions are ``[x y z w]`` rows;
the edge ``(i, j)`` carries ``R_j = R_ij R_i``.

``window_solve`` is the incremental engine's windowed solve as the
reference's ``ViewGraph::rotAvg`` states it (src/ViewGraph.cpp:1263-1435):
the edges whose larger endpoint is among the last ``win`` views, fixed
vertices (outside the window or pinned) first, L1-RA then IRLS from the
current estimates, normalised.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

EPS = 2.2204e-16
PDTOL = 1e-3


def qmul(q1, q2):
    q1 = np.atleast_2d(q1)
    q2 = np.atleast_2d(q2)
    x1, y1, z1, w1 = q1[:, 0], q1[:, 1], q1[:, 2], q1[:, 3]
    x2, y2, z2, w2 = q2[:, 0], q2[:, 1], q2[:, 2], q2[:, 3]
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], axis=1)


def qnormalize(q):
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def geodesic_deg(q1, q2):
    """Angle in degrees between the rotations of two quaternion rows,
    from the relative quaternion's vector part (``atan2``), which keeps
    its digits where ``arccos`` of a dot product near 1 would not."""
    a = qnormalize(np.atleast_2d(q1)).copy()
    a[:, :3] *= -1
    r = qmul(a, qnormalize(np.atleast_2d(q2)))
    return np.degrees(2 * np.arctan2(np.linalg.norm(r[:, :3], axis=1),
                                     np.abs(r[:, 3])))


def delta_rel(edges, QQ, Q):
    Qi = Q[edges[:, 0]]
    Qj_inv = Q[edges[:, 1]].copy()
    Qj_inv[:, 3] *= -1
    return qmul(Qj_inv, qmul(QQ, Qi))


def log_map(q):
    q = np.array(q, float)
    s2 = np.linalg.norm(q[:, :3], axis=1)
    theta = 2 * np.arctan2(s2, q[:, 3])
    theta = np.where(theta < -np.pi, theta + 2 * np.pi, theta)
    theta = np.where(theta >= np.pi, theta - 2 * np.pi, theta)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = theta / s2
    out = q.copy()
    out[:, :3] *= scale[:, None]
    out[:, 3] = theta
    out[s2 < EPS, :3] = 0
    return out


def exp_map(v):
    v = np.array(v, float)[:, :3]
    theta = np.linalg.norm(v, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        coef = np.sin(theta / 2) / theta
    coef = np.where(np.isfinite(coef), coef, 0.0)
    return np.concatenate([v * coef[:, None], np.cos(theta / 2)[:, None]],
                          axis=1)


def make_A(n, f, edges):
    """Incidence matrix over the free vertices ``f..n-1``."""
    rows, cols, vals = [], [], []
    for k, (i, j) in enumerate(edges):
        if j - f < 0:
            continue
        rows.append(k), cols.append(j - f), vals.append(1.0)
        if i - f < 0:
            continue
        rows.append(k), cols.append(i - f), vals.append(-1.0)
    return sp.csc_matrix((vals, (rows, cols)), shape=(len(edges), n - f))


def _qmul1(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def init_mst(Q, QQ, edges, f):
    """Spanning-tree initialisation from vertex 0: sweep the edges in
    order, set each newly reached vertex from its tree edge (the inverse
    with ``w`` negated), until every vertex is reached; the first ``f``
    rotations are kept."""
    Q = np.array(Q, np.float64, copy=True)
    n = len(Q)
    flags = np.zeros(n, bool)
    flags[0] = True
    count = 1
    while count < n:
        spanned = False
        for k, (e1, e2) in enumerate(np.asarray(edges).tolist()):
            if flags[e1] and not flags[e2]:
                if e2 >= f:
                    Q[e2] = _qmul1(QQ[k], Q[e1])
                flags[e2] = True
                count += 1
                spanned = True
            elif flags[e2] and not flags[e1]:
                if e1 >= f:
                    inv = np.array(QQ[k], np.float64)
                    inv[3] = -inv[3]
                    Q[e1] = _qmul1(inv, Q[e2])
                flags[e1] = True
                count += 1
                spanned = True
        if not spanned:
            raise ValueError(f"edges span {count} of {n} vertices")
    return Q


def l1decode_pd(x0, A, y, pdmaxiter):
    alpha, beta, mu = 0.01, 0.5, 10.0
    m = len(y)
    x = x0.copy()
    Ax = A @ x
    ra = np.abs(y - Ax)
    u = 0.95 * ra + 0.10 * ra.max()
    fu1 = Ax - y - u
    fu2 = -Ax + y - u
    lamu1 = -1.0 / fu1
    lamu2 = -1.0 / fu2
    Atv = A.T @ (lamu1 - lamu2)
    sdg = -(fu1 @ lamu1 + fu2 @ lamu2)
    tau = mu * 2 * m / sdg
    rdual = np.concatenate([Atv, 1.0 - lamu1 - lamu2])
    rcent = np.concatenate([-lamu1 * fu1, -lamu2 * fu2]) - 1.0 / tau
    resnorm = np.sqrt(rdual @ rdual + rcent @ rcent)
    pditer = 0
    xp = x
    while not (sdg < PDTOL or pditer >= pdmaxiter):
        pditer += 1
        w2 = -1 - 1.0 / tau * (1 / fu1 + 1 / fu2)
        sig1 = -lamu1 / fu1 - lamu2 / fu2
        sig2 = lamu1 / fu1 - lamu2 / fu2
        sigx = sig1 - sig2 ** 2 / sig1
        w1 = -1.0 / tau * (A.T @ (-1 / fu1 + 1 / fu2))
        w1p = w1 - A.T @ ((sig2 / sig1) * w2)
        H11p = (A.T @ sp.diags(sigx) @ A).tocsc()
        dx = spla.spsolve(H11p, w1p)
        Adx = A @ dx
        du = (w2 - sig2 * Adx) / sig1
        dlamu1 = -(lamu1 / fu1) * (Adx - du) - lamu1 - (1 / tau) / fu1
        dlamu2 = (lamu2 / fu2) * (Adx + du) - lamu2 - (1 / tau) / fu2
        Atdv = A.T @ (dlamu1 - dlamu2)
        s = 1.0
        for num, den in ((-lamu1, dlamu1), (-lamu2, dlamu2)):
            ind = den < 0
            if ind.any():
                s = min(s, (num[ind] / den[ind]).min())
        for num, den in ((-fu1, Adx - du), (-fu2, -Adx - du)):
            ind = den > 0
            if ind.any():
                s = min(s, (num[ind] / den[ind]).min())
        s *= 0.99
        suffdec = False
        backiter = 0
        while not suffdec:
            xp = x + s * dx
            up = u + s * du
            Axp = Ax + s * Adx
            Atvp = Atv + s * Atdv
            lamu1p = lamu1 + s * dlamu1
            lamu2p = lamu2 + s * dlamu2
            fu1p = Axp - y - up
            fu2p = -Axp + y - up
            rdp = np.concatenate([Atvp, 1.0 - lamu1p - lamu2p])
            rcp = np.concatenate([-lamu1p * fu1p, -lamu2p * fu2p]) - 1.0 / tau
            suffdec = (np.sqrt(rdp @ rdp + rcp @ rcp)
                       <= (1 - alpha * s) * resnorm)
            s *= beta
            backiter += 1
            if backiter > 32:
                return x
        x, u, Ax, Atv = xp, up, Axp, Atvp
        lamu1, lamu2, fu1, fu2 = lamu1p, lamu2p, fu1p, fu2p
        sdg = -(fu1 @ lamu1 + fu2 @ lamu2)
        tau = mu * 2 * m / sdg
        rcent = np.concatenate([-lamu1 * fu1, -lamu2 * fu2]) - 1.0 / tau
        rdual = rdp
        resnorm = np.sqrt(rdual @ rdual + rcent @ rcent)
    return xp


def l1ra(QQ, edges, Q, f, max_iters, change_th, pd_iters=2):
    Q = np.array(Q, np.float64, copy=True)
    A = make_A(len(Q), f, edges)
    n = len(Q) - f
    score, it = np.inf, 0
    while score >= change_th and it < max_iters:
        w = log_map(delta_rel(edges, QQ, Q))
        W = np.zeros((n, 4))
        for c in range(3):
            W[:, c] = l1decode_pd(np.zeros(n), A, w[:, c], pd_iters)
        score = np.linalg.norm(W[:, :3], axis=1).mean()
        Q[f:] = qmul(Q[f:], exp_map(W))
        it += 1
    return Q, it


def irls(QQ, edges, Q, f, sigma, max_iters, change_th):
    """IRLS with Geman-McClure weights ``1 / (e^2 + sigma^2)``; returns
    ``(Q, weights, iterations)``."""
    Q = np.array(Q, np.float64, copy=True)
    A = make_A(len(Q), f, edges)
    weights = np.ones(len(QQ))
    score, it = np.inf, 0
    while score > change_th and it < max_iters:
        w = log_map(delta_rel(edges, QQ, Q))
        DA = sp.diags(weights) @ A
        DB = weights[:, None] * w[:, :3]
        G = (DA.T @ DA).tocsc()
        W3 = np.asarray(spla.spsolve(G, DA.T @ DB)).reshape(-1, 3)
        E = A @ W3 - w[:, :3]
        weights = 1.0 / (np.sum(E ** 2, axis=1) + sigma ** 2)
        score = np.linalg.norm(W3, axis=1).mean()
        Q[f:] = qmul(Q[f:], exp_map(np.concatenate(
            [W3, np.zeros((len(W3), 1))], axis=1)))
        it += 1
    return Q, weights, it


def solve(QQ, edges, Q0, f, *, sigma, l1_iters, irls_iters, change_th):
    """L1-RA then IRLS from ``Q0``: ``(Q_l1, Q, weights)``, ``Q``
    normalised."""
    Q1, _ = l1ra(QQ, edges, Q0, f, l1_iters, change_th)
    Q2, w, _ = irls(QQ, edges, Q1, f, sigma, irls_iters, change_th)
    return Q1, qnormalize(Q2), w


def window_solve(Q, fixed, edges, QQ, win, *, sigma, l1_iters, irls_iters,
                 change_th):
    """The incremental engine's windowed solve of views ``Q (n, 4)`` over
    the edge list ``edges (m, 2)`` / ``QQ (m, 4)``: every view's rotation
    after it (unchanged where the window is skipped or the view fixed)."""
    Q = np.array(Q, np.float64, copy=True)
    n = len(Q)
    win = min(n, win)
    if win < 2:
        return Q
    lo = n - win
    ids = np.flatnonzero(edges[:, 1] >= lo)
    # the engine lists a window's edges by their larger endpoint, in the
    # order each was added
    ids = ids[np.argsort(edges[ids, 1], kind="stable")]
    if len(ids) < win:
        return Q
    sub = edges[ids]
    verts = np.unique(sub)
    if len(verts) < win:
        return Q
    vfixed = (verts < lo) | fixed[verts]
    order = np.concatenate([verts[vfixed], verts[~vfixed]])
    f = int(vfixed.sum())
    new = np.empty(n, np.int64)
    new[order] = np.arange(len(order))
    Q0 = Q[order].copy()
    if f == 0:
        Q0[0] = (0.0, 0.0, 0.0, 1.0)
        f = 1
    _, Qs, _ = solve(QQ[ids], new[sub], Q0, f, sigma=sigma,
                     l1_iters=l1_iters, irls_iters=irls_iters,
                     change_th=change_th)
    Q[order[f:]] = Qs[f:]
    return Q

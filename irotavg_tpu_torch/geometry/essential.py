"""Essential-matrix RANSAC (8-point hypotheses + homography rescue) and
cheirality-checked pose recovery.

Port of ``irotavg_tpu/geometry/essential.py`` (contract of
cv::findEssentialMat + cv::recoverPose as used by
``ViewGraph::findRelativePose``, src/ViewGraph.cpp:600-650).  The math is
ported, not the reference's TPU substitutes: ``torch.linalg.svd`` and
``torch.linalg.eigh`` replace the unrolled Jacobi eigensolver, the
``E^T E`` SVD and the Householder null vector.  Singular vectors carry an
arbitrary sign, so an essential matrix agrees with the reference's only
up to sign — which changes no Sampson residual, no projection and no
cheirality count.

The sample draws are the reference's own: JAX's threefry keys derived on
the host (``prng.py``) and mapped to positions by ``ops/draw.py`` (one
kernel launch on the card).  The hypotheses, the votes and the pose
recovery are solved in f64 (native on the H100) from f32 points, and E,
R and t return in f32: with the same draws, f32 solves on cuSOLVER and
LAPACK changed the inlier mask of 4 and the cheirality count of 8 in 48
calls at the per-frame shape, and f64 solves none of the masks.
"""

from __future__ import annotations

import functools

import torch

from irotavg_tpu_torch.ops.draw import draw_positions

F64 = torch.float64
DIST_THRESH = 50.0  # cv::recoverPose triangulated-distance cutoff
RERANK_K = 48       # Sampson-best hypotheses re-ranked by cheirality
# A minimal sample that drew one correspondence twice has a design of
# rank < 8 (and a refit on fewer than 8 inliers a singular Gram matrix),
# whose null space the solvers span with bases of their own (LAPACK and
# cuSOLVER differ), so its "null vector" would depend on the device.
# _pick_null takes instead the projection of a fixed direction onto the
# null space, which does not depend on the basis; for a one-dimensional
# null space that is the null vector, with its sign fixed.
NULL_PICK = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0)
RANK_TOL = 1e-10       # singular values below this share of the largest
GRAM_RANK_TOL = 1e-12  # Gram eigenvalues below this share of the largest

_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device):
    """The constant ``values`` as a tensor on ``device``, made once per
    dtype and device (made on every call it would be a host-to-device
    copy each time).  Shared: never written in place."""
    return torch.tensor(values, dtype=dtype, device=device)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _det3x3(M):
    return torch.sum(_cross(M[..., :, 0], M[..., :, 1]) * M[..., :, 2],
                     dim=-1)


def _svd3x3(E):
    """SVD of (..., 3, 3) -> (U, s, V), singular values descending, with
    the third columns completed as ``u0 x u1`` / ``v0 x v1`` so that U and
    V are proper rotations (the reference's contract; the sign of det E
    then sits in the implicit third singular value).  Each pair ``(u_i,
    v_i)`` takes the sign that makes ``u_i . NULL_PICK[:3]`` positive, so
    the pose and homography hypotheses come in the same order whichever
    solver (LAPACK or cuSOLVER) made the vectors."""
    U, s, Vh = torch.linalg.svd(E)
    V = Vh.transpose(-2, -1)
    r = _const(NULL_PICK[:3], U.dtype, U.device)
    sgn = torch.where((r @ U) < 0, -1.0, 1.0).to(U.dtype)[..., None, :]
    U, V = U * sgn, V * sgn
    U = torch.cat([U[..., :, :2],
                   _cross(U[..., :, 0], U[..., :, 1])[..., :, None]], dim=-1)
    V = torch.cat([V[..., :, :2],
                   _cross(V[..., :, 0], V[..., :, 1])[..., :, None]], dim=-1)
    return U, s, V


def _hom(p):
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def sampson_distance(E, p1, p2):
    """Squared Sampson distance for (..., 3, 3) E against (N, 2)
    normalised points -> (..., N)."""
    x1, x2 = _hom(p1), _hom(p2)
    Ex1 = x1 @ E.transpose(-2, -1)                    # (..., N, 3)
    Etx2 = x2 @ E
    num = torch.sum(x2 * Ex1, dim=-1) ** 2
    den = (Ex1[..., :, 0] ** 2 + Ex1[..., :, 1] ** 2
           + Etx2[..., :, 0] ** 2 + Etx2[..., :, 1] ** 2)
    return num / torch.clamp(den, min=1e-18)


def _T_of(c, s):
    """Hartley transform ``[[s,0,-s cx],[0,s,-s cy],[0,0,1]]``."""
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -s * c[..., 0]], -1),
        torch.stack([z, s, -s * c[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], dim=-2)


def _T_inv_of(c, s):
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    si = 1.0 / s
    return torch.stack([
        torch.stack([si, z, c[..., 0]], -1),
        torch.stack([z, si, c[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], dim=-2)


def _hartley_T(sw, sx, sy, sxx, syy, eps=1e-12):
    """Hartley transform from weighted moments (centroid to the origin,
    RMS radius sqrt(2))."""
    w = torch.clamp(sw, min=eps)
    c = torch.stack([sx / w, sy / w], dim=-1)
    var = torch.clamp((sxx + syy) / w - c[..., 0] ** 2 - c[..., 1] ** 2,
                      min=eps)
    return _T_of(c, torch.sqrt(2.0 / var))


def _kron3(T2, T1):
    """(..., 9, 9) Kronecker product of two (..., 3, 3) blocks."""
    k = T2[..., :, None, :, None] * T1[..., None, :, None, :]
    return k.reshape(k.shape[:-4] + (9, 9))


def _design_sq(p1, p2):
    """(N, 81) per-row outer products of the 8-point design rows
    ``a_n = x2h (x) x1h``."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=1)
    return (A[:, :, None] * A[:, None, :]).reshape(-1, 81)


def _solve_gram(AtA):
    """Null direction of batched 8-point Gram matrices (..., 9, 9), with
    Hartley conditioning applied as the congruence ``M AtA M^T``."""
    sw = AtA[..., 8, 8]
    T1 = _hartley_T(sw, AtA[..., 8, 6], AtA[..., 8, 7],
                    AtA[..., 6, 6], AtA[..., 7, 7])
    T2 = _hartley_T(sw, AtA[..., 2, 8], AtA[..., 5, 8],
                    AtA[..., 2, 2], AtA[..., 5, 5])
    M = _kron3(T2, T1)
    AtA_n = M @ AtA @ M.transpose(-2, -1)
    e_n = _gram_null(AtA_n)
    e = (M.transpose(-2, -1) @ e_n[..., None])[..., 0]
    e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                        min=1e-30)
    return e.reshape(e.shape[:-1] + (3, 3))


def _eight_point(p1, p2, weights):
    """Weighted 8-point solve -> (..., 3, 3) E (unprojected)."""
    AtA = (weights @ _design_sq(p1, p2)).reshape(weights.shape[:-1] + (9, 9))
    return _solve_gram(AtA)


def _pick_null(rows, null):
    """``NULL_PICK`` projected onto the span of the orthonormal ``rows``
    (..., 9, 9) selected by ``null`` (..., 9), as a unit vector."""
    r = _const(NULL_PICK, rows.dtype, rows.device)
    e = (((rows @ r) * null)[..., None, :] @ rows)[..., 0, :]
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                           min=1e-300)


def _nullvec(A):
    """Unit null direction of batched (..., 8, 9) matrices: the right
    singular vectors of the ninth singular value and of those below
    ``RANK_TOL`` of the largest (:func:`_pick_null`)."""
    _, s, Vh = torch.linalg.svd(A, full_matrices=True)
    null = torch.cat([s < RANK_TOL * s[..., :1],
                      torch.ones_like(s[..., :1], dtype=torch.bool)], dim=-1)
    return _pick_null(Vh, null)


def _gram_null(G):
    """Unit direction of the smallest eigenvalue of symmetric (..., 9, 9)
    Gram matrices, with the eigenvalues below ``GRAM_RANK_TOL`` of the
    largest (:func:`_pick_null`)."""
    w, V = torch.linalg.eigh(G)
    null = w < GRAM_RANK_TOL * w[..., -1:]
    null[..., 0] = True
    return _pick_null(V.transpose(-2, -1), null)


def _norm_pts(q):
    """Per-sample Hartley normalisation of (S, k, 2) points."""
    c = q.mean(dim=-2, keepdim=True)
    var = ((q - c) ** 2).sum(dim=-1).mean(dim=-1)
    s = torch.sqrt(2.0 / torch.clamp(var, min=1e-12))[..., None, None]
    return (q - c) * s, c[..., 0, :], s[..., 0, 0]


def _eight_point_samples(p1, p2, idx):
    """Minimal-sample 8-point E for ``idx (S, 8)`` draws, per-sample
    Hartley normalised; returns (S, 3, 3) (unprojected, unit norm)."""
    q1n, c1, s1 = _norm_pts(p1[idx])
    q2n, c2, s2 = _norm_pts(p2[idx])
    x1, y1 = q1n[..., 0], q1n[..., 1]
    x2, y2 = q2n[..., 0], q2n[..., 1]
    rows = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)
    En = _nullvec(rows).reshape(rows.shape[:-2] + (3, 3))
    E = _T_of(c2, s2).transpose(-2, -1) @ En @ _T_of(c1, s1)
    nrm = torch.sqrt(torch.sum(E * E, dim=(-2, -1), keepdim=True))
    return E / torch.clamp(nrm, min=1e-30)


def _homography_rows(x1, y1, x2, y2):
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    ra = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rb = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    return ra, rb


def _homography_samples(p1, p2, idx):
    """Minimal 4-point DLT homographies for ``idx (S, 4)`` draws, with
    ``x2h ~ H x1h``; returns (S, 3, 3) unit-norm H."""
    q1n, c1, s1 = _norm_pts(p1[idx])
    q2n, c2, s2 = _norm_pts(p2[idx])
    ra, rb = _homography_rows(q1n[..., 0], q1n[..., 1], q2n[..., 0],
                              q2n[..., 1])
    A = torch.cat([ra, rb], dim=-2)                  # (S, 8, 9)
    Hn = _nullvec(A).reshape(A.shape[:-2] + (3, 3))
    H = _T_inv_of(c2, s2) @ Hn @ _T_of(c1, s1)
    nrm = torch.sqrt(torch.sum(H * H, dim=(-2, -1), keepdim=True))
    return H / torch.clamp(nrm, min=1e-30)


def _homography_ls(p1, p2, w):
    """Weighted least-squares homography over all N correspondences
    (``w`` the inlier weights), Hartley-normalised with weighted moments."""
    sw = torch.clamp(w.sum(), min=1e-12)

    def norm_pts(q):
        c = (w @ q) / sw
        d = q - c
        var = (w @ (d * d).sum(dim=-1)) / sw
        s = torch.sqrt(2.0 / torch.clamp(var, min=1e-12))
        return d * s, c, s

    q1, c1, s1 = norm_pts(p1)
    q2, c2, s2 = norm_pts(p2)
    ra, rb = _homography_rows(q1[:, 0], q1[:, 1], q2[:, 0], q2[:, 1])
    AtA = ra.T @ (w[:, None] * ra) + rb.T @ (w[:, None] * rb)
    Hn = _gram_null(AtA).reshape(3, 3)
    H = _T_inv_of(c2, s2) @ Hn @ _T_of(c1, s1)
    return H / torch.clamp(torch.sqrt(torch.sum(H * H)), min=1e-30)


def _transfer_inliers(H, p1, p2, valid, th2):
    """Forward-transfer inlier mask per homography: ``|Hx1/z - x2|^2 <
    th2``."""
    y = _hom(p1) @ H.transpose(-2, -1)                # (..., N, 3)
    zok = torch.abs(y[..., 2]) > 1e-8
    zsafe = torch.where(zok, y[..., 2], torch.ones_like(y[..., 2]))
    e = y[..., :2] / zsafe[..., None] - p2
    d2 = torch.sum(e * e, dim=-1)
    return zok & (d2 < th2) & valid


def _transfer_support(H, p1, p2, valid, th2):
    return _transfer_inliers(H, p1, p2, valid, th2).sum(dim=-1)


def _decompose_homography(H):
    """Faugeras-Lustman decomposition of a calibrated homography into its
    8 (R, t) motion hypotheses: (Rs (8, 3, 3), ts (8, 3))."""
    H = H * torch.where(_det3x3(H) < 0, -1.0, 1.0)[..., None, None]
    U, d, V = _svd3x3(H)
    s = _det3x3(U) * _det3x3(V)
    d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2]
    d2s = torch.where(torch.abs(d2) > 1e-12, d2, torch.ones_like(d2))
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-24)
    x1a = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3a = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1 = e1 * x1a
            x3 = e3 * x3a
            st = (d1 - d3) * x1 * x3 / d2s             # case d' = +d2
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
            Rp = torch.stack([torch.stack([ct, zero, -st], -1),
                              torch.stack([zero, one, zero], -1),
                              torch.stack([st, zero, ct], -1)], dim=-2)
            tp = torch.stack([(d1 - d3) * x1, zero, -(d1 - d3) * x3], -1)
            sf = (d1 + d3) * x1 * x3 / d2s             # case d' = -d2
            cf = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
            Rm = torch.stack([torch.stack([cf, zero, sf], -1),
                              torch.stack([zero, -one, zero], -1),
                              torch.stack([sf, zero, -cf], -1)], dim=-2)
            tm = torch.stack([(d1 + d3) * x1, zero, (d1 + d3) * x3], -1)
            for Rx, tx in ((Rp, tp), (Rm, tm)):
                R = s[..., None, None] * (U @ Rx @ V.transpose(-2, -1))
                t = (U @ tx[..., None])[..., 0]
                t = t / torch.clamp(torch.linalg.vector_norm(
                    t, dim=-1, keepdim=True), min=1e-12)
                Rs.append(R)
                ts.append(t)
    return torch.stack(Rs), torch.stack(ts)


def _skew(t):
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1),
    ], dim=-2)


def _project_essential(E):
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, _, V = _svd3x3(E)
    return (U[..., :, 0:1] * V[..., :, 0:1].transpose(-2, -1)
            + U[..., :, 1:2] * V[..., :, 1:2].transpose(-2, -1))


def _ray_depths(R, t, p1, p2):
    """Closed-form two-ray depths for P1 = [I|0], P2 = [R|t]: minimises
    ``|z1 (R x1h) - z2 x2h + t|`` per point.  Returns (z1, z2, dist1),
    shape (..., N); near-parallel rays get negative depths."""
    x1h, x2h = _hom(p1), _hom(p2)
    a = x1h @ R.transpose(-2, -1)                     # (..., N, 3)
    aa = torch.sum(a * a, dim=-1)
    bb = torch.sum(x2h * x2h, dim=-1)
    ab = torch.sum(a * x2h, dim=-1)
    at = (a @ t[..., None])[..., 0]
    bt = (x2h @ t[..., None])[..., 0]
    det = aa * bb - ab * ab
    good = det > 1e-12 * aa * bb
    det_safe = torch.where(good, det, torch.ones_like(det))
    neg = torch.full_like(det, -1.0)
    z1 = torch.where(good, (-at * bb + ab * bt) / det_safe, neg)
    z2 = torch.where(good, (aa * bt - ab * at) / det_safe, neg)
    dist1 = torch.abs(z1) * torch.sqrt(torch.sum(x1h * x1h, dim=-1))
    return z1, z2, dist1


def _pose_candidates(E):
    """The four (R, t) decompositions of E: (..., 4, 3, 3), (..., 4, 3)."""
    U, _, V = _svd3x3(E)
    Vt = V.transpose(-2, -1)
    U = U * torch.sign(_det3x3(U))[..., None, None]
    Vt = Vt * torch.sign(_det3x3(Vt))[..., None, None]
    W = _const(_W, E.dtype, E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    tu = U[..., :, 2]
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([tu, -tu, tu, -tu], dim=-2))


def _cheirality_counts(E, p1, p2, inl):
    """Best-branch cheirality count for (..., 3, 3) E against the Sampson
    inlier masks ``inl (..., N)``."""
    Rs, ts = _pose_candidates(E)
    z1, z2, dist = _ray_depths(Rs, ts, p1, p2)        # (..., 4, N)
    good = (z1 > 0) & (z2 > 0) & (dist < DIST_THRESH) & inl[..., None, :]
    return good.sum(dim=-1).amax(dim=-1)


def ransac_essential(p1, p2, valid, key, *, th_norm, n_samples=1024,
                     E_seed=None, rerank_k=RERANK_K, h_samples=192):
    """RANSAC essential matrix from (N, 2) normalised correspondences.

    Returns (E (3, 3), inlier_mask (N,), n_inliers).  ``th_norm`` is the
    Sampson threshold in normalised coordinates and ``key`` a host key
    (``prng.key``).  Hypotheses: ``n_samples`` minimal 8-point samples
    drawn from ``key``, ``E_seed`` (optional (3, 3)) and, when
    ``h_samples``, the 8 Faugeras motions of the least-squares refit of
    the best of ``h_samples`` 4-point homographies drawn from
    ``fold_in(key, 1)``.  The Sampson top ``rerank_k`` are re-ranked by
    cheirality; the winner is refit on its inliers and the refit kept
    unless it loses cheirality support.
    """
    idx, idx_h = draw_positions(valid[None], [key],
                                ((n_samples, 8), (h_samples, 4)))
    return ransac_drawn(p1, p2, valid, idx[0], idx_h[0], th_norm=th_norm,
                        E_seed=E_seed, rerank_k=rerank_k)


def ransac_drawn(p1, p2, valid, idx, idx_h, *, th_norm, E_seed=None,
                 rerank_k=RERANK_K):
    """:func:`ransac_essential` on drawn sample positions ``idx (S, 8)``
    and ``idx_h (H, 4)`` (``ops/draw.py:draw_positions``; callers with
    several lanes draw them all at once).  Solves and votes in f64 (see
    the module doc); E comes back in the points' dtype."""
    dtype = p1.dtype
    p1, p2 = p1.to(F64), p2.to(F64)
    E_cand = _project_essential(_eight_point_samples(p1, p2, idx))
    if E_seed is not None:
        E_cand = torch.cat([E_cand, E_seed[None].to(F64)], dim=0)
    th_norm = torch.as_tensor(th_norm, device=p1.device).to(F64)
    th2 = th_norm * th_norm

    if idx_h.shape[0]:
        Hc = _homography_samples(p1, p2, idx_h)
        sup_h = _transfer_support(Hc, p1, p2, valid[None, :], 4.0 * th2)
        H_best = Hc[torch.argmax(sup_h)]
        hinl = _transfer_inliers(H_best, p1, p2, valid, 4.0 * th2)
        H_ref = _homography_ls(p1, p2, hinl.to(p1.dtype))
        sup_ref = _transfer_support(H_ref, p1, p2, valid, 4.0 * th2)
        H_use = torch.where(sup_ref >= sup_h.max(), H_ref, H_best)
        Rh, th_ = _decompose_homography(H_use)
        E_h = _project_essential(_skew(th_) @ Rh)
        E_cand = torch.cat([E_cand, E_h], dim=0)

    inl = (sampson_distance(E_cand, p1, p2) < th2) & valid[None, :]
    scores = inl.sum(dim=1)
    # top-k with lower indices first among ties (jax.lax.top_k's order)
    top = torch.sort(scores, descending=True, stable=True)[1][:rerank_k]
    che = _cheirality_counts(E_cand[top], p1, p2, inl[top])
    best = top[torch.argmax(che)]

    E_ref = _project_essential(_eight_point(p1, p2, inl[best].to(F64)))
    inl_ref = (sampson_distance(E_ref, p1, p2) < th2) & valid
    che_ref = _cheirality_counts(E_ref, p1, p2, inl_ref)
    better = che_ref >= che.max()
    E_out = torch.where(better, E_ref, E_cand[best])
    inl_out = torch.where(better, inl_ref, inl[best])
    return E_out.to(dtype), inl_out, inl_out.sum()


def recover_pose(E, p1, p2, inlier_mask):
    """Cheirality-checked (R, t) from E (cv::recoverPose contract), solved
    in f64 like the RANSAC.  Returns (R, t, n_cheirality, pose_mask) with
    x2 ~ R x1 + t, R and t in E's dtype."""
    Rs, ts = _pose_candidates(E.to(F64))
    z1, z2, dist = _ray_depths(Rs, ts, p1.to(F64), p2.to(F64))  # (4, N)
    good = ((z1 > 0) & (z2 > 0) & (dist < DIST_THRESH)
            & inlier_mask[None, :])
    counts = good.sum(dim=1)
    k = torch.argmax(counts)
    return Rs[k].to(E.dtype), ts[k].to(E.dtype), counts[k], good[k]

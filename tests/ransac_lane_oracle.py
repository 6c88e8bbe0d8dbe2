"""The port's RANSAC tail as it ran before its kernels: the homography
rescue, the cheirality re-rank, the refit's check and ``recover_pose``
one lane at a time in eager PyTorch, with ``torch.linalg`` solves
(``eigh`` for the 9x9 Gram matrices, ``svd`` for the 3x3 ones).

The tests hold the plain versions of the tail kernels (``ops/ransac.py``)
and the batched route of ``geometry/essential.py`` to it: the same draws,
pool, top-48 order, picks, keep choices, masks and cheirality counts, and
E, R and t within 1e-10 up to sign.
"""

from __future__ import annotations

import functools

import torch

from irotavg_tpu_torch.ops.ransac import (
    NULL_PICK, ransac_hypotheses, ransac_vote,
)

F64 = torch.float64
DIST_THRESH = 50.0  # cv::recoverPose triangulated-distance cutoff
RERANK_K = 48       # Sampson-best hypotheses re-ranked by cheirality
# A minimal sample that drew one correspondence twice has a design of
# rank < 8 (and a refit on fewer than 8 inliers a singular Gram matrix),
# whose null space solvers span with bases of their own (LAPACK and
# cuSOLVER differ), so its "null vector" would depend on the device.
# ops/ransac.py and _pick_null take instead the projection of NULL_PICK
# onto the null space, which does not depend on the basis; for a
# one-dimensional null space that is the null vector, with its sign fixed.
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


def _gram_null(G):
    """Unit direction of the smallest eigenvalue of symmetric (..., 9, 9)
    Gram matrices, with the eigenvalues below ``GRAM_RANK_TOL`` of the
    largest (:func:`_pick_null`)."""
    w, V = torch.linalg.eigh(G)
    null = w < GRAM_RANK_TOL * w[..., -1:]
    null[..., 0] = True
    return _pick_null(V.transpose(-2, -1), null)


def _homography_rows(x1, y1, x2, y2):
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    ra = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rb = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    return ra, rb


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
    E, inl = ransac_lanes(
        p1[None], p2[None], valid[None], th_norm, keys=[key],
        n_samples=n_samples, h_samples=h_samples,
        E_seed=None if E_seed is None else E_seed[None], rerank_k=rerank_k)
    return E[0], inl[0], inl[0].sum()


def ransac_drawn(p1, p2, valid, idx, idx_h, *, th_norm, E_seed=None,
                 rerank_k=RERANK_K):
    """:func:`ransac_essential` on given sample positions ``idx (S, 8)``
    and ``idx_h (H, 4)`` instead of a key."""
    E, inl = ransac_lanes(
        p1[None], p2[None], valid[None], th_norm,
        positions=(idx[None], idx_h[None]), n_samples=idx.shape[0],
        h_samples=idx_h.shape[0],
        E_seed=None if E_seed is None else E_seed[None], rerank_k=rerank_k)
    return E[0], inl[0], inl[0].sum()


def candidate_pool(p1, p2, valid, th2, *, keys=None, positions=None,
                   n_samples, h_samples, E_seed=None):
    """The hypothesis pool of L lanes (f64 inputs, ``th2`` the squared
    Sampson threshold, a 0-dim f64 tensor): (models (L, C, 3, 3), the
    homography samples' transfer support (L, h_samples) int32), where the
    models are each lane's projected minimal-sample E, its ``E_seed``
    (optional (L, 3, 3)) and, with ``h_samples``, the 8 motions of its
    rescued homography."""
    E_cand, Hc = ransac_hypotheses(p1, p2, valid, keys, n_samples,
                                   h_samples, positions)
    parts = [E_cand]
    if E_seed is not None:
        parts.append(E_seed.to(F64)[:, None])
    L = p1.shape[0]
    if not h_samples:
        return torch.cat(parts, dim=1), torch.zeros(
            (L, 0), dtype=torch.int32, device=p1.device)
    th2h = 4.0 * th2
    hmask, sup_h = ransac_vote(Hc, p1, p2, valid, th2h, "transfer")
    lanes = torch.arange(L, device=p1.device)
    best = torch.argmax(sup_h, dim=1)
    H_best, hinl = Hc[lanes, best], hmask[lanes, best]
    H_ref = torch.stack([_homography_ls(p1[k], p2[k], hinl[k].to(F64))
                         for k in range(L)])
    _, sup_ref = ransac_vote(H_ref[:, None], p1, p2, valid, th2h,
                             "transfer")
    keep = (sup_ref[:, 0] >= sup_h[lanes, best])[:, None, None]
    H_use = torch.where(keep, H_ref, H_best)
    E_h = []
    for k in range(L):
        Rh, th_ = _decompose_homography(H_use[k])
        E_h.append(_project_essential(_skew(th_) @ Rh))
    parts.append(torch.stack(E_h))
    return torch.cat(parts, dim=1), sup_h


def ransac_lanes(p1, p2, valid, th_norm, *, keys=None, positions=None,
                 n_samples, h_samples, E_seed=None, rerank_k=RERANK_K):
    """:func:`ransac_essential` for L lanes of correspondences ``p1``,
    ``p2`` (L, N, 2) with ``valid`` (L, N), lane ``l`` drawing from
    ``keys[l]`` (or sampling ``positions``, ``(L, n_samples, 8)`` and
    ``(L, h_samples, 4)``).  The minimal samples of every lane are solved
    in one ``ransac_hypotheses`` launch and each vote over every lane is
    one ``ransac_vote`` launch; the homography rescue, the cheirality
    re-rank and the refit run lane by lane.  Solves and votes in f64 (see
    the module doc).  Returns (E (L, 3, 3) in the points' dtype,
    inlier_mask (L, N))."""
    dtype = p1.dtype
    p1, p2 = p1.to(F64), p2.to(F64)
    th_norm = torch.as_tensor(th_norm, device=p1.device).to(F64)
    th2 = th_norm * th_norm
    models, _ = candidate_pool(p1, p2, valid, th2, keys=keys,
                               positions=positions, n_samples=n_samples,
                               h_samples=h_samples, E_seed=E_seed)
    inl, scores = ransac_vote(models, p1, p2, valid, th2, "sampson")
    L = p1.shape[0]
    picks = []
    for k in range(L):
        # top-k with lower indices first among ties (jax.lax.top_k's
        # order)
        top = torch.sort(scores[k], descending=True,
                         stable=True)[1][:rerank_k]
        che = _cheirality_counts(models[k, top], p1[k], p2[k],
                                 inl[k, top])
        best = top[torch.argmax(che)]
        E_ref = _project_essential(_eight_point(p1[k], p2[k],
                                                inl[k, best].to(F64)))
        picks.append((best, che.max(), E_ref))
    E_ref = torch.stack([E for _, _, E in picks])
    inl_ref, _ = ransac_vote(E_ref[:, None], p1, p2, valid, th2,
                             "sampson")
    E_out, inl_out = [], []
    for k, (best, che_max, E_r) in enumerate(picks):
        che_ref = _cheirality_counts(E_r, p1[k], p2[k], inl_ref[k, 0])
        better = che_ref >= che_max
        E_out.append(torch.where(better, E_r, models[k, best]))
        inl_out.append(torch.where(better, inl_ref[k, 0], inl[k, best]))
    return torch.stack(E_out).to(dtype), torch.stack(inl_out)


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

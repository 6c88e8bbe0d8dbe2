"""Essential-matrix RANSAC (8-point hypotheses + homography rescue) and
cheirality-checked pose recovery.

Port of ``irotavg_tpu/geometry/essential.py`` (contract of
cv::findEssentialMat + cv::recoverPose as used by
``ViewGraph::findRelativePose``, src/ViewGraph.cpp:600-650).  The math is
ported, not the reference's TPU substitutes.

Every step of a call runs for all of its L lanes at once, in
``ops/ransac.py``'s kernels on the card (their plain versions, the same
arithmetic, on the CPU): the minimal samples drawn and solved
(``ransac_hypotheses``), the homography samples' transfer vote
(``ransac_vote``), the best one's least-squares refit
(``homography_refit``) and its vote, the keep choice and the 8 motions of
the kept H (``homography_pool``), the Sampson vote of the pool, the
cheirality re-rank of its top ``RERANK_K`` (``cheirality_rerank``), the
8-point refit of the pick (``essential_refit``) and its vote, the refit's
check and :func:`recover_pose` (``ransac_finish``).  Between the first
launch and the return the host reads nothing from the card.  Singular
vectors carry an arbitrary sign, so their signs are fixed
(``ops/ransac.py:_svd3``); an essential matrix agrees with the
reference's only up to sign, which changes no Sampson residual, no
projection and no cheirality count.

Everything is solved in f64 (native on the H100) from f32 points, and E,
R and t return in f32, so the card decides as the CPU does: every kernel
equals its plain version bit for bit.

Under a profiler session the hypotheses and their vote run inside the
program span ``geometry.ransac.kernels`` and the rest (the tail) inside
``geometry.ransac.lanes``, whose attribute ``launches`` counts the tail
kernels' launches (``utils/timing.py:span``).
"""

from __future__ import annotations

import torch

from irotavg_tpu_torch.ops import ransac
from irotavg_tpu_torch.ops.ransac import (  # noqa: F401  (DIST_THRESH: API)
    DIST_THRESH, ransac_hypotheses, ransac_vote,
)
from irotavg_tpu_torch.utils.timing import span

F64 = torch.float64
RERANK_K = 48       # Sampson-best hypotheses re-ranked by cheirality


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
    E, inl = ransac_pose_lanes(
        p1[None], p2[None], valid[None], th_norm, keys=[key],
        n_samples=n_samples, h_samples=h_samples,
        E_seed=None if E_seed is None else E_seed[None],
        rerank_k=rerank_k)[:2]
    return E[0], inl[0], inl[0].sum()


def ransac_drawn(p1, p2, valid, idx, idx_h, *, th_norm, E_seed=None,
                 rerank_k=RERANK_K):
    """:func:`ransac_essential` on given sample positions ``idx (S, 8)``
    and ``idx_h (H, 4)`` instead of a key."""
    E, inl = ransac_pose_lanes(
        p1[None], p2[None], valid[None], th_norm,
        positions=(idx[None], idx_h[None]), n_samples=idx.shape[0],
        h_samples=idx_h.shape[0],
        E_seed=None if E_seed is None else E_seed[None],
        rerank_k=rerank_k)[:2]
    return E[0], inl[0], inl[0].sum()


def _hypotheses(p1, p2, valid, th2, keys, positions, n_samples, h_samples):
    """The minimal-sample E (L, S, 3, 3) and H (L, H, 3, 3) of every lane
    and the H samples' transfer vote (masks, support; None without H)."""
    with span("geometry.ransac.kernels"):
        E_cand, Hc = ransac_hypotheses(p1, p2, valid, keys, n_samples,
                                       h_samples, positions)
        if not h_samples:
            return E_cand, Hc, None, None
        hmask, sup_h = ransac_vote(Hc, p1, p2, valid, 4.0 * th2, "transfer")
    return E_cand, Hc, hmask, sup_h


def _pool(p1, p2, valid, th2, E_cand, Hc, hmask, sup_h, E_seed):
    """The candidate pool of :func:`candidate_pool` from the hypotheses:
    the homography rescue (refit, its vote, the keep choice, 8 motions)."""
    if E_seed is not None:
        E_seed = E_seed.to(F64)
    if hmask is None:
        seed = [] if E_seed is None else [E_seed[:, None]]
        return torch.cat([E_cand] + seed, dim=1)
    H_ref, hbest = ransac.homography_refit(Hc, hmask, sup_h, p1, p2)
    _, sup_ref = ransac_vote(H_ref, p1, p2, valid, 4.0 * th2, "transfer")
    return ransac.homography_pool(E_cand, E_seed, Hc, hbest, sup_h, H_ref,
                                  sup_ref)


def candidate_pool(p1, p2, valid, th2, *, keys=None, positions=None,
                   n_samples, h_samples, E_seed=None):
    """The hypothesis pool of L lanes (f64 inputs, ``th2`` the squared
    Sampson threshold, a 0-dim f64 tensor): (models (L, C, 3, 3), the
    homography samples' transfer support (L, h_samples) int32), where the
    models are each lane's projected minimal-sample E, its ``E_seed``
    (optional (L, 3, 3)) and, with ``h_samples``, the 8 motions of its
    rescued homography."""
    E_cand, Hc, hmask, sup_h = _hypotheses(p1, p2, valid, th2, keys,
                                           positions, n_samples, h_samples)
    models = _pool(p1, p2, valid, th2, E_cand, Hc, hmask, sup_h, E_seed)
    if sup_h is None:
        sup_h = torch.zeros((p1.shape[0], 0), dtype=torch.int32,
                            device=p1.device)
    return models, sup_h


def ransac_pose_lanes(p1, p2, valid, th_norm, *, keys=None, positions=None,
                      n_samples, h_samples, E_seed=None, rerank_k=RERANK_K):
    """:func:`ransac_essential` and :func:`recover_pose` for L lanes of
    correspondences ``p1``, ``p2`` (L, N, 2) f32 or f64 with ``valid`` (L,
    N), lane ``l`` drawing from ``keys[l]`` (or sampling ``positions``,
    ``(L, n_samples, 8)`` and ``(L, h_samples, 4)``); every step for every
    lane at once (module doc).  Returns (E (L, 3, 3), inlier_mask (L, N),
    R (L, 3, 3), t (L, 3), n_cheirality (L,), pose_mask (L, N)), E, R and t
    in the points' dtype."""
    dtype = p1.dtype
    if dtype not in (torch.float32, F64):
        raise TypeError(f"points must be float32 or float64, got {dtype}")
    p1, p2 = p1.to(F64), p2.to(F64)
    th_norm = torch.as_tensor(th_norm, device=p1.device).to(F64)
    th2 = th_norm * th_norm
    hyp = _hypotheses(p1, p2, valid, th2, keys, positions, n_samples,
                      h_samples)
    before = ransac.tail_launches()
    with span("geometry.ransac.lanes") as sp:
        models = _pool(p1, p2, valid, th2, *hyp, E_seed)
        inl, scores = ransac_vote(models, p1, p2, valid, th2, "sampson")
        top, che = ransac.cheirality_rerank(models, inl, scores, p1, p2,
                                            rerank_k)
        best, che_max, E_ref = ransac.essential_refit(top, che, inl, p1, p2)
        inl_ref, _ = ransac_vote(E_ref, p1, p2, valid, th2, "sampson")
        E, mask, R, t, n_che, pose_mask = ransac.ransac_finish(
            E_ref, inl_ref, p1, p2, dtype == torch.float32,
            (models, inl, best, che_max))
        launches = ransac.tail_launches() - before
        sp.set(launches=launches)
    return E.to(dtype), mask, R.to(dtype), t.to(dtype), n_che, pose_mask


def recover_pose(E, p1, p2, inlier_mask):
    """Cheirality-checked (R, t) from E (cv::recoverPose contract), solved
    in f64 like the RANSAC (``ops/ransac.py:ransac_finish``).  Returns (R,
    t, n_cheirality, pose_mask) with x2 ~ R x1 + t, R and t in E's
    dtype."""
    _, _, R, t, n, mask = ransac.ransac_finish(
        E.to(F64)[None, None], inlier_mask[None, None], p1.to(F64)[None],
        p2.to(F64)[None], False)
    return R[0].to(E.dtype), t[0].to(E.dtype), n[0], mask[0]

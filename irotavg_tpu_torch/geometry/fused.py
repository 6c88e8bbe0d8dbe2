"""Two-view estimation loops of the per-frame path.

Port of ``irotavg_tpu/geometry/fused.py``: the reference's `refinePose`
(src/ViewGraph.cpp:725-783), `findInitialPose` (:828-902) and the window
walk of `processFrame` (:1035-1145).  The reference runs each as one
compiled ``lax.while_loop`` with all state on device; here each is a
Python loop over device tensors that reads a few scalars back per
iteration, with the same stopping rules: ``stall >= 2`` and
``MAX_ITERS`` for the refine, ``MAX_TRIALS`` with the search radius
x1.25 per retry for the initial pose, and the ``GATE_PX`` keyframe gate.
With ``has_nodes`` (every frame involved carries vocabulary node ids) the
epipolar re-match also requires the same node (gate ``epipolar``);
without a vocabulary the node arrays are zeros and the gate is
``epipolar_nonode``.  `fused_bow_pair_estimate` is the loop-closure
verification (BoW match, RANSAC, refine).

Matches travel as assignment vectors ``m12 (N1,)`` (row -> column or -1).
The reference's ``vmap`` over the K window candidates is a batch axis
here: the candidates' epipolar re-matching reaches the matcher kernel as
one batched launch (``B = K``).

Random draws follow the reference's key tree call for call: the public
functions take the reference's ``seed`` (``prng.key(seed)``), and every
loop splits its keys where the reference's does, one key per lane, so a
lane the port skips (an inactive window candidate, the refine of a pair
whose RANSAC failed) disturbs no other lane's draws.  The RANSACs of a
batch of lanes run every step in one launch for all of them
(``essential.ransac_pose_lanes``).
`fused_initial_pose` and `fused_refine_window` are the two halves of
`fused_process_frame` (before and after the keyframe gate) as public
calls.

The offline pipeline's functions (`fused_flow`, `fused_pair_estimate`)
take P independent frame pairs: their local matching is one batched
launch with a column frame per lane, and so is the refine of the pairs
that reach it.

Under a profiler session each RANSAC batch (:func:`_ransac_lanes`) runs
inside a program span ``geometry.ransac`` (attribute ``lanes``), the
initial-pose search inside ``geometry.initial_pose`` (``trials``) and
the post-gate part inside ``geometry.refine_window`` (``iters``, the
refine iterations of the pose and the window walk); ``utils/timing.py``.
"""

from __future__ import annotations

import math

import torch

from irotavg_tpu_torch import prng
from irotavg_tpu_torch.geometry.essential import ransac_pose_lanes
from irotavg_tpu_torch.matching.matchers import (
    _match_by_bow_core, _match_epipolar_core, _match_locally_core,
)
from irotavg_tpu_torch.utils.timing import span

N_SAMPLES = 512        # minimal 8-point samples per RANSAC
H_SAMPLES = 192        # 4-point homography samples per RANSAC
F64 = torch.float64
MAX_ITERS = 10         # refine alternations
MAX_TRIALS = 6         # initial-pose radius escalations
GATE_PX = 5.0          # keyframe gate on the mean match displacement


def _norm_coords(x, y, cam):
    fx, fy, cx, cy = cam.unbind(-1)
    return torch.stack([(x - cx) / fx, (y - cy) / fy], dim=-1)


def _mean_disp(xa, ya, xb, yb, matched):
    """Mean pixel displacement over the matched entries of the last axis,
    in f32 from an f64 sum (an f32 sum rounds differently on the card and
    the CPU, and the keyframe gate and the next search radius read it)."""
    d = torch.hypot(xa.to(F64) - xb.to(F64), ya.to(F64) - yb.to(F64))
    total = torch.where(matched, d, torch.zeros_like(d)).sum(dim=-1)
    return (total / matched.sum(dim=-1).clamp(min=1)).to(torch.float32)


def _assignment_coords(m12, x1, y1, x2, y2, cam):
    """Normalised correspondences of L assignment vectors ``m12 (L, N1)``
    (rows of frame 1 -> columns of frame 2): ``p1``, ``p2`` (L, N1, 2)
    and ``valid`` (L, N1).  ``x2`` / ``y2`` are ``(L, N2)`` or one
    ``(N2,)`` frame shared by the lanes."""
    j = m12.clamp(min=0)
    if x2.dim() == 1:
        x2, y2 = x2[j], y2[j]
    else:
        x2, y2 = x2.gather(1, j), y2.gather(1, j)
    return (_norm_coords(x1, y1, cam), _norm_coords(x2, y2, cam),
            m12 >= 0)


def _ransac_lanes(p1, p2, valid, keys, th_norm, n_samples=N_SAMPLES):
    """RANSAC + cheirality for L lanes of correspondences ``p1``, ``p2``
    (L, N, 2) with ``valid`` (L, N), lane ``l`` drawing from ``keys[l]``
    (``essential.ransac_pose_lanes``: every step for every lane at once,
    with no host read).  Returns (E, R, t, n_che, pose_mask) with leading
    L."""
    with span("geometry.ransac", lanes=valid.shape[0]):
        E, _, R, t, n_che, pose_mask = ransac_pose_lanes(
            p1, p2, valid, th_norm, keys=keys, n_samples=n_samples,
            h_samples=H_SAMPLES)
        return E, R, t, n_che, pose_mask


def _flip_assignment(m12_cp, n_prev):
    """Current -> previous assignment flipped to previous -> current.
    A target claimed by several rows keeps the largest row id (the
    in-order "last writer wins" of the reference's scatter, made
    deterministic with ``scatter_reduce(amax)``)."""
    matched = m12_cp >= 0
    rows = torch.arange(m12_cp.shape[0], device=m12_cp.device)
    tgt = torch.where(matched, m12_cp, torch.full_like(m12_cp, n_prev))
    out = torch.full((n_prev + 1,), -1, dtype=m12_cp.dtype,
                     device=m12_cp.device)
    out = out.scatter_reduce(0, tgt, torch.where(matched, rows, -1)
                             .to(m12_cp.dtype), "amax")
    return out[:n_prev]


def fused_refine(f1, f2, E0, R0, t0, n0, m12_0, K_inv, sigma2, cam,
                 th_norm, keys, min_pairs, has_nodes=False,
                 max_iters=MAX_ITERS, n_samples=N_SAMPLES):
    """`refinePose` over a batch of B row frames.

    ``f1`` holds row-frame tensors with a leading batch axis
    ``(desc, nodes, valid, angle, x, y, octave)``; ``f2`` the column
    frame's ``(desc, nodes, valid, angle, x, y)``, either one frame shared
    by every lane (``desc`` is ``(N2, 8)``; the kernel reads it with a
    batch stride of 0) or one frame per lane (a leading ``B``, as the
    offline pairs give).  Each lane re-matches with the epipolar gate of
    its current E, re-solves, and keeps the best model while the
    cheirality count strictly grows; a lane stops when the rematch is too
    small (< ``min_pairs``, <= 4), recovery gives <= 6 inliers, or after
    two re-solves without improvement.  Stopped lanes are frozen.
    ``has_nodes`` selects the ``epipolar`` gate (same vocabulary node
    required) over ``epipolar_nonode``.  ``keys`` holds one host key per
    lane, split once per iteration of that lane (the reference's
    ``k, sub = split(k)``).  Returns (E, R, t, best_n, best_m12, iters)
    per lane.
    """
    desc1, nodes1, valid1, angle1, x1, y1, oct1 = f1
    per_lane = f2[0].dim() == 3
    B = desc1.shape[0]
    f32 = torch.float32
    E_cur = E0.to(f32).clone()
    E, R, t = E0.to(f32).clone(), R0.to(f32).clone(), t0.to(f32).clone()
    best_n = n0.to(torch.int64).clone()
    best_m12 = m12_0.to(torch.int64).clone()
    keys = list(keys)
    done = [False] * B
    stall = [0] * B
    it = 0
    while not all(done) and it < max_iters:
        lanes = [b for b in range(B) if not done[b]]
        sel = torch.tensor(lanes, device=desc1.device)
        # in f64, so that the f32 F is the same on the card and the CPU
        F = (K_inv.T.to(F64) @ E_cur[sel].to(F64) @ K_inv.to(F64)).to(f32)
        cols = tuple(a[sel] for a in f2) if per_lane else f2
        m12 = _match_epipolar_core(
            desc1[sel], nodes1[sel], valid1[sel], angle1[sel], x1[sel],
            y1[sel], oct1[sel], *cols, F, sigma2, has_nodes=has_nodes)
        counts = (m12 >= 0).sum(dim=1).tolist()
        subs = []
        for b in lanes:
            keys[b], sub = prng.split(keys[b])
            subs.append(sub)
        # fresh hypotheses every re-solve (no model seeding): a seeded
        # pool locks into a model that cheirality rejects
        Es, Rs, ts, ns, masks = _ransac_lanes(
            *_assignment_coords(m12, x1[sel], y1[sel], cols[4], cols[5],
                                cam), subs, th_norm, n_samples)
        ns = ns.tolist()
        for k, b in enumerate(lanes):
            E_new, R_new, t_new, pose_mask = Es[k], Rs[k], ts[k], masks[k]
            n_new = ns[k]
            usable = (counts[k] >= min_pairs and counts[k] > 4
                      and n_new > 6)
            improved = usable and n_new > int(best_n[b])
            if improved:
                E[b], R[b], t[b] = E_new, R_new, t_new
                best_n[b] = n_new
                best_m12[b] = torch.where(pose_mask, m12[k],
                                          torch.full_like(m12[k], -1))
            if usable:
                E_cur[b] = E_new
            stall[b] = 0 if improved else stall[b] + 1
            done[b] = (not usable) or stall[b] >= 2
        it += 1
    return E, R, t, best_n, best_m12, it


def _initial_pose_core(fc, fp, local_rad0, cam, th_norm, key, min_inliers,
                       nnratio, max_trials, n_samples):
    """`findInitialPose`'s adaptive-radius search.

    ``fc`` / ``fp`` are the current / previous frame tensors ``(desc,
    valid, octave, x, y)``.  Matches current -> previous in a window of
    the escalating radius (x1.25 per retry), sets ``local_rad`` to the
    mean match displacement, and accepts once cheirality inliers exceed
    ``min_inliers``, in at most ``max_trials`` trials of ``n_samples``
    RANSAC samples.  Each trial's RANSAC draws from ``split(key)``'s
    second key, the first going on to the next trial.  Returns (E, R, t,
    n_che, m12, local_rad, rel_valid, accepted); the pose maps previous
    -> current.
    """
    with span("geometry.initial_pose") as sp:
        desc_c, valid_c, oct_c, x_c, y_c = fc
        desc_p, valid_p, oct_p, x_p, y_p = fp
        dev = x_c.device
        f32 = torch.float32
        rad = 2.0 * float(local_rad0)
        local_rad = torch.tensor(float(local_rad0), dtype=f32, device=dev)
        E = torch.eye(3, dtype=f32, device=dev)
        R = torch.eye(3, dtype=f32, device=dev)
        t = torch.zeros(3, dtype=f32, device=dev)
        n_che = 0
        m12_best = torch.full(x_c.shape, -1, dtype=torch.int64, device=dev)
        valid_rel = False
        accepted = False
        trials = 0
        for _ in range(max_trials):
            trials += 1
            m12 = _match_locally_core(desc_c, valid_c, oct_c, x_c, y_c,
                                      desc_p, valid_p, oct_p, x_p, y_p,
                                      rad, nnratio)
            matched = m12 >= 0
            j = m12.clamp(min=0)
            count = int(matched.sum())
            if count > 0:
                local_rad = _mean_disp(x_c, y_c, x_p[j], y_p[j], matched)
            rad = float(torch.tensor(rad, dtype=f32) * 1.25)   # in f32
            if count <= 4:
                # too few: local_rad = 1 fails the keyframe gate downstream;
                # the previous trial's pose is kept
                local_rad = torch.ones((), dtype=f32, device=dev)
                accepted = False
                break
            # pose: previous -> current, so frame-1 coordinates come via m12
            key, sub = prng.split(key)
            p1 = _norm_coords(x_p[j], y_p[j], cam)
            p2 = _norm_coords(x_c, y_c, cam)
            E, R, t, n_new, pose_mask = (a[0] for a in _ransac_lanes(
                p1[None], p2[None], matched[None], [sub], th_norm, n_samples))
            n_che = int(n_new)
            valid_rel = n_che > 6
            accepted = valid_rel and n_che > min_inliers
            m12_best = (torch.where(pose_mask, m12, torch.full_like(m12, -1))
                        if accepted else m12)
            if accepted:
                break
        sp.set(trials=trials)
    return E, R, t, n_che, m12_best, local_rad, valid_rel, accepted


def fused_window_connect(fw, m12_0, active, f2, K_inv, sigma2, cam,
                         th_norm, key, min_matches, has_nodes=False,
                         n_samples=N_SAMPLES):
    """The window walk's per-older-view RANSAC + refinement, batched over
    the K candidates (leading axis of ``fw`` and ``m12_0``; ``active`` a
    host list of bools).  Candidate ``k`` draws from ``split(key, K)[k]``:
    its RANSAC (``n_samples`` samples) from that key, its refine (always
    ``N_SAMPLES``, as the reference's) from the key's ``split(...)[1]``.
    Returns (E, R, t, n_che, m12, success) with leading axis K; the
    caller stops at the first failure."""
    return _window_connect(fw, m12_0, active, f2, K_inv, sigma2, cam,
                           th_norm, key, min_matches, has_nodes,
                           n_samples)[0]


def _window_connect(fw, m12_0, active, f2, K_inv, sigma2, cam, th_norm, key,
                    min_matches, has_nodes, n_samples):
    """:func:`fused_window_connect`; returns its result and the refine
    iterations it ran."""
    desc_w, nodes_w, valid_w, angle_w, x_w, y_w, oct_w = fw
    x2, y2 = f2[4], f2[5]
    K = desc_w.shape[0]
    dev = x2.device
    f32 = torch.float32
    E = torch.zeros((K, 3, 3), dtype=f32, device=dev)
    R = torch.eye(3, dtype=f32, device=dev).repeat(K, 1, 1)
    t = torch.zeros((K, 3), dtype=f32, device=dev)
    n = torch.zeros(K, dtype=torch.int64, device=dev)
    m12 = torch.full(m12_0.shape, -1, dtype=torch.int64, device=dev)
    rel_ok = [False] * K
    iters = 0
    keys = prng.split(key, K)
    # the reference computes and discards the inactive lanes
    lanes = [k for k in range(K) if active[k]]
    refine = []
    if lanes:
        sel = torch.tensor(lanes, device=dev)
        m12_a = m12_0[sel]
        count0 = (m12_a >= 0).sum(dim=1).tolist()
        E[sel], R[sel], t[sel], n[sel], pose_mask = _ransac_lanes(
            *_assignment_coords(m12_a, x_w[sel], y_w[sel], x2, y2, cam),
            [keys[k] for k in lanes], th_norm, n_samples)
        m12[sel] = torch.where(pose_mask, m12_a, torch.full_like(m12_a, -1))
        n0 = n[sel].tolist()
        cntf = (m12[sel] >= 0).sum(dim=1).tolist()
        for i, k in enumerate(lanes):
            rel_ok[k] = count0[i] > 4 and n0[i] > 6
            if cntf[i] > 10:          # implies rel_ok
                refine.append(k)
    if refine:
        sel = torch.tensor(refine, device=dev)
        cnt = (m12[sel] >= 0).sum(dim=1)
        Er, Rr, tr, nr, m12r, iters = fused_refine(
            tuple(a[sel] for a in fw), f2, E[sel], R[sel], t[sel], cnt,
            m12[sel], K_inv, sigma2, cam, th_norm,
            [prng.split(keys[k])[1] for k in refine],
            math.ceil(0.75 * min_matches), has_nodes)
        E[sel], R[sel], t[sel], n[sel], m12[sel] = Er, Rr, tr, nr, m12r
    final = (m12 >= 0).sum(dim=1).tolist()
    success = [rel_ok[k] and final[k] >= min_matches for k in range(K)]
    return (E, R, t, n, m12, success), iters


def fused_initial_pose(fc, fp, local_rad0, cam, th_norm, seed, min_inliers,
                       nnratio):
    """`findInitialPose`'s adaptive-radius search (src/ViewGraph.cpp:
    828-902) as one public call: :func:`_initial_pose_core` with the key
    ``prng.key(seed)``, as the reference makes it.  ``fc`` / ``fp`` are
    the current / previous frame tensors ``(desc, valid, octave, x, y)``;
    matches run current -> previous (gate ``local``); ``min_inliers`` is
    the accept level (the engine passes ``2 * min_matches``).  Returns
    (E, R, t, n_che, m12, local_rad, rel_valid, accepted); the pose maps
    previous -> current."""
    return _initial_pose_core(fc, fp, local_rad0, cam, th_norm,
                              prng.key(seed), min_inliers, nnratio,
                              MAX_TRIALS, N_SAMPLES)


def _stack_candidates(cands, n_feat, has_nodes):
    """Stack per-candidate frame tuples ``(desc, nodes, valid, angle, x, y,
    octave)`` along a leading K; ``nodes`` are zeros (and may be None in
    the tuples) without ``has_nodes``."""
    dev = cands[0][0].device
    cols = list(zip(*cands))
    nodes = (torch.stack(cols[1]) if has_nodes else
             torch.zeros((len(cands), n_feat), dtype=torch.int32, device=dev))
    return (torch.stack(cols[0]), nodes) + tuple(torch.stack(c)
                                                 for c in cols[2:])


def _refine_window_core(fc, fp, fw, m12_w2p, active_w, E0, R0, t0, m12_cp,
                        K_inv, sigma2, cam, th_norm, key, min_matches,
                        has_nodes, n_samples):
    """Everything `processFrame` does after the keyframe gate
    (src/ViewGraph.cpp:1081-1136): the epipolar refine of the initial pose
    in the previous -> current orientation, then the pivot-chained window
    walk over the stacked candidates ``fw``, each from the second key of
    one more ``split`` of ``key``, with ``n_samples`` RANSAC samples.
    Returns ``(refined, window)`` as :func:`fused_process_frame` does."""
    with span("geometry.refine_window") as sp:
        x_p = fp[4]
        m12_pc0 = _flip_assignment(m12_cp, x_p.shape[0])
        cnt0 = (m12_pc0 >= 0).sum()
        min_pairs = math.ceil(0.75 * min_matches)
        key, sub = prng.split(key)
        Er, Rr, tr, nr, m12_pc, iters = fused_refine(
            tuple(a[None] for a in fp), fc[:6], E0[None], R0[None], t0[None],
            cnt0[None], m12_pc0[None], K_inv, sigma2, cam, th_norm, [sub],
            min_pairs, has_nodes, n_samples=n_samples)
        refined = (Er[0], Rr[0], tr[0], nr[0], m12_pc[0])

        # pivot chaining: candidate row -> pivot row -> current column
        j = m12_w2p.clamp(min=0)
        m12_w2c = torch.where(m12_w2p >= 0, m12_pc[0][j],
                              torch.full_like(m12_w2p, -1))
        n_chain = (m12_w2c >= 0).sum(dim=1).tolist()
        active = [bool(a) and c > 5 for a, c in zip(active_w, n_chain)]
        key, sub = prng.split(key)
        window, window_iters = _window_connect(
            fw, m12_w2c, active, fc[:6], K_inv, sigma2, cam, th_norm, sub,
            min_matches, has_nodes, n_samples)
        sp.set(iters=iters + window_iters)
    return refined, window


def fused_refine_window(fc, fp, cands, m12_w2p, active_w, E0, R0, t0,
                        m12_cp, K_inv, sigma2, cam, th_norm, seed,
                        min_matches, has_nodes=False):
    """The post-gate part of `processFrame` as one public call (the JAX
    package's ``fused_refine_window``): :func:`_refine_window_core` with
    the key ``prng.key(seed)``.

    ``fc`` / ``fp`` are the current and previous frame tuples ``(desc,
    nodes, valid, angle, x, y, octave)`` (``nodes`` may be None without
    ``has_nodes``); ``cands`` an unstacked tuple of such tuples, one per
    window candidate; ``m12_cp`` the initial pose's current-row ->
    previous-column assignment.  Returns ``(refined, window)``:
    ``refined = (E, R, t, n, m12_pc)`` (previous row -> current column)
    and ``window = (E, R, t, n, m12, success)`` with leading K.
    """
    fc, fp, fw = _frames_with_nodes(fc, fp, cands, has_nodes)
    return _refine_window_core(
        fc, fp, fw, m12_w2p, active_w, E0, R0, t0, m12_cp, K_inv, sigma2,
        cam, th_norm, prng.key(seed), min_matches, has_nodes, N_SAMPLES)


def _frames_with_nodes(fc, fp, cands, has_nodes):
    """The current and previous frame tuples with zeros for their node
    ids without ``has_nodes``, and the stacked candidates."""
    n_feat = fc[4].shape[0]
    if not has_nodes:
        zeros = torch.zeros(n_feat, dtype=torch.int32, device=fc[4].device)
        fc = fc[:1] + (zeros,) + tuple(fc[2:])
        fp = fp[:1] + (zeros,) + tuple(fp[2:])
    return fc, fp, _stack_candidates(cands, n_feat, has_nodes)


def fused_process_frame(fc, fp, cands, m12_w2p, active_w, local_rad0, K_inv,
                        sigma2, cam, th_norm, seed, min_matches, min_inliers,
                        nnratio, has_nodes=False, max_trials=MAX_TRIALS,
                        n_samples=N_SAMPLES, gate_px=GATE_PX):
    """The whole per-frame pipeline: adaptive initial pose, the 5 px
    keyframe gate, and for accepted frames the epipolar refine of the
    initial pose plus the pivot-chained window walk
    (src/ViewGraph.cpp:1035-1145).

    Frames are tuples ``(desc, nodes, valid, angle, x, y, octave)``
    (``nodes`` may be None without ``has_nodes``); ``cands`` an unstacked
    tuple of such tuples, one per window candidate.  The key
    ``prng.key(seed)`` splits into the initial pose's and the rest's, as
    the reference's does.  Returns ``(local_rad, rel_valid, refined,
    window)`` where ``refined = (E, R, t, n, m12_pc)`` (previous row ->
    current column) and ``window`` is as in
    :func:`fused_window_connect`; both are None when the gate rejects.
    """
    k1, k2 = prng.split(prng.key(seed))
    desc_c, _, valid_c, _, x_c, y_c, oct_c = fc
    desc_p, _, valid_p, _, x_p, y_p, oct_p = fp
    E0, R0, t0, _n0, m12_cp, local_rad, rel_valid, _acc = _initial_pose_core(
        (desc_c, valid_c, oct_c, x_c, y_c),
        (desc_p, valid_p, oct_p, x_p, y_p),
        local_rad0, cam, th_norm, k1, min_inliers, nnratio, max_trials,
        n_samples)
    local_rad = float(local_rad)
    if not local_rad >= gate_px:
        return local_rad, rel_valid, None, None
    fc, fp, fw = _frames_with_nodes(fc, fp, cands, has_nodes)
    refined, window = _refine_window_core(
        fc, fp, fw, m12_w2p, active_w, E0, R0, t0, m12_cp, K_inv, sigma2,
        cam, th_norm, k2, min_matches, has_nodes, n_samples)
    return local_rad, rel_valid, refined, window


def fused_bow_pair_estimate(f1, f2, K_inv, sigma2, cam, th_norm, seed,
                            nnratio, min_matches, has_nodes,
                            n_samples=N_SAMPLES, max_iters=MAX_ITERS):
    """Loop-closure verification (the app's loop-closure block,
    src/IRotAvg.cpp:309-347): BoW-guided matching (gate ``node``, or
    ``none`` without nodes) -> essential RANSAC + cheirality -> epipolar
    refine.

    ``f1`` / ``f2`` are the candidate and current frame tensors ``(desc,
    nodes, valid, angle, x, y, octave)``; the RANSAC and the refine draw
    from the second keys of two ``split``s of ``prng.key(seed)``, as the
    reference's do.  Rejected unless more than 4
    matches, more than 6 cheirality inliers and at least ``min_matches``
    of them (:320-326); the refine (rematch floor ``ceil(0.75 *
    min_matches)``) runs when the RANSAC passed and more than 10 matches
    survive it; ``success`` when the final count still reaches
    ``min_matches``.  Returns (E, R, t, n_che, m12, success) with the
    pose mapping frame 1 -> frame 2 and ``m12`` frame-1 rows -> frame-2
    columns.
    """
    desc1, nodes1, valid1, angle1, x1, y1, oct1 = f1
    desc2, nodes2, valid2, angle2, x2, y2 = f2[:6]
    m12 = _match_by_bow_core(desc1, nodes1, valid1, angle1, desc2, nodes2,
                             valid2, angle2, nnratio, has_nodes=has_nodes)
    count0 = int((m12 >= 0).sum())
    key, sub = prng.split(prng.key(seed))
    E, R, t, n, pose_mask = (a[0] for a in _ransac_lanes(
        *_assignment_coords(m12[None], x1[None], y1[None], x2, y2, cam),
        [sub], th_norm, n_samples))
    n = int(n)
    rel_ok = count0 > 4 and n > 6 and n >= min_matches
    m12 = torch.where(pose_mask, m12, torch.full_like(m12, -1))
    cntf = (m12 >= 0).sum()
    if rel_ok and int(cntf) > 10:
        Er, Rr, tr, nr, m12r, _ = fused_refine(
            tuple(a[None] for a in f1), f2[:6], E[None], R[None], t[None],
            cntf[None], m12[None], K_inv, sigma2, cam, th_norm,
            [prng.split(key)[1]], math.ceil(0.75 * min_matches), has_nodes,
            max_iters, n_samples)
        E, R, t, n, m12 = Er[0], Rr[0], tr[0], int(nr[0]), m12r[0]
    success = rel_ok and int((m12 >= 0).sum()) >= min_matches
    return E, R, t, n, m12, success


def fused_pair_estimate(fa, fb, radius, K_inv, sigma2, cam, th_norm, key,
                        min_matches, max_iters=MAX_ITERS, counts=None):
    """Independent two-view estimation for P arbitrary frame pairs (the
    offline pipeline's core, ``_pair_estimate_core`` of the reference).

    ``fa`` / ``fb`` are the source (A) and target (B) frames ``(desc,
    valid, octave, x, y, angle)`` with a leading P, ``radius`` a ``(P,)``
    search radius per pair.  Per pair: local window matching (A rows -> B
    columns; all pairs in one batched launch, gate ``local``), essential
    RANSAC + cheirality (``rel_ok``: more than 4 matches and more than 6
    inliers), then, when more than 10 matches survive it, the epipolar
    refine of every such pair in one batched run with each lane's own
    column frame (gate ``epipolar_nonode``, rematch floor ``ceil(0.75 *
    min_matches)``).  ``success`` (a host list) when ``rel_ok`` and the
    final count reaches ``min_matches``; the pose maps A -> B (edge
    convention ``R_B = R_AB R_A``).  Pair ``p`` draws from ``k =
    split(key, P)[p]``: its RANSAC from ``split(k)[1]``, its refine from
    ``split(split(k)[0])[1]``, as the reference's lanes do (a lane's keys
    do not depend on P, so padding a chunk changes no draw).  Returns (E,
    R, t, n_che, m12, success) with leading P.  A dict ``counts`` gets
    ``refined``, the number of pairs that reached the refine (a host
    count).
    """
    dA, vA, oA, xA, yA, aA = fa
    dB, vB, oB, xB, yB, aB = fb
    m12 = _match_locally_core(dA, vA, oA, xA, yA, dB, vB, oB, xB, yB,
                              radius, 0.9)
    P = dA.shape[0]
    count0 = (m12 >= 0).sum(dim=1).tolist()
    lane = [prng.split(k) for k in prng.split(key, P)]
    E, R, t, n, mask = _ransac_lanes(
        *_assignment_coords(m12, xA, yA, xB, yB, cam),
        [sub for _, sub in lane], th_norm)
    m12 = torch.where(mask, m12, torch.full_like(m12, -1))
    n0 = n.tolist()
    cntf = (m12 >= 0).sum(dim=1)
    rel_ok = [count0[p] > 4 and n0[p] > 6 for p in range(P)]
    # more than 10 matches surviving cheirality implies rel_ok
    refine = [p for p, c in enumerate(cntf.tolist()) if c > 10]
    if counts is not None:
        counts["refined"] = len(refine)
    if refine:
        sel = torch.tensor(refine, device=dA.device)
        nodes_a = torch.zeros_like(vA[sel], dtype=torch.int32)
        nodes_b = torch.zeros_like(vB[sel], dtype=torch.int32)
        E[sel], R[sel], t[sel], n[sel], m12[sel], _ = fused_refine(
            (dA[sel], nodes_a, vA[sel], aA[sel], xA[sel], yA[sel], oA[sel]),
            (dB[sel], nodes_b, vB[sel], aB[sel], xB[sel], yB[sel]),
            E[sel], R[sel], t[sel], cntf[sel], m12[sel], K_inv, sigma2,
            cam, th_norm, [prng.split(lane[p][0])[1] for p in refine],
            math.ceil(0.75 * min_matches), False, max_iters)
    final = (m12 >= 0).sum(dim=1).tolist()
    success = [rel_ok[p] and final[p] >= min_matches for p in range(P)]
    return E, R, t, n, m12, success


def fused_pair_estimate_gather(desc, valid, octave, x, y, angle, ia, ib,
                               radius, K_inv, sigma2, cam, th_norm, seed,
                               min_matches, max_iters=MAX_ITERS,
                               counts=None):
    """:func:`fused_pair_estimate` of the pairs ``(ia[p], ib[p])`` of
    stacked ``(F, N, ...)`` features, with the key ``prng.key(seed)``."""
    fa = tuple(a[ia] for a in (desc, valid, octave, x, y, angle))
    fb = tuple(a[ib] for a in (desc, valid, octave, x, y, angle))
    return fused_pair_estimate(fa, fb, radius, K_inv, sigma2, cam, th_norm,
                               prng.key(seed), min_matches, max_iters,
                               counts)


def fused_flow(fa, fb, radius):
    """Mean feature displacement between P frame pairs (the offline
    analogue of `findInitialPose`'s velocity estimate,
    src/ViewGraph.cpp:848-864): per pair, local-window matching (one
    batched launch, gate ``local``) then the mean match displacement in
    pixels.  ``fa`` / ``fb``: ``(desc, valid, octave, x, y)`` with a
    leading P.  Returns (mean_disp (P,) f32, n_matches (P,) int32)."""
    xa, ya = fa[3], fa[4]
    xb, yb = fb[3], fb[4]
    m12 = _match_locally_core(*fa, *fb, radius, 0.9)
    matched = m12 >= 0
    j = m12.clamp(min=0)
    mean = _mean_disp(xa, ya, xb.gather(1, j), yb.gather(1, j), matched)
    return mean, matched.sum(dim=1).to(torch.int32)


def fused_flow_gather(desc, valid, octave, x, y, ia, ib, radius):
    """:func:`fused_flow` of the pairs ``(ia[p], ib[p])`` of stacked
    ``(F, N, ...)`` features."""
    fa = tuple(a[ia] for a in (desc, valid, octave, x, y))
    fb = tuple(a[ib] for a in (desc, valid, octave, x, y))
    return fused_flow(fa, fb, radius)

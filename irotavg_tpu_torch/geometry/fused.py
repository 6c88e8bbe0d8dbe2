"""Two-view estimation loops of the per-frame path.

Port of ``irotavg_tpu/geometry/fused.py``: the reference's `refinePose`
(src/ViewGraph.cpp:725-783), `findInitialPose` (:828-902) and the window
walk of `processFrame` (:1035-1145).  The reference runs each as one
compiled ``lax.while_loop`` with all state on device; here each is a
Python loop over device tensors that reads a few values back per
iteration (the refine one vector, its lanes' stop flags, its re-match
and update replayed from CUDA graphs on the card), with the same
stopping rules: ``stall >= 2`` and
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
refine iterations of the pose and the window walk), and each refine
inside ``geometry.refine`` (``lanes``, ``iters``, ``replays``,
``captures`` and the re-match's shape);
``utils/timing.py``.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

from irotavg_tpu_torch import prng
from irotavg_tpu_torch.geometry.essential import ransac_pose_lanes
from irotavg_tpu_torch.matching.matchers import (
    _epipolar_rowf, _match_by_bow_core, _match_epipolar_core,
    _match_locally_core,
)
from irotavg_tpu_torch.ops import match as match_ops
from irotavg_tpu_torch.utils.timing import span

N_SAMPLES = 512        # minimal 8-point samples per RANSAC
H_SAMPLES = 192        # 4-point homography samples per RANSAC
F64 = torch.float64
MAX_ITERS = 10         # refine alternations
MAX_TRIALS = 6         # initial-pose radius escalations
GATE_PX = 5.0          # keyframe gate on the mean match displacement
REFINE_GRAPHS = 16     # refine signatures whose CUDA graphs are kept
REFINE_LANES = 8       # the fewest lanes a refine replays (padding frozen)

# :func:`fused_refine`'s captured loops by signature, least recently used
# first (module level, so that a throwaway warm-up captures what later
# calls replay)
_refine_loops: OrderedDict = OrderedDict()


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


def _column_coords(m12, x2, y2, cam):
    """Normalised column points of L assignment vectors ``m12 (L, N1)``:
    ``(L, N1, 2)``; ``x2`` / ``y2`` are ``(L, N2)`` or one ``(N2,)`` frame
    shared by the lanes."""
    j = m12.clamp(min=0)
    if x2.dim() == 1:
        x2, y2 = x2[j], y2[j]
    else:
        x2, y2 = x2.gather(1, j), y2.gather(1, j)
    return _norm_coords(x2, y2, cam)


def _assignment_coords(m12, x1, y1, x2, y2, cam):
    """Normalised correspondences of L assignment vectors ``m12 (L, N1)``
    (rows of frame 1 -> columns of frame 2): ``p1``, ``p2`` (L, N1, 2)
    and ``valid`` (L, N1), the columns as in :func:`_column_coords`."""
    return (_norm_coords(x1, y1, cam), _column_coords(m12, x2, y2, cam),
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


class _RefineLoop:
    """The tensors of :func:`fused_refine` for one signature, and the three
    steps of its loop over them:

    - ``prep``: what the loop does not change, the rows' gate features
      and normalised points;
    - ``rematch``: every lane's epipolar re-match under its ``E_cur``, the
      matches' normalised points and counts;
    - ``update``: every lane's state updated under masks from the RANSAC
      results put in by :meth:`take`.

    Every lane stays in the batch; a lane that stopped (``done``) is
    frozen by the update's masks.  On a CUDA device each step can be a
    CUDA graph, captured once (:meth:`capture`) and replayed; otherwise
    the steps run eagerly.
    """

    def __init__(self, f1, f2, K_inv, sigma2, cam, has_nodes):
        dev = f1[0].device
        B, N1 = f1[4].shape
        f32, i64 = torch.float32, torch.int64

        def zeros(*shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.has_nodes = has_nodes
        self.gate = "epipolar" if has_nodes else "epipolar_nonode"
        self.rows = tuple(torch.empty_like(a) for a in f1)
        self.cols = tuple(torch.empty_like(a) for a in f2)
        self.consts = tuple(torch.empty_like(a) for a in (K_inv, sigma2, cam))
        self.min_pairs = zeros(dtype=i64)
        self.E_cur, self.E, self.R = (zeros(B, 3, 3) for _ in range(3))
        self.t = zeros(B, 3)
        self.best_n, self.stall = zeros(B, dtype=i64), zeros(B, dtype=i64)
        self.best_m12 = zeros(B, N1, dtype=i64)
        self.done = zeros(B, dtype=torch.bool)
        # the RANSAC results of the lanes that ran (:meth:`take`)
        self.new = (zeros(B, 3, 3), zeros(B, 3, 3), zeros(B, 3),
                    zeros(B, dtype=i64), zeros(B, N1, dtype=torch.bool))
        self.graphs = None
        self.prep, self.rematch, self.update = (self._prep, self._rematch,
                                                self._update)

    def load(self, f1, f2, E0, R0, t0, n0, m12_0, K_inv, sigma2, cam,
             min_pairs, frozen):
        """Copy a call's inputs in; the lanes ``frozen`` start done."""
        # first, while the queue is short: a copy from the host waits for it
        self.done.copy_(torch.tensor(frozen))
        for buf, a in zip(self.rows + self.cols + self.consts,
                          tuple(f1) + tuple(f2) + (K_inv, sigma2, cam)):
            buf.copy_(a)
        self.min_pairs.fill_(min_pairs)
        for buf, a in ((self.E_cur, E0), (self.E, E0), (self.R, R0),
                       (self.t, t0), (self.best_n, n0),
                       (self.best_m12, m12_0)):
            buf.copy_(a)
        self.stall.zero_()

    def _prep(self):
        _, nodes1, valid1, _, x1, y1, oct1 = self.rows
        _, sigma2, cam = self.consts
        self.rowf = _epipolar_rowf(valid1, nodes1, x1, y1, oct1, sigma2)
        self.p1 = _norm_coords(x1, y1, cam)

    def _rematch(self):
        K_inv, sigma2, cam = self.consts
        # in f64, so that the f32 F is the same on the card and the CPU
        F = (K_inv.T.to(F64) @ self.E_cur.to(F64) @ K_inv.to(F64)).to(
            torch.float32)
        # a stopped lane matches nothing: its rows go in invalid (the
        # plain matcher skips such lanes)
        rowf = self.rowf * (~self.done)[:, None, None]
        # the matcher itself, not the module entry a caller may wrap: a
        # wrapper that synchronises cannot be captured
        self.m12 = _match_epipolar_core(
            *self.rows, *self.cols, F, sigma2, has_nodes=self.has_nodes,
            rowf=rowf, matcher=match_ops.best2)
        self.valid = self.m12 >= 0
        self.p2 = _column_coords(self.m12, self.cols[4], self.cols[5], cam)
        self.counts = self.valid.sum(dim=1)

    def take(self, sel, *results):
        """Put in the RANSAC results (E, R, t, n_che, pose_mask) of the
        lanes ``sel`` (a device index; None: every lane)."""
        for buf, v in zip(self.new, results):
            if sel is None:
                buf.copy_(v)
            else:
                buf.index_copy_(0, sel, v.to(buf.dtype))

    def _update(self):
        E_new, R_new, t_new, n_new, mask = self.new
        active = ~self.done
        c = self.counts
        usable = active & (c >= self.min_pairs) & (c > 4) & (n_new > 6)
        improved = usable & (n_new > self.best_n)
        lane3 = improved[:, None, None]
        self.E.copy_(torch.where(lane3, E_new, self.E))
        self.R.copy_(torch.where(lane3, R_new, self.R))
        self.t.copy_(torch.where(improved[:, None], t_new, self.t))
        self.best_n.copy_(torch.where(improved, n_new, self.best_n))
        kept = torch.where(mask, self.m12, torch.full_like(self.m12, -1))
        self.best_m12.copy_(torch.where(improved[:, None], kept,
                                        self.best_m12))
        self.E_cur.copy_(torch.where(usable[:, None, None], E_new,
                                     self.E_cur))
        stall = torch.where(improved, 0, self.stall + 1)
        self.stall.copy_(torch.where(active, stall, self.stall))
        self.done.copy_(self.done | (active & (~usable | (stall >= 2))))

    def capture(self):
        """Capture the three steps as CUDA graphs sharing one memory pool,
        after one eager run of each on the capturing stream (it loads their
        kernels and warms the allocator, and changes the state: load the
        inputs again).  Neither run counts a matcher launch."""
        dev = self.done.device
        counted = (match_ops.best2.launches,
                   dict(match_ops.best2.launches_by_gate))
        steps = (self._prep, self._rematch, self._update)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graphs, pool = [], None
        with torch.cuda.stream(side):
            for step in steps:
                step()
            for step in steps:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                step()
                g.capture_end()
                pool = pool or g.pool()
                graphs.append(g)
        torch.cuda.current_stream(dev).wait_stream(side)
        match_ops.best2.launches, match_ops.best2.launches_by_gate = counted
        self.graphs = graphs
        self.prep, self.update = graphs[0].replay, graphs[2].replay
        self.rematch = self._replay_rematch

    def _replay_rematch(self):
        self.graphs[1].replay()
        match_ops.count_launch(self.gate)

    def result(self, B):
        """The state of the first ``B`` lanes."""
        return tuple(a[:B].clone() for a in (self.E, self.R, self.t,
                                             self.best_n, self.best_m12))


def _captured_loop(f1, f2, K_inv, sigma2, cam, has_nodes):
    """The module's :class:`_RefineLoop` for this signature (the gate, and
    the device, shape and dtype of every frame tensor and constant: lanes,
    row and column slots, a shared or per-lane column frame, octave
    levels), the most recently used ``REFINE_GRAPHS`` kept; a new one is
    not captured yet."""
    key = (has_nodes,) + tuple((a.device, a.shape, a.dtype) for a in (
        *f1, *f2, K_inv, sigma2, cam))
    loop = _refine_loops.pop(key, None)
    if loop is None:
        loop = _RefineLoop(f1, f2, K_inv, sigma2, cam, has_nodes)
    _refine_loops[key] = loop
    while len(_refine_loops) > REFINE_GRAPHS:
        _refine_loops.popitem(last=False)
    return loop


def fused_refine(f1, f2, E0, R0, t0, n0, m12_0, K_inv, sigma2, cam,
                 th_norm, keys, min_pairs, has_nodes=False,
                 max_iters=MAX_ITERS, n_samples=N_SAMPLES, frozen=None):
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
    two re-solves without improvement.  Stopped lanes are frozen: they
    stay in the batch, and only the lanes still running run RANSAC.
    ``frozen`` (a host list of bools) names lanes stopped from the start:
    they return their inputs and split no key.  ``has_nodes`` selects the
    ``epipolar`` gate (same vocabulary node required) over
    ``epipolar_nonode``.  ``keys`` holds one host key per lane, split once
    per iteration of that lane (the reference's ``k, sub = split(k)``).
    Returns (E, R, t, best_n, best_m12, iters) per lane.

    On a CUDA device the re-match, and the update of every lane's state,
    replay CUDA graphs captured once per signature and kept at module
    level, the lanes padded with frozen ones to a power of two of at least
    ``REFINE_LANES`` (the shapes of the main paths meet one signature a
    gate, captured before a window of them); the host reads one vector
    an iteration, the lanes' stop flags.  Under a profiler session the
    call runs inside the program span ``geometry.refine`` (``lanes``:
    those not frozen;
    ``width``, ``rows``, ``cols``, ``shared``, ``gate``: the re-match's
    launch, its lanes with the frozen and padding ones, its row and column
    slots, one column frame for every lane or not, its gate; ``iters``;
    ``replays``: the iterations that replayed graphs; ``captures``: the
    graphs' captures, 1 where the call met a new signature).
    """
    B = f1[0].shape[0]
    frozen = [False] * B if frozen is None else [bool(f) for f in frozen]
    lanes = frozen.count(False)
    replay = f1[0].device.type == "cuda"
    width = max(REFINE_LANES, 1 << (B - 1).bit_length()) if replay else B
    rows, cols = f1[4].shape[1], f2[4].shape[-1]
    shared = int(f2[0].dim() == 2)
    gate = "epipolar" if has_nodes else "epipolar_nonode"
    with span("geometry.refine", lanes=lanes, width=width, rows=rows,
              cols=cols, shared=shared, gate=gate) as sp:
        out, replays, captures = _refine(
            f1, f2, E0, R0, t0, n0, m12_0, K_inv, sigma2, cam, th_norm, keys,
            min_pairs, has_nodes, max_iters, n_samples, frozen, replay, width)
        sp.set(iters=out[5], replays=replays, captures=captures)
    return out


def _refine(f1, f2, E0, R0, t0, n0, m12_0, K_inv, sigma2, cam, th_norm, keys,
            min_pairs, has_nodes, max_iters, n_samples, frozen, replay,
            width):
    """:func:`fused_refine`'s loop over ``width`` lanes (its B lanes, then
    lane 0 repeated and frozen), its steps replayed from CUDA graphs with
    ``replay`` and run eagerly without; returns fused_refine's tuple, the
    iterations replayed and the captures made."""
    B = len(frozen)
    if width > B:
        pad = torch.tensor(list(range(B)) + [0] * (width - B),
                           device=f1[0].device)
        f1 = tuple(a[pad] for a in f1)
        if f2[0].dim() == 3:
            f2 = tuple(a[pad] for a in f2)
        E0, R0, t0, n0, m12_0 = (a[pad] for a in (E0, R0, t0, n0, m12_0))
        keys = list(keys) + [keys[0]] * (width - B)
        frozen = frozen + [True] * (width - B)
    if replay:
        loop = _captured_loop(f1, f2, K_inv, sigma2, cam, has_nodes)
    else:
        loop = _RefineLoop(f1, f2, K_inv, sigma2, cam, has_nodes)
    inputs = (f1, f2, E0, R0, t0, n0, m12_0, K_inv, sigma2, cam, min_pairs,
              frozen)
    loop.load(*inputs)
    captures = 0
    if replay and loop.graphs is None:
        loop.capture()
        loop.load(*inputs)
        captures = 1
    loop.prep()
    keys = list(keys)
    done = frozen
    it = 0
    while not all(done) and it < max_iters:
        lanes = [b for b in range(len(done)) if not done[b]]
        # before the re-match: a copy from the host waits for the queue
        sel = (None if len(lanes) == len(done) else
               torch.tensor(lanes, device=loop.done.device))
        loop.rematch()
        subs = []
        for b in lanes:
            keys[b], sub = prng.split(keys[b])
            subs.append(sub)
        points = (loop.p1, loop.p2, loop.valid)
        if sel is not None:
            points = tuple(a[sel] for a in points)
        # fresh hypotheses every re-solve (no model seeding): a seeded
        # pool locks into a model that cheirality rejects
        loop.take(sel, *_ransac_lanes(*points, subs, th_norm, n_samples))
        loop.update()
        done = loop.done.tolist()
        it += 1
    return loop.result(B) + (it,), it if replay else 0, captures


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
        # every candidate in the batch, those that do not refine frozen:
        # the refine keeps one width
        frozen = [k not in refine for k in range(K)]
        n0 = torch.where(torch.tensor(frozen, device=dev), n,
                         (m12 >= 0).sum(dim=1))
        E, R, t, n, m12, iters = fused_refine(
            fw, f2, E, R, t, n0, m12, K_inv, sigma2, cam, th_norm,
            [prng.split(k)[1] for k in keys], math.ceil(0.75 * min_matches),
            has_nodes, frozen=frozen)
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
    min_matches)``), every pair a lane, those that do not refine frozen
    (so that the refine's width is P's).  ``success`` (a host list) when
    ``rel_ok`` and the final count reaches ``min_matches``; the pose maps
    A -> B (edge convention ``R_B = R_AB R_A``).  Pair ``p`` draws from
    ``k = split(key, P)[p]``: its RANSAC from ``split(k)[1]``, its refine
    from ``split(split(k)[0])[1]``, as the reference's lanes do (a lane's
    keys do not depend on P, so padding a chunk changes no draw).  Returns (E,
    R, t, n_che, m12, success) with leading P.  A dict ``counts`` gets
    ``refined``, the number of pairs that reached the refine (a host
    count).
    """
    dA, vA, oA, xA, yA, aA = fa
    dB, vB, oB, xB, yB, aB = fb
    m12 = _match_locally_core(dA, vA, oA, xA, yA, dB, vB, oB, xB, yB,
                              radius, 0.9)
    P = dA.shape[0]
    count0 = (m12 >= 0).sum(dim=1)
    lane = [prng.split(k) for k in prng.split(key, P)]
    E, R, t, n, mask = _ransac_lanes(
        *_assignment_coords(m12, xA, yA, xB, yB, cam),
        [sub for _, sub in lane], th_norm)
    m12 = torch.where(mask, m12, torch.full_like(m12, -1))
    cntf = (m12 >= 0).sum(dim=1)
    count0, n0, cnt = torch.stack([count0, n, cntf]).tolist()
    rel_ok = [count0[p] > 4 and n0[p] > 6 for p in range(P)]
    # more than 10 matches surviving cheirality implies rel_ok
    refine = [p for p, c in enumerate(cnt) if c > 10]
    if counts is not None:
        counts["refined"] = len(refine)
    if refine:
        frozen = [p not in refine for p in range(P)]
        n_in = torch.where(torch.tensor(frozen, device=dA.device), n, cntf)
        nodes_a = torch.zeros_like(vA, dtype=torch.int32)
        nodes_b = torch.zeros_like(vB, dtype=torch.int32)
        E, R, t, n, m12, _ = fused_refine(
            (dA, nodes_a, vA, aA, xA, yA, oA), (dB, nodes_b, vB, aB, xB, yB),
            E, R, t, n_in, m12, K_inv, sigma2, cam, th_norm,
            [prng.split(k)[1] for k, _ in lane],
            math.ceil(0.75 * min_matches), False, max_iters, frozen=frozen)
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

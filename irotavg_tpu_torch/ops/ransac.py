"""RANSAC's two fused f64 kernels: every lane's minimal-sample hypotheses
in one launch (``csrc/ransac_hyp.cu``) and their inlier vote in another
(``csrc/ransac_vote.cu``); the wrappers, their plain PyTorch versions and
their bounds.

:func:`ransac_hypotheses` computes, for each of L lanes of
correspondences ``p1``, ``p2`` (L, N, 2) f64:

* the sample positions: JAX's threefry draws of the lane's key mapped
  through the cumulative valid count, exactly as
  ``ops/draw.py:draw_positions_plain`` draws them (or positions given by
  the caller);
* per 8-point sample the essential candidate: the 8 correspondences
  Hartley-normalised, the null direction of their 8x9 design, the
  Hartley transforms undone, the result scaled to unit Frobenius norm and
  projected onto singular values (1, 1, 0);
* per 4-point sample the unit-norm homography ``x2h ~ H x1h`` from the
  null direction of its 8x9 DLT design.

The null direction comes from a Householder QR with column pivoting of
the design's transpose (9x8): step ``k`` takes the remaining column of
largest norm as its pivot and stops, leaving rank ``k``, when that norm
is at most ``RANK_TOL`` of the first pivot's (the largest row of the
design).  The null space is the span of Q's columns from the rank on
(at least the ninth), and ``NULL_PICK`` is projected onto it (``Q^T``,
the first ``rank`` entries zeroed, ``Q``), so a sample that drew a
correspondence twice (a rank-7 design) gets an answer that does not
depend on the basis.  The projection of E onto singular values (1, 1, 0)
is a one-sided (Hestenes) Jacobi on the 3x3 E: column pairs (0, 1), (0,
2), (1, 2) in turn, a pair rotated unless ``|b_p . b_q| <= JACOBI_TOL *
sqrt(|b_p|^2 |b_q|^2)`` or the squared norm of one is at most
``ZERO_TOL2`` of the other's, at most ``MAX_SWEEPS3`` sweeps and none
after a sweep that rotated nothing; with ``E W = [b_0 b_1 b_2]`` and
``k`` the shortest column, the projection is ``sum_{j != k} (b_j /
|b_j|) w_j^T``.

:func:`ransac_vote` gives each model's inlier mask (L, C, N) and count
(L, C) int32: Sampson distance ``< th2`` (``mode="sampson"``) or forward
transfer error ``< th2`` (``mode="transfer"``), and ``valid``.

Every sum is taken left to right, one term at a time.  Only IEEE
``+ - * / sqrt`` are used (the kernels are built with ``-fmad=false``),
so each kernel equals its plain version bit for bit.  PyTorch's CPU
``sqrt`` on f64 vectors is not correctly rounded (a unit in the last
place off for about 1% of inputs), so the plain versions take numpy's,
which is.

The tail of a RANSAC call (``csrc/ransac_tail.cu``) is five more
kernels, each over every lane in one launch, between the votes:

* :func:`homography_refit`: the best homography sample's weighted
  least-squares refit over its transfer inliers (Hartley-normalised
  moments, the 9x9 Gram matrix of the DLT rows, its null direction);
* :func:`homography_pool`: the keep choice between the refit and the
  sample, the Faugeras decomposition of the kept H into 8 motions, each
  ``[t]x R`` projected onto (1, 1, 0), written with the minimal-sample E
  (and ``E_seed``) into the pool;
* :func:`cheirality_rerank`: the top ``k`` Sampson scores of the pool in
  ``torch.sort(descending=True, stable=True)``'s order (a model's rank is
  the models above it, ties broken by index) and each one's best-branch
  cheirality count;
* :func:`essential_refit`: the first largest count, the weighted 8-point
  refit on that model's inliers (the Gram matrix, Hartley conditioning as
  a congruence, its null direction) projected onto (1, 1, 0);
* :func:`ransac_finish`: the refit's cheirality check against the pick's
  count, the chosen E and mask, and the pose (``cv::recoverPose``): the
  four decompositions of E, each point's two-ray depths, the first
  largest count, its R, t and mask.

The null direction of a 9x9 Gram matrix comes from a cyclic two-sided
Jacobi in the rounds of ``ROUNDS9`` (four disjoint pairs a round, all
rotated from the round's matrix: rows, then columns, the rotated pair's
entry set to 0, the upper triangle mirrored), a pair rotated unless
``|a_pq| <= JACOBI9_TOL sqrt(|a_pp a_qq|)``; ``NULL_PICK`` is projected
onto the eigenvectors whose eigenvalues lie below ``GRAM_RANK_TOL`` of
the largest (and the smallest's).  A 3x3 SVD is the one-sided Jacobi of
the projection, its columns ordered by norm (the first largest, then the
larger of the other two), the first two pairs signed so that ``u .
NULL_PICK[:3] >= 0`` and the third the cross product of the first two.
A sum over points runs as the kernels' blocks take it: thread ``t`` of
``TAIL_THREADS`` adds the points ``t, t + TAIL_THREADS, ...`` in turn,
each warp halves its 32 partials, then the block halves its warps'
(:func:`_block_sum`).

The wrappers dispatch on the device of their tensors only: CPU tensors
run the plain version, CUDA tensors launch the kernel (one launch per
``MAX_LANES`` lanes for the hypotheses, whose keys travel in the
kernel's arguments; one launch for the vote and for each tail kernel) or
raise.  Each launch adds one to the wrapper's ``launches``
(:func:`tail_launches` sums the tail's).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from irotavg_tpu_torch.ops.draw import (
    MAP_OPS, THREEFRY_OPS, draw_positions_plain, lane_keys,
)
from irotavg_tpu_torch.ops.segment import H100_ADDS_PER_S, \
    H100_HBM_BYTES_PER_S

F64 = torch.float64
# the direction whose projection onto a null space is taken as its null
# direction: a minimal sample that drew one correspondence twice has a
# design of rank < 8 (and a refit on fewer than 8 inliers a singular Gram
# matrix), whose null space solvers span with bases of their own, so its
# "null vector" would depend on the solver; the projection of NULL_PICK
# does not depend on the basis, and for a one-dimensional null space it is
# the null vector with its sign fixed
NULL_PICK = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0)
# a design's rank ends where its QR pivot's norm is at most RANK_TOL of the
# first pivot's; compared squared, against the literal RANK_TOL2
RANK_TOL = 1e-10
RANK_TOL2 = 1e-20
# a 3x3 Jacobi pair is rotated unless its columns are this close to
# orthogonal, or the squared norm of one is at most ZERO_TOL2 of the
# other's (rounding noise, which a rotation would only stir)
JACOBI_TOL = 1e-14
ZERO_TOL2 = 1e-26
# sweeps at most of the 3x3 projection
MAX_SWEEPS3 = 16
# its column pairs, one after the other
PAIRS3 = ((0, 1), (0, 2), (1, 2))
MODES = {"sampson": 0, "transfer": 1}
# models a step of the plain vote takes
VOTE_CHUNK = 32
# lanes of one hypotheses launch (their keys travel by value) and the
# longest valid row (its cumulative count lives in shared memory); both
# must equal the .cu's kMaxLanes and kMaxN
MAX_LANES = 64
MAX_N = 57344


class _Keys(ctypes.Structure):
    """The hypotheses kernel's ``DrawKeys``: per lane the words ``k1, k2``
    of the first shape's keys, then those of the second shape's."""
    _fields_ = [("k", ctypes.c_uint32 * (MAX_LANES * 8))]


# f64 operations (each + - * / sqrt, compare and abs one) behind the
# bounds, besides the QR (:func:`_qr_ops`): a hypothesis's two Hartley
# normalisations, its design, the norm of its null direction, the
# transforms undone and the Frobenius norm; a 3x3 Jacobi pair's three
# dot products and its test, and a rotation's parameters and its update
# of 3 rows of E and 3 of W; the projection's column norms and rank-2
# sum; per point and model, the Sampson or transfer residual and the
# compare
HYP_OPS = 2 * (10 * 8 + 2) + 48 + 28 + 40 + 28
PAIR3_OPS = 3 * 5 + 6
ROTATE3_OPS = 13 + 6 * 6
PROJ_OPS = 3 * 6 + 9 * 3 + 6
RESIDUAL_OPS = {"sampson": 35, "transfer": 23}


def _qr_ops(rank):
    """f64 operations of the pivoted QR of one design that stops at
    ``rank``: per step the remaining columns' norms, the pivot search and
    test, the reflector and its application to the later columns, and
    the reflector's two applications to ``NULL_PICK``; a stopping step
    only its norms and test."""
    ops = 0
    for k in range(min(rank + 1, 8)):
        rows, cols = 9 - k, 8 - k
        ops += cols * (2 * rows - 1) + cols + 2
        if k < rank:
            ops += (4 + 2 * rows + (cols - 1) * (4 * rows + 1)
                    + 2 * (4 * rows + 1))
    return ops


def _sqrt(x):
    """Correctly rounded sqrt (numpy's on the CPU, see the module doc)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _clamp_min(x, m):
    """``x < m ? m : x`` (NaN stays NaN), as the kernels write it."""
    return torch.where(x < m, torch.full_like(x, m), x)


def _seq(terms):
    """Left-to-right sum of a list of tensors."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _hartley(q):
    """Hartley normalisation of (B, K, 2) points: centroid to the origin,
    RMS radius sqrt(2).  Returns (normalised points, c (B, 2), s (B,))."""
    k = q.shape[-2]
    c = _seq(list(q.unbind(-2))) / k
    d = q - c[:, None, :]
    var = _seq(list((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                    .unbind(-1))) / k
    s = _sqrt(torch.full_like(var, 2.0) / _clamp_min(var, 1e-12))
    return d * s[:, None, None], c, s


def _designs(q1, q2, essential):
    """(B, 8, 9) designs: the 8-point rows ``x2h (x) x1h`` of 8
    correspondences, or the DLT rows of 4 (``ra`` of each point, then
    ``rb``)."""
    x1, y1 = q1[..., 0], q1[..., 1]
    x2, y2 = q2[..., 0], q2[..., 1]
    o = torch.ones_like(x1)
    if essential:
        return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                            x1, y1, o], dim=-1)
    z = torch.zeros_like(x1)
    ra = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rb = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    return torch.cat([ra, rb], dim=-2)


def _rotation(al, be, ga):
    """Jacobi rotation of a pair with squared norms ``al``, ``be`` and
    inner product ``ga``: (rotate?, c, s).  A pair is left alone when it
    is orthogonal to ``JACOBI_TOL`` or when one squared norm is at most
    ``ZERO_TOL2`` of the other."""
    lt = al < be
    lo, hi = torch.where(lt, al, be), torch.where(lt, be, al)
    rot = ((torch.abs(ga) > JACOBI_TOL * _sqrt(al * be))
           & (lo > ZERO_TOL2 * hi))
    ga = torch.where(rot, ga, torch.ones_like(ga))
    zeta = (be - al) / (2.0 * ga)
    sgn = torch.where(zeta >= 0, torch.ones_like(zeta),
                      torch.full_like(zeta, -1.0))
    t = sgn / (torch.abs(zeta) + _sqrt(1.0 + zeta * zeta))
    c = torch.ones_like(t) / _sqrt(1.0 + t * t)
    return rot, c, c * t


def _jacobi3(X, stats):
    """One-sided Jacobi on the 3 columns of ``X (B, 6, 3)``: E's rows,
    then the rows of W, which accumulates the rotations; in place.  Only
    the matrices that rotated in a sweep take the next one (the others
    would rotate nothing)."""
    dev = X.device
    act = torch.arange(X.shape[0], device=dev)
    x = X.clone()
    pairs = rotations = 0
    for _ in range(MAX_SWEEPS3):
        moved = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
        for p, q in PAIRS3:
            xp, xq = x[:, :, p], x[:, :, q]
            ap, aq = xp[:, :3], xq[:, :3]
            rot, c, s = _rotation(*(_seq(list((u * v).unbind(1)))
                                    for u, v in ((ap, ap), (aq, aq),
                                                 (ap, aq))))
            r, c, s = rot[:, None], c[:, None], s[:, None]
            new_p = torch.where(r, c * xp - s * xq, xp)
            new_q = torch.where(r, s * xp + c * xq, xq)
            x[:, :, p], x[:, :, q] = new_p, new_q
            moved |= rot
            if stats is not None:
                rotations += int(rot.sum())
        pairs += len(PAIRS3) * x.shape[0]
        X[act] = x
        act, x = act[moved], x[moved]
        if not act.numel():
            break
    if stats is not None:
        stats["pairs3"] = stats.get("pairs3", 0) + pairs
        stats["rotations3"] = stats.get("rotations3", 0) + rotations


def _arg_first(x, better):
    """First index of the extreme of (B, n) ``x`` under ``better``
    (``torch.gt``: the largest, ``torch.lt``: the smallest) and that
    value, scanning left to right."""
    j = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    best = x[:, 0]
    for i in range(1, x.shape[1]):
        b = better(x[:, i], best)
        j = torch.where(b, i, j)
        best = torch.where(b, x[:, i], best)
    return j, best


def _householder(y, k, v, beta, go):
    """``H_k y = y - (beta (v . y[k:])) v`` on rows ``k:`` of (B, 9)
    ``y`` where ``go``."""
    tail = y[:, k:]
    f = beta * _seq([v[:, i] * tail[:, i] for i in range(9 - k)])
    y = y.clone()
    y[:, k:] = torch.where(go[:, None], tail - f[:, None] * v, tail)
    return y


def _null_directions(A, stats):
    """Unit null directions (B, 9) of (B, 8, 9) designs (module doc)."""
    B = A.shape[0]
    ar = torch.arange(B, device=A.device)
    M = A.transpose(1, 2).clone()                       # (B, 9, 8)
    go = torch.ones(B, dtype=torch.bool, device=A.device)
    rank = torch.zeros(B, dtype=torch.int64, device=A.device)
    refl = []
    for k in range(8):
        cols = M[:, k:, k:]
        nrm2 = _seq([cols[:, i] * cols[:, i] for i in range(9 - k)])
        piv, best = _arg_first(nrm2, torch.gt)
        if k == 0:
            first = best
        go = go & ~(best <= RANK_TOL2 * first)
        piv = piv + k
        ck, cp = M[:, :, k].clone(), M[ar, :, piv]
        M[:, :, k] = torch.where(go[:, None], cp, ck)
        M[ar, :, piv] = torch.where(go[:, None], ck, cp)
        x = M[:, k:, k]
        sg = torch.where(x[:, 0] >= 0, torch.ones_like(best),
                         torch.full_like(best, -1.0))
        v = x.clone()
        v[:, 0] = x[:, 0] + sg * _sqrt(best)
        beta = torch.full_like(best, 2.0) / _seq(
            [v[:, i] * v[:, i] for i in range(9 - k)])
        if k < 7:
            C = M[:, k:, k + 1:]
            f = beta[:, None] * _seq([v[:, i, None] * C[:, i]
                                      for i in range(9 - k)])
            M[:, k:, k + 1:] = torch.where(
                go[:, None, None], C - f[:, None, :] * v[:, :, None], C)
        refl.append((v, beta, go))
        rank += go
    y = torch.tensor(NULL_PICK, dtype=F64, device=A.device).expand(B, 9)
    for k, (v, beta, g) in enumerate(refl):
        y = _householder(y, k, v, beta, g)
    y = torch.where(torch.arange(9, device=A.device) < rank[:, None],
                    torch.zeros_like(y), y)
    for k in range(7, -1, -1):
        y = _householder(y, k, *refl[k])
    if stats is not None:
        counts = torch.bincount(rank, minlength=9).tolist()
        stats["qr_ops"] = stats.get("qr_ops", 0) + sum(
            n * _qr_ops(r) for r, n in enumerate(counts))
        stats["rank_deficient"] = (stats.get("rank_deficient", 0)
                                   + B - counts[8])
    nrm = _sqrt(_seq([y[:, i] * y[:, i] for i in range(9)]))
    return y / _clamp_min(nrm, 1e-300)[:, None]


def _times_T1(M, c1, s1):
    """``M T1`` for (B, 3, 3) ``M`` and ``T1 = [[s,0,-s cx],[0,s,-s cy],
    [0,0,1]]``, written out."""
    tx = -(s1 * c1[:, 0])
    ty = -(s1 * c1[:, 1])
    m0, m1, m2 = M[:, :, 0], M[:, :, 1], M[:, :, 2]
    return torch.stack([m0 * s1[:, None], m1 * s1[:, None],
                        (m0 * tx[:, None] + m1 * ty[:, None]) + m2], dim=-1)


def _unit_frobenius(X):
    """(B, 3, 3) over its Frobenius norm (left-to-right sum of squares in
    row-major order), as the kernel divides it."""
    f = X.reshape(-1, 9)
    nrm = _sqrt(_seq([f[:, i] * f[:, i] for i in range(9)]))
    return X / _clamp_min(nrm, 1e-30)[:, None, None]


def _essential_of(e, c1, s1, c2, s2):
    """``T2^T En T1`` of the normalised null direction, at unit norm."""
    En = e.reshape(-1, 3, 3)
    s2_ = s2[:, None]
    row2 = ((-(s2 * c2[:, 0]))[:, None] * En[:, 0]
            + (-(s2 * c2[:, 1]))[:, None] * En[:, 1]) + En[:, 2]
    M = torch.stack([s2_ * En[:, 0], s2_ * En[:, 1], row2], dim=1)
    return _unit_frobenius(_times_T1(M, c1, s1))


def _homography_of(h, c1, s1, c2, s2):
    """``T2^-1 Hn T1`` of the normalised null direction, at unit norm."""
    Hn = h.reshape(-1, 3, 3)
    si2 = (torch.ones_like(s2) / s2)[:, None]
    M = torch.stack([si2 * Hn[:, 0] + c2[:, 0, None] * Hn[:, 2],
                     si2 * Hn[:, 1] + c2[:, 1, None] * Hn[:, 2],
                     Hn[:, 2]], dim=1)
    return _unit_frobenius(_times_T1(M, c1, s1))


def _project_rank2(E, stats):
    """(B, 3, 3) E projected onto singular values (1, 1, 0) (module
    doc)."""
    B = E.shape[0]
    X = torch.cat([E, torch.eye(3, dtype=F64, device=E.device)
                   .expand(B, 3, 3)], dim=1)
    _jacobi3(X, stats)
    Bm, W = X[:, :3], X[:, 3:]
    sig = _sqrt(_seq([Bm[:, i, :] * Bm[:, i, :] for i in range(3)]))
    jmin, _ = _arg_first(sig, torch.lt)
    U = Bm / _clamp_min(sig, 1e-300)[:, None, :]
    keep = [torch.where(jmin == 0, 1, 0), torch.where(jmin == 2, 1, 2)]
    P = None
    for j in keep:
        uj = U.gather(2, j[:, None, None].expand(B, 3, 1))       # (B, 3, 1)
        wj = W.gather(2, j[:, None, None].expand(B, 3, 1))
        term = uj * wj.transpose(1, 2)
        P = term if P is None else P + term
    return P


def _check_inputs(p1, p2, valid):
    if p1.dim() != 3 or p1.shape[-1] != 2 or p2.shape != p1.shape:
        raise ValueError(f"p1 and p2 must be (lanes, N, 2), got "
                         f"{tuple(p1.shape)} and {tuple(p2.shape)}")
    if p1.dtype != F64 or p2.dtype != F64:
        raise TypeError(f"p1 and p2 must be float64, got {p1.dtype}")
    if valid.shape != p1.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool (lanes, N), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if p1.device != valid.device or p2.device != valid.device:
        raise ValueError("p1, p2 and valid must be on one device")


def _positions(valid, keys, n_samples, h_samples, positions):
    if positions is not None:
        idx, idx_h = positions
        L = valid.shape[0]
        if (tuple(idx.shape) != (L, n_samples, 8)
                or tuple(idx_h.shape) != (L, h_samples, 4)):
            raise ValueError(f"positions must be (L, {n_samples}, 8) and "
                             f"(L, {h_samples}, 4), got {tuple(idx.shape)} "
                             f"and {tuple(idx_h.shape)}")
        return idx, idx_h
    if keys is None or len(keys) != valid.shape[0]:
        raise ValueError("one key per lane is needed when no positions "
                         "are given")
    return draw_positions_plain(valid, keys,
                                ((n_samples, 8), (h_samples, 4)))


def ransac_hypotheses_plain(p1, p2, valid, keys=None, n_samples=512,
                            h_samples=192, positions=None, stats=None):
    """Plain version of :func:`ransac_hypotheses`, on the inputs' device.
    ``stats``, a dict, receives the QR's operations (``qr_ops``), the
    designs found rank-deficient (``rank_deficient``) and the 3x3 Jacobi
    pairs evaluated and rotated (``pairs3``, ``rotations3``), which the
    bounds count."""
    _check_inputs(p1, p2, valid)
    L, S, Hs = p1.shape[0], n_samples, h_samples
    idx, idx_h = _positions(valid, keys, S, Hs, positions)
    lane = torch.arange(L, device=p1.device)[:, None, None]
    nE = L * S
    out = []
    for pos, k, essential in ((idx, 8, True), (idx_h, 4, False)):
        n1, c1, s1 = _hartley(p1[lane, pos].reshape(-1, k, 2))
        n2, c2, s2 = _hartley(p2[lane, pos].reshape(-1, k, 2))
        out.append((_designs(n1, n2, essential), (c1, s1, c2, s2)))
    A = torch.cat([out[0][0], out[1][0]])
    e = _null_directions(A, stats)
    E = _project_rank2(_essential_of(e[:nE], *out[0][1]), stats)
    H = _homography_of(e[nE:], *out[1][1])
    return E.reshape(L, S, 3, 3), H.reshape(L, Hs, 3, 3)


def ransac_vote_plain(models, p1, p2, valid, th2, mode):
    """Plain version of :func:`ransac_vote` (``VOTE_CHUNK`` models at a
    time, so that its temporaries stay in the cache)."""
    _check_vote(models, p1, p2, valid, th2, mode)
    x1, y1 = p1[:, None, :, 0], p1[:, None, :, 1]
    x2, y2 = p2[:, None, :, 0], p2[:, None, :, 1]
    masks = []
    for c0 in range(0, models.shape[1], VOTE_CHUNK):
        chunk = models[:, c0:c0 + VOTE_CHUNK]
        m = [[chunk[..., i, j][:, :, None] for j in range(3)]
             for i in range(3)]
        a = [(m[i][0] * x1 + m[i][1] * y1) + m[i][2] for i in range(3)]
        if mode == "sampson":
            b0 = (m[0][0] * x2 + m[1][0] * y2) + m[2][0]
            b1 = (m[0][1] * x2 + m[1][1] * y2) + m[2][1]
            num = (x2 * a[0] + y2 * a[1]) + a[2]
            num = num * num
            den = ((a[0] * a[0] + a[1] * a[1]) + b0 * b0) + b1 * b1
            inl = num / torch.clamp(den, min=1e-18) < th2
        else:
            zok = torch.abs(a[2]) > 1e-8
            z = torch.where(zok, a[2], torch.ones_like(a[2]))
            e0 = a[0] / z - x2
            e1 = a[1] / z - y2
            inl = zok & (e0 * e0 + e1 * e1 < th2)
        masks.append(inl & valid[:, None, :])
    mask = (torch.cat(masks, dim=1) if masks else torch.zeros(
        models.shape[:2] + p1.shape[1:2], dtype=torch.bool,
        device=p1.device))
    return mask, mask.sum(dim=-1, dtype=torch.int32)


def _check_vote(models, p1, p2, valid, th2, mode):
    _check_inputs(p1, p2, valid)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if (models.dim() != 4 or models.shape[0] != p1.shape[0]
            or models.shape[2:] != (3, 3) or models.dtype != F64):
        raise ValueError(f"models must be float64 (lanes, C, 3, 3), got "
                         f"{models.dtype} {tuple(models.shape)}")
    if th2.dim() != 0 or th2.dtype != F64 or th2.device != p1.device:
        raise ValueError("th2 must be a 0-dim float64 tensor on the points' "
                         "device")


def hypotheses_work(lanes, n, n_samples, h_samples, stats, drawn=True):
    """(operations, bytes) of :func:`ransac_hypotheses`: the QR
    operations and the 3x3 Jacobi pairs evaluated and rotated that
    ``stats`` (from the plain version on the same inputs) counts, the
    fixed work of each hypothesis and
    projection, and the draws (two threefry evaluations, randint's
    mapping and a binary search each, the scan of the flags); ``p1``,
    ``p2`` and ``valid`` read once, the models written once."""
    hyps = lanes * (n_samples + h_samples)
    ops = (stats["qr_ops"]
           + stats["pairs3"] * PAIR3_OPS + stats["rotations3"] * ROTATE3_OPS
           + hyps * HYP_OPS + lanes * n_samples * PROJ_OPS)
    if drawn:
        draws = lanes * (8 * n_samples + 4 * h_samples)
        steps = math.ceil(math.log2(n + 1))
        ops += lanes * n + draws * (2 * THREEFRY_OPS + MAP_OPS + steps)
    return ops, lanes * n * (2 * 16 + 1) + hyps * 72


def vote_work(lanes, n, models, mode):
    """(operations, bytes) of :func:`ransac_vote`: each point's residual
    under each model and its compare; models, points and flags read
    once, masks and counts written once."""
    ops = lanes * models * n * RESIDUAL_OPS[mode]
    return ops, lanes * (models * 72 + n * 33 + models * n + models * 4)


# f64 operations behind the tail's bounds: a 9x9 Jacobi sweep (36
# rotations: their parameters, then 2 rows, 2 columns and 2 eigenvector
# columns of 9 entries at 3 operations each) times the sweeps a Gram matrix
# takes (8 in the runs); a 3x3 SVD (about 6 rotations and the ordering,
# signs and cross products); a point's two-ray test under one candidate;
# a point's share of a Gram matrix (moments, normalisation, 45 products
# and sums)
JACOBI9_OPS = 8 * 36 * (20 + 6 * 9 * 3)
SVD3_OPS = 6 * (PAIR3_OPS + ROTATE3_OPS) + 60
RAY_OPS = 40
GRAM_POINT_OPS = 160


def tail_work(kernel, lanes, n, models, k):
    """(operations, bytes) of the tail kernel ``kernel`` over ``lanes``
    lanes of ``n`` points, a pool of ``models`` and ``k`` re-ranked: the
    counts above, every point taken as an inlier; points, masks and models
    read once, outputs written once."""
    if kernel == "homography_refit":
        ops = n * GRAM_POINT_OPS + JACOBI9_OPS + 300
        nbytes = n * 33 + 76
    elif kernel == "homography_pool":
        ops = 8 * (2 * SVD3_OPS + 400)
        nbytes = 2 * models * 72
    elif kernel == "cheirality_rerank":
        ops = k * (SVD3_OPS + 100 + 4 * n * RAY_OPS)
        nbytes = k * (n * 33 + 72 + models * 4)
    elif kernel == "essential_refit":
        ops = n * GRAM_POINT_OPS + JACOBI9_OPS + 4 * 9 * 81 + SVD3_OPS
        nbytes = n * 33 + k * 8 + 72
    elif kernel == "ransac_finish":
        ops = 2 * SVD3_OPS + 9 * n * RAY_OPS
        nbytes = n * 37 + 2 * 72 + 80
    else:
        raise ValueError(f"no tail kernel {kernel!r}")
    return lanes * ops, lanes * nbytes


def bound_ms(work):
    """(ms, "operations" or "bytes"): the least time one H100 SXM could
    take for ``work = (operations, bytes)``, its f64 operations at 34
    TFLOP/s or its bytes at 3.35 TB/s, whichever is longer."""
    ops, nbytes = work
    t_ops = ops / H100_ADDS_PER_S[F64] * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@functools.lru_cache(maxsize=None)
def _hyp_lib():
    from irotavg_tpu_torch.kernels.build import load

    lib = load("ransac_hyp")
    limits = (ctypes.c_int * 3)()
    lib.ransac_hyp_limits(limits)
    consts = (ctypes.c_double * 12)()
    lib.ransac_hyp_constants(consts)
    want = ((MAX_LANES, MAX_N, MAX_SWEEPS3),
            (RANK_TOL2, JACOBI_TOL, ZERO_TOL2) + NULL_PICK)
    if (tuple(limits), tuple(consts)) != want:
        raise RuntimeError(f"ransac_hyp limits and constants "
                           f"{tuple(limits)}, {tuple(consts)} differ from "
                           f"ops/ransac.py's {want}")
    fn = lib.ransac_hyp
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        _Keys, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _vote_lib():
    from irotavg_tpu_torch.kernels.build import load

    fn = load("ransac_vote").ransac_vote
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cuda_or_raise(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what} has no kernel for device {t.device}")


def hypotheses_launcher(p1, p2, valid, keys=None, n_samples=512,
                        h_samples=192, positions=None):
    """Check CUDA inputs once and allocate the outputs: returns ``(launch,
    (E, H))``, where each ``launch()`` runs the kernel into those
    tensors, one launch for every ``MAX_LANES`` lanes, each counted.
    :func:`ransac_hypotheses` is one such call; ``chip_smoke.py`` times
    back-to-back calls with it."""
    _check_inputs(p1, p2, valid)
    _cuda_or_raise(p1, "ransac_hypotheses")
    L, N = valid.shape
    if N > MAX_N:
        raise ValueError(f"ransac_hypotheses takes at most {MAX_N} "
                         f"correspondences, got {N}")
    if n_samples < 0 or h_samples < 0:
        raise ValueError("sample counts must be >= 0")
    dev = p1.device
    p1, p2 = p1.contiguous(), p2.contiguous()
    valid = valid.contiguous()
    pos = None
    if positions is not None:
        idx, idx_h = _positions(valid, None, n_samples, h_samples, positions)
        pos = torch.cat([idx.reshape(L, -1), idx_h.reshape(L, -1)], dim=1)
        pos = pos.to(device=dev, dtype=torch.int64).contiguous()
        if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) >= N):
            raise ValueError("positions out of range")
    elif keys is None or len(keys) != L:
        raise ValueError("one key per lane is needed when no positions "
                         "are given")
    E = torch.empty((L, n_samples, 3, 3), dtype=F64, device=dev)
    H = torch.empty((L, h_samples, 3, 3), dtype=F64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = []
    for g in range(0, L, MAX_LANES):
        lanes = min(MAX_LANES, L - g)
        words = _Keys()
        if pos is None:
            for i, key in enumerate(keys[g:g + lanes]):
                (a1, a2), (b1, b2) = lane_keys(key)
                words.k[8 * i:8 * i + 8] = [*a1, *a2, *b1, *b2]
        calls.append((p1[g].data_ptr(), p2[g].data_ptr(),
                      valid[g].data_ptr(),
                      None if pos is None else pos[g].data_ptr(),
                      E[g].data_ptr() if n_samples else None,
                      H[g].data_ptr() if h_samples else None,
                      lanes, N, n_samples, h_samples, words, stream))
    fn = _hyp_lib()

    def launch():
        if n_samples + h_samples == 0:
            return
        for args in calls:
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"ransac_hyp launch failed: CUDA error "
                                   f"{err}")
            ransac_hypotheses.launches += 1

    launch.tensors = (p1, p2, valid, pos, E, H)   # what ``calls`` points at
    return launch, (E, H)


def ransac_hypotheses(p1, p2, valid, keys=None, n_samples=512,
                      h_samples=192, positions=None):
    """Minimal-sample hypotheses of L lanes (module doc): ``p1``, ``p2``
    (L, N, 2) f64, ``valid`` (L, N) bool, and either ``keys`` (L host
    keys, ``prng.key``; the draws of ``ops/draw.py``) or ``positions``
    (``(L, n_samples, 8)`` and ``(L, h_samples, 4)`` sample positions).
    Returns E (L, n_samples, 3, 3), projected onto (1, 1, 0), and H (L,
    h_samples, 3, 3), unit norm, f64.  CPU tensors run
    :func:`ransac_hypotheses_plain`; CUDA tensors launch ``ransac_hyp``;
    any other device raises."""
    if p1.device.type == "cpu":
        return ransac_hypotheses_plain(p1, p2, valid, keys, n_samples,
                                       h_samples, positions)
    launch, out = hypotheses_launcher(p1, p2, valid, keys, n_samples,
                                      h_samples, positions)
    launch()
    return out


def vote_launcher(models, p1, p2, valid, th2, mode):
    """:func:`hypotheses_launcher`'s counterpart for :func:`ransac_vote`:
    ``(launch, (mask, counts))``."""
    _check_vote(models, p1, p2, valid, th2, mode)
    _cuda_or_raise(p1, "ransac_vote")
    L, C = models.shape[:2]
    N = p1.shape[1]
    dev = p1.device
    models = models.contiguous()
    p1, p2, valid = p1.contiguous(), p2.contiguous(), valid.contiguous()
    mask = torch.empty((L, C, N), dtype=torch.bool, device=dev)
    counts = torch.empty((L, C), dtype=torch.int32, device=dev)
    args = (models.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            valid.data_ptr(), th2.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), L, C, N, MODES[mode],
            torch.cuda.current_stream(dev).cuda_stream)
    fn = _vote_lib()

    def launch():
        if L * C == 0:
            return
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"ransac_vote launch failed: CUDA error {err}")
        ransac_vote.launches += 1

    launch.tensors = (models, p1, p2, valid, th2, mask, counts)   # ``args``
    return launch, (mask, counts)


def ransac_vote(models, p1, p2, valid, th2, mode):
    """Inlier masks (L, C, N) bool and counts (L, C) int32 of ``models``
    (L, C, 3, 3) f64 against the lanes' ``p1``, ``p2`` (L, N, 2) f64 and
    ``valid`` (L, N): ``mode="sampson"`` (E, Sampson distance) or
    ``"transfer"`` (H, forward transfer error), each ``< th2`` (a 0-dim
    f64 tensor on the points' device).  CPU tensors run
    :func:`ransac_vote_plain`; CUDA tensors launch ``ransac_vote``; any
    other device raises."""
    if p1.device.type == "cpu":
        return ransac_vote_plain(models, p1, p2, valid, th2, mode)
    launch, out = vote_launcher(models, p1, p2, valid, th2, mode)
    launch()
    return out


# -- RANSAC's tail (csrc/ransac_tail.cu) -------------------------------------

# threads of a lane's block in the tail kernels (their sums over points run
# in this block's order, :func:`_block_sum`)
TAIL_THREADS = 256
WARP = 32
# the 9x9 Jacobi: tolerance, sweeps at most, and the eigenvalues taken as
# null (below this share of the largest)
JACOBI9_TOL = 1e-14
MAX_SWEEPS9 = 32
GRAM_RANK_TOL = 1e-12
# cv::recoverPose's cutoff of the triangulated distance, and the two-ray
# system's determinant below which a point has no depth
DIST_THRESH = 50.0
DEPTH_DET_TOL = 1e-12
# the upper triangle of a 9x9 matrix, row by row
UPPER9 = tuple((i, j) for i in range(9) for j in range(i, 9))


def _round_robin(n):
    """The cyclic Jacobi's rounds of disjoint pairs ``(p, q)``, ``p < q``,
    over ``n`` indices (the circle method; every pair once a sweep)."""
    m = n + n % 2
    rounds = []
    for r in range(m - 1):
        arr = [0] + [1 + (k + r) % (m - 1) for k in range(m - 1)]
        pairs = sorted(tuple(sorted((arr[k], arr[m - 1 - k])))
                       for k in range(m // 2))
        rounds.append(tuple(p for p in pairs if p[1] < n))
    return tuple(rounds)


# 9 rounds of 4 pairs; must equal the .cu's kRounds9
ROUNDS9 = _round_robin(9)


def _block_sum(terms, mask):
    """Sum over points of ``terms`` (L, N, K) where ``mask`` (L, N), in the
    tail kernels' order: thread ``t`` of ``TAIL_THREADS`` adds the points
    ``t, t + TAIL_THREADS, ...`` to 0, each warp halves its 32 partials,
    then the block halves its warps'.  -> (L, K)."""
    L, N, K = terms.shape
    T = TAIL_THREADS
    rows = -(-N // T)
    t = torch.where(mask[..., None], terms, torch.zeros_like(terms))
    t = torch.cat([t, t.new_zeros(L, rows * T - N, K)], dim=1)
    t = t.reshape(L, rows, T, K)
    acc = t.new_zeros(L, T, K)
    for r in range(rows):
        acc = acc + t[:, r]
    acc = acc.reshape(L, T // WARP, WARP, K)
    h = WARP // 2
    while h:
        acc = acc[:, :, :h] + acc[:, :, h:2 * h]
        h //= 2
    acc = acc[:, :, 0]
    h = T // WARP // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


_UI = torch.tensor([i for i, _ in UPPER9])
_UJ = torch.tensor([j for _, j in UPPER9])


def _sym9(g):
    """The symmetric (B, 9, 9) of upper-triangle entries (B, 45)."""
    G = g.new_empty(g.shape[0], 9, 9)
    G[:, _UI, _UJ] = g
    G[:, _UJ, _UI] = g
    return G


def _mirror_upper(A):
    """(B, 9, 9) with its lower triangle replaced by its upper one's."""
    upper = torch.ones(9, 9, dtype=torch.bool, device=A.device).triu()
    return torch.where(upper, A, A.transpose(1, 2))


def _jacobi9(G):
    """Eigenvalues (B, 9) and eigenvectors (columns of (B, 9, 9)) of the
    symmetric ``G`` by the cyclic Jacobi of the module doc.  Only the
    matrices that rotated in a sweep take the next one (the others would
    rotate nothing)."""
    B = G.shape[0]
    dev = G.device
    A_out = G.clone()
    V_out = torch.eye(9, dtype=F64, device=dev).repeat(B, 1, 1)
    act = torch.arange(B, device=dev)
    A, V = A_out, V_out.clone()
    rounds = [(torch.tensor([p for p, _ in r], device=dev),
               torch.tensor([q for _, q in r], device=dev)) for r in ROUNDS9]
    for _ in range(MAX_SWEEPS9):
        moved = torch.zeros(A.shape[0], dtype=torch.bool, device=dev)
        for P, Q in rounds:
            app, aqq, apq = A[:, P, P], A[:, Q, Q], A[:, P, Q]
            rot = torch.abs(apq) > JACOBI9_TOL * _sqrt(torch.abs(app)
                                                       * torch.abs(aqq))
            g = torch.where(rot, apq, torch.ones_like(apq))
            tau = (aqq - app) / (2.0 * g)
            sgn = torch.where(tau >= 0, torch.ones_like(tau),
                              torch.full_like(tau, -1.0))
            t = sgn / (torch.abs(tau) + _sqrt(1.0 + tau * tau))
            c = torch.ones_like(t) / _sqrt(1.0 + t * t)
            s = c * t
            r, cc, ss = rot[:, :, None], c[:, :, None], s[:, :, None]
            Ap, Aq = A[:, P, :], A[:, Q, :]
            Bm = A.clone()
            Bm[:, P, :] = torch.where(r, cc * Ap - ss * Aq, Ap)
            Bm[:, Q, :] = torch.where(r, ss * Ap + cc * Aq, Aq)
            r, cc, ss = rot[:, None, :], c[:, None, :], s[:, None, :]
            Bp, Bq = Bm[:, :, P], Bm[:, :, Q]
            A2 = Bm.clone()
            A2[:, :, P] = torch.where(r, cc * Bp - ss * Bq, Bp)
            A2[:, :, Q] = torch.where(r, ss * Bp + cc * Bq, Bq)
            A2[:, P, Q] = torch.where(rot, torch.zeros_like(apq),
                                      A2[:, P, Q])
            A = _mirror_upper(A2)
            Vp, Vq = V[:, :, P], V[:, :, Q]
            V = V.clone()
            V[:, :, P] = torch.where(r, cc * Vp - ss * Vq, Vp)
            V[:, :, Q] = torch.where(r, ss * Vp + cc * Vq, Vq)
            moved |= rot.any(dim=1)
        A_out[act], V_out[act] = A, V
        act, A, V = act[moved], A[moved], V[moved]
        if not act.numel():
            break
    return torch.diagonal(A_out, dim1=1, dim2=2), V_out


def _gram_null(G):
    """Unit null direction (B, 9) of symmetric (B, 9, 9) Gram matrices:
    ``NULL_PICK`` projected onto the eigenvectors whose eigenvalues lie
    below ``GRAM_RANK_TOL`` of the largest, and the smallest's."""
    w, V = _jacobi9(G)
    wmax = w[:, 0]
    for i in range(1, 9):
        wmax = torch.where(w[:, i] > wmax, w[:, i], wmax)
    jmin, _ = _arg_first(w, torch.lt)
    null = ((w < (GRAM_RANK_TOL * wmax)[:, None])
            | (torch.arange(9, device=G.device) == jmin[:, None]))
    d = _seq([V[:, k, :] * NULL_PICK[k] for k in range(9)])
    e = torch.zeros_like(d)
    for i in range(9):
        e = e + torch.where(null[:, i, None], d[:, i, None] * V[:, :, i],
                            torch.zeros_like(e))
    nrm = _sqrt(_seq([e[:, k] * e[:, k] for k in range(9)]))
    return e / _clamp_min(nrm, 1e-300)[:, None]


def _cross3(a, b):
    """Cross products of (B, 3) rows."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _det3(M):
    """Determinants of (B, 3, 3): ``(c0 x c1) . c2`` of the columns."""
    cr = _cross3(M[:, :, 0], M[:, :, 1])
    return _seq([cr[:, k] * M[:, k, 2] for k in range(3)])


def _mm3(A, B):
    """(B, 3, 3) products, each entry summed left to right."""
    return _seq([A[:, :, k, None] * B[:, None, k, :] for k in range(3)])


def _svd3(M):
    """SVD of (B, 3, 3) by the one-sided Jacobi of the projection (module
    doc): (U, d, V) with ``M ~ U diag(d) V^T``, ``d`` descending and U, V
    proper rotations."""
    B = M.shape[0]
    X = torch.cat([M, torch.eye(3, dtype=F64, device=M.device)
                   .expand(B, 3, 3)], dim=1)
    _jacobi3(X, None)
    Bm, W = X[:, :3], X[:, 3:]
    sig = _sqrt(_seq([Bm[:, i, :] * Bm[:, i, :] for i in range(3)]))
    i0, _ = _arg_first(sig, torch.gt)
    ra = torch.where(i0 == 0, 1, 0)
    rb = torch.where(i0 == 2, 1, 2)
    first = (sig.gather(1, ra[:, None])[:, 0]
             >= sig.gather(1, rb[:, None])[:, 0])
    order = torch.stack([i0, torch.where(first, ra, rb),
                         torch.where(first, rb, ra)], dim=1)
    d = sig.gather(1, order)
    u, v = [], []
    for k in range(2):
        j = order[:, k, None, None].expand(B, 3, 1)
        uk = Bm.gather(2, j)[:, :, 0] / _clamp_min(d[:, k], 1e-300)[:, None]
        vk = W.gather(2, j)[:, :, 0]
        flip = (_seq([uk[:, i] * NULL_PICK[i] for i in range(3)]) < 0)[:, None]
        u.append(torch.where(flip, -uk, uk))
        v.append(torch.where(flip, -vk, vk))
    U = torch.stack([u[0], u[1], _cross3(u[0], u[1])], dim=2)
    V = torch.stack([v[0], v[1], _cross3(v[0], v[1])], dim=2)
    return U, d, V


def _skew3(t):
    """``[t]x`` of (B, 3) rows."""
    z = torch.zeros_like(t[:, 0])
    return torch.stack([torch.stack([z, -t[:, 2], t[:, 1]], -1),
                        torch.stack([t[:, 2], z, -t[:, 0]], -1),
                        torch.stack([-t[:, 1], t[:, 0], z], -1)], dim=1)


def _decompose(H):
    """Faugeras-Lustman decomposition of calibrated homographies (B, 3, 3)
    into their 8 motions: R (B, 8, 3, 3), t (B, 8, 3) unit."""
    H = H * torch.where(_det3(H) < 0, -1.0, 1.0)[:, None, None]
    U, d, V = _svd3(H)
    s = _det3(U) * _det3(V)
    Vt = V.transpose(1, 2)
    d1, d2, d3 = d.unbind(1)
    d2s = torch.where(torch.abs(d2) > 1e-12, d2, torch.ones_like(d2))
    denom = _clamp_min(d1 * d1 - d3 * d3, 1e-24)
    x1a = _sqrt(_clamp_min((d1 * d1 - d2 * d2) / denom, 0.0))
    x3a = _sqrt(_clamp_min((d2 * d2 - d3 * d3) / denom, 0.0))
    z, o = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], dim=1)

    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1, x3 = e1 * x1a, e3 * x3a
            st = (d1 - d3) * x1 * x3 / d2s             # case d' = +d2
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
            sf = (d1 + d3) * x1 * x3 / d2s             # case d' = -d2
            cf = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
            for Rx, tx in (
                    (mat([[ct, z, -st], [z, o, z], [st, z, ct]]),
                     [(d1 - d3) * x1, z, -(d1 - d3) * x3]),
                    (mat([[cf, z, sf], [z, -o, z], [sf, z, -cf]]),
                     [(d1 + d3) * x1, z, (d1 + d3) * x3])):
                Rs.append(s[:, None, None] * _mm3(_mm3(U, Rx), Vt))
                t = _seq([U[:, :, k] * tx[k][:, None] for k in range(3)])
                nrm = _sqrt(_seq([t[:, k] * t[:, k] for k in range(3)]))
                ts.append(t / _clamp_min(nrm, 1e-12)[:, None])
    return torch.stack(Rs, dim=1), torch.stack(ts, dim=1)


def _pose_candidates(E):
    """The four (R, t) of (B, 3, 3) essential matrices: R (B, 4, 3, 3) =
    (Ra, Ra, Rb, Rb), t (B, 4, 3) = (u2, -u2, u2, -u2), ``Ra = U W V^T``,
    ``Rb = U W^T V^T``."""
    U, _, V = _svd3(E)
    u0, u1, u2 = U.unbind(2)
    v0, v1, v2 = V.unbind(2)

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    Ra = _seq([outer(u1, v0), outer(-u0, v1), outer(u2, v2)])
    Rb = _seq([outer(-u1, v0), outer(u0, v1), outer(u2, v2)])
    return (torch.stack([Ra, Ra, Rb, Rb], dim=1),
            torch.stack([u2, -u2, u2, -u2], dim=1))


def _ray_ok(R, t, p1, p2, mask):
    """Per model (R (L, M, 3, 3), t (L, M, 3)) and point of the lane (``p1``,
    ``p2`` (L, N, 2)): both two-ray depths positive, the first point's
    distance below ``DIST_THRESH``, and ``mask`` (L, M, N)."""
    x1, y1 = p1[:, None, :, 0], p1[:, None, :, 1]
    x2, y2 = p2[:, None, :, 0], p2[:, None, :, 1]
    r = R[..., None]
    a = [(r[:, :, i, 0] * x1 + r[:, :, i, 1] * y1) + r[:, :, i, 2]
         for i in range(3)]
    tt = t[..., None]
    aa = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]
    bb = (x2 * x2 + y2 * y2) + 1.0
    ab = (a[0] * x2 + a[1] * y2) + a[2]
    at = (a[0] * tt[:, :, 0] + a[1] * tt[:, :, 1]) + a[2] * tt[:, :, 2]
    bt = (x2 * tt[:, :, 0] + y2 * tt[:, :, 1]) + tt[:, :, 2]
    det = aa * bb - ab * ab
    good = det > (DEPTH_DET_TOL * aa) * bb
    det = torch.where(good, det, torch.ones_like(det))
    z1 = ((-at) * bb + ab * bt) / det
    z2 = (aa * bt - ab * at) / det
    r1 = _sqrt((x1 * x1 + y1 * y1) + 1.0)
    return (good & (z1 > 0) & (z2 > 0)
            & (torch.abs(z1) * r1 < DIST_THRESH) & mask)


def _cheirality_counts(E, mask, p1, p2):
    """Best-branch cheirality counts (L, M) of E (L, M, 3, 3) against the
    masks (L, M, N), ``VOTE_CHUNK`` candidates at a time (so that the
    temporaries stay in the cache)."""
    L, M = E.shape[:2]
    Rs, ts = _pose_candidates(E.reshape(-1, 3, 3))
    Rs, ts = Rs.reshape(L, 4 * M, 3, 3), ts.reshape(L, 4 * M, 3)
    mask = mask.repeat_interleave(4, dim=1)
    counts = torch.cat([
        _ray_ok(Rs[:, c:c + VOTE_CHUNK], ts[:, c:c + VOTE_CHUNK], p1, p2,
                mask[:, c:c + VOTE_CHUNK]).sum(dim=-1)
        for c in range(0, 4 * M, VOTE_CHUNK)], dim=1)
    return counts.reshape(L, M, 4).amax(dim=-1)


def _hartley_T(sw, sx, sy, sxx, syy):
    """(B, 3, 3) Hartley transforms from weighted moments (centroid to the
    origin, RMS radius sqrt(2))."""
    w = _clamp_min(sw, 1e-12)
    cx, cy = sx / w, sy / w
    var = _clamp_min((sxx + syy) / w - cx * cx - cy * cy, 1e-12)
    s = _sqrt(2.0 / var)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([torch.stack([s, z, -(s * cx)], -1),
                        torch.stack([z, s, -(s * cy)], -1),
                        torch.stack([z, z, o], -1)], dim=1)


def _solve_gram(G):
    """Unit E (B, 3, 3) from weighted 8-point Gram matrices (B, 9, 9):
    Hartley conditioning as the congruence ``M G M^T`` (``M = T2 (x)
    T1``), its null direction, ``M^T`` of it."""
    B = G.shape[0]
    T1 = _hartley_T(G[:, 8, 8], G[:, 8, 6], G[:, 8, 7], G[:, 6, 6],
                    G[:, 7, 7])
    T2 = _hartley_T(G[:, 8, 8], G[:, 2, 8], G[:, 5, 8], G[:, 2, 2],
                    G[:, 5, 5])
    M = (T2[:, :, None, :, None] * T1[:, None, :, None, :]).reshape(B, 9, 9)
    P = _seq([M[:, :, k, None] * G[:, None, k, :] for k in range(9)])
    Gn = _mirror_upper(_seq([P[:, :, k, None] * M[:, None, :, k]
                             for k in range(9)]))
    e_n = _gram_null(Gn)
    e = _seq([M[:, i, :] * e_n[:, i, None] for i in range(9)])
    nrm = _sqrt(_seq([e[:, k] * e[:, k] for k in range(9)]))
    return (e / _clamp_min(nrm, 1e-30)[:, None]).reshape(B, 3, 3)


def homography_refit_plain(Hc, hmask, sup_h, p1, p2):
    """Plain version of :func:`homography_refit`."""
    L = p1.shape[0]
    lanes = torch.arange(L, device=p1.device)
    hbest, _ = _arg_first(sup_h, torch.gt)
    w = hmask[lanes, hbest]
    sw = _clamp_min(w.sum(dim=1).to(F64), 1e-12)[:, None]
    mom = _block_sum(torch.cat([p1, p2], dim=2), w)
    d1, d2 = p1 - (mom[:, None, :2] / sw[:, None]), p2 - (
        mom[:, None, 2:] / sw[:, None])
    var = _block_sum(torch.stack(
        [d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] for d in (d1, d2)],
        dim=2), w) / sw
    s = _sqrt(2.0 / _clamp_min(var, 1e-12))
    q1, q2 = d1 * s[:, None, 0:1], d2 * s[:, None, 1:2]
    x1, y1, x2, y2 = q1[..., 0], q1[..., 1], q2[..., 0], q2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    ra = (x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2)
    rb = (z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2)
    G = _sym9(_block_sum(torch.stack(
        [ra[i] * ra[j] + rb[i] * rb[j] for i, j in UPPER9], dim=2), w))
    H = _homography_of(_gram_null(G), mom[:, :2] / sw, s[:, 0],
                       mom[:, 2:] / sw, s[:, 1])
    return H.reshape(L, 1, 3, 3), hbest.to(torch.int32)


def homography_pool_plain(E_cand, E_seed, Hc, hbest, sup_h, H_ref, sup_ref):
    """Plain version of :func:`homography_pool`."""
    L = E_cand.shape[0]
    lanes = torch.arange(L, device=E_cand.device)
    hb = hbest.long()
    keep = (sup_ref[:, 0] >= sup_h[lanes, hb])[:, None, None]
    Rs, ts = _decompose(torch.where(keep, H_ref[:, 0], Hc[lanes, hb]))
    E_h = _project_rank2(_mm3(_skew3(ts.reshape(-1, 3)),
                              Rs.reshape(-1, 3, 3)), None)
    seed = [] if E_seed is None else [E_seed[:, None]]
    return torch.cat([E_cand] + seed + [E_h.reshape(L, 8, 3, 3)], dim=1)


def cheirality_rerank_plain(models, inl, scores, p1, p2, k):
    """Plain version of :func:`cheirality_rerank`."""
    top = torch.sort(scores, dim=1, descending=True,
                     stable=True)[1][:, :k]
    lanes = torch.arange(scores.shape[0], device=scores.device)[:, None]
    che = _cheirality_counts(models[lanes, top], inl[lanes, top], p1, p2)
    return top.to(torch.int32), che.to(torch.int32)


def essential_refit_plain(top, che, inl, p1, p2):
    """Plain version of :func:`essential_refit`."""
    L = top.shape[0]
    lanes = torch.arange(L, device=top.device)
    bi, che_max = _arg_first(che, torch.gt)
    best = top[lanes, bi]
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    a = (x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
         torch.ones_like(x1))
    G = _sym9(_block_sum(torch.stack([a[i] * a[j] for i, j in UPPER9],
                                     dim=2), inl[lanes, best.long()]))
    E = _project_rank2(_solve_gram(G), None)
    return best, che_max, E.reshape(L, 1, 3, 3)


def ransac_finish_plain(E_ref, inl_ref, p1, p2, round_f32, pick=None):
    """Plain version of :func:`ransac_finish`."""
    L = E_ref.shape[0]
    lanes = torch.arange(L, device=E_ref.device)
    E, mask = E_ref[:, 0], inl_ref[:, 0]
    if pick is not None:
        models, inl, best, che_max = pick
        b = best.long()
        better = _cheirality_counts(E_ref, inl_ref, p1, p2)[:, 0] >= che_max
        E = torch.where(better[:, None, None], E, models[lanes, b])
        mask = torch.where(better[:, None], mask, inl[lanes, b])
    if round_f32:
        E = E.to(torch.float32).to(F64)
    Rs, ts = _pose_candidates(E)
    ok = _ray_ok(Rs, ts, p1, p2, mask[:, None].expand(L, 4, -1))
    k, n_che = _arg_first(ok.sum(dim=-1), torch.gt)
    return E, mask, Rs[lanes, k], ts[lanes, k], n_che, ok[lanes, k]


# name -> ctypes argument kinds of each tail kernel's entry point (p a
# pointer, i an int; the stream last)
_TAIL_ARGS = {"tail_homography_refit": "ppppppp" "iii",
              "tail_homography_pool": "pppppppp" "iii",
              "tail_cheirality_rerank": "ppppppp" "iiii",
              "tail_essential_refit": "pppppppp" "iiii",
              "tail_finish": "pppppppp" "pppppp" "iiii"}
# the .cu's constants, checked at load (ROUNDS9 besides)
TAIL_CONSTANTS = (JACOBI9_TOL, GRAM_RANK_TOL, DIST_THRESH, DEPTH_DET_TOL,
                  JACOBI_TOL, ZERO_TOL2) + NULL_PICK


@functools.lru_cache(maxsize=None)
def _tail_lib():
    from irotavg_tpu_torch.kernels.build import load

    lib = load("ransac_tail")
    limits = (ctypes.c_int * (4 + 9 * 4 * 2))()
    lib.ransac_tail_limits(limits)
    consts = (ctypes.c_double * len(TAIL_CONSTANTS))()
    lib.ransac_tail_constants(consts)
    rounds = tuple(tuple(tuple(limits[4 + 8 * r + 2 * k:6 + 8 * r + 2 * k])
                         for k in range(4)) for r in range(9))
    want = ((TAIL_THREADS, MAX_SWEEPS9, MAX_SWEEPS3, 9), ROUNDS9,
            TAIL_CONSTANTS)
    got = (tuple(limits[:4]), rounds, tuple(consts))
    if got != want:
        raise RuntimeError(f"ransac_tail limits and constants {got} differ "
                           f"from ops/ransac.py's {want}")
    for name, kinds in _TAIL_ARGS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                       for k in kinds] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _tail_launch(wrapper, name, *args):
    """Launch the tail kernel ``name`` on the current stream of the first
    tensor's device (tensors pass by pointer, None as null) and count it on
    ``wrapper``."""
    fn = getattr(_tail_lib(), name)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    wrapper.launches += 1


def _on_cuda(what, *tensors):
    """The tensors contiguous, after checking that they are CUDA tensors
    of one device."""
    dev = tensors[0].device
    _cuda_or_raise(tensors[0], what)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: every tensor must be on {dev}")
    return [t.contiguous() for t in tensors]


def homography_refit(Hc, hmask, sup_h, p1, p2):
    """The least-squares refit of each lane's best homography sample
    (module doc): ``Hc`` (L, Hs, 3, 3) f64 samples, ``hmask`` (L, Hs, N) and
    ``sup_h`` (L, Hs) int32 their transfer votes, ``p1``, ``p2`` (L, N, 2)
    f64.  Returns the refit H (L, 1, 3, 3), unit norm, and the sample's
    index (L,) int32 (the first of the largest support)."""
    if p1.device.type == "cpu":
        return homography_refit_plain(Hc, hmask, sup_h, p1, p2)
    Hc, hmask, sup_h, p1, p2 = _on_cuda("homography_refit", Hc, hmask,
                                        sup_h, p1, p2)
    L, Hs, N = hmask.shape
    H = torch.empty((L, 1, 3, 3), dtype=F64, device=p1.device)
    hbest = torch.empty(L, dtype=torch.int32, device=p1.device)
    _tail_launch(homography_refit, "tail_homography_refit", Hc, hmask,
                 sup_h, p1, p2, H, hbest, L, Hs, N)
    return H, hbest


def homography_pool(E_cand, E_seed, Hc, hbest, sup_h, H_ref, sup_ref):
    """The candidate pool (L, S + [1] + 8, 3, 3) f64: the minimal-sample E
    ``E_cand`` (L, S, 3, 3), ``E_seed`` (L, 3, 3) f64 or None, and the 8
    motions of the kept homography (the refit ``H_ref`` (L, 1, 3, 3) when
    its support ``sup_ref`` (L, 1) is at least the sample ``hbest``'s in
    ``sup_h``, else the sample ``Hc[hbest]``), each ``[t]x R`` projected
    onto (1, 1, 0)."""
    if E_cand.device.type == "cpu":
        return homography_pool_plain(E_cand, E_seed, Hc, hbest, sup_h,
                                     H_ref, sup_ref)
    seed = () if E_seed is None else (E_seed,)
    E_cand, Hc, hbest, sup_h, H_ref, sup_ref, *seed = _on_cuda(
        "homography_pool", E_cand, Hc, hbest, sup_h, H_ref, sup_ref, *seed)
    L, S = E_cand.shape[:2]
    pool = torch.empty((L, S + len(seed) + 8, 3, 3), dtype=F64,
                       device=E_cand.device)
    _tail_launch(homography_pool, "tail_homography_pool", E_cand,
                 seed[0] if seed else None, Hc, hbest, sup_h, H_ref, sup_ref,
                 pool, L, S, Hc.shape[1])
    return pool


def cheirality_rerank(models, inl, scores, p1, p2, k):
    """The ``min(k, C)`` best Sampson scores of each lane's pool in
    ``torch.sort(descending=True, stable=True)``'s order, ``top`` (L, K)
    int32, and each one's best-branch cheirality count over its inliers,
    ``che`` (L, K) int32: ``models`` (L, C, 3, 3) f64, ``inl`` (L, C, N)
    and ``scores`` (L, C) int32 their Sampson vote."""
    if p1.device.type == "cpu":
        return cheirality_rerank_plain(models, inl, scores, p1, p2, k)
    models, inl, scores, p1, p2 = _on_cuda("cheirality_rerank", models,
                                           inl, scores, p1, p2)
    L, C, N = inl.shape
    K = min(k, C)
    top = torch.empty((L, K), dtype=torch.int32, device=p1.device)
    che = torch.empty((L, K), dtype=torch.int32, device=p1.device)
    _tail_launch(cheirality_rerank, "tail_cheirality_rerank", models, inl,
                 scores, p1, p2, top, che, L, C, N, K)
    return top, che


def essential_refit(top, che, inl, p1, p2):
    """The pick of each lane, the first largest ``che`` (``best`` (L,)
    int32, a model index, and ``che_max`` (L,) int32), and the 8-point refit
    on its inliers ``inl[best]`` projected onto (1, 1, 0): (best, che_max,
    E (L, 1, 3, 3) f64)."""
    if p1.device.type == "cpu":
        return essential_refit_plain(top, che, inl, p1, p2)
    top, che, inl, p1, p2 = _on_cuda("essential_refit", top, che, inl, p1,
                                     p2)
    L, C, N = inl.shape
    best = torch.empty(L, dtype=torch.int32, device=p1.device)
    che_max = torch.empty(L, dtype=torch.int32, device=p1.device)
    E = torch.empty((L, 1, 3, 3), dtype=F64, device=p1.device)
    _tail_launch(essential_refit, "tail_essential_refit", top, che, inl, p1,
                 p2, best, che_max, E, L, C, N, top.shape[1])
    return best, che_max, E


def ransac_finish(E_ref, inl_ref, p1, p2, round_f32, pick=None):
    """The end of a RANSAC call and ``recover_pose``: with ``pick =
    (models, inl, best, che_max)``, E is the refit ``E_ref`` (L, 1, 3, 3)
    and its mask ``inl_ref`` (L, 1, N) when the refit's cheirality count is
    at least ``che_max``, else ``models[best]`` and ``inl[best]``; without,
    ``E_ref`` and ``inl_ref``.  E is rounded to f32 when ``round_f32``, then
    its pose recovered (module doc).  Returns (E (L, 3, 3), mask (L, N),
    R (L, 3, 3), t (L, 3), f64, n_che (L,) int64, pose mask (L, N))."""
    if p1.device.type == "cpu":
        return ransac_finish_plain(E_ref, inl_ref, p1, p2, round_f32, pick)
    E_ref, inl_ref, p1, p2, *picked = _on_cuda(
        "ransac_finish", E_ref, inl_ref, p1, p2, *(pick or ()))
    models, inl, best, che_max = picked or (None,) * 4
    L, _, N = inl_ref.shape
    dev = p1.device
    E = torch.empty((L, 3, 3), dtype=F64, device=dev)
    mask = torch.empty((L, N), dtype=torch.bool, device=dev)
    R = torch.empty((L, 3, 3), dtype=F64, device=dev)
    t = torch.empty((L, 3), dtype=F64, device=dev)
    n_che = torch.empty(L, dtype=torch.int64, device=dev)
    pose_mask = torch.empty((L, N), dtype=torch.bool, device=dev)
    _tail_launch(ransac_finish, "tail_finish", E_ref, inl_ref, models, inl,
                 best, che_max, p1, p2, E, mask, R, t, n_che, pose_mask, L,
                 0 if models is None else models.shape[1], N, int(round_f32))
    return E, mask, R, t, n_che, pose_mask


TAIL_WRAPPERS = (homography_refit, homography_pool, cheirality_rerank,
                 essential_refit, ransac_finish)


def reset_launch_counts() -> None:
    """Zero the kernel launch counters of every wrapper."""
    for fn in (ransac_hypotheses, ransac_vote) + TAIL_WRAPPERS:
        fn.launches = 0


def tail_launches() -> int:
    """Launches of the tail kernels so far (a host count)."""
    return sum(fn.launches for fn in TAIL_WRAPPERS)


# kernel launches made by the wrappers and launchers (read and reset by
# chip_smoke.py)
reset_launch_counts()

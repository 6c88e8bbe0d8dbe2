"""RANSAC's two fused f64 kernels: every lane's minimal-sample hypotheses
in one launch (``csrc/ransac_hyp.cu``) and their inlier vote in another
(``csrc/ransac_vote.cu``); the wrappers, their plain PyTorch versions and
their bounds.

:func:`ransac_hypotheses` computes, for each of L lanes of
correspondences ``p1``, ``p2`` (L, N, 2) f64:

* the sample positions: JAX's threefry draws of the lane's key mapped
  through the cumulative valid count, exactly as ``ops/draw.py`` draws
  them (or positions given by the caller);
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

The wrappers dispatch on the device of their tensors only: CPU tensors
run the plain version, CUDA tensors launch the kernel (one launch per
``MAX_LANES`` lanes for the hypotheses, whose keys travel in the
kernel's arguments; one launch for the vote) or raise.  Each launch adds
one to ``ransac_hypotheses.launches`` / ``ransac_vote.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from irotavg_tpu_torch.ops.draw import (
    MAP_OPS, THREEFRY_OPS, _Keys, draw_positions_plain, lane_keys,
)
from irotavg_tpu_torch.ops.segment import H100_ADDS_PER_S, \
    H100_HBM_BYTES_PER_S

F64 = torch.float64
# the direction whose projection onto a sample's null space is its null
# direction (geometry/essential.py's comment says why)
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


def reset_launch_counts() -> None:
    """Zero the kernel launch counters of both wrappers."""
    ransac_hypotheses.launches = 0
    ransac_vote.launches = 0


# kernel launches made by the wrappers and launchers (read and reset by
# chip_smoke.py)
reset_launch_counts()

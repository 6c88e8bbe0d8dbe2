"""Descriptor matchers as masked best-2 reductions.

Port of ``irotavg_tpu/matching/matchers.py`` (parity contracts of
src/ViewGraph.cpp :125-295 BoW, :298-437 epipolar, :440-569 local).  The
best-2 reduction is :func:`irotavg_tpu_torch.ops.match.best2` — the CUDA
kernel on the card.  Every core takes an optional leading batch axis on
the row side (window candidates); the column frame may be shared.

Kept from the reference, deliberately: a contested target keeps the
globally smallest distance (ties -> smaller row), and the rotation
histogram bins by ``round(delta_deg / 30)`` (only bins 0..12 are ever
populated — the ORB-SLAM2 quirk).

The Frame-level matchers (:func:`match_by_bow`, :func:`match_epipolar`,
:func:`match_locally`, :func:`match_sift`) read the frames' device tensors
(``Frame.dev``), run on that device and return the (N1,) host (numpy)
assignment vector.
"""

from __future__ import annotations

import numpy as np
import torch

import irotavg_tpu_torch.device  # noqa: F401  (no TF32: full f32 products)
from irotavg_tpu_torch.ops.match import best2, make_colf, make_rowf

TH_LOW = 50          # src/ViewGraph.cpp:33
HISTO_LENGTH = 30    # src/ViewGraph.cpp:32
_BIG = 10_000


def _best_two(desc1, desc2, rowf, colf, gate, matcher=None):
    """(d1, d2) as int32 and the best column as int64.  A shared column
    frame (2-D ``desc2`` or ``colf`` beside batched rows) goes to the
    kernel as it is, with a batch stride of 0.  ``matcher`` replaces this
    module's ``best2`` (a caller that captures the launch in a CUDA graph
    passes ``ops.match.best2`` itself, which nothing wraps)."""
    d1, d2, idx = (matcher or best2)(desc1, desc2, rowf, colf, gate)
    return d1.to(torch.int32), d2.to(torch.int32), idx.long()


def _resolve_conflicts(matches12, dists, n2):
    """Keep, for each contested target j, the row with minimal distance
    (ties -> smaller row index)."""
    n1 = matches12.shape[-1]
    j = torch.where(matches12 >= 0, matches12,
                    torch.full_like(matches12, n2))
    rows = torch.arange(n1, device=matches12.device)
    key = dists.long() * (n1 + 1) + rows
    best_key = torch.full(matches12.shape[:-1] + (n2 + 1,),
                          _BIG * (n1 + 1) + n1, dtype=torch.int64,
                          device=matches12.device)
    best_key = best_key.scatter_reduce(-1, j, key, "amin")
    winner = best_key.gather(-1, j) == key
    return torch.where((matches12 >= 0) & winner, matches12,
                       torch.full_like(matches12, -1))


def _rot_bins(angle1_rad, angle2_rad, matches12):
    """The reference's histogram bin per row (quirk included)."""
    a1 = torch.rad2deg(angle1_rad)
    a2 = torch.rad2deg(angle2_rad)
    if a2.dim() < matches12.dim():
        a2 = a2.expand(matches12.shape[:-1] + a2.shape)
    rot = a1 - a2.gather(-1, matches12.clamp(min=0))
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = torch.round(rot * (1.0 / HISTO_LENGTH)).to(torch.int64)
    return torch.where(bins == HISTO_LENGTH, torch.zeros_like(bins), bins)


def rotation_consistency_filter(matches12, angle1_rad, angle2_rad):
    """Drop matches outside the 3 dominant rotation-histogram bins
    (``computeThreeMaxima``, src/ViewGraph.cpp:64-103: second/third
    maxima kept only if >= 0.1x the first)."""
    bins = _rot_bins(angle1_rad, angle2_rad, matches12)
    valid = matches12 >= 0
    counts = torch.zeros(matches12.shape[:-1] + (HISTO_LENGTH,),
                         dtype=torch.int64, device=matches12.device)
    counts = counts.scatter_add(-1, torch.where(valid, bins, 0),
                                valid.long())

    def top(c):
        i = torch.argmax(c, dim=-1, keepdim=True)   # first occurrence
        return c.gather(-1, i), i, c.scatter(-1, i, -1)

    c1, i1, counts2 = top(counts)
    c2, i2, counts3 = top(counts2)
    c3, i3, _ = top(counts3)
    keep2 = c2.float() >= 0.1 * c1.float()
    keep3 = c3.float() >= 0.1 * c1.float()
    ok = (bins == i1) | (keep2 & (bins == i2)) | (keep2 & keep3 & (bins == i3))
    return torch.where(valid & ok, matches12, torch.full_like(matches12, -1))


def _match_by_bow_core(desc1, nodes1, valid1, angle1,
                       desc2, nodes2, valid2, angle2,
                       nnratio, has_nodes=True):
    rowf = make_rowf(valid1, node=nodes1)
    colf = make_colf(valid2, node=nodes2)
    d1, d2, best = _best_two(desc1, desc2, rowf, colf,
                             "node" if has_nodes else "none")
    ok = (d1 <= TH_LOW) & (d1.float() < nnratio * d2.float())
    matches12 = torch.where(ok, best, torch.full_like(best, -1))
    matches12 = _resolve_conflicts(matches12, d1, desc2.shape[-2])
    return rotation_consistency_filter(matches12, angle1, angle2)


def epipolar_lines(x2, y2, F12):
    """Line of p2 through F12^T, evaluated later at p1 (reference argument
    order), each product and sum rounded separately."""
    a = x2 * F12[..., 0, 0, None] + y2 * F12[..., 1, 0, None] + \
        F12[..., 2, 0, None]
    b = x2 * F12[..., 0, 1, None] + y2 * F12[..., 1, 1, None] + \
        F12[..., 2, 1, None]
    c = x2 * F12[..., 0, 2, None] + y2 * F12[..., 1, 2, None] + \
        F12[..., 2, 2, None]
    return a, b, c


def _epipolar_rowf(valid1, nodes1, x1, y1, oct1, sigma2_oct):
    """The rows' feature block of the epipolar gates: the chi-square
    threshold ``3.84 sigma^2`` of each row's octave."""
    th = 3.84 * sigma2_oct[oct1.long()]
    return make_rowf(valid1, node=nodes1, x=x1, y=y1, th=th)


def _match_epipolar_core(desc1, nodes1, valid1, angle1, x1, y1, oct1,
                         desc2, nodes2, valid2, angle2, x2, y2,
                         F12, sigma2_oct, has_nodes=True, rowf=None,
                         matcher=None):
    """Epipolar matching under ``F12``.  ``rowf``, when given, is the
    rows' feature block that :func:`_epipolar_rowf` makes of ``valid1``,
    ``nodes1``, ``x1``, ``y1``, ``oct1`` and ``sigma2_oct`` (made once for
    a loop of re-matches); ``matcher`` as in :func:`_best_two`."""
    if rowf is None:
        rowf = _epipolar_rowf(valid1, nodes1, x1, y1, oct1, sigma2_oct)
    a, b, c = epipolar_lines(x2, y2, F12)
    colf = make_colf(torch.as_tensor(valid2).expand(a.shape), node=nodes2,
                     a=a, b=b, c=c)
    gate = "epipolar" if has_nodes else "epipolar_nonode"
    d1, _, best = _best_two(desc1, desc2, rowf, colf, gate, matcher)
    matches12 = torch.where(d1 <= TH_LOW, best, torch.full_like(best, -1))
    matches12 = _resolve_conflicts(matches12, d1, desc2.shape[-2])
    return rotation_consistency_filter(matches12, angle1, angle2)


def _match_locally_core(desc1, valid1, oct1, gx, gy,
                        desc2, valid2, oct2, x2, y2, radius, nnratio):
    """``radius`` is one number, or a ``(B,)`` tensor giving each lane of
    batched rows its own."""
    # square search window (Frame::getFeaturesInArea filters |dx|,|dy| <= r)
    th = torch.as_tensor(radius, dtype=torch.float32, device=gx.device)
    th = (th[..., None] if th.dim() else th).expand(gx.shape)
    rowf = make_rowf(valid1, x=gx, y=gy, octave=oct1, th=th)
    colf = make_colf(valid2, x=x2, y=y2, octave=oct2)
    d1, d2, best = _best_two(desc1, desc2, rowf, colf, "local")
    ok = (d1 <= TH_LOW) & (d1.float() < nnratio * d2.float())
    matches12 = torch.where(ok, best, torch.full_like(best, -1))
    return _resolve_conflicts(matches12, d1, desc2.shape[-2])


def matches_to_pairs(m: np.ndarray) -> np.ndarray:
    """(N1,) host assignment vector -> (M, 2) index pairs."""
    i = np.where(m >= 0)[0]
    return np.stack([i, m[i]], axis=1).astype(np.int32)


# -- Frame-level wrappers ---------------------------------------------------


def _nodes(f):
    """The frame's vocabulary node ids on its device, or None."""
    return None if f.feat_nodes is None else f.dev("feat_nodes")


def match_by_bow(f1, f2, nnratio: float = 0.9):
    """BoW-guided matching between two Frames -> (N1,) matches12.  When
    either frame has no node ids the search is global (gate ``none``)."""
    n1, n2 = _nodes(f1), _nodes(f2)
    m = _match_by_bow_core(
        f1.dev("desc"), n1, f1.dev("valid"), f1.dev("angle"),
        f2.dev("desc"), n2, f2.dev("valid"), f2.dev("angle"),
        float(np.float32(nnratio)),
        has_nodes=n1 is not None and n2 is not None)
    return m.cpu().numpy()


def match_epipolar(f1, f2, F12, scale_factor: float = 1.2):
    """Epipolar-gated matching (undistorted coords) -> (N1,) matches12.
    ``F12`` is taken as f32; the gate scales with the octave's
    ``sigma^2`` over ``max(n_octaves, 8)`` levels."""
    n_oct = int(max(f1.octave.max(), f2.octave.max())) + 1
    dev = f1.device
    sigma2 = torch.as_tensor(
        (scale_factor ** np.arange(max(n_oct, 8))) ** 2,
        dtype=torch.float32, device=dev)
    F = torch.as_tensor(np.asarray(F12), dtype=torch.float32, device=dev)
    n1, n2 = _nodes(f1), _nodes(f2)
    has_nodes = n1 is not None and n2 is not None
    m = _match_epipolar_core(
        f1.dev("desc"), n1, f1.dev("valid"), f1.dev("angle"),
        f1.dev("xu"), f1.dev("yu"), f1.dev("octave"),
        f2.dev("desc"), n2, f2.dev("valid"), f2.dev("angle"),
        f2.dev("xu"), f2.dev("yu"), F, sigma2, has_nodes=has_nodes)
    return m.cpu().numpy()


def match_locally(f1, f2, guess_xy=None, radius: float = 100.0,
                  nnratio: float = 0.9):
    """Window search around guess positions (by default f1's own
    keypoints, the motion-free guess of `findCurr2PrevLocalMatches`,
    src/ViewGraph.cpp:574-596) -> (N1,) matches12."""
    if guess_xy is None:
        gx, gy = f1.dev("xu"), f1.dev("yu")
    else:
        gx, gy = (torch.as_tensor(np.asarray(g), dtype=torch.float32,
                                  device=f1.device) for g in guess_xy)
    m = _match_locally_core(
        f1.dev("desc"), f1.dev("valid"), f1.dev("octave"), gx, gy,
        f2.dev("desc"), f2.dev("valid"), f2.dev("octave"),
        f2.dev("xu"), f2.dev("yu"),
        float(np.float32(radius)), float(np.float32(nnratio)))
    return m.cpu().numpy()


def _match_sift_core(d1, valid1, d2, valid2):
    """Nearest neighbour by L2 over SIFT descriptors scaled by 512 (OpenCV's
    scale, so the reference's absolute threshold keeps its meaning): one
    f32 product ``|a|^2 + |b|^2 - 2 a.b``, the first arg-min, and the
    ``d <= max(3 * min_d, 80)`` filter.  Returns (m12, dmin)."""
    a = d1 * 512.0
    b = d2 * 512.0
    dist2 = ((a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :]
             - 2.0 * (a @ b.T))
    gate = valid1[:, None] & valid2[None, :]
    dist2 = torch.where(gate, dist2.clamp(min=0.0),
                        torch.full_like(dist2, float("inf")))
    j = torch.argmin(dist2, dim=1)                  # first occurrence
    dmin = torch.sqrt(dist2.gather(1, j[:, None])[:, 0])
    finite = torch.isfinite(dmin)
    global_min = torch.where(finite, dmin,
                             torch.full_like(dmin, float("inf"))).min()
    keep = finite & (dmin <= torch.clamp(3.0 * global_min, min=80.0))
    return torch.where(keep, j, torch.full_like(j, -1)), dmin


def match_sift(f1, f2):
    """Nearest-neighbour L2 matching of SIFT descriptors with the
    reference's good-match filter ``d <= max(3*min_d, 80.0)`` —
    `findSIFTMatches` (src/ViewGraph.cpp:694-722; FLANN there, one exact
    distance product here).  Returns the (N1,) assignment vector."""
    m12, _ = _match_sift_core(
        f1.dev("desc").to(torch.float32), f1.dev("valid"),
        f2.dev("desc").to(torch.float32), f2.dev("valid"))
    return m12.cpu().numpy()

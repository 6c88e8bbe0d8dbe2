"""FAST-9/16 corner detection as dense score maps (port of
``irotavg_tpu/ops/fast.py``).

Score (OpenCV's FAST-9 corner score): for the bright test, the max over
the 16 contiguous 9-arcs of (min over the arc of I(x_i) - I(p)); dark
symmetric; score = max(bright, dark) - 1.  A pixel is a corner at
threshold t iff score >= t.  Then 3x3 non-max suppression with the
reference's scan-order tie rule and the per-cell two-threshold fallback.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 in circular order, (dy, dx) from 12 o'clock
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1),
    ],
    dtype=np.int32,
)
ARC = 9  # contiguous arc length for FAST-9


def fast_score_map(img):
    """``([B,] H, W)`` f32 FAST-9/16 score; pixels within 3 px of the
    border get -inf.  Neighbours beyond the border replicate the edge (the
    reference's ``mode="edge"``)."""
    h, w = img.shape[-2:]
    pad = 3
    p = F.pad(img.reshape(-1, 1, h, w), (pad,) * 4, mode="replicate")
    p = p.reshape(img.shape[:-2] + p.shape[-2:])
    d = torch.stack([p[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]
                     - img for dy, dx in FAST_OFFSETS.tolist()])
    ext = torch.cat([d, d[:ARC - 1]], dim=0)            # (24, [B,] H, W)

    def arc_scores(vals):
        mins = vals[:16]
        for k in range(1, ARC):
            mins = torch.minimum(mins, vals[k:k + 16])
        return mins.amax(dim=0)

    score = torch.maximum(arc_scores(ext), arc_scores(-ext)) - 1.0
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= pad) & (yy < h - pad) & (xx >= pad) & (xx < w - pad)
    return torch.where(interior, score, torch.full_like(score, -np.inf))


def nms3(score):
    """3x3 non-max suppression of ``([B,] H, W)`` scores: a pixel must
    beat its neighbours earlier in row-scan order strictly and tie-or-beat
    the later ones."""
    h, w = score.shape[-2:]
    p = F.pad(score, (1, 1, 1, 1), value=-np.inf)
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            if (dy, dx) < (0, 0):             # earlier in scan order
                keep &= score > nb
            else:
                keep &= score >= nb
    return keep


def cell_fallback_mask(score, th_hi: float, th_lo: float, cell: int = 32):
    """Two-threshold detection with per-cell fallback (cells with a
    high-threshold corner use the high threshold, others the low one) of
    ``([B,] H, W)`` scores.  H and W must be multiples of ``cell``."""
    h, w = score.shape[-2:]
    if h % cell or w % cell:
        raise ValueError("pad the score map to a cell multiple")
    hi = score >= th_hi
    has_hi = hi.reshape(score.shape[:-2] + (h // cell, cell, w // cell, cell)
                        ).any(dim=-1).any(dim=-2)
    has_hi = has_hi.repeat_interleave(cell, -2).repeat_interleave(cell, -1)
    return torch.where(has_hi, hi, score >= th_lo)

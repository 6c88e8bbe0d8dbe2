"""Intensity-centroid keypoint orientation (port of
``irotavg_tpu/ops/orient.py``; IC_Angle, src/ORBExtractor.cpp:102-129):
moments m10 = sum u*I and m01 = sum v*I over the radius-15 discretised
disc, angle = atan2(m01, m10) in [0, 2pi).

The moments, ``atan2`` and the wrap run in f64 and the angle is cast to
f32 once, at the end (the reference sums in f32).  An f32 pixel times an
integer offset in [-15, 15] is exact in f64, so the sums of 961 products
carry an error near 1e-16 relative whatever order a device adds them in,
and the f32 angle is the same on the CPU and on a GPU unless its f64
value lies within a few f64 ulps of an f32 rounding boundary."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

HALF_PATCH = 15


def _umax() -> np.ndarray:
    """The reference's symmetric quarter-circle column bounds."""
    umax = np.zeros(HALF_PATCH + 2, np.int64)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


@functools.lru_cache(maxsize=1)
def orb_disc_mask() -> np.ndarray:
    """(31, 31) bool — the exact pixel disc IC_Angle sums over."""
    um = _umax()
    mask = np.zeros((31, 31), bool)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = um[abs(v)]
        mask[v + HALF_PATCH, HALF_PATCH - d: HALF_PATCH + d + 1] = True
    return mask


def ic_angles(patches):
    """Angles (radians, [0, 2pi), f32) for (K, 31, 31) f32 patches."""
    dev = patches.device
    mask = torch.from_numpy(orb_disc_mask()).to(dev, torch.float64)
    uu = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=torch.float64,
                      device=dev)
    p = patches.to(torch.float64)
    m10 = torch.sum(p * (mask * uu[None, :])[None], dim=(1, 2))
    m01 = torch.sum(p * (mask * uu[:, None])[None], dim=(1, 2))
    ang = torch.atan2(m01, m10)
    return torch.where(ang < 0, ang + 2 * math.pi, ang).to(torch.float32)

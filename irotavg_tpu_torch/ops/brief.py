"""Steered BRIEF-256 descriptors from gathered patches (port of
``irotavg_tpu/ops/brief.py``; computeOrbDescriptor,
src/ORBExtractor.cpp:133-172).

Each pattern point (px, py) is sampled at ``x = round(px*a - py*b)``,
``y = round(px*b + py*a)`` (a = cos, b = sin of the keypoint angle) from
the blurred level, and bit j is ``I(p_2j) < I(p_2j+1)``.  Descriptors are
8 words of 32 bits, bit j in word j // 32 at position j % 32, held as
int32 bit patterns (the reference's uint32 words).

``cos``/``sin`` of the f32 angle and the rotated offsets are computed in
f64 before rounding (the reference uses f32): a device's f64 ``cos`` and
``sin`` differ from another's by an ulp or two, far below the distance
of any real offset from a rounding tie, so every device samples the same
pixels.
"""

from __future__ import annotations

import torch

from irotavg_tpu_torch.ops.orb_pattern import ORB_PATTERN

PATCH_R = 20  # patch radius covering all rotated pattern offsets (<= 18)
PATCH_W = 2 * PATCH_R + 1


def steered_brief(patches, angles):
    """(K, 41, 41) blurred patches and (K,) angles -> (K, 8) int32."""
    dev = patches.device
    pts = torch.from_numpy(ORB_PATTERN.reshape(512, 2)).to(dev,
                                                           torch.float64)
    ang = angles.to(torch.float64)
    a = torch.cos(ang)[:, None]
    b = torch.sin(ang)[:, None]
    px = pts[None, :, 0]
    py = pts[None, :, 1]
    xo = torch.round(px * a - py * b).long() + PATCH_R
    yo = torch.round(px * b + py * a).long() + PATCH_R
    flat = patches.reshape(patches.shape[0], -1)
    vals = torch.gather(flat, 1, yo * PATCH_W + xo)          # (K, 512)
    bits = (vals[:, 0::2] < vals[:, 1::2]).to(torch.int64)   # (K, 256)
    bits = bits.reshape(-1, 8, 32)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = (bits << shifts).sum(dim=2)                      # < 2**32
    # reinterpret the low 32 bits as int32 (two's complement)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)

"""ORB feature extraction over an 8-level pyramid (port of
``irotavg_tpu/frontend/orb.py``).

Functional parity with the reference extractor (src/ORBExtractor.cpp):
chained bilinear pyramid (scale 1.2), geometric per-level budgets,
FAST-9/16 with a per-cell two-threshold fallback, 3x3 NMS, spatial
balancing as a per-16px-cell argmax then a global top-K by response,
intensity-centroid orientation on the unblurred level, a 7x7 sigma-2
blur then steered BRIEF-256.  Each level yields exactly ``budget[level]``
slots with a validity mask.

Tie rules kept from the reference: the per-cell argmax is the first
occurrence, and the top-K keeps lower cell indices first among equal
responses (a stable descending sort — ``torch.topk`` promises no order,
and FAST scores are integer-valued, so ties are common).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from irotavg_tpu_torch.device import pick_device
from irotavg_tpu_torch.ops.brief import PATCH_R, steered_brief
from irotavg_tpu_torch.ops.fast import (
    cell_fallback_mask, fast_score_map, nms3,
)
from irotavg_tpu_torch.ops.image import (
    gaussian_blur7, pad_reflect101, pyramid_sizes, resize_bilinear,
)
from irotavg_tpu_torch.ops.orient import ic_angles

DET_BORDER = 19  # detection border: EDGE_THRESHOLD-3 cell origin + 3 FAST margin
SEL_CELL = 16    # spatial-balance cell (px)
TH_CELL = 32     # two-threshold fallback cell (px)


@dataclasses.dataclass(frozen=True)
class OrbParams:
    """Extractor settings (the five ORB-SLAM YAML keys)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    def level_budgets(self) -> list[int]:
        """Geometric distribution over levels (src/ORBExtractor.cpp:461-472)."""
        factor = 1.0 / self.scale_factor
        ndesired = (self.n_features * (1 - factor)
                    / (1 - factor ** self.n_levels))
        budgets, acc = [], 0
        for _ in range(self.n_levels - 1):
            budgets.append(int(round(ndesired)))
            acc += budgets[-1]
            ndesired *= factor
        budgets.append(max(self.n_features - acc, 0))
        return budgets

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels)


def _patches(src, cy, cx, r, pad):
    """``(B, K, 2r+1, 2r+1)`` patches of the ``(B, H, W)`` images ``src``
    (padded by ``pad``) centred on the ``(B, K)`` keypoints."""
    off = torch.arange(-r, r + 1, device=src.device)
    rows = (cy + pad)[..., None] + off
    cols = (cx + pad)[..., None] + off
    b = torch.arange(src.shape[0], device=src.device)[:, None, None, None]
    return src[b, rows[..., :, None], cols[..., None, :]]


def _extract_level(img, th_hi, th_lo, k_budget: int):
    """All keypoints of one pyramid level of ``(B, H, W)`` f32 images;
    every output has a leading ``B``."""
    B, h, w = img.shape
    dev = img.device
    ninf = float("-inf")
    score = fast_score_map(img)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    region = ((yy >= DET_BORDER) & (yy < h - DET_BORDER)
              & (xx >= DET_BORDER) & (xx < w - DET_BORDER))
    score = torch.where(region, score, torch.full_like(score, ninf))

    sp = F.pad(score, (0, -w % TH_CELL, 0, -h % TH_CELL), value=ninf)
    corners = cell_fallback_mask(sp, th_hi, th_lo, TH_CELL)[:, :h, :w]
    corners &= nms3(score)
    cscore = torch.where(corners, score, torch.full_like(score, ninf))

    hc = -(-h // SEL_CELL)
    wc = -(-w // SEL_CELL)
    cs = F.pad(cscore, (0, wc * SEL_CELL - w, 0, hc * SEL_CELL - h),
               value=ninf)
    blocks = cs.reshape(B, hc, SEL_CELL, wc, SEL_CELL).permute(0, 1, 3, 2, 4)
    blocks = blocks.reshape(B, hc * wc, SEL_CELL * SEL_CELL)
    in_cell = torch.argmax(blocks, dim=-1)         # first occurrence
    cell_max = blocks.gather(-1, in_cell[..., None])[..., 0]

    # per image: a stable descending sort along the cells
    k = min(k_budget, hc * wc)
    top_val, top_cell = torch.sort(cell_max, dim=-1, descending=True,
                                   stable=True)
    top_val, top_cell = top_val[:, :k], top_cell[:, :k]
    valid = torch.isfinite(top_val)
    off = in_cell.gather(-1, top_cell)
    cy = torch.clamp((top_cell // wc) * SEL_CELL + off // SEL_CELL, 0, h - 1)
    cx = torch.clamp((top_cell % wc) * SEL_CELL + off % SEL_CELL, 0, w - 1)

    # the moment sums run image by image on a fresh (K, 31, 31) tensor, as
    # for one image: CUDA's reduction layout depends on the number of
    # outputs and on the data's alignment, so one call over B*K patches
    # could round differently from B calls over K
    ip = _patches(pad_reflect101(img, PATCH_R), cy, cx, 15, PATCH_R)
    angles = torch.stack([ic_angles(ip[b].clone()) for b in range(B)])
    # quantise like the reference's uint8 blurred image (half to even)
    bp = torch.round(pad_reflect101(gaussian_blur7(img), PATCH_R))
    desc = steered_brief(
        _patches(bp, cy, cx, PATCH_R, PATCH_R).reshape(
            B * k, 2 * PATCH_R + 1, 2 * PATCH_R + 1),
        angles.reshape(B * k)).reshape(B, k, 8)
    return {"x": cx.to(torch.float32), "y": cy.to(torch.float32),
            "response": top_val, "angle": angles, "desc": desc,
            "valid": valid}


def extract_batch(imgs, params: OrbParams) -> dict:
    """The whole pyramid for a ``(B, H, W)`` or ``(B, H, W, 3)`` stack of
    images: a dict of ``(B, N, ...)`` tensors.  Every operation is
    elementwise, per cell or per image, so ``out[k][b]`` equals
    :func:`extract` of image ``b`` bit for bit."""
    h, w = imgs.shape[1:3]
    sizes = pyramid_sizes(h, w, params.n_levels, params.scale_factor)
    budgets = params.level_budgets()
    scales = params.scale_factors()
    cur = imgs.to(torch.float32)
    if cur.dim() == 4:
        cur = 0.299 * cur[..., 0] + 0.587 * cur[..., 1] + 0.114 * cur[..., 2]
    levels = []
    for lv in range(params.n_levels):
        if lv > 0:
            cur = resize_bilinear(cur, *sizes[lv])
        out = _extract_level(cur, float(params.ini_th_fast),
                             float(params.min_th_fast), budgets[lv])
        s = float(np.float32(scales[lv]))
        out["x0"] = out["x"] * s
        out["y0"] = out["y"] * s
        out["octave"] = torch.full(out["x"].shape, lv, dtype=torch.int32,
                                   device=cur.device)
        out["size"] = torch.full(out["x"].shape, 31.0 * scales[lv],
                                 dtype=torch.float32, device=cur.device)
        levels.append(out)
    return {key: torch.cat([lv[key] for lv in levels], dim=1)
            for key in levels[0]}


def extract(img, params: OrbParams) -> dict:
    """The whole pyramid for one (H, W) or (H, W, 3) image tensor."""
    return {k: v[0] for k, v in extract_batch(img[None], params).items()}


class ORBExtractor:
    """Functional equivalent of the reference ``ORBextractor``.

    Call with a (H, W) uint8/float grayscale image (numpy or tensor);
    returns a dict of fixed-capacity tensors on ``device``: ``x0, y0``
    level-0 pixel coords, ``x, y`` level coords, ``octave``, ``size``,
    ``angle`` (radians), ``response``, ``desc`` (N, 8) int32, ``valid``.
    """

    def __init__(self, n_features=2000, scale_factor=1.2, n_levels=8,
                 ini_th_fast=20, min_th_fast=7, device=None):
        self.params = OrbParams(
            n_features=n_features, scale_factor=scale_factor,
            n_levels=n_levels, ini_th_fast=ini_th_fast,
            min_th_fast=min_th_fast)
        self.device = pick_device(device)

    @property
    def capacity(self) -> int:
        """Upper bound on output slots."""
        return sum(self.params.level_budgets())

    def __call__(self, image) -> dict:
        return extract(self._tensor(image), self.params)

    def extract_batch(self, images) -> dict:
        """``(B, H, W)`` images (a tensor, an array or a list of arrays) ->
        dict of ``(B, N, ...)`` tensors on ``device``; ``out[k][b]`` is
        this extractor's output for image ``b``."""
        return extract_batch(self._tensor(images), self.params)

    def _tensor(self, image):
        img = image if torch.is_tensor(image) else \
            torch.from_numpy(np.ascontiguousarray(image))
        return img.to(self.device)

"""Two-view relative pose estimation and epipolar re-match refinement.

Port of ``irotavg_tpu/geometry/twoview.py``: `ViewGraph::findRelativePose`
(src/ViewGraph.cpp:600-650) as one essential RANSAC plus pose recovery on
bucket-padded normalised coordinates, and `ViewGraph::refinePose`
(:725-783) as the engine's ``geometry/fused.py:fused_refine`` (epipolar
re-match on the matcher kernel, re-solve, keep the pose while
the cheirality count grows).  Both run on the frames' device (the card
unless the frames are on the CPU) and draw from the reference's key
``prng.key(seed)``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from irotavg_tpu_torch import prng, so3
from irotavg_tpu_torch.geometry.essential import (
    ransac_essential, recover_pose,
)
from irotavg_tpu_torch.geometry.fused import fused_refine
from irotavg_tpu_torch.matching.matchers import matches_to_pairs


@dataclasses.dataclass
class RelativePose:
    """Result of a two-view solve: x2 ~ R x1 + t (camera-1 to camera-2).
    Host (numpy) arrays, as the engine's bookkeeping reads them."""

    R: np.ndarray            # (3, 3)
    t: np.ndarray            # (3,)
    E: np.ndarray            # (3, 3) essential matrix (normalised coords)
    n_cheirality: int        # inliers passing the depth test
    inlier_mask: np.ndarray  # (M,) over the input pairs

    @property
    def q(self) -> np.ndarray:
        """Relative rotation as [x y z w] (edge convention R_j = R_ij R_i)."""
        R = torch.as_tensor(np.asarray(self.R, np.float64))
        return so3.rotmat_to_quat(R).numpy()


def _bucket(n, lo=64):
    """The padded correspondence count: the next power of two >= ``lo``."""
    b = lo
    while b < n:
        b <<= 1
    return b


def find_relative_pose(f1, f2, pairs, camera, *, th: float = 1.0,
                       seed: int = 0) -> RelativePose | None:
    """Estimate the relative pose from matched feature pairs.

    ``pairs``: (M, 2) indices into f1/f2 features (undistorted coords, as
    the reference).  Returns None when M <= 4 (the reference asserts) or
    when at most 6 correspondences pass cheirality (the reference's check
    at src/ViewGraph.cpp:637).  Runs on the frames' device.
    """
    m = len(pairs)
    if m <= 4:
        return None
    dev = f1.device
    x1 = (f1.xu[pairs[:, 0]] - camera.cx) / camera.fx
    y1 = (f1.yu[pairs[:, 0]] - camera.cy) / camera.fy
    x2 = (f2.xu[pairs[:, 1]] - camera.cx) / camera.fx
    y2 = (f2.yu[pairs[:, 1]] - camera.cy) / camera.fy
    mp = _bucket(m)
    p1 = np.zeros((mp, 2), np.float32)
    p2 = np.zeros((mp, 2), np.float32)
    p1[:m, 0], p1[:m, 1] = x1, y1
    p2[:m, 0], p2[:m, 1] = x2, y2
    valid = np.zeros(mp, bool)
    valid[:m] = True

    p1, p2, valid = (torch.from_numpy(a).to(dev) for a in (p1, p2, valid))
    th_norm = torch.tensor(np.float32(th / float(camera.fx)), device=dev)
    E, inl, _ = ransac_essential(p1, p2, valid, prng.key(seed),
                                 th_norm=th_norm, n_samples=1024)
    R, t, n_che, pose_mask = recover_pose(E, p1, p2, inl)
    n_che = int(n_che)
    if n_che <= 6:
        return None
    return RelativePose(
        R=R.cpu().numpy().astype(np.float64),
        t=t.cpu().numpy().astype(np.float64),
        E=E.cpu().numpy().astype(np.float64),
        n_cheirality=n_che, inlier_mask=pose_mask.cpu().numpy()[:m])


def refine_pose(f1, f2, rel: RelativePose, pairs, camera, *,
                min_matches: int = 100, max_iters: int = 10,
                seed: int = 1) -> tuple[RelativePose, np.ndarray]:
    """Alternate epipolar-guided re-matching and re-estimation
    (`ViewGraph::refinePose`).  ``pairs`` is the current (inlier-filtered)
    match set of ``rel``.  Returns ``(pose, pairs)``: the refined pose and
    its inlier pairs when the cheirality support grew past ``len(pairs)``,
    else ``rel`` and ``pairs`` unchanged.

    Runs :func:`~irotavg_tpu_torch.geometry.fused.fused_refine` on the
    frames' device with the key ``prng.key(seed)``; the re-match uses
    the ``epipolar`` gate when both frames carry vocabulary node ids,
    else ``epipolar_nonode``."""
    dev = f1.device
    f32 = torch.float32
    has_nodes = f1.feat_nodes is not None and f2.feat_nodes is not None

    def tensors(f):
        nodes = f.dev("feat_nodes") if has_nodes else torch.zeros(
            f.capacity, dtype=torch.int32, device=dev)
        return (f.dev("desc"), nodes, f.dev("valid"), f.dev("angle"),
                f.dev("xu"), f.dev("yu"), f.dev("octave"))

    m12_0 = np.full(f1.capacity, -1, np.int64)
    m12_0[pairs[:, 0]] = pairs[:, 1]
    K_inv = torch.tensor(np.linalg.inv(camera.K).astype(np.float32),
                         device=dev)
    sigma2 = torch.tensor(((1.2 ** np.arange(8)) ** 2).astype(np.float32),
                          device=dev)
    cam = torch.tensor([camera.fx, camera.fy, camera.cx, camera.cy],
                       dtype=f32, device=dev)
    th_norm = torch.tensor(np.float32(1.0 / camera.fx), device=dev)

    def batch(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=dev)[None]

    E, R, t, n, m12, _ = fused_refine(
        tuple(a[None] for a in tensors(f1)), tensors(f2)[:6],
        batch(rel.E), batch(rel.R), batch(rel.t),
        batch(len(pairs), torch.int64), batch(m12_0, torch.int64),
        K_inv, sigma2, cam, th_norm, [prng.key(seed)],
        math.ceil(0.75 * min_matches), has_nodes, max_iters)
    n = int(n[0])
    if n <= len(pairs):
        return rel, pairs
    best_pairs = matches_to_pairs(m12[0].cpu().numpy())
    best = RelativePose(
        R=R[0].cpu().numpy().astype(np.float64),
        t=t[0].cpu().numpy().astype(np.float64),
        E=E[0].cpu().numpy().astype(np.float64), n_cheirality=n,
        inlier_mask=np.ones(len(best_pairs), bool))
    return best, best_pairs

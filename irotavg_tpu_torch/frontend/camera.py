# Copied verbatim from irotavg_tpu/frontend/camera.py (numpy only; deduplicate once irotavg_tpu imports lazily).
"""Camera intrinsics / distortion model.

Parity with src/Camera.{hpp,cpp}: pinhole K = [[fx,0,cx],[0,fy,cy],[0,0,1]]
with radial-tangential distortion [k1 k2 p1 p2]; undistorted image bounds
from the 4 undistorted corners; the 64x48 feature-grid scale factors
(FRAME_GRID macros, src/Camera.hpp:31-32).  Not a singleton — an immutable
value passed where needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FRAME_GRID_COLS = 64
FRAME_GRID_ROWS = 48


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 0
    height: int = 0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]],
            np.float64,
        )

    @property
    def has_distortion(self) -> bool:
        # reference skips undistortion entirely when k1 == 0 (src/Frame.cpp:105)
        return self.k1 != 0.0

    def undistort_points(self, x, y, iters: int = 5):
        """Iterative undistortion (cv::undistortPoints fixed-point scheme),
        pixel coords in, pixel coords out."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        xd = (x - self.cx) / self.fx
        yd = (y - self.cy) / self.fy
        xu, yu = xd, yd
        for _ in range(iters):
            r2 = xu * xu + yu * yu
            k_radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
            dx = 2 * self.p1 * xu * yu + self.p2 * (r2 + 2 * xu * xu)
            dy = self.p1 * (r2 + 2 * yu * yu) + 2 * self.p2 * xu * yu
            xu = (xd - dx) / k_radial
            yu = (yd - dy) / k_radial
        return xu * self.fx + self.cx, yu * self.fy + self.cy

    def normalize_points(self, x, y):
        """Pixel -> normalised camera coords (undistorted)."""
        xu, yu = self.undistort_points(x, y) if self.has_distortion else (x, y)
        return (
            (np.asarray(xu) - self.cx) / self.fx,
            (np.asarray(yu) - self.cy) / self.fy,
        )

    def undistorted_bounds(self):
        """(min_x, max_x, min_y, max_y) from the undistorted image corners
        (src/Camera.cpp:30-67)."""
        if not self.has_distortion:
            return 0.0, float(self.width), 0.0, float(self.height)
        xs = np.array([0.0, self.width, 0.0, self.width])
        ys = np.array([0.0, 0.0, self.height, self.height])
        xu, yu = self.undistort_points(xs, ys)
        return float(xu.min()), float(xu.max()), float(yu.min()), float(yu.max())

    def grid_cell(self, x, y):
        """Feature-grid cell indices (col, row) for undistorted pixel coords;
        -1 where outside the grid."""
        min_x, max_x, min_y, max_y = self.undistorted_bounds()
        ix = np.floor(
            (np.asarray(x) - min_x) * FRAME_GRID_COLS / (max_x - min_x)
        ).astype(np.int32)
        iy = np.floor(
            (np.asarray(y) - min_y) * FRAME_GRID_ROWS / (max_y - min_y)
        ).astype(np.int32)
        ok = (ix >= 0) & (ix < FRAME_GRID_COLS) & (iy >= 0) & (iy < FRAME_GRID_ROWS)
        return np.where(ok, ix, -1), np.where(ok, iy, -1)

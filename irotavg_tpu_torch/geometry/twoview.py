"""Two-view relative pose result (port of ``RelativePose`` from
``irotavg_tpu/geometry/twoview.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from irotavg_tpu_torch import so3


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

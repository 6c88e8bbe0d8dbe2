"""Two-view geometry: essential RANSAC, pose recovery, fused loops."""

from irotavg_tpu_torch.geometry.essential import (  # noqa: F401
    ransac_essential,
    recover_pose,
    sampson_distance,
)
from irotavg_tpu_torch.geometry.twoview import (  # noqa: F401
    RelativePose,
    find_relative_pose,
    refine_pose,
)

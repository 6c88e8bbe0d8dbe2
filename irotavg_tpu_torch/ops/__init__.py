"""Image, FAST, orientation, BRIEF, Hamming and matcher operations."""

from irotavg_tpu_torch.ops.image import (  # noqa: F401
    gaussian_blur7,
    pad_reflect101,
    pyramid_sizes,
    resize_bilinear,
)
from irotavg_tpu_torch.ops.fast import (  # noqa: F401
    FAST_OFFSETS,
    fast_score_map,
    nms3,
)
from irotavg_tpu_torch.ops.orient import ic_angles, orb_disc_mask  # noqa: F401
from irotavg_tpu_torch.ops.brief import steered_brief  # noqa: F401
from irotavg_tpu_torch.ops.hamming import (  # noqa: F401
    hamming_matrix, popcount32,
)
from irotavg_tpu_torch.ops.orb_pattern import ORB_PATTERN  # noqa: F401

"""Front ends: the ORB and SIFT extractors, Frame, Camera, batched
look-ahead extraction."""

from irotavg_tpu_torch.frontend.orb import (  # noqa: F401
    ORBExtractor, OrbParams,
)
from irotavg_tpu_torch.frontend.camera import Camera  # noqa: F401
from irotavg_tpu_torch.frontend.frame import Frame  # noqa: F401
from irotavg_tpu_torch.frontend.prefetch import FramePrefetcher  # noqa: F401
from irotavg_tpu_torch.frontend.sift import (  # noqa: F401
    SIFTExtractor, SiftParams,
)

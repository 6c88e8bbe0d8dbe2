"""The offline (batched) pipeline: the whole sequence extracted up front,
all window pairs estimated in chunks, one global robust solve."""

from irotavg_tpu_torch.pipeline.offline import (  # noqa: F401
    OfflineResult, run_offline,
)

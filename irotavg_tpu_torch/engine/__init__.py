"""View-graph engine and the incremental windowed solver."""

from irotavg_tpu_torch.engine.incremental import (  # noqa: F401
    IncrementalRotAvg,
)

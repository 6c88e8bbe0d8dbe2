"""Sequence loading, per-stage timing and tracing, match plots."""

from irotavg_tpu_torch.utils.sequence import (  # noqa: F401
    SequenceLoader, load_gray,
)
from irotavg_tpu_torch.utils.timing import (  # noqa: F401
    StageTimer, device_trace,
)
from irotavg_tpu_torch.utils.viz import (  # noqa: F401
    draw_matches,
    plot_matches,
    save_png,
)

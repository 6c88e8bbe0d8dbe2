"""engine: milliseconds a whole-graph solve: the mean of the program's
``engine.rot_avg`` spans that ran a solve (attribute ``n``) over a window
wider than the CLI's ``rotavg_win_size`` (the re-solve after a new loop
edge), in the traced window."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("engine.rot_avg",)


def read(r):
    from irotavg_tpu_torch.config import PipelineConfig

    win = PipelineConfig().rotavg_win_size
    got = [b - a for a, b, attrs in ps.spans(r, "engine.rot_avg")
           if "n" in attrs and attrs.get("win_size", 0) > win]
    if not got:
        return None
    return sum(got) / len(got) / 1e6

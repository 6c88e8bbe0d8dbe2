"""geometry: the share of the epipolar refine's iterations that replayed
CUDA graphs, in %: Σ ``replays`` / Σ ``iters`` of the program's
``geometry.refine`` spans (``geometry/fused.py:fused_refine``, one a
call) in the traced window.  None where no span ran an iteration, and
from a program that opens no such span."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("geometry.refine",)


def read(r):
    got = ps.spans(r, "geometry.refine")
    iters = sum(a.get("iters", 0) for _, _, a in got)
    if iters <= 0:
        return None
    return 100.0 * sum(a.get("replays", 0) for _, _, a in got) / iters

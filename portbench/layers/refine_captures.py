"""geometry: the captures of the epipolar refine's CUDA graphs in the
traced window: Σ ``captures`` of the program's ``geometry.refine`` spans
(``geometry/fused.py:fused_refine``, one a call; 1 where the call met a
signature whose graphs were not captured yet).  Set-up should capture
every signature the window meets, so this should read 0: a capture in
the window costs an eager iteration and the capture itself.  None where
no such span carries ``captures``, and from a program that opens none."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("geometry.refine",)


def read(r):
    got = [a for _, _, a in ps.spans(r, "geometry.refine") if "captures" in a]
    if not got:
        return None
    return float(sum(a["captures"] for a in got))

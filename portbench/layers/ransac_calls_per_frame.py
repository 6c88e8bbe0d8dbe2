"""geometry: RANSAC batches a frame: the program's ``geometry.ransac``
spans (``geometry/fused.py:_ransac_lanes``: the initial-pose trials, the
refine iterations, the window walk, the loop verification) in the traced
window over its frames."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("geometry.ransac",)


def read(r):
    got = ps.spans(r, "geometry.ransac")
    frames = r.units.get("frames", 0)
    if not got or frames <= 0:
        return None
    return len(got) / frames

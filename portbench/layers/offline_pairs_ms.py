"""geometry: milliseconds a frame in an offline job's window-pair stage:
the program's ``offline.pairs`` spans (every window pair of the
keyframes through local matching, RANSAC and refine in chunks, with the
retry pass at twice the radius) in the traced window over the frames of
the jobs finished in it."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("offline.pairs",)


def read(r):
    return ps.ms_per_unit(r, "offline.pairs", "frames")

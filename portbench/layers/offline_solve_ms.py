"""solver: milliseconds a job in an offline job's global solve: the
program's ``offline.solve`` spans (spanning-tree start, L1-RA and IRLS
over every keyframe, f64, dense) in the traced window over the jobs
finished in it."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("offline.solve",)


def read(r):
    return ps.ms_per_unit(r, "offline.solve", "jobs")

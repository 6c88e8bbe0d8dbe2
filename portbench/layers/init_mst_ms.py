"""solver: milliseconds a solve in the host's spanning-tree start: the
program's ``solver.init_mst`` spans in the traced window over its solves."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("solver.init_mst",)


def read(r):
    return ps.ms_per_unit(r, "solver.init_mst", "solves")

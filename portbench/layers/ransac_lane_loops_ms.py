"""geometry: milliseconds a frame in RANSAC's lane-by-lane host loops: the
program's ``geometry.ransac.lanes`` spans (the homography rescue's refit
and decomposition, the cheirality re-rank, the refit's check,
``recover_pose``) in the traced window over its frames."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("geometry.ransac.lanes",)


def read(r):
    return ps.ms_per_unit(r, "geometry.ransac.lanes", "frames")

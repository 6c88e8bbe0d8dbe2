"""frontend: milliseconds a frame in an offline job's batched extraction:
the program's ``offline.extract`` spans (ORB over every frame of the job
in batches, keypoints to f32) in the traced window over the frames of the
jobs finished in it."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("offline.extract",)


def read(r):
    return ps.ms_per_unit(r, "offline.extract", "frames")

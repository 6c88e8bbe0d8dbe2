"""placerec and loop closure: milliseconds a frame in an offline job's
loop-closure stage: the program's ``offline.loop`` spans (the keyframes'
BoW descents, the inverted-file cascade and consistency, the loop pairs'
verification) in the traced window over the frames of the jobs finished
in it."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("offline.loop",)


def read(r):
    return ps.ms_per_unit(r, "offline.loop", "frames")

"""geometry: device-to-host copies a chunk of offline pair estimates: the
device trace's copies named ``DtoH`` that start and end inside one of
the program's ``offline.pair_chunk`` spans (a ``fused_pair_estimate``
call with its results copied to the host), over those spans."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("offline.pair_chunk",)


def read(r):
    got = ps.spans(r, "offline.pair_chunk")
    if not got:
        return None
    return ps.device_to_host_in(r, [(a, b) for a, b, _ in got]) / len(got)

"""geometry: device-to-host copies a RANSAC batch: the device trace's
copies named ``DtoH`` that start and end inside one of the program's
``geometry.ransac`` spans, over those spans (each read the host waits for)."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("geometry.ransac",)


def read(r):
    got = ps.spans(r, "geometry.ransac")
    if not got:
        return None
    return ps.device_to_host_in(r, [(a, b) for a, b, _ in got]) / len(got)

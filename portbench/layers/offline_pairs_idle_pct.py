"""geometry: the share of the time inside the program's ``offline.pairs``
spans in which no operation ran on the card, in %: 100 * (1 - busy time
inside the union of the spans / that union's length) (device trace)."""

import os

from pbkit import spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("offline.pairs",)


def read(r):
    return ps.idle_pct(r, "offline.pairs")

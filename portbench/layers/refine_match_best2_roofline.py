"""kernels: the matcher's share of its roofline inside the epipolar
refine, in %.  ``geometry/fused.py:fused_refine`` launches its re-match
from a replayed CUDA graph, not through the ``best2`` call that
``match_best2_roofline`` wraps, so that metric does not see it.

The least time of a launch is the bytes of ``roofline/match_best2.py``'s
model (every input read once, 12 bytes a row written) at the launch's
shape, which the program's ``geometry.refine`` span records (``width``
lanes, ``rows`` and ``cols`` slots, one column frame for every lane or
not), at the HBM rate.  The model's other side, 2 * 256 operations a
pair the gate admits, is left out: a replay reads nothing back, so the
admitted pairs are not known.  The share is therefore at most the one
that model would give.  Device time: the ``match_best2`` kernels that
start inside the spans.  A span holds ``replays`` + ``captures``
launches (a capture runs one eager re-match first).  Summed over the
window's spans; None without such spans or kernels."""

import bisect
import os

from pbkit import peaks, spec

ps = spec.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "_program_spans.py"),
                      "portbench_layers_program_spans")

WRAP = {}
SPANS = ("geometry.refine",)
KERNEL = "match_best2"
ROW_BYTES = 8 * 4        # a descriptor's 8 int32 words, or 8 f32 features
OUT_BYTES = 12           # two f32 distances and an int32 index a row


def launch_bytes(a) -> int:
    """Bytes of one re-match launch of a span's attributes ``a``."""
    lanes, n1, n2 = a["width"], a["rows"], a["cols"]
    desc2 = n2 if a["shared"] else lanes * n2
    # desc1, desc2, the row and column feature blocks (the column block is
    # one a lane: its epipolar lines are), the outputs
    return (ROW_BYTES * (lanes * n1 + desc2 + lanes * n1 + lanes * n2)
            + OUT_BYTES * lanes * n1)


def read(r):
    got = [(s, e, a) for s, e, a in ps.spans(r, "geometry.refine")
           if "width" in a and a.get("replays", 0) + a.get("captures", 0)]
    least = dev = 0.0
    starts = r.device.starts if got else []
    for s, e, a in got:
        least += (a["replays"] + a.get("captures", 0)) * launch_bytes(a) \
            / peaks.HBM_BYTES
        lo = bisect.bisect_left(starts, s)
        hi = bisect.bisect_left(starts, e)
        dev += sum(b - t for t, b, name in r.device.ops[lo:hi]
                   if KERNEL in name) / 1e9
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev

"""kernels: the matcher's share of its roofline, in %: the least time the
card needs for the work that each ``best2`` call's inputs ask for
(``roofline/match_best2.py``) over the device time of every operation
inside the call, summed over the window's calls (device trace)."""

from pbkit import spec
from pbkit.trace import roofline_pct

WRAP = {"best2": (["irotavg_tpu_torch.matching.matchers:best2"], True)}


def read(r):
    if r.device is None:
        return None
    return roofline_pct(r.device, r.tracer, "best2",
                        spec.roofline("match_best2").least_s)

"""What the per-layer readers of the program's own spans share.

The program records its spans itself (``irotavg_tpu_torch/utils/timing.py:
span``) while a profiler session runs, so in a traced run, on the clock
the profiler stamps the device's operations with (``time.time_ns``).
These spans never synchronise the card, unlike the harness's.  A checkout
of the program without the recorder gives no spans, and every reader then
returns None.
"""

from __future__ import annotations

import bisect

# the harness's merge of intervals: sorted, merged [[start, end]]
from pbkit.trace import _union as union


def spans(r, name: str) -> list:
    """``[(start_ns, end_ns, attrs)]`` of the program's finished spans
    ``name`` that start inside the traced window; [] without a device trace
    or a recorder."""
    if r.device is None or r.device.window is None:
        return []
    try:
        from irotavg_tpu_torch.utils import timing
    except ImportError:
        return []
    recorded = getattr(timing, "recorded_spans", None)
    if recorded is None:
        return []
    s, e = r.device.window
    return [(a, b, attrs) for n, a, b, _, attrs in recorded()
            if n == name and b is not None and s <= a < e]


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_pct(r, name: str):
    """100 * (1 - device-busy time inside the union of the spans ``name``
    / that union's length); None without such spans."""
    u = union((a, b) for a, b, _ in spans(r, name))
    length = sum(e - s for s, e in u)
    if length <= 0:
        return None
    return 100.0 * (1.0 - overlap_ns(r.device.busy(), u) / length)


def ms_per_unit(r, name: str, unit: str):
    """Milliseconds of the spans ``name`` per unit of work (``frames``,
    ``solves``); None without such spans or units."""
    got = spans(r, name)
    units = r.units.get(unit, 0)
    if not got or units <= 0:
        return None
    return sum(b - a for a, b, _ in got) / 1e6 / units


def device_to_host_in(r, intervals) -> int:
    """Device-to-host copies (operations named ``DtoH``) that start and end
    inside one of ``intervals``: a read the host waits for inside a span
    ends before the host goes on, so inside the span; a copy that ends
    after the span is not one its code waited for."""
    starts = r.device.starts
    n = 0
    for s, e in intervals:
        lo = bisect.bisect_left(starts, s)
        hi = bisect.bisect_left(starts, e)
        n += sum(1 for _, b, name in r.device.ops[lo:hi]
                 if b <= e and "DtoH" in name)
    return n

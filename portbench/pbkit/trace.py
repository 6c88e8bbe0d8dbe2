"""Spans around the calls into the program, and the device trace.

A :class:`Tracer` is on only in a traced run (``--trace 1``).  There each
span synchronises the card at its start and end, so the device work of
the calls inside it lies inside it, and records its host interval on the
system clock (``time.time_ns``), the clock the profiler puts the device's
operations on.  Off, a span costs one ``if``.  ``wrap`` puts a span around
a program function at the module attribute its callers look it up by, and
can keep each call's arguments for a roofline's work function.

One profiler session runs over the whole window (``begin`` to ``end``),
with CUDA activity only, so the session holds the device's operations and
no host operators (some two million operations in a 51-second SLAM
window).

:class:`DeviceTrace` reduces that session to the device's operations,
beside the tracer's spans; its window is the traced span (``traced``).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, on: bool, device):
        self.on = bool(on)
        self.device = device
        self.spans: dict[str, list] = defaultdict(list)
        self.calls: dict[str, list] = defaultdict(list)
        self.events = None
        self._undo: list = []
        self._prof = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        self.sync()
        t0 = time.time_ns()
        yield
        self.sync()
        self.spans[name].append((t0, time.time_ns()))

    def wrap(self, target: str, name: str, capture: bool = False) -> None:
        """Span ``name`` around ``module:attr`` (traced runs only); with
        ``capture`` the ``(args, kwargs, (start, end))`` of each call made
        while the profiler runs are kept."""
        if not self.on:
            return
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                out = orig(*args, **kwargs)
            if capture and self._prof is not None:
                self.calls[name].append((args, kwargs, self.spans[name][-1]))
            return out

        setattr(mod, attr, wrapped)
        self._undo.append((mod, attr, orig))

    def unwrap(self) -> None:
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    def begin(self) -> None:
        """Start the profiler (the window's start)."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        act = (ProfilerActivity.CUDA if self.device.type == "cuda"
               else ProfilerActivity.CPU)
        self._prof = profile(activities=[act])
        self._prof.__enter__()
        self.sync()
        self._t0 = time.time_ns()

    def end(self) -> None:
        if self._prof is None:
            return
        self.sync()
        self.spans["traced"].append((self._t0, time.time_ns()))
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.events = prof.profiler.kineto_results.events()

    def total_s(self, name: str) -> float:
        return sum(t1 - t0 for t0, t1 in self.spans.get(name, ())) / 1e9


def _duration_ns(e) -> int:
    if hasattr(e, "duration_ns"):
        return e.duration_ns()
    return int(e.duration_us() * 1000)


def _union(intervals):
    """Sorted, merged ``[(start, end)]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """The device's operations ``(start_ns, end_ns, name)`` of the traced
    part of the window and the tracer's spans ``name -> [(start_ns,
    end_ns)]``; ``window`` is the traced part."""

    def __init__(self, events, spans):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for e in events:
            kind = e.activity_type() if hasattr(e, "activity_type") else None
            if (kind in DEVICE_ACTIVITIES if kind is not None
                    else e.device_type() == cuda):
                s = e.start_ns()
                ops.append((s, s + _duration_ns(e), e.name()))
        ops.sort()
        self.ops = ops
        self.starts = [s for s, _, _ in ops]
        self.ranges = {k: sorted(v) for k, v in spans.items()}
        w = self.ranges.get("traced", [])
        self.window = w[0] if w else None

    def outside_window(self) -> int:
        """Operations that do not lie inside the traced window (0 when the
        two clocks agree: it synchronises the card at both ends)."""
        if self.window is None:
            return len(self.ops)
        s, e = self.window
        return sum(1 for a, b, _ in self.ops if a < s or b > e)

    def _inside(self, s, e):
        lo = bisect.bisect_left(self.starts, s)
        hi = bisect.bisect_left(self.starts, e)
        return self.ops[lo:hi]

    def busy(self):
        """Merged device-busy intervals inside the window."""
        if self.window is None:
            return []
        s, e = self.window
        return _union((max(a, s), min(b, e)) for a, b, _ in self.ops
                      if b > s and a < e)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def window_s(self) -> float:
        return 0.0 if self.window is None else \
            (self.window[1] - self.window[0]) / 1e9

    def op_time_s(self, s, e) -> float:
        """Device seconds of the operations that start in ``[s, e)``."""
        return sum(b - a for a, b, _ in self._inside(s, e)) / 1e9

    def top_ops(self, k=10):
        """The ``k`` operation names with most device time: ``[[name, s]]``."""
        if self.window is None:
            return []
        tot = defaultdict(int)
        for a, b, name in self._inside(*self.window):
            tot[name] += b - a
        return [[n, t / 1e9] for n, t in
                sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_by_span(self, k=10):
        """Idle device time in the window, by the innermost harness range
        the host was in at each gap's midpoint: ``[[name, s]]``, longest
        first (``window`` where no other range was open)."""
        if self.window is None:
            return []
        busy = self.busy()
        s, e = self.window
        edges = [s] + [x for iv in busy for x in iv] + [e]
        gaps = [((a + b) / 2, b - a) for a, b in zip(edges[0::2], edges[1::2])
                if b > a]
        # harness ranges nest (they are context managers on one thread), so
        # a sweep with a stack of open ranges finds the innermost one
        spans = sorted(((a, -b, name) for name, rs in self.ranges.items()
                        if name not in ("window", "traced")
                        for a, b in rs))
        tot = defaultdict(int)
        stack, j = [], 0
        for mid, length in gaps:
            while j < len(spans) and spans[j][0] <= mid:
                a, nb, name = spans[j]
                while stack and stack[-1][0] <= a:
                    stack.pop()
                stack.append((-nb, name))
                j += 1
            while stack and stack[-1][0] <= mid:
                stack.pop()
            tot[stack[-1][1] if stack else "window"] += length
        return [[n, t / 1e9] for n, t in
                sorted(tot.items(), key=lambda x: -x[1])[:k]]


def roofline_pct(device: DeviceTrace, tracer: Tracer, span: str, work):
    """Σ least time / Σ device time, in %, over the calls of ``span`` made
    while the profiler ran: ``work(args, kwargs)`` gives the least seconds
    or None per call; the device time of a call is that of every operation
    inside its span.  None where no call was read or no device time found."""
    least = dev = 0.0
    for args, kwargs, (s, e) in tracer.calls.get(span, ()):
        t = work(args, kwargs)
        if t is None:
            continue
        least += t
        dev += device.op_time_s(s, e)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev


def per_unit_ms(tracer: Tracer, span: str, units: int):
    """Milliseconds of ``span`` per unit of work (frame, solve)."""
    if units <= 0 or span not in tracer.spans:
        return None
    return 1e3 * tracer.total_s(span) / units

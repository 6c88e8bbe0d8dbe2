# Copied from irotavg_tpu/utils/timing.py (StageTimer, which now opens a
# program span per stage; device_trace is rewritten on torch.profiler, and
# the span recorder is the port's own).
"""Per-stage timing, program spans and profiling.

The reference's observability is `clock()` brackets printing per-frame
``frame creation / frame processing / rotavg`` seconds
(src/IRotAvg.cpp:258,273-274,356-357,379-383) and solver runtime
out-params (ral/l1_irls.cpp:581-583,741-743).  This module keeps that
per-frame timing line as a compatible observable and adds structured
aggregation plus an optional ``torch.profiler`` trace context (the
counterpart of the JAX package's ``jax.profiler.trace``).

Program spans (:func:`span`) mark the layer boundaries where the work
happens (``engine.process_frame``, ``geometry.ransac``, ``solver.l1ra``,
...).  They record only while a ``torch.profiler`` session runs (the
CLI's ``--trace_dir``, a benchmark's traced window), checked at each
span's entry; otherwise a span costs that check.  A recorded span is
``(name, start_ns, end_ns, parent, attrs)``: host times on
``time.time_ns()``, the clock the profiler stamps device operations
with; ``parent`` the index of the enclosing span (None at the root);
``attrs`` counts known on the host.  A span never synchronises the
device and never reads it.  It also opens a
``torch.profiler.record_function`` range of its name, so a profiler
trace shows the program's tree.  Spans nest on one thread.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_profiler_enabled = torch.autograd._profiler_enabled
# every recorded span, [name, start_ns, end_ns, parent, attrs], in the
# order they opened, and the indices of the open ones, innermost last
_records: list = []
_open: list = []


class _Span:
    """A span recorded while the profiler runs."""

    __slots__ = ("_rec", "_range")

    def __init__(self, name: str, attrs: dict):
        self._rec = [name, None, None, None, attrs]

    def __enter__(self):
        self._range = torch.profiler.record_function(self._rec[0])
        self._range.__enter__()
        self._rec[3] = _open[-1] if _open else None
        _open.append(len(_records))
        _records.append(self._rec)
        self._rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._rec[2] = time.time_ns()
        _open.pop()
        self._range.__exit__(*exc)
        return False

    def set(self, **attrs) -> None:
        """Add host-known counts to the span's attributes."""
        self._rec[4].update(attrs)


class _Off:
    """The span outside a profiler session: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A program span ``name`` around a ``with`` block, with the host-known
    counts ``attrs`` (more with ``.set(...)`` inside the block).  Recorded
    only while a ``torch.profiler`` session runs; otherwise one check and
    nothing else."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def recorded_spans() -> list:
    """Every recorded span ``(name, start_ns, end_ns, parent, attrs)`` in
    the order they opened; a span still open has ``end_ns`` None."""
    return [tuple(r) for r in _records]


def clear_spans() -> None:
    """Forget the recorded spans (none may be open)."""
    if _open:
        raise RuntimeError("clear_spans() inside an open span")
    _records.clear()


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block under ``name``, inside a program span of it."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def frame_line(self, frame_id: int) -> str:
        """The reference's per-frame printf (src/IRotAvg.cpp:382-383)."""
        return (
            f"frame {frame_id}  -- runtimes: "
            f"frame creation {self.last.get('frame_creation', 0.0):.3f}; "
            f"frame processing {self.last.get('frame_processing', 0.0):.3f}, "
            f"rotavg {self.last.get('rotavg', 0.0):.3f}"
        )

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir: str | None, device=None):
    """``torch.profiler`` trace of the enclosed code when ``log_dir`` is
    set; a no-op with ``None``.

    Records CPU activity, and CUDA activity (kernels, copies) when
    ``device`` is a CUDA device, or, with ``device=None``, when a card is
    available.  On exit it writes one TensorBoard / Chrome trace file,
    ``<host>_<pid>.<ms>.pt.trace.json``, under ``log_dir``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield

"""One run of one cell: set-up, the measured window, the per-layer
readings, the program let go, the check against the reference, and the
result line."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from pbkit import spec
from pbkit.trace import DeviceTrace, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "irotavg_tpu")


def process_age_s() -> float | None:
    """Seconds since this process started (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not see,
    compared whole (``irotavg_tpu_torch`` is not ``irotavg_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver's ``setup`` gets."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: object
    tracer: Tracer
    root: str
    control: bool = False
    shared: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Reading:
    """What a per-layer reader gets: the tracer, the device trace (or
    None) and the window's work counts (``frames``, ``solves``)."""
    tracer: Tracer
    device: DeviceTrace | None
    units: dict


def wraps_of(cell: spec.Cell) -> list:
    """``(target, span, capture)`` of every per-layer metric of the cell."""
    out = []
    for m in cell.per_layer:
        for span, (targets, capture) in getattr(cell.layer(m["name"]),
                                                "WRAP", {}).items():
            for t in targets:
                out.append((t, span, capture))
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, *, control=False, fault=None, shared=None,
             t_start=None, log=sys.stderr) -> dict:
    """Everything after the card check; returns the result object (its
    keys in the order they are printed)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    tracer = Tracer(trace, device)
    ctx = Context(config=cell.config, traffic=cell.traffic, seed=seed,
                  seconds=seconds, device=device, tracer=tracer,
                  root=cell.root, control=control,
                  shared={} if shared is None else shared)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    drv = cell.driver()
    run = drv.setup(ctx)
    if fault is not None:
        drv.plant(run, fault)
    for target, span, capture in wraps_of(cell):
        tracer.wrap(target, span, capture)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # process start to the window's start (the interpreter's own start
    # included where /proc tells it)
    setup_s = process_age_s()
    if setup_s is None:
        setup_s = time.perf_counter() - t_start
    dev_trace = None
    with tracer.span("window"):
        tracer.begin()
        res = drv.window(run, seconds)
        tracer.end()
    if trace:
        t_read = time.perf_counter()
        dev_trace = DeviceTrace(tracer.events, tracer.spans)
        tracer.events = None
        print(f"portbench: {len(dev_trace.ops)} device operations in the "
              f"traced {dev_trace.window_s():.3f} s "
              f"({dev_trace.outside_window()} outside it), read in "
              f"{time.perf_counter() - t_read:.3f} s", file=log)
    tracer.unwrap()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics = {}
    if trace:
        reading = Reading(tracer=tracer, device=dev_trace,
                          units=res["units"])
        for m in cell.per_layer:
            v = cell.layer(m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else \
                res["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    tracer.calls.clear()
    drv.collect(run)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = drv.check(run)
    print(f"portbench: reference {time.perf_counter() - t_ref:.3f} s, "
          f"setup {setup_s:.3f} s", file=log)
    limits = cell.traffic["limits"]
    compared = {k: {"value": v, "limit": limits.get(k)}
                for k, v in numbers.items()}
    correct = (res["failed"] == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and dev_trace is not None:
        out["device"]["busy_s"] = dev_trace.busy_s()
        out["device"]["window_s"] = dev_trace.window_s()
        out["breakdown"] = {"device_ops": dev_trace.top_ops(10),
                            "idle_gaps": dev_trace.idle_by_span(10)}
    out["compared"] = compared
    for k, c in compared.items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return out


def dumps(out: dict) -> str:
    return json.dumps(out, allow_nan=False)

#!/usr/bin/env python3
"""The solver on the fused Laplacian kernels (``csrc/laplacian.cu``)
against the unfused composition they replace
(``tests/composed_laplacian.py``), on one CUDA card.

    python3 tools/prof_cg50k.py [--iters 3]

1. A ``torch.profiler`` trace of ``--iters`` IRLS iterations of the
   50k-view f64 CG solve (``chip_smoke.large_problem``: bench.py:379-401's
   problem, the reference's f64 CG configuration), on the composition,
   then on the fused kernels.  For each it prints the card, the host wall
   of the profiled iterations, the CG iterations, the kernel events per
   CG iteration, the device time by operator (``key_averages``, inclusive
   of the kernels each launches), the shares of the port's ctypes kernels
   (their events carry the kernel's name and no operator:
   ``segment_sum``, the fused matvec and assembly), the gathers
   (``index``), ``cholesky``/``cholesky_solve`` and the rest, the
   matvec's device time (the device work launched inside the
   ``cg_matvec`` range around each matvec call), and the device's idle
   share of the wall (1 - the summed time of the device's own events over
   the wall; one stream, so kernels do not overlap), beside the share
   from the operators' summed self device time, this tool's earlier
   measure.
2. The solves in turns (rounds of composition, fused, fused,
   composition; ``ROUNDS``), each run required to give the first run's
   bits: 5b's solve; the 4541-view
   engine re-solve (``IncrementalRotAvg.rot_avg(5_000_000)``), CG and
   dense; bench.py's 384 windows through ``solve_windows``; 20 engine
   window solves (L1-RA, then IRLS, dense) of a 13-view chain.
3. The kernel launches and sorts of one call: the CG matvec at 5b, and a
   dense assembly of the 13-view window with three L1-RA lanes, with its
   plan built beforehand (as ``irls`` and ``l1ra`` build it once a call)
   and with the plan built inside the call
   (``solver/graph.py:laplacian_dense`` given no plan).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# exact operator names; a name ending in "*" matches every event key that
# contains the rest (a kernel's demangled template names)
GROUPS = (("segment_sum (scatter-add)", ("segment_sum_kernel*",)),
          ("laplacian_matvec (fused CG matvec)",
           ("laplacian_matvec_rows*",)),
          ("laplacian_assemble (dense Laplacian)",
           ("laplacian_assemble_kernel*",)),
          ("gathers (aten::index)", ("aten::index",)),
          ("cholesky / cholesky_solve",
           ("aten::linalg_cholesky_ex", "aten::cholesky_solve")))


# rounds of (composition, fused, fused, composition) of each workload in
# part 2: host-bound times spread, so the cheap ones take more
ROUNDS = {"5b": 3, "5c": 1, "5d": 5, "window": 5}


def _dev_us(e, self_only):
    name = "self_device_time_total" if self_only else "device_time_total"
    if not hasattr(e, name):           # older torch
        name = name.replace("device", "cuda")
    return getattr(e, name)


def _annotated(fn):
    """``fn`` inside a ``cg_matvec`` profiler range."""
    from torch.profiler import record_function

    def matvec(*a, **kw):
        with record_function("cg_matvec"):
            return fn(*a, **kw)
    return matvec


def _is_runtime(e):
    """A CUDA runtime or driver call (a launch, a copy, a fill): the only
    host events named ``cuda*`` / ``cu*``."""
    return e.name().startswith("cu")


def _matvec_device_us(prof, torch):
    """(device us, calls) of the work launched inside the host-side
    ``cg_matvec`` ranges: the device events whose runtime call (matched by
    its correlation id) started inside a range.  A kernel launched through
    ctypes has no operator to hang under, so the ranges' own device time
    would miss it."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == "cg_matvec" and e.device_type() == cpu)
    starts = [a for a, _ in ranges]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    launched = {e.correlation_id() for e in events
                if e.device_type() == cpu and _is_runtime(e)
                and inside(e.start_ns())}
    us = sum(e.duration_ns() for e in events
             if e.device_type() != cpu and e.name() != "cg_matvec"
             and e.correlation_id() in launched) / 1e3
    return us, len(ranges)


def profile_route(route, g, cfg, card):
    """Profiles ``irls(g, cfg)`` on ``route``; returns its kernel events
    and CG iterations."""
    import composed_laplacian
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from irotavg_tpu_torch.solver import graph
    from irotavg_tpu_torch.solver.irls import irls

    if route == "composed":
        ctx = composed_laplacian.composed_route()
        target = (composed_laplacian, "composed_matvec")
    else:
        ctx = contextlib.nullcontext()
        target = (graph, "laplacian_matvec")
    orig = getattr(*target)
    setattr(*target, _annotated(orig))
    try:
        with ctx:
            irls(g, dataclasses.replace(cfg, max_iters=1))     # warm-up
            torch.cuda.synchronize()
            with chip_smoke.CountCG() as cg, profile(
                    activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                irls(g, cfg)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        setattr(*target, orig)
    cg_iters = cg.total()
    ops = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the device's own events (kernels, copies, fills), without the
    # device-side copy of the cg_matvec range, which spans its kernels and
    # the gaps between them
    device = [e for e in prof.events()
              if e.device_type == cuda and e.name != "cg_matvec"]
    n_kernels = len(device)
    mv_us, n_ranges = _matvec_device_us(prof, torch)
    # the operators' summed self device time (the earlier measure) counts
    # each kernel under the operator that launched it as well as under its
    # own name
    busy_us = sum(e.device_time_total for e in device)
    ops_us = sum(_dev_us(e, True) for e in ops)
    if busy_us <= 0:
        print("prof_cg50k: the trace holds no device time", file=sys.stderr)
        return None
    print(f"[prof] {card}; route {route}: {cfg.max_iters} IRLS iterations "
          f"of the 50k f64 CG solve, {cg_iters} CG iterations: wall "
          f"{wall_us / 1e3:.3f} ms, {n_kernels} kernel events "
          f"({n_kernels / cg_iters:.2f} per CG iteration), device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f} "
          f"(operators' summed self device time {ops_us / 1e3:.3f} ms, "
          f"idle share {1 - ops_us / wall_us:.4f})")

    def matching(names):
        return [e for e in ops if any(
            n[:-1] in e.key if n.endswith("*") else e.key == n
            for n in names)]

    print(f"[prof] {route} the CG matvec: {mv_us / 1e3:.3f} ms device "
          f"over {n_ranges} calls, {mv_us / max(n_ranges, 1):.2f} us a "
          f"call, share of device time {mv_us / busy_us:.4f}")
    for label, names in GROUPS:
        hits = matching(names)
        us = sum(_dev_us(e, False) for e in hits)
        calls = sum(e.count for e in hits)
        per = f", {us / calls:.2f} us a call" if calls else ""
        print(f"[prof] {route} {label}: {us / 1e3:.3f} ms device, {calls} "
              f"calls{per}, share of device time {us / busy_us:.4f}, of "
              f"wall {us / wall_us:.4f}")
    top = sorted((e for e in ops if e.key.startswith("aten::")),
                 key=lambda e: -_dev_us(e, True))[:15]
    print(f"[prof] {route} aten operators by self device time (ms, calls):")
    for e in top:
        print(f"[prof]   {e.key:40s} {_dev_us(e, True) / 1e3:10.3f} "
              f"{e.count:8d}")
    return n_kernels, cg_iters


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _route(name):
    from composed_laplacian import composed_route

    return composed_route() if name == "composed" else \
        contextlib.nullcontext()


def in_turns(torch, label, fn, card, rounds, unit="s", scale=1.0):
    """Runs ``fn`` ``rounds`` times on the composition, the fused kernels,
    the fused kernels and the composition; prints every time and the
    medians; fails unless every run gives the first run's bits."""
    from composed_laplacian import bits_equal

    order = ("composed", "fused", "fused", "composed") * rounds
    times = {"composed": [], "fused": []}
    first = None
    for route in order:
        with _route(route):
            out, secs = _timed(torch, fn)
        out = [t.detach().clone() for t in out]
        if first is None:
            first = out
        elif not all(bits_equal(a, b) for a, b in zip(first, out)):
            raise SystemExit(f"prof_cg50k: {label} on {route} differs from "
                             f"the first run")
        times[route].append(secs * scale)
    med = {r: statistics.median(t) for r, t in times.items()}
    runs = ", ".join(f"{r} {t:.4f}" for r, t in zip(
        order, [times[r].pop(0) for r in order]))
    print(f"[turns] {label}: {runs} {unit}; median composed "
          f"{med['composed']:.4f}, fused {med['fused']:.4f} {unit} "
          f"(fused / composed {med['fused'] / med['composed']:.4f}); "
          f"every run bit-identical  ({card})")
    return med


def solves_in_turns(torch, g, cfg, card):
    """Part 2: 5b, 5c (CG and dense), 5d and a main-path window solve in
    turns on both routes."""
    import numpy as np

    import chip_smoke
    from irotavg_tpu_torch.engine.batched import solve_windows
    from irotavg_tpu_torch.engine.incremental import IncrementalRotAvg, \
        _window_solve
    from irotavg_tpu_torch.solver.irls import irls

    dev = g.edges.device
    irls(g, cfg)                                         # warm-up
    in_turns(torch, "5b 50k f64 CG IRLS solve", lambda: irls(g, cfg)[:2],
             card, ROUNDS["5b"])

    _, edges, QQ, Q0 = chip_smoke.kitti_chain(chip_smoke.KITTI_VIEWS)
    for name, dense_n_max in (("cg", 2048), ("dense", 8192)):
        eng = IncrementalRotAvg(device=dev, dense_n_max=dense_n_max)
        for _ in range(chip_smoke.KITTI_VIEWS):
            eng.add_view()
        for (i, j), q in zip(edges, QQ):
            eng.add_edge(int(i), int(j), q)
        eng.fix_pose(0)

        def resolve():
            eng.Q = Q0.copy()
            eng.rot_avg(5_000_000)
            return [torch.from_numpy(eng.Q.copy())]

        in_turns(torch, f"5c 4541-view re-solve, {name}", resolve, card,
                 ROUNDS["5c"])

    problems = chip_smoke.bench_windows(chip_smoke.N_WINDOWS)

    def windows():
        Q, w, it, _ = solve_windows(problems, m_pad=64, n_pad=16,
                                    device=dev)
        return [torch.from_numpy(np.concatenate(Q)), torch.from_numpy(it)]

    windows()                                            # warm-up
    med = in_turns(torch, f"5d {chip_smoke.N_WINDOWS} batched windows",
                   windows, card, ROUNDS["5d"])
    print(f"[turns] 5d windows/s: composed "
          f"{chip_smoke.N_WINDOWS / med['composed']:.1f}, fused "
          f"{chip_smoke.N_WINDOWS / med['fused']:.1f}  ({card})")

    n = chip_smoke.MAIN_WINDOW_VIEWS
    _, we, wq, wq0 = chip_smoke.kitti_chain(n)
    we, wq, wq0 = (torch.as_tensor(a, device=dev) for a in (we, wq, wq0))

    def window():
        return [torch.stack([_window_solve(
            we.long(), wq, wq0, 1, l1_iters=100, irls_iters=100,
            sigma=float(np.radians(5.0)), change_th=1e-3,
            cost="Geman-McClure")[0] for _ in range(20)])]

    window()                                             # warm-up
    in_turns(torch, f"main-path window solve ({n} views, L1-RA + IRLS, "
             f"dense; 20 solves)", window, card, ROUNDS["window"],
             "ms a solve", 1e3 / 20)


def events_a_call(torch, label, fns, card):
    """Part 3: the kernel launches (the runtime's launch calls, as the host
    makes them), the device's kernel events and the sorts of one call of
    each of ``fns``."""
    from torch.profiler import ProfilerActivity, profile

    cpu = torch.autograd.DeviceType.CPU
    for route, fn in fns.items():
        with _route("composed" if route == "composed" else "fused"):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        launches = sum(e.device_type == cpu and e.name.startswith(
            ("cudaLaunch", "cuLaunch")) for e in events)
        kernels = sum(e.device_type != cpu for e in events)
        sorts = sum(e.name == "aten::sort" for e in events)
        print(f"[events] {label}, {route}: {launches} kernel launches "
              f"({kernels} device events traced), {sorts} sorts a call  "
              f"({card})")


def events(torch, g, card):
    import chip_smoke
    from composed_laplacian import composed_dense, composed_matvec
    from irotavg_tpu_torch.ops import laplacian as lap
    from irotavg_tpu_torch.solver import graph

    dev = g.edges.device
    n = chip_smoke.MAIN_WINDOW_VIEWS
    we = torch.as_tensor(chip_smoke.kitti_chain(n)[1], device=dev).long()
    free = (torch.arange(n, device=dev) >= 1)[None]
    emask = torch.ones((1, len(we)), dtype=torch.bool, device=dev)
    coef = torch.rand((3, len(we)), dtype=torch.float64, device=dev)
    dplan = lap.dense_plan(we[None], free, emask, n, (3,))
    events_a_call(torch, f"dense assembly, {n}-view window, 3 L1-RA lanes", {
        "composed": lambda: composed_dense(we[None], coef, free, emask, n),
        "fused, plan built beforehand":
            lambda: lap.laplacian_assemble(coef, dplan),
        "fused, plan built in the call":
            lambda: graph.laplacian_dense(we[None], coef, free, emask, n)},
        card)
    x = torch.randn((g.n, 3), dtype=torch.float64, device=dev)
    c = torch.rand((g.m, 1), dtype=torch.float64, device=dev)
    free5b = g.free_mask()
    rplan = graph.rmatvec_plan(g.edges, g.n)
    mplan = lap.matvec_plan(g.edges, free5b, g.edge_mask, g.n)
    events_a_call(torch, "CG matvec, 5b", {
        "composed": lambda: composed_matvec(g.edges, c, x, free5b,
                                            g.edge_mask, g.n, rplan),
        "fused": lambda: lap.laplacian_matvec(x, c, mplan)}, card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3,
                    help="IRLS iterations profiled on each route")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("prof_cg50k: needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_name(torch)
    dev = torch.device("cuda", torch.cuda.current_device())
    _, g, cfg = chip_smoke.large_problem(dev)
    prof_cfg = dataclasses.replace(cfg, max_iters=args.iters, change_th=0.0)
    seen = {}
    for route in ("composed", "fused"):
        seen[route] = profile_route(route, g, prof_cfg, card)
        if seen[route] is None:
            return 1
    (kc, it), (kf, _) = seen["composed"], seen["fused"]
    print(f"[prof] kernel events per CG iteration: composed {kc / it:.2f}, "
          f"fused {kf / it:.2f}; the fused matvec is one launch, so the "
          f"composed matvec is {(kc - kf) / it + 1:.2f} launches")
    solves_in_turns(torch, g, cfg, card)
    events(torch, g, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

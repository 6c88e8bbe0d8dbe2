#!/usr/bin/env python3
"""torch.profiler trace of IRLS iterations of the 50k-view f64 CG solve
(``chip_smoke.large_problem``: bench.py:379-401's problem, the reference's
f64 CG configuration) on one CUDA card.

    python3 tools/prof_cg50k.py [--iters 3]

Prints the card, the host wall of the profiled iterations, the device
time by operator (``key_averages``, inclusive of the kernels each
launches), the shares of ``index_add_`` (the scatter-adds), the gathers
(``index``), ``cholesky``/``cholesky_solve`` and the rest, the kernel
count, and the device's idle share of the wall (1 - the summed self
device time of all operators over the wall; one stream, so kernels do not
overlap).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (("index_add_ (scatter-add)", ("aten::index_add_",)),
          ("gathers (aten::index)", ("aten::index",)),
          ("cholesky / cholesky_solve",
           ("aten::linalg_cholesky_ex", "aten::cholesky_solve")))


def _dev_us(e, self_only):
    name = "self_device_time_total" if self_only else "device_time_total"
    if not hasattr(e, name):           # older torch
        name = name.replace("device", "cuda")
    return getattr(e, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from irotavg_tpu_torch.solver.irls import irls

    if not torch.cuda.is_available():
        print("prof_cg50k: needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke._card(torch)
    dev = torch.device("cuda", torch.cuda.current_device())
    _, g, cfg = chip_smoke.large_problem(dev)
    irls(g, dataclasses.replace(cfg, max_iters=1))        # warm-up
    cfg = dataclasses.replace(cfg, max_iters=args.iters, change_th=0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        irls(g, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = prof.key_averages()
    n_kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                    for e in prof.events())
    busy_us = sum(_dev_us(e, True) for e in ops)
    if busy_us <= 0:
        print("prof_cg50k: the trace holds no device time", file=sys.stderr)
        return 1
    print(f"[prof] {card}; {args.iters} IRLS iterations of the 50k f64 CG "
          f"solve: wall {wall_us / 1e3:.3f} ms, {n_kernels} kernel events, "
          f"device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    by_name = {e.key: e for e in ops}
    for label, names in GROUPS:
        us = sum(_dev_us(by_name[n], False) for n in names if n in by_name)
        calls = sum(by_name[n].count for n in names if n in by_name)
        print(f"[prof] {label}: {us / 1e3:.3f} ms device, {calls} calls, "
              f"share of device time {us / busy_us:.4f}, of wall "
              f"{us / wall_us:.4f}")
    top = sorted((e for e in ops if e.key.startswith("aten::")),
                 key=lambda e: -_dev_us(e, True))[:15]
    print("[prof] aten operators by self device time (ms, calls):")
    for e in top:
        print(f"[prof]   {e.key:40s} {_dev_us(e, True) / 1e3:10.3f} "
              f"{e.count:8d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

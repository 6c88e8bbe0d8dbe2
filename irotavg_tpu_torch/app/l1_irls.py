"""Batch rotation-averaging CLI on PyTorch (port of
``irotavg_tpu/app/l1_irls.py``, the reference ``l1_irls`` binary,
ral/test.cpp:75-333).

    python -m irotavg_tpu_torch.app.l1_irls INPUT [OUTPUT] [COST] [SIGMA_DEG]
                                            [IRLS_ITERS] [L1_ITERS]
                                            [CHANGE_TH] [--device cuda|cpu]

defaults: OUTPUT=l1_irls_out.txt, COST=Geman-McClure, SIGMA_DEG=5,
IRLS_ITERS=50, L1_ITERS=5, CHANGE_TH=1e-3 (ral/test.cpp:250-271).
``--device`` is ``cuda`` by default; without a card the CLI exits 2
unless given ``--device cpu``.

Pipeline: parse problem -> (f==0: pin identity, f=1) -> init_mst seeded
with max(#abs_given, f) protected rows (ral/test.cpp:284-286) -> L1-RA ->
IRLS -> normalise -> write rotations then weights (ral/test.cpp:314-326).
The solve runs in f64 with the dense backend.
"""

from __future__ import annotations

import sys
import time

USAGE = ("usage: python -m irotavg_tpu_torch.app.l1_irls input_file "
         "[output_file] [cost] [sigma_deg] [irls_iters] [l1_iters] "
         "[change_th] [--device cuda|cpu]")


def _split_device(argv):
    """(positional arguments, device name) from ``argv``."""
    pos, device = [], "cuda"
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise ValueError("--device needs a value")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            pos.append(a)
    return pos, device


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        argv, device_name = _split_device(argv)
    except ValueError as e:
        print(f"{e}\n{USAGE}", file=sys.stderr)
        return 1
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1

    import dataclasses
    import math

    import torch

    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.device import SOLVER_DTYPE, pick_device
    from irotavg_tpu_torch.solver.graph import RotationGraph
    from irotavg_tpu_torch.solver.init import init_mst
    from irotavg_tpu_torch.solver.io import read_problem, write_solution
    from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig, irls
    from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra

    try:
        device = pick_device(device_name)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2

    input_file = argv[0]
    output_file = argv[1] if len(argv) > 1 else "l1_irls_out.txt"
    cost = Cost.parse(argv[2]) if len(argv) > 2 else Cost.GEMAN_MCCLURE
    sigma = float(argv[3]) * math.pi / 180.0 if len(argv) > 3 \
        else 5.0 * math.pi / 180.0
    irls_iters = int(argv[4]) if len(argv) > 4 else 50
    l1_iters = int(argv[5]) if len(argv) > 5 else 5
    change_th = float(argv[6]) if len(argv) > 6 else 1e-3

    print(f"input file: {input_file}")
    print(f"output file: {output_file}")
    print(f"cost: {cost.name}")
    print(f"sigma [deg]: {sigma * 180.0 / math.pi:g}")
    print(f"IRLS max. iterations: {irls_iters}")
    print(f"L1-RA max. iterations: {l1_iters}")
    print(f"change threshold: {change_th:g}")

    p = read_problem(input_file)
    edges, QQ, Q, f = p["edges"], p["QQ"], p["Q"], p["f"]
    n_abs = p["n_abs_given"]
    if f == 0:
        Q[0] = (0.0, 0.0, 0.0, 1.0)
        print("set first abs rot = I")
        f = 1
    print(f"# initial absolute rots {n_abs}")
    Q0 = init_mst(Q, QQ, edges, max(n_abs, f))

    g = RotationGraph.create(edges, QQ, Q0, f=f, dtype=SOLVER_DTYPE,
                             device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    Q1, l1_iters_out, _ = l1ra(
        g, L1RAConfig(max_iters=l1_iters, change_th=change_th))
    sync()
    l1_runtime = time.perf_counter() - t0

    t0 = time.perf_counter()
    Q2, weights, irls_iters_out, _ = irls(
        dataclasses.replace(g, Q=Q1),
        IRLSConfig(cost=cost, sigma=sigma, max_iters=irls_iters,
                   change_th=change_th))
    sync()
    irls_runtime = time.perf_counter() - t0

    Qf = so3.qnormalize(Q2).cpu().numpy()
    print(f"L1-RA iterations = {l1_iters_out}")
    print(f"IRLS  iterations = {irls_iters_out}")
    print(f"L1-RA runtime [s] = {l1_runtime:g}")
    print(f"IRLS  runtime [s] = {irls_runtime:g}")
    print(f"total runtime [s] = {l1_runtime + irls_runtime:g}")

    write_solution(output_file, Qf, weights.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())

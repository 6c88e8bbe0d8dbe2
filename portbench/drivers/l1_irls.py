"""Driver of the ``l1_irls`` batch solve.

A solve is ``app/l1_irls.py:main`` without its file I/O, timed from the
parsed problem in host memory to the rotations and weights on the host:
``init_mst`` -> ``RotationGraph.create`` -> ``l1ra`` -> ``irls`` ->
normalise, in the configuration's dtype on the dense backend.  The window
solves the traffic's relabellings of the problem in turn, back to back.

``check`` re-solves a sample of the window's solves, drawn from the seed
with the last among them, with the reference (``reference/rotavg.py``)
from the same problem: its spanning-tree start, L1-RA's rotations, and
IRLS's rotations and weights.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import os
import time

import numpy as np

from gen import relabel_problem
from gen.ring_orbit import seed_rng
from pbkit.trace import Tracer
from reference import rotavg

# what a NaN reading counts as: the largest finite f64, over any limit
BROKEN = float(np.finfo(np.float64).max)


@dataclasses.dataclass
class Run:
    cfg: dict
    traffic: dict
    device: object
    tracer: object
    problems: list
    dtype: object
    seed: int
    solved: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    undo: list = dataclasses.field(default_factory=list)
    outputs: list = None


def setup(ctx) -> Run:
    import torch

    cfg, s = ctx.config, ctx.config["solver"]
    if s["dtype"] != "float64" or s["backend"] != "dense":
        raise ValueError("the l1_irls CLI solves in f64 on the dense backend")
    prob = cfg["problem"]
    problems = relabel_problem.generate(
        ctx.traffic, os.path.join(ctx.root, prob["file"]), prob["sha256"],
        ctx.seed)
    run = Run(cfg=cfg, traffic=ctx.traffic, device=ctx.device,
              tracer=ctx.tracer, problems=problems, seed=ctx.seed,
              dtype=torch.float32 if ctx.control else torch.float64)
    for k in range(ctx.traffic["warmup_solves"]):
        _solve(run, problems[k % len(problems)], Tracer(False, run.device))
    return run


def _solve(run: Run, p, tr):
    """One solve as the CLI runs it; returns what the check compares."""
    import torch

    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.solver.graph import RotationGraph

    # the package exports the functions irls and l1ra under the modules'
    # names, so the modules come from importlib
    init_mod, irls_mod, l1ra_mod = (
        importlib.import_module(f"irotavg_tpu_torch.solver.{m}")
        for m in ("init", "irls", "l1ra"))

    s = run.cfg["solver"]
    f = p.f
    with tr.span("init"):
        Q0 = init_mod.init_mst(p.Q, p.QQ, p.edges, max(p.n_abs, f))
    with tr.span("graph"):
        g = RotationGraph.create(p.edges, p.QQ, Q0, f=f, dtype=run.dtype,
                                 device=run.device)
    with tr.span("l1ra"):
        Q1, _, _ = l1ra_mod.l1ra(g, l1ra_mod.L1RAConfig(
            max_iters=s["l1_iters"], change_th=s["change_th"]))
    with tr.span("irls"):
        Q2, w, _, _ = irls_mod.irls(
            dataclasses.replace(g, Q=Q1), irls_mod.IRLSConfig(
                cost=irls_mod.Cost.parse(s["cost"]),
                sigma=math.radians(s["sigma_deg"]),
                max_iters=s["irls_iters"], change_th=s["change_th"]))
    with tr.span("normalise"):
        Qf = so3.qnormalize(Q2).cpu().numpy()
        wf = w.cpu().numpy()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    return Q0, Q1, Qf, wf


def window(run: Run, seconds: float) -> dict:
    t0 = time.perf_counter()
    t_end = t0
    k = 0
    while True:
        p = run.problems[k % len(run.problems)]
        run.attempted += 1
        with run.tracer.span("solve"):
            Q0, Q1, Qf, wf = _solve(run, p, run.tracer)
        run.solved.append((k % len(run.problems), Q0, Q1, Qf, wf))
        k += 1
        t_end = time.perf_counter()
        if t_end - t0 >= seconds:
            break
    run.window_s = t_end - t0
    return {"attempted": run.attempted, "failed": run.failed,
            "metrics": {"solve_ms": 1e3 * run.window_s / k},
            "units": {"solves": k}, "window_s": run.window_s}


def collect(run: Run) -> None:
    """The sample's answers on the host; the rest is let go."""
    n = len(run.solved)
    pick = sorted(set(seed_rng(run.seed + 1).choice(
        n, size=min(n, run.traffic["check_solves"] - 1), replace=False)
        .tolist()) | {n - 1})
    run.outputs = [(run.solved[i][0], run.solved[i][1],
                    run.solved[i][2].cpu().numpy().astype(np.float64),
                    run.solved[i][3], run.solved[i][4]) for i in pick]
    run.solved = []
    release(run)


def release(run: Run) -> None:
    for mod, attr, old in reversed(run.undo):
        setattr(mod, attr, old)
    run.undo.clear()


def check(run: Run) -> dict:
    s = run.cfg["solver"]
    sigma = math.radians(s["sigma_deg"])
    init_gap = l1_gap = irls_gap = w_gap = 0.0
    for k, Q0, Q1, Qf, wf in run.outputs:
        p = run.problems[k]
        R0 = rotavg.init_mst(p.Q, p.QQ, p.edges, max(p.n_abs, p.f))
        R1, Rf, rw = rotavg.solve(p.QQ, p.edges, R0, p.f, sigma=sigma,
                                  l1_iters=s["l1_iters"],
                                  irls_iters=s["irls_iters"],
                                  change_th=s["change_th"])
        # a NaN (a solve that broke down on either side) reads as a failure
        init_gap = max(init_gap, _worst(np.abs(Q0 - R0)))
        l1_gap = max(l1_gap, _worst(rotavg.geodesic_deg(Q1, R1)))
        irls_gap = max(irls_gap, _worst(rotavg.geodesic_deg(Qf, Rf)))
        w_gap = max(w_gap, _worst(np.abs(wf - rw) * sigma ** 2))
    return {"init_gap": init_gap, "l1ra_gap_deg": l1_gap,
            "irls_gap_deg": irls_gap, "weight_gap": w_gap}


def _worst(x) -> float:
    return float(np.nan_to_num(np.asarray(x), nan=BROKEN).max())


def plant(run: Run, fault: str) -> None:
    irls_mod = importlib.import_module("irotavg_tpu_torch.solver.irls")

    old = irls_mod.irls
    if fault == "state_unchanged":
        def irls(g, cfg, weights=None):
            import torch

            return g.Q, torch.ones(g.edges.shape[:-1], dtype=g.dtype,
                                   device=g.Q.device), 0, math.inf
    elif fault == "answer_altered":
        def irls(g, cfg, weights=None):
            Q, w, it, score = old(g, cfg, weights)
            return Q, w * 1.01, it, score
    else:
        raise ValueError(f"no fault {fault!r} for this driver")
    irls_mod.irls = irls
    run.undo.append((irls_mod, "irls", old))


FAULTS = ("state_unchanged", "answer_altered")

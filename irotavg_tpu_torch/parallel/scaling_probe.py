"""World-size scaling probe for the edge-sharded distributed solver.

Port of ``irotavg_tpu/parallel/scaling_probe.py``.  Runs the SAME
fixed-work distributed IRLS solve (fixed outer iterations, fixed CG
budget: ``change_th = 0``, ``cg_tol = 0``) on the same generator (seed 11)
over several world sizes, one process per rank, and reports the wall time
per world size.

* On the card (``--device cuda``, NCCL) each rank has its own GPU, so at
  most ``torch.cuda.device_count()`` ranks run; falling ``t_D`` is the
  scaling claim itself.
* On the CPU (``--device cpu``, gloo) the ranks are processes that
  timeshare the host's cores, so wall time cannot drop with D: ``t_D /
  t_1`` measures what the sharding adds (collectives, per-rank launch
  and bookkeeping), and the replicated node work is timed and its share
  predicted as in the reference.

    python -m irotavg_tpu_torch.parallel.scaling_probe [--device cuda|cpu] \\
        [--n 50000 --extra-edges 200000 | --sizes 2000:6000,4000:12000] \\
        [--devices 1,2,4,8] [--outer-iters 6] [--cg-iters 40] [--reps 3]

Prints one JSON object to stdout.  Exits 2 without a card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--extra-edges", type=int, default=200_000)
    ap.add_argument("--sizes", default=None,
                    help="comma list of n:extra_edges pairs; overrides "
                         "--n/--extra-edges and reports one block per size "
                         "(small vs large separates collective overhead "
                         "from CG work)")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--outer-iters", type=int, default=6)
    ap.add_argument("--cg-iters", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling_probe: no CUDA card (torch.cuda.is_available() is "
              "False); pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    counts = [int(d) for d in args.devices.split(",")]
    if args.device == "cuda":
        counts = [d for d in counts if d <= torch.cuda.device_count()]
    sizes = ([tuple(int(v) for v in s.split(":"))
              for s in args.sizes.split(",")] if args.sizes
             else [(args.n, args.extra_edges)])
    on_cpu = args.device == "cpu"
    out = {
        "platform": args.device,
        "physical_cores_note": (
            "CPU ranks are processes that timeshare host cores; see module "
            "doc" if on_cpu else ""),
        "outer_iters": args.outer_iters,
        "cg_iters_per_outer": args.cg_iters,
        "reps": args.reps,
        "by_size": _probe(sizes, counts, args),
    }
    if len(sizes) == 1:          # the reference's flat layout, kept
        out.update(next(iter(out["by_size"].values())))
    json.dump(out, sys.stdout)
    print()
    return 0


def make_problem(n, m_extra):
    """The reference probe's synthetic problem (seed 11): a chain plus
    ``m_extra`` chords of span 2-49, 3 deg noise, a 3 deg-perturbed warm
    start with node 0 at its true rotation.  Returns (edges, QQ, Q0)."""
    from scipy.spatial.transform import Rotation as Rsc

    rng = np.random.default_rng(11)
    R_gt = Rsc.from_rotvec(rng.normal(scale=0.5, size=(n, 3)))
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    ii = rng.integers(0, n - 3, m_extra)
    jj = np.minimum(ii + rng.integers(2, 50, m_extra), n - 1)
    edges = np.concatenate([chain, np.stack([ii, jj], 1)]).astype(np.int64)
    Rrel = R_gt[edges[:, 1]] * R_gt[edges[:, 0]].inv()
    noise = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0),
                                       size=(len(edges), 3)))
    QQ = (noise * Rrel).as_quat()
    pert = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0), size=(n, 3)))
    Q0 = (pert * R_gt).as_quat()
    Q0[0] = R_gt[0].as_quat()
    return edges, QQ, Q0


def _m_pad(n, m_extra, counts):
    """The edge count padded to a multiple of the largest world size."""
    lcm = max(counts)
    return -(-((n - 1) + m_extra) // lcm) * lcm


def _rank_main(rank, world, store, device, sizes, counts, outer, cg, reps,
               result_q):
    """One rank of one world size: for each problem size the fixed-work
    solve, a warm-up then ``reps`` timed runs between barriers; rank 0
    reports ``{size: (times, iters)}``."""
    import torch
    import torch.distributed as dist

    from irotavg_tpu_torch.parallel.sharded import (
        init_multihost, make_graph_mesh, shard_graph, sharded_irls,
    )
    from irotavg_tpu_torch.solver.graph import RotationGraph
    from irotavg_tpu_torch.solver.irls import IRLSConfig

    try:
        if device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_multihost(init_method=f"file://{store}", num_processes=world,
                       process_id=rank, device=device)
        mesh = make_graph_mesh(world, device=device)
        cfg = IRLSConfig(max_iters=outer, change_th=0.0, backend="cg",
                         cg_tol=0.0, cg_maxiter=cg)
        solve = sharded_irls(mesh, cfg)
        out = {}
        for n, m_extra in sizes:
            edges, QQ, Q0 = make_problem(n, m_extra)
            g = RotationGraph.create(edges, QQ, Q0, f=1, dtype=torch.float32
                                     ).pad_to(_m_pad(n, m_extra, counts), n)
            gs = shard_graph(g, mesh)

            def timed():
                dist.barrier()
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                t0 = time.perf_counter()
                _, _, iters, _ = solve(gs)
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                dist.barrier()
                return time.perf_counter() - t0, iters

            timed()                              # warm-up
            runs = [timed() for _ in range(reps)]
            out[(n, m_extra)] = ([t for t, _ in runs], runs[-1][1])
        if rank == 0:
            result_q.put(("ok", out))
        dist.destroy_process_group()
    except BaseException as e:                   # reported, then re-raised
        result_q.put(("error", f"rank {rank}: {type(e).__name__}: {e}"))
        raise


def _probe(sizes, counts, args):
    """One process group per world size runs every problem size; returns
    one fixed-work scaling curve per size."""
    from irotavg_tpu_torch.parallel.sharded import run_ranks

    per_world = {d: run_ranks(_rank_main, d, (
        args.device, sizes, counts, args.outer_iters, args.cg_iters,
        args.reps))[0] for d in counts}
    return {f"{n // 1000}k": _curve(n, m_extra, counts, {
        d: per_world[d][(n, m_extra)] for d in counts}, args)
        for n, m_extra in sizes}


def _curve(n, m_extra, counts, runs, args):
    """The reference's per-size block from ``{world: (times, iters)}``."""
    results = {d: {"solve_s": round(float(np.median(t)), 3),
                   "solve_s_min": round(float(np.min(t)), 3),
                   "iters": int(it)} for d, (t, it) in runs.items()}
    t1 = results[counts[0]]["solve_s"]
    t1_min = results[counts[0]]["solve_s_min"]
    on_cpu = args.device == "cpu"
    for d in counts:
        td = results[d]["solve_s"]
        results[d]["speedup_vs_1dev"] = round(t1 / td, 3)
        results[d]["parallel_efficiency"] = round(t1 / (d * td), 3)
        if on_cpu:
            # constant-work ratio: ~1.0 means the distributed program adds
            # no overhead over the 1-rank run (see the module doc)
            results[d]["work_conservation"] = round(
                t1_min / results[d]["solve_s_min"], 3)
    out = {"n_views": n, "n_edges": (n - 1) + m_extra,
           "by_devices": {str(k): v for k, v in results.items()}}
    if on_cpu:
        # every rank repeats the replicated (n, 3) CG vector work; with C
        # cores, D ranks duplicate it (D - 1) extra times, which predicts
        # the largest world size's conservation (the reference's model)
        total_cg = args.outer_iters * (args.cg_iters + 2)
        node_s = _replicated_node_work_s(n, total_cg)
        cores = os.cpu_count() or 1
        D = counts[-1]
        out["replicated_node_cg_s"] = round(node_s, 3)
        out["host_cores"] = cores
        out["wc_predicted_from_replication"] = {
            str(D): round(t1_min / (t1_min + (D - 1) * node_s / cores), 3)}
    return out


def _replicated_node_work_s(n, iters):
    """One process's wall time of ``iters`` CG iterations' replicated
    ``(n, 3)`` vector operations on the CPU — the work every rank
    duplicates in the sharded solve."""
    import torch

    x = r = p = torch.ones((n, 3), dtype=torch.float32)
    dinv = torch.ones((n, 1), dtype=torch.float32)

    def run():
        x_, r_, p_ = x, r, p
        for _ in range(iters):
            alpha = (p_ * r_).sum() / ((p_ * p_).sum() + 1.0)
            x_ = x_ + alpha * p_
            r_ = r_ - alpha * p_
            z = dinv * r_
            beta = (r_ * z).sum() / ((p_ * r_).sum() + 1.0)
            p_ = z + beta * p_
        return x_

    run()
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())

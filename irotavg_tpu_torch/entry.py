"""The flagship step on PyTorch: one robust IRLS rotation-averaging
iteration on a padded view graph, the twin of the JAX package's
``__graft_entry__.entry()``, and the distributed dry run, the twin of its
``dryrun_multichip``.

``entry(device=None)`` returns ``(fn, args)``; ``fn(*args)`` is
``solver.irls.irls_step`` (dense backend, f32) on a small deterministic
chain-plus-chords problem.  ``dryrun_multichip(n, device=None)`` runs the
distributed solver over ``n`` ranks on that problem.  The device is the
card unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np


def _tiny_problem(n_nodes=24, m_pad=64, dtype=np.float32):
    """Small deterministic chain+chords SO(3) problem: padded ``edges``,
    ``QQ``, the warm start ``Q0`` (node 0 at its true rotation, the rest
    identity) and ``edge_mask`` (a numpy copy of
    ``__graft_entry__._tiny_problem``)."""
    rng = np.random.default_rng(0)

    def qmul(a, b):
        x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ], axis=-1)

    v = rng.normal(size=(n_nodes, 4))
    Q_gt = v / np.linalg.norm(v, axis=1, keepdims=True)
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    edges += [(i, i + 3) for i in range(n_nodes - 3)]
    edges = np.array(edges, np.int32)
    qi = Q_gt[edges[:, 0]].copy()
    qi[:, :3] *= -1  # conj
    QQ = qmul(Q_gt[edges[:, 1]], qi)
    Q0 = np.zeros((n_nodes, 4))
    Q0[:, 3] = 1.0
    Q0[0] = Q_gt[0]
    m = len(edges)
    edge_mask = np.zeros(m_pad, bool)
    edge_mask[:m] = True
    edges_p = np.zeros((m_pad, 2), np.int32)
    edges_p[:m] = edges
    QQ_p = np.zeros((m_pad, 4), dtype)
    QQ_p[:, 3] = 1.0
    QQ_p[:m] = QQ
    return edges_p, QQ_p, Q0.astype(dtype), edge_mask


def entry(device=None):
    """(fn, example_args) — one IRLS step: ``fn(g, weights)`` returns
    ``(new_Q, new_weights, score)``."""
    import torch

    from irotavg_tpu_torch.device import pick_device
    from irotavg_tpu_torch.solver.graph import RotationGraph
    from irotavg_tpu_torch.solver.irls import IRLSConfig, irls_step

    dev = pick_device(device)
    edges, QQ, Q0, edge_mask = _tiny_problem()
    g = RotationGraph.create(edges, QQ, Q0, f=1, edge_mask=edge_mask,
                             device=dev)
    weights = torch.ones(g.m, dtype=g.dtype, device=dev)
    cfg = IRLSConfig(backend="dense")

    def fn(g, weights):
        return irls_step(g, weights, cfg)

    return fn, (g, weights)


# the sharded pipeline against the single-device schedule, both f64: the
# two differ only in the summation order of the reduction
DRYRUN_TOL_DEG = 1e-6


def _dryrun_rank(rank, world, store, device, result_q):
    """One rank of :func:`dryrun_multichip`; rank 0 reports."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.parallel import (
        init_multihost, make_graph_mesh, shard_graph, sharded_irls_step,
        sharded_ravg_pipeline,
    )
    from irotavg_tpu_torch.solver.graph import RotationGraph
    from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig, irls

    try:
        init_multihost(init_method=f"file://{store}", num_processes=world,
                       process_id=rank, device=device)
        mesh = make_graph_mesh(world, device=device)
        m_pad = world * -(-64 // world)          # >= 64 and divisible
        edges, QQ, Q0, edge_mask = _tiny_problem(m_pad=m_pad,
                                                 dtype=np.float64)
        g = RotationGraph.create(edges, QQ, Q0, f=1, edge_mask=edge_mask,
                                 device=mesh.device)
        gs = shard_graph(g, mesh)
        step = sharded_irls_step(mesh, IRLSConfig(backend="cg",
                                                  cg_maxiter=100))
        Q, w, score = step(gs, torch.ones(g.m, dtype=g.dtype,
                                          device=mesh.device))
        if not (torch.isfinite(score) and torch.isfinite(Q).all()
                and w.shape == (g.m,)):
            raise RuntimeError("non-finite sharded step")
        # the whole pipeline (L1 warmup, then the robust cost), long
        # enough that both phases iterate on this problem
        cfg = IRLSConfig(backend="cg", cg_maxiter=200, max_iters=10,
                         change_th=1e-5)
        Q2, _, iters, _ = sharded_ravg_pipeline(mesh, l1_iters=3,
                                                cfg=cfg)(gs)
        if not torch.isfinite(Q2).all() or iters < 3:
            raise RuntimeError(f"pipeline barely iterated ({iters})")
        # the single-device two-phase schedule on the whole graph
        Q1s, _, it1, _ = irls(g, dataclasses.replace(cfg, cost=Cost.L1,
                                                     max_iters=3))
        Qs, _, it2, _ = irls(dataclasses.replace(g, Q=Q1s), cfg)
        geo = so3.qgeodesic(Q2, so3.qnormalize(Qs))
        geo_deg = float(torch.rad2deg(geo).max())
        if rank == 0:
            result_q.put(("ok", geo_deg, iters, it1 + it2))
        dist.destroy_process_group()
    except BaseException as e:                   # reported, then re-raised
        result_q.put(("error", f"rank {rank}: {type(e).__name__}: {e}"))
        raise


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded IRLS step and the whole sharded pipeline over
    ``n_devices`` ranks (spawned processes joined through a ``file://``
    store; NCCL on the card, gloo with ``device="cpu"``), held to the
    single-device two-phase schedule on the same problem.  Returns
    ``{"max_geodesic_deg", "iters", "single_iters"}``; raises on a
    mismatch."""
    from irotavg_tpu_torch.device import pick_device
    from irotavg_tpu_torch.parallel.sharded import run_ranks

    dev = pick_device(device)
    if dev.type == "cuda":
        import torch

        if n_devices > torch.cuda.device_count():
            raise ValueError(f"need {n_devices} cards, have "
                             f"{torch.cuda.device_count()}")
    geo, iters, single = run_ranks(_dryrun_rank, n_devices, (dev.type,))
    if iters != single or not geo < DRYRUN_TOL_DEG:
        raise RuntimeError(f"sharded vs single-device mismatch: iterations "
                           f"{iters} / {single}, max {geo} deg")
    return {"max_geodesic_deg": geo, "iters": iters, "single_iters": single}

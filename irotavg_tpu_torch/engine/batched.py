"""Batched window solver — many independent rotAvg windows per call
(port of ``irotavg_tpu/engine/batched.py``).

The incremental product shape is thousands of small solves: every
accepted keyframe triggers ``rotAvg(10)`` (src/IRotAvg.cpp:371-378), a
~16-node / ~40-edge problem, far too small to occupy a card alone.  A
batch of windows from independent sequences (the multi-camera / fleet
serving shape) runs as one set of tensors: each L1 Newton step is one
batched ``(W, 3, n_pad, n_pad)`` Cholesky over W windows and 3 axes, each
IRLS step one ``(W, n_pad, n_pad)`` Cholesky with a per-window singularity
rescue, and every elementwise stage a ``(W, m_pad, ...)`` tensor.

Windows inside one sequence depend on each other (each warm-starts from
the previous write-back, src/ViewGraph.cpp:1396-1397), so the batch axis
runs across independent sequences, not across time.  Each window stops at
its own convergence and keeps its own iteration count: a stopped window
is frozen, as under the reference's ``vmap`` of ``lax.while_loop``; the
host reads the stopping tests once per outer iteration for all windows.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.device import pick_device
from irotavg_tpu_torch.solver.graph import RotationGraph
from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig, irls
from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra


def batched_window_solver(m_pad: int, n_pad: int, l1_iters: int = 100,
                          irls_iters: int = 100,
                          sigma: float = float(5.0 * math.pi / 180.0),
                          change_th: float = 1e-3,
                          cost_name: str = "Geman-McClure",
                          dtype_name: str = "float64"):
    """L1-RA + IRLS over a batch of windows padded to one bucket.

    Returns ``solve(edges (W,m,2), QQ (W,m,4), Q (W,n,4), f (W,),
    edge_mask (W,m), node_mask (W,n)) -> (Q (W,n,4), w (W,m), iters (W,),
    score (W,))`` — the contract of the incremental engine's window solve
    with a leading window axis.  The solve runs on the device of its
    arguments (tensors; numpy arrays go to the CPU) in ``dtype_name``.
    """
    l1_cfg = L1RAConfig(max_iters=l1_iters, change_th=change_th)
    irls_cfg = IRLSConfig(cost=Cost.parse(cost_name), sigma=sigma,
                          max_iters=irls_iters, change_th=change_th,
                          backend="dense")
    dtype = getattr(torch, dtype_name)

    def solve(edges, QQ, Q, f, edge_mask, node_mask):
        g = RotationGraph.create(edges, QQ, Q, f=f, edge_mask=edge_mask,
                                 node_mask=node_mask, dtype=dtype)
        if (g.m, g.n) != (m_pad, n_pad) or g.Q.dim() != 3:
            raise ValueError(f"expected (W, {m_pad}) edges and (W, {n_pad}) "
                             f"nodes, got {tuple(g.edges.shape)} and "
                             f"{tuple(g.Q.shape)}")
        Q1, _, _ = l1ra(g, l1_cfg)
        Q2, w, iters, score = irls(dataclasses.replace(g, Q=Q1), irls_cfg)
        return so3.qnormalize(Q2), w, iters, score

    return solve


def pack_windows(problems, m_pad: int | None = None, n_pad: int | None = None,
                 dtype=np.float64):
    """Stack a list of ``(edges, QQ, Q0, f)`` problems into padded batch
    arrays for :func:`batched_window_solver`.

    Padded edges point at node 0 with identity relative rotation and are
    masked out; padded nodes are identity quaternions outside
    ``node_mask`` (the padding contract of the reference's
    ``RotationGraph.pad_to``).
    """
    W = len(problems)
    if m_pad is None:
        m_pad = max(len(e) for e, _, _, _ in problems)
    if n_pad is None:
        n_pad = max(len(q) for _, _, q, _ in problems)
    edges = np.zeros((W, m_pad, 2), np.int32)
    QQ = np.zeros((W, m_pad, 4), dtype)
    QQ[..., 3] = 1.0
    Q = np.zeros((W, n_pad, 4), dtype)
    Q[..., 3] = 1.0
    f = np.zeros((W,), np.int32)
    emask = np.zeros((W, m_pad), bool)
    nmask = np.zeros((W, n_pad), bool)
    for k, (e, qq, q0, fk) in enumerate(problems):
        m, n = len(e), len(q0)
        if m > m_pad or n > n_pad:
            raise ValueError(f"window {k} ({m}, {n}) exceeds padding "
                             f"({m_pad}, {n_pad})")
        edges[k, :m] = e
        QQ[k, :m] = qq
        Q[k, :n] = q0
        f[k] = fk
        emask[k, :m] = True
        nmask[k, :n] = True
    return edges, QQ, Q, f, emask, nmask


def solve_windows(problems, *, l1_iters: int = 100, irls_iters: int = 100,
                  sigma: float = float(5.0 * math.pi / 180.0),
                  change_th: float = 1e-3, cost: str = "Geman-McClure",
                  dtype=np.float64, m_pad: int | None = None,
                  n_pad: int | None = None, device=None):
    """Solve a list of independent ``(edges, QQ, Q0, f)`` windows in one
    batched call on ``device`` (the card unless ``device="cpu"``).
    Returns ``(Q_list, w_list, iters (W,), score (W,))`` as numpy arrays,
    each window trimmed back to its true size."""
    dev = pick_device(device)
    packed = pack_windows(problems, m_pad, n_pad, dtype)
    solve = batched_window_solver(
        packed[0].shape[1], packed[2].shape[1], l1_iters, irls_iters,
        float(sigma), float(change_th), cost, np.dtype(dtype).name)
    Qf, w, iters, score = (t.cpu().numpy() for t in solve(
        *(torch.as_tensor(a, device=dev) for a in packed)))
    Q_list = [Qf[k, :len(q0)] for k, (_, _, q0, _) in enumerate(problems)]
    w_list = [w[k, :len(e)] for k, (e, _, _, _) in enumerate(problems)]
    return Q_list, w_list, iters, score

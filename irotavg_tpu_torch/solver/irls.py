"""IRLS robust rotation averaging (port of ``irotavg_tpu/solver/irls.py``).

Per iteration: per-edge residual -> tangent space; weighted least squares
for the three tangent axes at once on the masked graph Laplacian (dense
Cholesky, or matrix-free Jacobi-CG with ``backend="cg"``); robust
re-weighting with one of the 14 costs (the clamps of
ral/l1_irls.cpp:617-727); right-multiplied retraction; stop when the mean
free-node update norm is <= ``change_th``.  The ``lax.while_loop`` of the
reference is a Python loop that reads the stopping test back each
iteration.  Under a profiler session :func:`irls` runs inside a program
span ``solver.irls`` (attribute ``iters``: the loop's steps;
``utils/timing.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.solver.graph import (
    RotationGraph, graph_plans, incidence_matvec, incidence_rmatvec,
    laplacian_cg_solve, laplacian_cho_solve,
)
from irotavg_tpu_torch.utils.timing import span


class Cost(enum.Enum):
    """Robust IRLS costs (ral/l1_irls.hpp:56-57)."""

    L2 = "L2"
    L1 = "L1"
    L15 = "L1.5"
    L05 = "L0.5"
    GEMAN_MCCLURE = "Geman-McClure"
    HUBER = "Huber"
    PSEUDO_HUBER = "Pseudo-Huber"
    ANDREWS = "Andrews"
    BISQUARE = "Bisquare"
    CAUCHY = "Cauchy"
    FAIR = "Fair"
    LOGISTIC = "Logistic"
    TALWAR = "Talwar"
    WELSCH = "Welsch"

    @staticmethod
    def parse(name: str) -> "Cost":
        for c in Cost:
            if c.value.lower() == name.lower():
                return c
        raise ValueError(f"Unknown cost: {name!r}")


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def update_weights(cost: Cost, E, prev_weights, sigma):
    """Robust weights from residual rows ``E (m, 3)``, with the reference's
    exact clamps (Huber keeps previous weights where ``e < 1``; Andrews is
    floored at 1e-4 after the ``e >= pi`` zeroing; Talwar is 1.0001 / 0)."""
    e2 = torch.sum(E * E, dim=-1)
    en = torch.sqrt(e2)
    one = torch.ones_like(e2)
    zero = torch.zeros_like(e2)

    if cost is Cost.L2:
        return prev_weights
    if cost is Cost.L05:
        w = torch.pow(torch.clamp(e2, min=1e-300), -3.0 / 8.0)
        return torch.clamp(w, max=1e4)
    if cost is Cost.L1:
        w = 1.0 / torch.sqrt(torch.clamp(en, min=1e-300))
        return torch.clamp(w, max=1e4)
    if cost is Cost.L15:
        w = 1.0 / torch.sqrt(torch.sqrt(torch.clamp(en, min=1e-300)))
        return torch.clamp(w, max=1e4)
    if cost is Cost.GEMAN_MCCLURE:
        return 1.0 / (e2 + sigma * sigma)
    if cost is Cost.HUBER:
        e = en / (1.345 * sigma)
        return torch.where(e >= 1, torch.sqrt(_safe_div(one, e)),
                           prev_weights)
    if cost is Cost.PSEUDO_HUBER:
        return 1.0 / torch.sqrt(torch.sqrt(1.0 + e2 / (sigma * sigma)))
    if cost is Cost.ANDREWS:
        e = en / (1.339 * sigma)
        ratio = _safe_div(torch.sin(torch.clamp(e, max=math.pi)), e)
        w = torch.sqrt(torch.clamp(ratio, min=0.0))
        w = torch.where(e >= math.pi, zero, w)
        w = torch.where(e < 1e-4, one, w)
        return torch.clamp(w, min=1e-4)
    if cost is Cost.BISQUARE:
        t = 4.685 * sigma
        return torch.clamp(1.0 - e2 / (t * t), min=1e-4)
    if cost is Cost.CAUCHY:
        t = 2.385 * sigma
        return 1.0 / torch.sqrt(1.0 + e2 / (t * t))
    if cost is Cost.FAIR:
        return 1.0 / torch.sqrt(1.0 + en / (1.400 * sigma))
    if cost is Cost.LOGISTIC:
        e = en / (1.205 * sigma)
        w = torch.sqrt(torch.clamp(_safe_div(torch.tanh(e), e), min=0.0))
        return torch.where(e < 1e-4, one, w)
    if cost is Cost.TALWAR:
        t = 2.795 * sigma
        return torch.where(e2 < t * t, torch.full_like(e2, 1.0001), zero)
    if cost is Cost.WELSCH:
        t = 2.985 * sigma
        return torch.clamp(torch.exp(-0.5 * e2 / (t * t)), min=1e-4)
    raise ValueError(f"Unknown cost {cost}")


@dataclasses.dataclass(frozen=True)
class IRLSConfig:
    cost: Cost = Cost.GEMAN_MCCLURE
    sigma: float = 5.0 * math.pi / 180.0  # radians (reference default 5 deg)
    max_iters: int = 50
    change_th: float = 1e-3
    backend: str = "dense"  # "dense" (Cholesky) or "cg" (matrix-free)
    ridge: float = 0.0
    cg_tol: float = 1e-10
    cg_maxiter: int = 1000


def _solve_wls(g: RotationGraph, coef, rhs, cfg: IRLSConfig, plan):
    """Solve ``(A' diag(coef) A) X = rhs`` over free nodes; X=0 on fixed.
    ``plan``: the graph's :func:`graph_plans` for ``cfg.backend``."""
    free = g.free_mask()
    if cfg.backend == "dense":
        X = laplacian_cho_solve(g.edges, coef, rhs, free, g.edge_mask, g.n,
                                ridge=cfg.ridge, plan=plan.dense)
        return torch.where(free[..., None], X, torch.zeros_like(X))
    if cfg.backend == "cg":
        X, _ = laplacian_cg_solve(g.edges, coef, rhs, free, g.edge_mask,
                                  tol=cfg.cg_tol, maxiter=cfg.cg_maxiter,
                                  plan=plan)
        return X
    raise ValueError(f"Unknown backend {cfg.backend!r}")


def free_mean(X, free):
    """Mean row norm of ``X (*B, n, 3)`` over the free nodes (per batch
    entry): the outer loops' update score."""
    norms = torch.linalg.vector_norm(X, dim=-1)
    n_free = free.sum(-1).clamp(min=1)
    return torch.where(free, norms, torch.zeros_like(norms)).sum(-1) / n_free


def _plans(g: RotationGraph, backend, lanes=None):
    """The graph's :func:`graph_plans` for ``backend``."""
    return graph_plans(g.edges, g.free_mask(), g.edge_mask, g.n, backend,
                       lanes)


def irls_step(g: RotationGraph, weights, cfg: IRLSConfig, plan=None):
    """One IRLS iteration. Returns (new_Q, new_weights, score tensor).
    ``plan``: :func:`graph_plans` of ``g`` for ``cfg.backend`` (built here
    when not given; :func:`irls` builds it once for all its steps)."""
    free = g.free_mask()
    if plan is None:
        plan = _plans(g, cfg.backend)
    w3 = so3.log_map(so3.delta_rel(g.edges, g.QQ, g.Q))[..., :3]
    w3 = torch.where(g.edge_mask[..., None], w3, torch.zeros_like(w3))

    wsq = weights * weights
    coef = torch.where(g.edge_mask, wsq, torch.zeros_like(wsq))
    rhs = incidence_rmatvec(g.edges, wsq[..., None] * w3, free, g.edge_mask,
                            g.n, plan.rmatvec)
    X = _solve_wls(g, coef, rhs, cfg, plan)

    E = incidence_matvec(g.edges, X, free, g.edge_mask) - w3
    new_weights = update_weights(cfg.cost, E, weights, cfg.sigma)
    new_Q = so3.qmul(g.Q, so3.exp_map(X))
    return new_Q, new_weights, free_mean(X, free)


def irls(g: RotationGraph, cfg: IRLSConfig = IRLSConfig(), weights=None):
    """Run IRLS to convergence. Returns (Q, weights, iters, score).

    Weights start at ones (ral/l1_irls.cpp:577); the loop runs while the
    mean free-node update norm is > ``change_th`` and ``iters <
    max_iters``.  A batch of windows (leading dims on ``g``) runs until its
    last window stops; a stopped window is frozen and keeps its own count,
    as under the reference's ``vmap``, and ``iters``/``score`` are then
    tensors.  The host reads the stopping test once per iteration.
    """
    batch = g.edges.shape[:-2]
    dev = g.Q.device
    if weights is None:
        weights = torch.ones(g.edges.shape[:-1], dtype=g.dtype, device=dev)
    Q = g.Q
    score = torch.full(batch, math.inf, dtype=g.dtype, device=dev)
    it = torch.zeros(batch, dtype=torch.int64, device=dev)
    active = (score > cfg.change_th) & (it < cfg.max_iters)
    with span("solver.irls") as sp:
        plan = _plans(g, cfg.backend)
        steps = 0
        while bool(active.any()):
            Q2, w2, s2 = irls_step(dataclasses.replace(g, Q=Q), weights, cfg,
                                   plan)
            Q = torch.where(active[..., None, None], Q2, Q)
            weights = torch.where(active[..., None], w2, weights)
            score = torch.where(active, s2, score)
            it = it + active
            active = (score > cfg.change_th) & (it < cfg.max_iters)
            steps += 1
        sp.set(iters=steps)
    if batch:
        return Q, weights, it, score
    return Q, weights, int(it), float(score)

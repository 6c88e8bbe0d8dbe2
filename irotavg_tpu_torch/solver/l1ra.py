"""L1 rotation averaging (port of ``irotavg_tpu/solver/l1ra.py``).

Outer loop: residual -> log map -> three independent scalar problems
``min ||A x - y||_1`` (one per tangent axis, ral/l1_irls.cpp:890-892) ->
exp map -> right-multiplied update.  The inner decoder is the l1-magic
primal-dual interior-point method (``l1decode_pd``, ral/l1_irls.cpp:
228-468).  The reference runs the three axes as one ``vmap`` of a
``lax.while_loop``; here the three axes (of every window, in a batch) are
lanes of one set of tensors with the same per-lane stopping tests
(``sdg < PDTOL``, ``pd_iters`` Newton steps, a stuck line search), so a
lane that stops early is frozen exactly as the vmapped loop freezes it.
The Newton systems are a batched Cholesky (``backend="dense"``) or
per-lane matrix-free CG (``"cg"``).  Under a profiler session :func:`l1ra`
runs inside a program span ``solver.l1ra`` (attribute ``iters``: the outer
loop's steps; ``utils/timing.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.solver.graph import (
    RotationGraph, incidence_matvec, incidence_rmatvec, laplacian_cg_solve,
    laplacian_dense,
)
from irotavg_tpu_torch.solver.irls import _plans, free_mean
from irotavg_tpu_torch.utils.timing import span

PDTOL = 1e-3  # ral/l1_irls.cpp:231
_ALPHA = 0.01
_BETA = 0.5
_MU = 10.0
_MAX_BACKTRACK = 32


@dataclasses.dataclass(frozen=True)
class L1RAConfig:
    max_iters: int = 5
    change_th: float = 1e-3
    pd_iters: int = 2  # Newton iterations per decode (l1_step, fixed)
    ridge: float = 0.0
    backend: str = "dense"  # "dense" (Cholesky) or "cg" (matrix-free)
    cg_tol: float = 1e-10
    cg_maxiter: int = 1000


def _newton_dx(edges, sigx, w1p, free, emask, n, cfg: L1RAConfig, plan):
    """The Newton direction ``(A' diag(sigx) A) dx = w1p`` of every lane:
    ``sigx (*B, m, L)``, ``w1p (*B, n, L)``, one system per lane;
    ``plan`` is the graph's ``graph_plans`` for ``cfg.backend`` (its dense
    plan built for L lanes)."""
    if cfg.backend == "dense":
        # a failed factorisation is zeroed rather than rescued, like the
        # reference (its 3-axis vmap would run both branches of a cond)
        H = laplacian_dense(edges[..., None, :, :], sigx.transpose(-1, -2),
                            free[..., None, :], emask[..., None, :], n,
                            ridge=cfg.ridge, plan=plan.dense)
        Lc, info = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(w1p.transpose(-1, -2)[..., None], Lc)
        dx = torch.where((info == 0)[..., None, None], dx,
                         torch.zeros_like(dx))[..., 0].transpose(-1, -2)
    elif cfg.backend == "cg":
        dx, _ = laplacian_cg_solve(edges, sigx, w1p, free, emask,
                                   tol=cfg.cg_tol, maxiter=cfg.cg_maxiter,
                                   per_column=True, plan=plan)
    else:
        raise ValueError(f"Unknown backend {cfg.backend!r}")
    ok = torch.isfinite(dx) & free[..., None]
    return torch.where(ok, dx, torch.zeros_like(dx))


def _l1decode_lanes(y, edges, free, emask, n, cfg: L1RAConfig, plan):
    """Scalar l1 decodes ``argmin_x ||A x - y||_1`` from x0 = 0, one per
    lane: ``y (*B, m, L)`` holds L right-hand sides of each graph
    ``edges (*B, m, 2)``.  Returns x ``(*B, n, L)``.

    ``plan``: ``graph_plans`` of ``edges`` for ``cfg.backend``, with L
    dense lanes.  Every lane runs the
    reference's decoder (``_l1decode_pd_single``
    under ``vmap``): its own Newton steps, backtracking line search and
    stop, and a lane that has stopped is frozen.  Per-lane scalars are
    ``(*B, 1, L)``; all ``(m,)`` quantities are masked by ``emask``.  The
    host reads one stopping test per Newton step and one per backtracking
    step, for all lanes at once.
    """
    dtype = y.dtype
    em = emask[..., None]
    fm = free[..., None]
    m_eff = torch.clamp(emask.sum(-1).to(dtype), min=1.0)[..., None, None]
    big = torch.finfo(dtype).max

    def lsum(v):
        return v.sum(-2, keepdim=True)

    def mz(v, fill=0.0):
        return torch.where(em, v, torch.full_like(v, fill))

    def Aop(x):
        return incidence_matvec(edges, x, free, emask)

    def Atop(e):
        return incidence_rmatvec(edges, e, free, emask, n, plan.rmatvec)

    def pin(fu1, fu2, lamu1, lamu2, u):
        """Neutral interior values on padded rows."""
        return (mz(fu1, -1.0), mz(fu2, -1.0), mz(lamu1, 1.0),
                mz(lamu2, 1.0), mz(u, 1.0))

    def sdg_of(fu1, fu2, lamu1, lamu2):
        return -(lsum(mz(fu1 * lamu1)) + lsum(mz(fu2 * lamu2)))

    def resnorm_of(rd_x, rd_u, fu1, fu2, lamu1, lamu2, tau):
        rc1 = -lamu1 * fu1 - 1.0 / tau
        rc2 = -lamu2 * fu2 - 1.0 / tau
        rdx2 = lsum(torch.where(fm, rd_x * rd_x, torch.zeros_like(rd_x)))
        return torch.sqrt(rdx2 + lsum(mz(rd_u * rd_u)) + lsum(mz(rc1 * rc1))
                          + lsum(mz(rc2 * rc2)))

    def select(c, new, old):
        return tuple(torch.where(c, a, b) for a, b in zip(new, old))

    x = torch.zeros(y.shape[:-2] + (n, y.shape[-1]), dtype=dtype,
                    device=y.device)
    Ax = torch.zeros_like(y)
    r_abs = mz(torch.abs(y - Ax))
    u = 0.95 * r_abs + 0.10 * r_abs.amax(-2, keepdim=True)
    fu1 = Ax - y - u
    fu2 = -Ax + y - u
    lamu1 = -1.0 / fu1
    lamu2 = -1.0 / fu2
    fu1, fu2, lamu1, lamu2, u = pin(fu1, fu2, lamu1, lamu2, u)
    Atv = Atop(lamu1 - lamu2)
    sdg = sdg_of(fu1, fu2, lamu1, lamu2)
    tau = _MU * 2.0 * m_eff / sdg
    rd_x = Atv
    rd_u = 1.0 - lamu1 - lamu2
    resnorm = resnorm_of(rd_x, rd_u, fu1, fu2, lamu1, lamu2, tau)

    done = sdg < PDTOL
    for it in range(cfg.pd_iters):
        if not bool((~done).any()):
            break
        fu1, fu2, lamu1, lamu2, u = pin(fu1, fu2, lamu1, lamu2, u)
        inv_fu1 = 1.0 / fu1
        inv_fu2 = 1.0 / fu2
        w2 = -1.0 - (1.0 / tau) * (inv_fu1 + inv_fu2)
        sig1 = -lamu1 * inv_fu1 - lamu2 * inv_fu2
        sig2 = lamu1 * inv_fu1 - lamu2 * inv_fu2
        sigx = sig1 - sig2 * sig2 / sig1
        w1 = -(1.0 / tau) * Atop(-inv_fu1 + inv_fu2)
        w1p = w1 - Atop((sig2 / sig1) * w2)
        dx = _newton_dx(edges, sigx, w1p, free, emask, n, cfg, plan)
        Adx = Aop(dx)

        du = (w2 - sig2 * Adx) / sig1
        dlamu1 = (-(lamu1 * inv_fu1) * (Adx - du) - lamu1
                  - (1.0 / tau) * inv_fu1)
        dlamu2 = ((lamu2 * inv_fu2) * (Adx + du) - lamu2
                  - (1.0 / tau) * inv_fu2)
        Atdv = Atop(dlamu1 - dlamu2)

        def ratio_min(neg_num, den, pred):
            vals = torch.where(pred & em, neg_num / den,
                               torch.full_like(den, big))
            return vals.amin(-2, keepdim=True)

        s_step = torch.ones_like(sdg)
        s_step = torch.minimum(s_step, ratio_min(-lamu1, dlamu1, dlamu1 < 0))
        s_step = torch.minimum(s_step, ratio_min(-lamu2, dlamu2, dlamu2 < 0))
        s_step = torch.minimum(
            s_step, ratio_min(-fu1, Adx - du, (Adx - du) > 0))
        s_step = torch.minimum(
            s_step, ratio_min(-fu2, -Adx - du, (-Adx - du) > 0))
        s_step = 0.99 * s_step

        def trial(sv):
            xp = x + sv * dx
            up = u + sv * du
            Axp = Ax + sv * Adx
            Atvp = Atv + sv * Atdv
            l1p = lamu1 + sv * dlamu1
            l2p = lamu2 + sv * dlamu2
            f1p = Axp - y - up
            f2p = -Axp + y - up
            rdxp = 1.0 * Atvp
            rdup = 1.0 - l1p - l2p
            rn = resnorm_of(rdxp, rdup, f1p, f2p, l1p, l2p, tau)
            return (xp, up, Axp, Atvp, l1p, l2p, f1p, f2p, rdxp, rdup, rn)

        # backtracking line search (ral/l1_irls.cpp:385-432), per lane: a
        # lane that has accepted its step (or stopped) is frozen
        t = trial(s_step)
        ok = t[-1] <= (1.0 - _ALPHA * s_step) * resnorm
        sv = s_step * _BETA
        k = 1
        while k <= _MAX_BACKTRACK:
            bt = ~ok & ~done
            if not bool(bt.any()):
                break
            t = select(bt, trial(sv), t)
            ok = torch.where(bt, t[-1] <= (1.0 - _ALPHA * sv) * resnorm, ok)
            sv = torch.where(bt, sv * _BETA, sv)
            k += 1
        # a lane past the backtrack budget keeps its iterate and stops
        keep = ~ok | done
        x, u, Ax, Atv, lamu1, lamu2, fu1, fu2, rd_x, rd_u = select(
            keep, (x, u, Ax, Atv, lamu1, lamu2, fu1, fu2, rd_x, rd_u),
            t[:-1])
        sdg_n = sdg_of(fu1, fu2, lamu1, lamu2)
        tau_n = _MU * 2.0 * m_eff / sdg_n
        resnorm_n = resnorm_of(rd_x, rd_u, fu1, fu2, lamu1, lamu2, tau_n)
        sdg, tau, resnorm = select(done, (sdg, tau, resnorm),
                                   (sdg_n, tau_n, resnorm_n))
        done = done | ~ok | (sdg_n < PDTOL) | (it + 1 >= cfg.pd_iters)
    return x


def l1ra_step(g: RotationGraph, cfg: L1RAConfig, plan=None):
    """One outer L1-RA iteration. Returns (new_Q, score tensor).
    ``plan``: ``graph_plans`` of ``g`` for ``cfg.backend`` with a dense
    lane per tangent axis (built here when not given; :func:`l1ra` builds
    it once for all its steps)."""
    free = g.free_mask()
    w3 = so3.log_map(so3.delta_rel(g.edges, g.QQ, g.Q))[..., :3]
    w3 = torch.where(g.edge_mask[..., None], w3, torch.zeros_like(w3))
    if plan is None:
        plan = _plans(g, cfg.backend, lanes=3)
    X = _l1decode_lanes(w3, g.edges, free, g.edge_mask, g.n, cfg, plan)
    return so3.qmul(g.Q, so3.exp_map(X)), free_mean(X, free)


def l1ra(g: RotationGraph, cfg: L1RAConfig = L1RAConfig()):
    """Run L1-RA. Returns (Q, iters, score): iterate while the mean
    free-node update norm is >= ``change_th`` (note >=, unlike IRLS) and
    ``iters < max_iters`` (ral/l1_irls.cpp:879-910).  A batch of windows
    stops window by window, as in :func:`irls`."""
    batch = g.edges.shape[:-2]
    dev = g.Q.device
    Q = g.Q
    score = torch.full(batch, math.inf, dtype=g.dtype, device=dev)
    it = torch.zeros(batch, dtype=torch.int64, device=dev)
    active = (score >= cfg.change_th) & (it < cfg.max_iters)
    with span("solver.l1ra") as sp:
        plan = _plans(g, cfg.backend, lanes=3)
        steps = 0
        while bool(active.any()):
            Q2, s2 = l1ra_step(dataclasses.replace(g, Q=Q), cfg, plan)
            Q = torch.where(active[..., None, None], Q2, Q)
            score = torch.where(active, s2, score)
            it = it + active
            active = (score >= cfg.change_th) & (it < cfg.max_iters)
            steps += 1
        sp.set(iters=steps)
    if batch:
        return Q, it, score
    return Q, int(it), float(score)

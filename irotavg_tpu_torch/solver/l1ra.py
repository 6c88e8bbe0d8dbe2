"""L1 rotation averaging (port of ``irotavg_tpu/solver/l1ra.py``).

Outer loop: residual -> log map -> three independent scalar problems
``min ||A x - y||_1`` (one per tangent axis, ral/l1_irls.cpp:890-892) ->
exp map -> right-multiplied update.  The inner decoder is the l1-magic
primal-dual interior-point method (``l1decode_pd``, ral/l1_irls.cpp:
228-468).  The reference runs the three axes as one ``vmap`` of a
``lax.while_loop``; here each axis runs its own Python loop with the same
stopping tests (``sdg < PDTOL``, ``pd_iters`` Newton steps, a stuck line
search), so an axis that stops early is frozen exactly as the vmapped
loop freezes its lane.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.solver.graph import (
    RotationGraph, incidence_matvec, incidence_rmatvec, laplacian_dense,
)

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


def _l1decode_pd_single(y, edges, free, emask, n, pd_iters, ridge):
    """One scalar l1 decode ``argmin_x ||A x - y||_1`` from x0 = 0.

    All (m,) quantities are masked by ``emask``; x lives in full node
    space (zeros on fixed nodes).  Returns x (n,).
    """
    dtype = y.dtype
    m_eff = max(float(emask.sum()), 1.0)
    big = torch.finfo(dtype).max

    def mz(v, fill=0.0):
        return torch.where(emask, v, torch.full_like(v, fill))

    def Aop(x):
        return incidence_matvec(edges, x[:, None], free, emask)[:, 0]

    def Atop(e):
        return incidence_rmatvec(edges, e[:, None], free, emask, n)[:, 0]

    def pin(fu1, fu2, lamu1, lamu2, u):
        """Neutral interior values on padded rows."""
        return (mz(fu1, -1.0), mz(fu2, -1.0), mz(lamu1, 1.0),
                mz(lamu2, 1.0), mz(u, 1.0))

    def sdg_of(fu1, fu2, lamu1, lamu2):
        return -(mz(fu1 * lamu1).sum() + mz(fu2 * lamu2).sum())

    def resnorm_of(rd_x, rd_u, fu1, fu2, lamu1, lamu2, tau):
        rc1 = -lamu1 * fu1 - 1.0 / tau
        rc2 = -lamu2 * fu2 - 1.0 / tau
        rdx2 = torch.where(free, rd_x * rd_x, torch.zeros_like(rd_x)).sum()
        return torch.sqrt(rdx2 + mz(rd_u * rd_u).sum()
                          + mz(rc1 * rc1).sum() + mz(rc2 * rc2).sum())

    x = torch.zeros(n, dtype=dtype, device=y.device)
    Ax = torch.zeros_like(y)
    r_abs = mz(torch.abs(y - Ax))
    u = 0.95 * r_abs + 0.10 * r_abs.max()
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

    done = bool(sdg < PDTOL)
    it = 0
    while not done:
        fu1, fu2, lamu1, lamu2, u = pin(fu1, fu2, lamu1, lamu2, u)
        inv_fu1 = 1.0 / fu1
        inv_fu2 = 1.0 / fu2
        w2 = -1.0 - (1.0 / tau) * (inv_fu1 + inv_fu2)
        sig1 = -lamu1 * inv_fu1 - lamu2 * inv_fu2
        sig2 = lamu1 * inv_fu1 - lamu2 * inv_fu2
        sigx = sig1 - sig2 * sig2 / sig1
        w1 = -(1.0 / tau) * Atop(-inv_fu1 + inv_fu2)
        w1p = w1 - Atop((sig2 / sig1) * w2)

        # a failed factorisation is zeroed rather than rescued, like the
        # reference (its 3-axis vmap would run both branches of a cond)
        H = laplacian_dense(edges, sigx, free, emask, n, ridge=ridge)
        Lc, info = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(w1p[:, None], Lc)[:, 0]
        if int(info) != 0:
            dx = torch.zeros_like(dx)
        dx = torch.where(torch.isfinite(dx) & free, dx, torch.zeros_like(dx))
        Adx = Aop(dx)

        du = (w2 - sig2 * Adx) / sig1
        dlamu1 = (-(lamu1 * inv_fu1) * (Adx - du) - lamu1
                  - (1.0 / tau) * inv_fu1)
        dlamu2 = ((lamu2 * inv_fu2) * (Adx + du) - lamu2
                  - (1.0 / tau) * inv_fu2)
        Atdv = Atop(dlamu1 - dlamu2)

        def ratio_min(neg_num, den, pred):
            vals = torch.where(pred & emask, neg_num / den,
                               torch.full_like(den, big))
            return vals.min()

        s_step = torch.ones((), dtype=dtype, device=y.device)
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

        # backtracking line search (ral/l1_irls.cpp:385-432)
        t = trial(s_step)
        ok = bool(t[-1] <= (1.0 - _ALPHA * s_step) * resnorm)
        sv = s_step * _BETA
        k = 1
        while not ok and k <= _MAX_BACKTRACK:
            t = trial(sv)
            ok = bool(t[-1] <= (1.0 - _ALPHA * sv) * resnorm)
            sv = sv * _BETA
            k += 1
        stuck = not ok   # exceeded the backtrack budget: keep the iterate

        if not stuck:
            (x, u, Ax, Atv, lamu1, lamu2, fu1, fu2, rd_x, rd_u, _) = t
        sdg = sdg_of(fu1, fu2, lamu1, lamu2)
        tau = _MU * 2.0 * m_eff / sdg
        resnorm = resnorm_of(rd_x, rd_u, fu1, fu2, lamu1, lamu2, tau)
        it += 1
        done = stuck or bool(sdg < PDTOL) or it >= pd_iters
    return x


def l1ra_step(g: RotationGraph, cfg: L1RAConfig):
    """One outer L1-RA iteration. Returns (new_Q, score tensor)."""
    free = g.free_mask()
    w3 = so3.log_map(so3.delta_rel(g.edges, g.QQ, g.Q))[:, :3]
    w3 = torch.where(g.edge_mask[:, None], w3, torch.zeros_like(w3))
    X = torch.stack([
        _l1decode_pd_single(w3[:, a], g.edges, free, g.edge_mask, g.n,
                            cfg.pd_iters, cfg.ridge)
        for a in range(3)
    ], dim=1)

    norms = torch.linalg.vector_norm(X, dim=-1)
    n_free = max(int(free.sum()), 1)
    score = torch.where(free, norms, torch.zeros_like(norms)).sum() / n_free
    return so3.qmul(g.Q, so3.exp_map(X)), score


def l1ra(g: RotationGraph, cfg: L1RAConfig = L1RAConfig()):
    """Run L1-RA. Returns (Q, iters, score): iterate while the mean
    free-node update norm is >= ``change_th`` (note >=, unlike IRLS) and
    ``iters < max_iters`` (ral/l1_irls.cpp:879-910)."""
    Q = g.Q
    score = math.inf
    it = 0
    while score >= cfg.change_th and it < cfg.max_iters:
        Q, s = l1ra_step(dataclasses.replace(g, Q=Q), cfg)
        score = float(s)
        it += 1
    return Q, it, score

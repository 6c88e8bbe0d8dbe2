"""Rotation-averaging problem representation and the Laplacian solves.

Port of ``irotavg_tpu/solver/graph.py``.  The graph is a set of tensors;
the first ``f`` rotations are fixed.  As in the reference, the signed
incidence matrix A (``make_A``, ral/l1_irls.cpp:755-780) is never built:
every operator works in the full node space with fixed and padded nodes
reading zero.

Every function also takes leading batch dims (a stack of independent
windows, ``engine/batched.py``): node fields are ``(*B, n, k)``, edge
fields ``(*B, m, k)``, and ``edges (*B, m, 2)`` index each window's own
nodes.  This is the reference's ``vmap`` over windows.

Two solves of ``(A' diag(coef) A) X = rhs``: a dense Cholesky with the
reference's singularity rescue (:func:`laplacian_cho_solve`) and the
matrix-free Jacobi-preconditioned CG (:func:`laplacian_cg_solve`).

Every scatter-add (the reference's ``.at[].add``) is added in a fixed
order: each node's terms in the order of their index, as on the CPU, so a
solve on the card gives the same answer on every run.  ``A.T @ e`` and
the Jacobi diagonal are segment sums (``ops/segment.py``); the CG's
Laplacian matvec and the dense Laplacian are fused kernels with the same
order (``ops/laplacian.py``).  Their plans are built once per graph
(:func:`graph_plans`) and reused by every iteration of a solve.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from irotavg_tpu_torch.ops.laplacian import DensePlan, MatvecPlan, \
    dense_plan, laplacian_assemble, laplacian_matvec, matvec_plan
from irotavg_tpu_torch.ops.segment import SegmentPlan, segment_plan, \
    segment_sum
from irotavg_tpu_torch.so3 import take_rows

# CG iterations run on the device between two host reads of the stopping
# test; iterations past a lane's stop are computed and discarded
CG_CHECK_EVERY = 16


@dataclasses.dataclass(frozen=True)
class RotationGraph:
    """A rotation-averaging problem.

    edges: ``(m, 2)`` int64 node indices ``(i, j)`` (``R_j ≈ R_ij R_i``);
    QQ: ``(m, 4)`` relative rotations; Q: ``(n, 4)`` absolute rotations,
    first ``f`` fixed; edge_mask ``(m,)`` / node_mask ``(n,)`` bool.  A
    batch of windows puts a leading ``(W,)`` on every field, and ``f`` is
    then a ``(W,)`` tensor.
    """

    edges: torch.Tensor
    QQ: torch.Tensor
    Q: torch.Tensor
    f: int | torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor

    @property
    def m(self) -> int:
        return self.edges.shape[-2]

    @property
    def n(self) -> int:
        return self.Q.shape[-2]

    @property
    def dtype(self):
        return self.Q.dtype

    def free_mask(self) -> torch.Tensor:
        """(*B, n) bool — nodes that are variables (index >= f, not
        padding)."""
        idx = torch.arange(self.n, device=self.Q.device)
        f = self.f if isinstance(self.f, int) else self.f[..., None]
        return (idx >= f) & self.node_mask

    @staticmethod
    def create(edges, QQ, Q, f=1, edge_mask=None, node_mask=None,
               dtype=None, device=None):
        Q = torch.as_tensor(Q, device=device)
        device = Q.device
        edges = torch.as_tensor(edges, device=device).long()
        QQ = torch.as_tensor(QQ, device=device)
        if dtype is not None:
            QQ = QQ.to(dtype)
            Q = Q.to(dtype)
        if edge_mask is None:
            edge_mask = torch.ones(edges.shape[:-1], dtype=torch.bool,
                                   device=device)
        if node_mask is None:
            node_mask = torch.ones(Q.shape[:-1], dtype=torch.bool,
                                   device=device)
        f = int(f) if Q.dim() == 2 else torch.as_tensor(f, device=device)
        return RotationGraph(
            edges=edges, QQ=QQ, Q=Q, f=f,
            edge_mask=torch.as_tensor(edge_mask, device=device).bool(),
            node_mask=torch.as_tensor(node_mask, device=device).bool(),
        )

    def pad_to(self, m_pad: int, n_pad: int) -> "RotationGraph":
        """Pad to ``m_pad`` edges and ``n_pad`` nodes: masked edges
        ``(0, 0)`` with identity rotations and masked identity nodes
        (``irotavg_tpu/solver/graph.py:83``).  Refuses to shrink."""
        if m_pad < self.m or n_pad < self.n:
            raise ValueError("pad_to cannot shrink the problem")
        dm, dn = m_pad - self.m, n_pad - self.n

        def grow(t, d, fill):
            pad = torch.full(t.shape[:-2] + (d,) + t.shape[-1:], fill,
                             dtype=t.dtype, device=t.device)
            return torch.cat([t, pad], dim=-2)

        def ident(t, d):
            out = grow(t, d, 0)
            out[..., t.shape[-2]:, 3] = 1
            return out

        def unmask(t, d):
            return grow(t[..., None], d, False)[..., 0]

        return RotationGraph(
            edges=grow(self.edges, dm, 0), QQ=ident(self.QQ, dm),
            Q=ident(self.Q, dn), f=self.f,
            edge_mask=unmask(self.edge_mask, dm),
            node_mask=unmask(self.node_mask, dn))


def _row_plan(idx, n) -> SegmentPlan:
    """The plan for terms going to rows ``idx (*B, N)`` of each batch
    entry's own ``n`` rows: the ids flattened to ``b*n + idx``."""
    batch = idx.shape[:-1]
    nb = batch.numel()
    if batch:
        base = torch.arange(nb, device=idx.device).view(*batch, 1) * n
        idx = idx + base
    return segment_plan(idx, nb * n)


def rmatvec_plan(edges, n, batch=None) -> SegmentPlan:
    """The plan of :func:`incidence_rmatvec` for ``edges (*B, m, 2)``
    over ``n`` nodes: the terms ``cat(e, -e)`` go to ``cat(j, i)``, so
    each node adds its ``+e`` terms in edge order, then its ``-e`` terms.
    ``batch`` broadcasts the edges over leading dims of the values."""
    if batch is not None:
        edges = edges.expand(*batch, *edges.shape[-2:])
    return _row_plan(torch.cat([edges[..., 1], edges[..., 0]], dim=-1), n)


def diag_plan(edges, n, batch=None) -> SegmentPlan:
    """The plan of :func:`diag_partial` for ``edges (*B, m, 2)`` over ``n``
    nodes: each node adds its terms as ``i``, then as ``j``, in edge
    order.  ``batch`` broadcasts the edges over leading dims of the
    coefficients."""
    if batch is not None:
        edges = edges.expand(*batch, *edges.shape[-2:])
    return _row_plan(torch.cat([edges[..., 0], edges[..., 1]], dim=-1), n)


class GraphPlans(NamedTuple):
    """The plans of one graph, built once per solve by :func:`graph_plans`
    and reused by every iteration: ``rmatvec`` for ``A.T @ e``
    (:func:`rmatvec_plan`); for the CG backend ``diag`` (the Jacobi
    diagonal, :func:`diag_plan`) and ``matvec`` (the Laplacian matvec,
    ``ops/laplacian.py:matvec_plan``); for the dense backend ``dense``
    (``ops/laplacian.py:dense_plan``)."""

    rmatvec: SegmentPlan
    diag: SegmentPlan | None = None
    matvec: MatvecPlan | None = None
    dense: DensePlan | None = None


def graph_plans(edges, free_mask, edge_mask, n, backend,
                lanes=None) -> GraphPlans:
    """The plans a solve of ``backend`` (``"dense"`` or ``"cg"``) needs on
    the graph ``edges (*B, m, 2)`` with its masks.  ``lanes``: the dense
    Laplacian is built for that many coefficient rows per graph (L1-RA's
    per-axis lanes, ``(*B, lanes, n, n)``); the CG takes lanes as
    columns."""
    batch = edges.shape[:-2]
    rmatvec = rmatvec_plan(edges, n)
    if backend == "cg":
        return GraphPlans(rmatvec, diag=diag_plan(edges, n),
                          matvec=matvec_plan(edges, free_mask, edge_mask, n,
                                             batch))
    if backend == "dense":
        if lanes is None:
            dense = dense_plan(edges, free_mask, edge_mask, n, batch)
        else:
            dense = dense_plan(edges[..., None, :, :], free_mask[..., None, :],
                               edge_mask[..., None, :], n,
                               (*batch, lanes))
        return GraphPlans(rmatvec, dense=dense)
    raise ValueError(f"Unknown backend {backend!r}")


def _sum_rows(plan, vals, n):
    """Segment sum of ``vals (*B, N, k)`` by ``plan`` -> ``(*B, n, k)``."""
    k = vals.shape[-1]
    out = segment_sum(vals.reshape(-1, k), plan)
    return out.view(*vals.shape[:-2], n, k)


def incidence_matvec(edges, x_nodes, free_mask, edge_mask):
    """``A @ x`` per edge: ``x[j] - x[i]``, fixed/padded nodes read 0.
    ``x_nodes (*B, n, k)`` -> ``(*B, m, k)``."""
    x = torch.where(free_mask[..., None], x_nodes, torch.zeros_like(x_nodes))
    out = take_rows(x, edges[..., 1]) - take_rows(x, edges[..., 0])
    return torch.where(edge_mask[..., None], out, torch.zeros_like(out))


def incidence_fixed_matvec(edges, x_nodes, free_mask, edge_mask):
    """``C @ x``: the incidence action over the *fixed* block, per edge
    ``x[j]·[j fixed] − x[i]·[i fixed]``; ``(*B, n, k)`` -> ``(*B, m, k)``.

    The complement of :func:`incidence_matvec`: for any node field x,
    ``A@x_free + C@x_fixed == x[j] − x[i]`` on real edges (the reference's
    ``make_C``, ral/l1_irls.cpp:783-806, built there but never called)."""
    x = torch.where(free_mask[..., None], torch.zeros_like(x_nodes), x_nodes)
    out = take_rows(x, edges[..., 1]) - take_rows(x, edges[..., 0])
    return torch.where(edge_mask[..., None], out, torch.zeros_like(out))


def incidence_rmatvec(edges, e, free_mask, edge_mask, n, plan=None):
    """``A.T @ e``: ``+e_k`` to node j, ``-e_k`` to node i; ``(*B, n, k)``
    zeroed at fixed nodes.  ``plan``: :func:`rmatvec_plan` of ``edges``
    (built here when not given)."""
    e = torch.where(edge_mask[..., None], e, torch.zeros_like(e))
    if plan is None:
        plan = rmatvec_plan(edges, n, e.shape[:-2])
    out = _sum_rows(plan, torch.cat([e, -e], dim=-2), n)
    return torch.where(free_mask[..., None], out, torch.zeros_like(out))


def diag_partial(edges, c, n, plan=None):
    """The raw diagonal of ``A' diag(c) A`` for masked coefficients ``c
    (*B, m, k)``, one column per ``k``, before :func:`guard_diag`: the
    sum over ``edges`` only, so that the partials of disjoint edge blocks
    add up to the whole graph's (``parallel/sharded.py`` reduces them
    over the ranks, then guards).  Each node adds its terms as ``i``,
    then as ``j``, in edge order.  ``plan``: :func:`diag_plan` of
    ``edges`` (built here when not given)."""
    if plan is None:
        plan = diag_plan(edges, n, c.shape[:-2])
    return _sum_rows(plan, torch.cat([c, c], dim=-2), n)


def guard_diag(d, free_mask):
    """1 where a node is fixed or has no weight, ``d`` elsewhere."""
    # d == 0 on a free node (every incident weight zero, e.g. Talwar
    # marking each neighbour an outlier): a unit diagonal keeps the
    # preconditioner finite, and with rhs == 0 there CG leaves the node
    # at zero update (the reference's SPQR minimum-norm behaviour)
    return torch.where(free_mask[..., None] & (d > 0), d, torch.ones_like(d))


def _diag(edges, c, free_mask, n, plan=None):
    """Diagonal of ``A' diag(c) A`` for masked coefficients ``c (*B, m,
    k)``, one column per ``k``; 1 where a node is fixed or has no weight."""
    return guard_diag(diag_partial(edges, c, n, plan), free_mask)


def laplacian_diag(edges, coef, free_mask, edge_mask, n):
    """Diagonal of ``A.T diag(coef) A`` in full node space (the Jacobi
    preconditioner); ``coef (*B, m)`` -> ``(*B, n)``."""
    c = torch.where(edge_mask, coef, torch.zeros_like(coef))
    return _diag(edges, c[..., None], free_mask, n)[..., 0]


def laplacian_dense(edges, coef, free_mask, edge_mask, n, ridge=0.0,
                    plan=None):
    """Dense ``A.T diag(coef) A`` with identity rows/cols on fixed nodes.

    ``coef (*B, m)``; ``edges``, ``free_mask`` and ``edge_mask`` broadcast
    to it (one graph may carry several coefficient rows).  Returns
    ``(*B, n, n)``, each entry's terms added in the reference's order
    ``(i, i)``, ``(j, j)``, ``(i, j)``, ``(j, i)``, each in edge order.
    ``plan``: ``ops/laplacian.py:dense_plan`` of the graph for ``coef``'s
    batch (built here when not given)."""
    if plan is None:
        plan = dense_plan(edges, free_mask, edge_mask, n, coef.shape[:-1])
    return laplacian_assemble(coef, plan, ridge)


def _cho_solve(L, rhs):
    """Cholesky solve of each ``L (*B, n, n)``; ``ok (*B, 1, 1)`` is False
    where the factorisation failed or the result is not finite."""
    Lc, info = torch.linalg.cholesky_ex(L)
    X = torch.cholesky_solve(rhs, Lc)
    ok = (info == 0)[..., None, None] & torch.isfinite(X).all(
        dim=(-2, -1), keepdim=True)
    return X, ok


def laplacian_cho_solve(edges, coef, rhs, free_mask, edge_mask, n,
                        ridge=0.0, plan=None):
    """Dense Cholesky solve of ``(A' diag(coef) A) X = rhs`` with the
    reference's singularity rescue: where the plain factorisation fails
    (or yields non-finite values) the result is that of a re-run with a
    tiny relative shift on the free diagonal, its non-finite entries (or
    all of it, if that factorisation fails too) set to 0.  The rescue is
    computed for every system and selected per system, so the solve needs
    no host read; well-posed systems keep the unshifted result.  ``plan``:
    as for :func:`laplacian_dense`."""
    L = laplacian_dense(edges, coef, free_mask, edge_mask, n, ridge=ridge,
                        plan=plan)
    X, ok = _cho_solve(L, rhs)
    free = free_mask.expand(L.shape[:-1])
    n_free = free.sum(-1, keepdim=True).clamp(min=1)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    scale = torch.where(free, diag, torch.zeros_like(diag)).sum(
        -1, keepdim=True) / n_free
    eps = 1e-6 if L.dtype == torch.float32 else 1e-10
    shift = torch.clamp(scale, min=1.0) * eps
    L2 = L + torch.diag_embed(torch.where(free, shift, torch.zeros_like(diag)))
    Lc2, info2 = torch.linalg.cholesky_ex(L2)
    X2 = torch.cholesky_solve(rhs, Lc2)
    X2 = torch.where((info2 == 0)[..., None, None] & torch.isfinite(X2), X2,
                     torch.zeros_like(X2))
    return torch.where(ok, X, X2)


def _pcg(matvec, dinv, b, tol, maxiter, dims):
    """Jacobi-preconditioned CG from x = 0, with the reference's loop
    (``irotavg_tpu/solver/graph.py:241-268``): the same guards and the
    stopping rule ``|r| > tol |b| and k < maxiter``.  The inner products
    sum over ``dims``; every other index of ``b`` is a lane that runs and
    stops on its own, as under ``vmap``.  A stopped lane is frozen, so
    ``x`` and the count are those the reference stops at; the host reads
    the stopping test once every ``CG_CHECK_EVERY`` iterations."""
    def dot(u, v):
        return (u * v).sum(dim=dims, keepdim=True)

    def going(r, k):
        return (torch.sqrt(dot(r, r)) > tol * bnorm) & (k < maxiter)

    x = torch.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    rz = dot(r, z)
    bnorm = torch.sqrt(dot(b, b)) + 1e-300
    k = torch.zeros(rz.shape, dtype=torch.int64, device=b.device)
    active = going(r, k)
    while bool(active.any()):
        for _ in range(CG_CHECK_EVERY):
            Ap = matvec(p)
            denom = dot(p, Ap)
            alpha = rz / torch.where(denom != 0, denom, torch.ones_like(denom))
            x_n = x + alpha * p
            r_n = r - alpha * Ap
            z = dinv * r_n
            rz_n = dot(r_n, z)
            beta = rz_n / torch.where(rz != 0, rz, torch.ones_like(rz))
            p_n = z + beta * p
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
            k = k + active
            active = going(r, k)
    return x, k


def laplacian_cg_solve(edges, coef, rhs, free_mask, edge_mask, *, tol=1e-10,
                       maxiter=500, per_column=False, plan=None):
    """Matrix-free Jacobi-preconditioned CG for ``(A.T diag(coef) A) x =
    rhs``; the matvec is one fused kernel (``ops/laplacian.py``).

    ``rhs (*B, n, k)``.  By default the k right-hand sides are solved at
    once, as one system with shared step sizes (the reference); with
    ``per_column`` each column is its own CG with its own stop (the
    reference's ``vmap`` over columns), and ``coef`` may then be ``(*B,
    m, k)``, one weight row per column.  ``plan``: the graph's
    :func:`graph_plans` for the CG backend (its ``matvec`` and ``diag``
    plans), built here once when not given.  Returns ``(x, iters)``,
    ``iters`` of shape ``*B`` (``(*B, k)`` per column)."""
    n = rhs.shape[-2]
    c = coef if coef.dim() == rhs.dim() else coef[..., None]
    c = torch.where(edge_mask[..., None], c, torch.zeros_like(c))
    if plan is None:
        plan = GraphPlans(None, diag=diag_plan(edges, n, c.shape[:-2]),
                          matvec=matvec_plan(edges, free_mask, edge_mask, n,
                                             rhs.shape[:-2]))

    def matvec(x):
        return laplacian_matvec(x, c, plan.matvec)

    dinv = 1.0 / _diag(edges, c, free_mask, n, plan.diag)
    b = torch.where(free_mask[..., None], rhs, torch.zeros_like(rhs))
    dims = (-2,) if per_column else (-2, -1)
    x, k = _pcg(matvec, dinv, b, tol, maxiter, dims)
    return x, (k[..., 0, :] if per_column else k[..., 0, 0])

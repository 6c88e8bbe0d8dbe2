"""Rotation-averaging problem representation and the Laplacian solve.

Port of ``irotavg_tpu/solver/graph.py`` (dense backend).  The graph is a
set of tensors; the first ``f`` rotations are fixed.  As in the
reference, the signed incidence matrix A (``make_A``,
ral/l1_irls.cpp:755-780) is never built: every operator works in the full
node space with fixed and padded nodes reading zero.

The matrix-free CG solve (``laplacian_cg_solve``) is not ported yet; the
windowed engine raises before it would be needed (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RotationGraph:
    """A rotation-averaging problem.

    edges: ``(m, 2)`` int64 node indices ``(i, j)`` (``R_j ≈ R_ij R_i``);
    QQ: ``(m, 4)`` relative rotations; Q: ``(n, 4)`` absolute rotations,
    first ``f`` fixed; edge_mask ``(m,)`` / node_mask ``(n,)`` bool.
    """

    edges: torch.Tensor
    QQ: torch.Tensor
    Q: torch.Tensor
    f: int
    edge_mask: torch.Tensor
    node_mask: torch.Tensor

    @property
    def m(self) -> int:
        return self.edges.shape[0]

    @property
    def n(self) -> int:
        return self.Q.shape[0]

    @property
    def dtype(self):
        return self.Q.dtype

    def free_mask(self) -> torch.Tensor:
        """(n,) bool — nodes that are variables (index >= f, not padding)."""
        idx = torch.arange(self.n, device=self.Q.device)
        return (idx >= self.f) & self.node_mask

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
        m, n = edges.shape[0], Q.shape[0]
        if edge_mask is None:
            edge_mask = torch.ones(m, dtype=torch.bool, device=device)
        if node_mask is None:
            node_mask = torch.ones(n, dtype=torch.bool, device=device)
        return RotationGraph(
            edges=edges, QQ=QQ, Q=Q, f=int(f),
            edge_mask=torch.as_tensor(edge_mask, device=device).bool(),
            node_mask=torch.as_tensor(node_mask, device=device).bool(),
        )


def incidence_matvec(edges, x_nodes, free_mask, edge_mask):
    """``A @ x`` per edge: ``x[j] - x[i]``, fixed/padded nodes read 0.
    ``x_nodes (n, k)`` -> ``(m, k)``."""
    x = torch.where(free_mask[:, None], x_nodes, torch.zeros_like(x_nodes))
    out = x[edges[:, 1]] - x[edges[:, 0]]
    return torch.where(edge_mask[:, None], out, torch.zeros_like(out))


def incidence_rmatvec(edges, e, free_mask, edge_mask, n):
    """``A.T @ e``: ``+e_k`` to node j, ``-e_k`` to node i; ``(n, k)``
    zeroed at fixed nodes."""
    e = torch.where(edge_mask[:, None], e, torch.zeros_like(e))
    out = torch.zeros((n, e.shape[1]), dtype=e.dtype, device=e.device)
    out.index_add_(0, edges[:, 1], e)
    out.index_add_(0, edges[:, 0], -e)
    return torch.where(free_mask[:, None], out, torch.zeros_like(out))


def laplacian_dense(edges, coef, free_mask, edge_mask, n, ridge=0.0):
    """Dense ``A.T diag(coef) A`` with identity rows/cols on fixed nodes."""
    zero = torch.zeros_like(coef)
    c = torch.where(edge_mask, coef, zero)
    i, j = edges[:, 0], edges[:, 1]
    fi = free_mask[i]
    fj = free_mask[j]
    both = fi & fj
    L = torch.zeros((n, n), dtype=coef.dtype, device=coef.device)
    L.index_put_((i, i), torch.where(fi, c, zero), accumulate=True)
    L.index_put_((j, j), torch.where(fj, c, zero), accumulate=True)
    L.index_put_((i, j), torch.where(both, -c, zero), accumulate=True)
    L.index_put_((j, i), torch.where(both, -c, zero), accumulate=True)
    fixed_diag = torch.where(
        free_mask, torch.full_like(free_mask, ridge, dtype=coef.dtype),
        torch.ones_like(free_mask, dtype=coef.dtype))
    return L + torch.diag(fixed_diag)


def _cho_solve(L, rhs):
    """Cholesky solve; returns (X, ok) with ``ok`` a host bool that is
    False when the factorisation failed (``cholesky_ex``'s ``info``)."""
    Lc, info = torch.linalg.cholesky_ex(L)
    if int(info) != 0:
        return None, False
    return torch.cholesky_solve(rhs, Lc), True


def laplacian_cho_solve(edges, coef, rhs, free_mask, edge_mask, n,
                        ridge=0.0):
    """Dense Cholesky solve of ``(A' diag(coef) A) X = rhs`` with the
    reference's singularity rescue: only if the plain factorisation fails
    (or yields non-finite values) is it re-run with a tiny relative shift
    on the free diagonal; non-finite entries of that result become 0."""
    L = laplacian_dense(edges, coef, free_mask, edge_mask, n, ridge=ridge)
    X, ok = _cho_solve(L, rhs)
    if ok and bool(torch.isfinite(X).all()):
        return X
    n_free = max(int(free_mask.sum()), 1)
    scale = float(torch.diagonal(L)[free_mask].sum()) / n_free
    eps = 1e-6 if L.dtype == torch.float32 else 1e-10
    shift = max(scale, 1.0) * eps
    L2 = L + torch.diag(torch.where(
        free_mask, torch.full((n,), shift, dtype=L.dtype, device=L.device),
        torch.zeros((n,), dtype=L.dtype, device=L.device)))
    X2, ok2 = _cho_solve(L2, rhs)
    if not ok2:
        return torch.zeros_like(rhs)
    return torch.where(torch.isfinite(X2), X2, torch.zeros_like(X2))

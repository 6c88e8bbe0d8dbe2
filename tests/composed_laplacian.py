"""The unfused composition that the fused Laplacian kernels
(``irotavg_tpu_torch/ops/laplacian.py``, ``csrc/laplacian.cu``) replace:
the reference they are held to bit for bit, on the CPU by
``tests/test_torch_laplacian_kernels.py`` and on the card by
``chip_smoke.py`` and ``tools/prof_cg50k.py``.

* :func:`composed_matvec`: the CG matvec as eager gathers, masks, a
  product and the fixed-order ``segment_sum`` of ``cat(e, -e)``;
* :func:`composed_cg_solve`: ``laplacian_cg_solve`` on it;
* :func:`composed_dense`: the dense Laplacian as a segment sum of its
  four blocks' terms over the flat matrices, with a plan built per call;
* :func:`composed_route`: a context in which ``irls`` and ``l1ra`` run on
  the composition (module attributes patched inside the block only; the
  port has no switch of its own).
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from irotavg_tpu_torch.ops.segment import segment_plan, segment_sum
from irotavg_tpu_torch.solver import graph


def bits_equal(a, b):
    """Two f64 or f32 tensors equal bit for bit (``-0.0`` is not
    ``0.0``)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {8: torch.int64, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def composed_matvec(edges, c, x, free_mask, edge_mask, n, rplan):
    """The CG matvec as the port composed it before the fused kernel:
    ``incidence_matvec`` (gathers, subtract, masks), ``* c``, then
    ``incidence_rmatvec`` (the fixed-order ``segment_sum`` of ``cat(e,
    -e)`` by ``rplan``, ``solver/graph.py:rmatvec_plan``)."""
    e = graph.incidence_matvec(edges, x, free_mask, edge_mask) * c
    return graph.incidence_rmatvec(edges, e, free_mask, edge_mask, n, rplan)


def composed_cg_solve(edges, coef, rhs, free_mask, edge_mask, *, tol=1e-10,
                      maxiter=500, per_column=False, plan=None):
    """``solver/graph.py:laplacian_cg_solve`` on :func:`composed_matvec`,
    with the Jacobi diagonal's plan built per call, as before the fused
    kernel (``plan``: the solve's ``graph_plans``, for its
    ``rmatvec``)."""
    n = rhs.shape[-2]
    c = coef if coef.dim() == rhs.dim() else coef[..., None]
    c = torch.where(edge_mask[..., None], c, torch.zeros_like(c))
    rplan = plan.rmatvec if plan is not None else graph.rmatvec_plan(
        edges, n, rhs.shape[:-2])

    def matvec(x):
        return composed_matvec(edges, c, x, free_mask, edge_mask, n, rplan)

    dinv = 1.0 / graph._diag(edges, c, free_mask, n)
    b = torch.where(free_mask[..., None], rhs, torch.zeros_like(rhs))
    dims = (-2,) if per_column else (-2, -1)
    x, k = graph._pcg(matvec, dinv, b, tol, maxiter, dims)
    return x, (k[..., 0, :] if per_column else k[..., 0, 0])


def composed_dense(edges, coef, free_mask, edge_mask, n, ridge=0.0,
                   plan=None):
    """``solver/graph.py:laplacian_dense`` as the port composed it before
    the fused kernel: the four blocks' terms ``(i, i)``, ``(j, j)``,
    ``(i, j)``, ``(j, i)`` as one column over the flat ``(*B, n, n)``
    entries, a segment plan of them built per call, their fixed-order
    ``segment_sum``, then ``+ diag_embed`` of the fixed diagonal
    (``plan`` is ignored)."""
    c = torch.where(edge_mask, coef, torch.zeros_like(coef))
    batch = c.shape[:-1]
    i = edges[..., 0].expand(c.shape)
    j = edges[..., 1].expand(c.shape)
    free = free_mask.expand(*batch, n)
    fi = torch.gather(free, -1, i)
    fj = torch.gather(free, -1, j)
    both = fi & fj
    zero = torch.zeros_like(c)
    base = torch.arange(c[..., 0].numel(), device=c.device).view(
        *batch, 1) * (n * n)
    blocks = ((i, i, torch.where(fi, c, zero)),
              (j, j, torch.where(fj, c, zero)),
              (i, j, torch.where(both, -c, zero)),
              (j, i, torch.where(both, -c, zero)))
    ids = torch.cat([(base + r * n + s).reshape(-1) for r, s, _ in blocks])
    vals = torch.cat([v.reshape(-1) for _, _, v in blocks])
    L = segment_sum(vals, segment_plan(ids, free.numel() * n))
    fixed_diag = torch.where(free, torch.full_like(free, ridge,
                                                   dtype=vals.dtype),
                             torch.ones_like(free, dtype=vals.dtype))
    return L.view(free.shape + (n,)) + torch.diag_embed(fixed_diag)


@contextlib.contextmanager
def composed_route():
    """Within the block ``irls`` and ``l1ra`` run the unfused composition
    that the fused kernels replace (:func:`composed_cg_solve`,
    :func:`composed_dense`)."""
    mods = {name: importlib.import_module(f"irotavg_tpu_torch.{name}")
            for name in ("solver.graph", "solver.irls", "solver.l1ra")}
    patches = [(mod, "laplacian_cg_solve", composed_cg_solve)
               for mod in mods.values()]
    patches += [(mods[m], "laplacian_dense", composed_dense)
                for m in ("solver.graph", "solver.l1ra")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)

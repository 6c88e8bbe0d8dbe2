"""The work a dense normal-equation solve needs, from its inputs.

Two callers solve ``(A' diag(c) A) X = rhs`` densely at the graph's size
``n``: IRLS's ``laplacian_cho_solve(edges, coef, rhs, free_mask,
edge_mask, n, ...)``, ``k`` right-hand sides of one matrix, and L1-RA's
``_newton_dx(edges, sigx, w1p, free, emask, n, cfg, plan)``, one matrix
and one right-hand side per lane.  A matrix needs a Cholesky
factorisation, ``n^3 / 3`` f64 operations, and
each right-hand side two triangular solves, ``2 n^2``; the bytes are the
inputs read once and the solution written once.  What the inputs do not
need (the rescue's second factorisation of a well-posed matrix) is not
counted.  The rate is the f64 tensor-core peak, which a DGEMM-based
factorisation can reach.
"""

from __future__ import annotations

from pbkit import peaks


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def work(args, kwargs):
    """(f64 operations, bytes) of one call, or None for a call that does
    not solve densely."""
    if len(args) >= 7 and hasattr(args[6], "backend"):
        edges, sigx, w1p, free, emask, n, cfg = args[:7]
        if cfg.backend != "dense":
            return None
        mats = sigx.numel() // sigx.shape[-2]          # lanes x batch
        rhs_cols = mats
        out = w1p
        nbytes = _nbytes(edges, sigx, w1p, free, emask, out)
    else:
        names = ("edges", "coef", "rhs", "free_mask", "edge_mask", "n")
        a = dict(zip(names, args), **kwargs)
        n, rhs = a["n"], a["rhs"]
        mats = rhs.numel() // (rhs.shape[-2] * rhs.shape[-1])
        rhs_cols = mats * rhs.shape[-1]
        nbytes = _nbytes(a["edges"], a["coef"], rhs, a["free_mask"],
                         a["edge_mask"], rhs)
    flops = mats * n ** 3 / 3.0 + rhs_cols * 2.0 * n ** 2
    return flops, nbytes


def least_s(args, kwargs):
    w = work(args, kwargs)
    if w is None:
        return None
    flops, nbytes = w
    return max(flops / peaks.FP64_TC_FLOPS, nbytes / peaks.HBM_BYTES)

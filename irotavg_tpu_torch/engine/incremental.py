"""Incremental windowed rotation averaging over a growing view graph.

Port of ``irotavg_tpu/engine/incremental.py`` (contract of
``ViewGraph::rotAvg``, src/ViewGraph.cpp:1263-1435): collect every edge
whose larger endpoint is one of the last ``win_size`` views, skip the
solve when edges or incident vertices are fewer than ``win_size``, order
the vertices ascending with the fixed ones (outside the window, or pinned
by :meth:`IncrementalRotAvg.fix_pose`) first, warm-start from the current
estimates, run L1-RA then IRLS (Geman-McClure), and write back the
normalised free rotations.

A window whose power-of-two node bucket exceeds ``dense_n_max`` (the
quasi-global re-solve after a loop closure, ``rotAvg(5e6)``,
src/IRotAvg.cpp:371-378) is solved with the matrix-free CG backend, as in
the reference; smaller ones factorise the dense Laplacian.

Differences from the reference, both deliberate:

* the solve runs in f64 at every size (the reference drops to f32 for
  large solves because f64 is emulated on a TPU), so CG's tolerance is
  the reference's f64 one, 1e-10;
* no padding buckets: eager PyTorch does not recompile per shape, and the
  reference's padding is masked out of every reduction.

Under a profiler session each ``rot_avg`` runs inside a program span
``engine.rot_avg`` (attributes ``view``, the newest view; ``win_size`` as
asked; and for a solve that runs, ``n``, ``m`` and ``backend``), with the
solver's ``solver.l1ra`` and ``solver.irls`` inside it
(``utils/timing.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.device import SOLVER_DTYPE, pick_device
from irotavg_tpu_torch.solver.graph import RotationGraph
from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig, irls
from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra
from irotavg_tpu_torch.utils.timing import span

DENSE_N_MAX = 2048   # default largest node bucket of the dense solve
CG_TOL = 1e-10       # the reference's CG tolerance for f64 solves


def _bucket(x: int, lo: int = 32) -> int:
    """Next power-of-two bucket (>= lo) — the reference's size classes."""
    b = lo
    while b < x:
        b <<= 1
    return b


def _window_solve(edges, QQ, Q, f, *, l1_iters, irls_iters, sigma,
                  change_th, cost, backend="dense"):
    """L1-RA + IRLS on one window; returns (Q, weights, iters, score)."""
    g = RotationGraph.create(edges, QQ, Q, f=f)
    Q1, _, _ = l1ra(g, L1RAConfig(max_iters=l1_iters, change_th=change_th,
                                  backend=backend, cg_tol=CG_TOL))
    irls_cfg = IRLSConfig(cost=Cost.parse(cost), sigma=sigma,
                          max_iters=irls_iters, change_th=change_th,
                          backend=backend, cg_tol=CG_TOL)
    g = RotationGraph.create(edges, QQ, Q1, f=f)
    Q2, w, iters, score = irls(g, irls_cfg)
    return so3.qnormalize(Q2), w, iters, score


class IncrementalRotAvg:
    """Growing view-graph solver state (absolute rotations + edge list).

    Host state (numpy): ``Q`` (n, 4) f64 ``[x y z w]`` rows, ``fixed``,
    ``edges`` (m, 2), ``QQ`` (m, 4).  The windowed solve runs on
    ``device``; a window whose node bucket exceeds ``dense_n_max`` is
    solved with matrix-free CG instead of a dense Cholesky.
    """

    def __init__(self, device=None, dense_n_max: int = DENSE_N_MAX):
        self.device = pick_device(device)
        self.dense_n_max = int(dense_n_max)
        self.dtype = np.float64
        self._Q = np.zeros((0, 4), self.dtype)
        self.fixed = np.zeros((0,), bool)
        self.edges = np.zeros((0, 2), np.int32)
        self.QQ = np.zeros((0, 4), self.dtype)
        self._edges_by_max: list[list[int]] = []
        # one in-flight lazy solve: (order, f, n, device result)
        self._pending = None

    # -- lazy write-back ------------------------------------------------------

    def _resolve(self) -> None:
        """Copy the in-flight lazy solve (if any) back to the host."""
        if self._pending is None:
            return
        order, f, n, Q_out = self._pending
        self._pending = None
        self._Q[order[f:]] = Q_out[f:n].cpu().numpy()

    @property
    def Q(self) -> np.ndarray:
        """Absolute rotations; resolves any in-flight lazy solve first."""
        self._resolve()
        return self._Q

    @Q.setter
    def Q(self, value) -> None:
        self.discard_pending()
        self._Q = value

    def discard_pending(self) -> None:
        """Drop an in-flight lazy solve without writing it back."""
        self._pending = None

    # -- graph construction -------------------------------------------------

    @property
    def num_views(self) -> int:
        return self._Q.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def add_view(self, q=None) -> int:
        """Append a view (identity by default); returns its index."""
        if q is None:
            q = np.array([0.0, 0.0, 0.0, 1.0], self.dtype)
        self.Q = np.concatenate([self.Q, np.asarray(q, self.dtype)[None]])
        self.fixed = np.concatenate([self.fixed, [False]])
        self._edges_by_max.append([])
        return self.num_views - 1

    def add_edge(self, i: int, j: int, q_rel) -> int:
        """Append relative rotation ``R_j = R_ij R_i`` for ``i < j``."""
        if not (0 <= i < j < self.num_views):
            raise ValueError(f"bad edge ({i}, {j}) for {self.num_views} views")
        self.edges = np.concatenate([self.edges, np.array([[i, j]], np.int32)])
        self.QQ = np.concatenate(
            [self.QQ, np.asarray(q_rel, self.dtype)[None]])
        eid = self.num_edges - 1
        self._edges_by_max[j].append(eid)
        return eid

    def fix_pose(self, idx: int, q=None) -> None:
        """Pin view ``idx``; optionally overwrite its rotation."""
        self.fixed[idx] = True
        if q is not None:
            self.Q[idx] = np.asarray(q, self.dtype)

    # -- the windowed solve --------------------------------------------------

    def rot_avg(self, win_size: int, *, l1_iters: int = 100,
                irls_iters: int = 100,
                sigma: float = float(5.0 * math.pi / 180.0),
                change_th: float = 1e-3, cost: str = "Geman-McClure",
                lazy: bool = False) -> dict | None:
        """Solve the window subproblem and write back rotations in place.

        Returns a stats dict, or None when the solve was skipped.  With
        ``lazy=True`` the solved rotations stay a device tensor until the
        next access of :attr:`Q`.
        """
        with span("engine.rot_avg", view=self.num_views - 1,
                  win_size=win_size) as sp:
            m_views = self.num_views
            win_size = min(m_views, win_size)
            if win_size < 2:
                return None
            lo = m_views - win_size
            edge_ids = [e for j in range(lo, m_views)
                        for e in self._edges_by_max[j]]
            if len(edge_ids) < win_size:
                return None
            sub_edges = self.edges[edge_ids]
            verts = np.unique(sub_edges)
            if len(verts) < win_size:
                return None

            vfixed = (verts < lo) | self.fixed[verts]
            order = np.concatenate([verts[vfixed], verts[~vfixed]])
            f = int(vfixed.sum())
            new_idx = np.empty(self.num_views, np.int64)
            new_idx[order] = np.arange(len(order))

            Q_sub = self.Q[order].copy()
            if f == 0:
                Q_sub[0] = (0.0, 0.0, 0.0, 1.0)
                f = 1
            m, n = len(edge_ids), len(order)
            n_pad = _bucket(n)
            backend = "cg" if n_pad > self.dense_n_max else "dense"
            sp.set(n=n, m=m, backend=backend)
            dev = self.device
            Q_out, w, iters, score = _window_solve(
                torch.as_tensor(new_idx[sub_edges], device=dev),
                torch.as_tensor(self.QQ[edge_ids], dtype=SOLVER_DTYPE,
                                device=dev),
                torch.as_tensor(Q_sub, dtype=SOLVER_DTYPE, device=dev), f,
                l1_iters=l1_iters, irls_iters=irls_iters, sigma=float(sigma),
                change_th=float(change_th), cost=cost, backend=backend)
            stats = {"m": m, "n": n, "f": f, "n_pad": n_pad,
                     "backend": backend, "solve_dtype": "float64",
                     "solved_views": order[f:], "irls_iters": iters,
                     "score": score}
            if lazy:
                self._pending = (order, f, n, Q_out)
                stats["lazy"] = True
                return stats
            self._Q[order[f:]] = Q_out[f:n].cpu().numpy()
            stats["weights"] = w.cpu().numpy()
            return stats

    # -- persistence ---------------------------------------------------------

    def save_poses(self, path: str) -> None:
        """Write per view ``id<TAB>qw qx qy qz tx ty tz`` rows
        (``ViewGraph::savePoses``, src/ViewGraph.cpp:1206-1231)."""
        with open(path, "w") as fh:
            for i in range(self.num_views):
                x, y, z, w = self.Q[i]
                vals = (w, x, y, z, 0.0, 0.0, 0.0)
                fh.write(str(i) + "\t"
                         + "\t".join(f"{v:.17e}" for v in vals) + "\n")

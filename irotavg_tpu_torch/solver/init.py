# Copied from irotavg_tpu/solver/init.py (numpy only; deduplicate once irotavg_tpu imports lazily),
# without its branch into irotavg_tpu.native: the port runs the Python sweep,
# inside the program span ``solver.init_mst`` (utils/timing.py).
"""Spanning-tree initialisation (host-side).

Mirrors ``init_mst`` (ral/l1_irls.cpp:915-979): sweep the edge list in order,
propagating ``Q[j] = QQ_ij * Q[i]`` (and the inverse direction) from flagged
to unflagged nodes until all nodes are covered; nodes with index < f keep
their given rotations.  The sweep order is part of the observable behavior
(it selects which tree edge initialises each node), so we reproduce it
exactly rather than using an arbitrary BFS.

This is a one-shot, latency-bound graph traversal — it stays on host
(numpy), like the reference's single-threaded loop.
"""

from __future__ import annotations

import numpy as np

from irotavg_tpu_torch.utils.timing import span


class DisconnectedGraphError(RuntimeError):
    """Raised when the relative rotations do not span all nodes
    (the reference exits the process, ral/l1_irls.cpp:970-977)."""

    def __init__(self, count, n):
        super().__init__(
            f"Relative rotations do not span all nodes: spanning tree covers "
            f"{count} of {n} nodes"
        )
        self.count = count
        self.n = n


def _qmul_np(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def init_mst(Q, QQ, edges, f):
    """Return a copy of ``Q`` with non-fixed rotations initialised by
    propagation along a spanning tree rooted at node 0.

    Args:
      Q: (n, 4) float array, quaternion rows [x y z w]; first f rows fixed.
      QQ: (m, 4) relative rotations per edge.
      edges: (m, 2) int array of (i, j).
      f: number of leading rotations to never overwrite (must be >= 1).
    """
    assert f >= 1, "at least one rotation must be fixed"
    with span("solver.init_mst"):
        return _sweep(Q, QQ, edges, f)


def _sweep(Q, QQ, edges, f):
    Q = np.array(Q, np.float64, copy=True)
    QQ = np.asarray(QQ, np.float64)
    edges = np.asarray(edges)
    n = Q.shape[0]
    m = edges.shape[0]

    flags = np.zeros(n, bool)
    flags[0] = True
    count = 1

    while count < n:
        span_flag = False
        for k in range(m):
            e1, e2 = int(edges[k, 0]), int(edges[k, 1])
            if flags[e1] and not flags[e2]:
                if e2 >= f:
                    Q[e2] = _qmul_np(QQ[k], Q[e1])
                flags[e2] = True
                count += 1
                span_flag = True
            elif flags[e2] and not flags[e1]:
                if e1 >= f:
                    # reference negates w only (-conj, same rotation)
                    qq_inv = QQ[k].copy()
                    qq_inv[3] = -qq_inv[3]
                    Q[e1] = _qmul_np(qq_inv, Q[e2])
                flags[e1] = True
                count += 1
                span_flag = True
        if not span_flag and count < n:
            raise DisconnectedGraphError(count, n)
    return Q

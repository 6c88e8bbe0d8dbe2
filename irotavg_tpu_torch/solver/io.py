# Copied verbatim from irotavg_tpu/solver/io.py (numpy only; deduplicate once irotavg_tpu imports lazily).
"""Problem-file IO compatible with the reference batch CLI.

Format (ral/test.cpp:89-131):
    m n f
    <m lines>  i j w x y z     (relative rotation of edge i->j, i<j)
    <n lines>  w x y z         (absolute rotations; >= f lines required)

Vertex ids are remapped to contiguous 0..n-1 by sorted order, exactly as the
reference does (ral/test.cpp:203-215).  Output file: n rotation rows
``w x y z`` then m weight rows (ral/test.cpp:314-326).
"""

from __future__ import annotations

import gzip

import numpy as np


def read_problem(path):
    """Parse a problem file (plain text or ``.gz``-compressed).

    Returns dict with: edges (m,2) int32 (remapped), QQ (m,4) [x y z w],
    Q (n,4) [x y z w] (zeros where absent), f int, n_abs_given int.
    """
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        tokens = fh.read().split()
    it = iter(tokens)
    m = int(next(it))
    n = int(next(it))
    f = int(next(it))

    edges = np.zeros((m, 2), np.int64)
    QQ = np.zeros((m, 4), np.float64)
    for k in range(m):
        e1 = int(next(it))
        e2 = int(next(it))
        w, x, y, z = (float(next(it)) for _ in range(4))
        edges[k] = (e1, e2)
        QQ[k] = (x, y, z, w)

    # Remap vertex ids to contiguous indices by sorted order.
    verts = np.unique(edges)
    remap = {int(v): i for i, v in enumerate(verts)}
    edges = np.vectorize(lambda v: remap[int(v)])(edges).astype(np.int32)

    Q = np.zeros((n, 4), np.float64)
    n_abs = 0
    try:
        while n_abs < n:
            w = float(next(it))
            x, y, z = (float(next(it)) for _ in range(3))
            Q[n_abs] = (x, y, z, w)
            n_abs += 1
    except StopIteration:
        pass

    if n_abs < f:
        raise ValueError(
            f"Insufficient absolute rotations: got {n_abs}, need at least {f}"
        )
    if n != int(edges[:, 1].max()) + 1:
        raise ValueError("Corrupt input file: check abs rotations")
    return {"edges": edges, "QQ": QQ, "Q": Q, "f": f, "n_abs_given": n_abs}


def write_solution(path, Q, weights):
    """Write rotations (``w x y z`` rows, full precision) then weights."""
    Q = np.asarray(Q)
    wxyz = np.stack([Q[:, 3], Q[:, 0], Q[:, 1], Q[:, 2]], axis=1)
    with open(path, "w") as fh:
        for row in wxyz:
            fh.write(" ".join(f"{v:.17g}" for v in row) + "\n")
        for v in np.asarray(weights):
            fh.write(f"{v:.17g}\n")

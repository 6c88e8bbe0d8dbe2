"""A rotation-averaging problem file, and relabellings of it from the seed.

The file format is the upstream ``l1_irls``'s (ral/test.cpp:89-131):
``m n f``, then ``m`` lines ``i j w x y z`` (edge ``i -> j``, ``i < j``),
then the given absolute rotations ``w x y z``.  Vertex ids are renumbered
by sorted order, as the upstream reader does.  Quaternions come out as
``[x y z w]`` rows.

A relabelling keeps vertex 0 (the fixed gauge, which holds the given
absolute rotation) and the edge order, and permutes the other vertices'
numbers; an edge whose ends swap order is stored the other way round with
its inverse rotation.  So every seed poses the same problem, with the same
spanning tree and the same work, under other numbers and a permuted
normal-equation matrix.  Seed 0 keeps the file's numbers.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib

import numpy as np

from gen.ring_orbit import seed_rng


@dataclasses.dataclass
class Problem:
    edges: np.ndarray     # (m, 2) int64, i < j
    QQ: np.ndarray        # (m, 4) [x y z w]
    Q: np.ndarray         # (n, 4) [x y z w], zeros where not given
    f: int                # leading rotations held fixed
    n_abs: int            # absolute rotations given
    perm: np.ndarray      # (n,) file vertex -> this problem's vertex


def read(path: str, sha256: str | None = None) -> Problem:
    with open(path, "rb") as fh:
        raw = fh.read()
    if sha256 is not None and hashlib.sha256(raw).hexdigest() != sha256:
        raise ValueError(f"{path}: sha256 differs from the configuration's")
    if path.endswith(".gz"):
        raw = gzip.decompress(raw)
    tok = raw.split()
    m, n, f = int(tok[0]), int(tok[1]), int(tok[2])
    body = np.array(tok[3:3 + 6 * m], dtype=np.float64).reshape(m, 6)
    ids = body[:, :2].astype(np.int64)
    QQ = body[:, [3, 4, 5, 2]].copy()
    verts, edges = np.unique(ids, return_inverse=True)
    edges = edges.reshape(m, 2)
    rest = np.array(tok[3 + 6 * m:], dtype=np.float64)
    n_abs = min(len(rest) // 4, n)
    Q = np.zeros((n, 4))
    Q[:n_abs] = rest[:4 * n_abs].reshape(n_abs, 4)[:, [1, 2, 3, 0]]
    if n_abs < f:
        raise ValueError(f"{path}: {n_abs} absolute rotations for f = {f}")
    return Problem(edges=edges, QQ=QQ, Q=Q, f=f, n_abs=n_abs,
                   perm=np.arange(n))


def relabel(p: Problem, rng) -> Problem:
    n = len(p.Q)
    perm = np.concatenate([[0], 1 + rng.permutation(n - 1)])
    e = perm[p.edges]
    QQ = p.QQ.copy()
    flip = e[:, 0] > e[:, 1]
    e[flip] = e[flip][:, ::-1]
    QQ[flip, :3] *= -1
    Q = np.zeros_like(p.Q)
    Q[perm] = p.Q
    return Problem(edges=e, QQ=QQ, Q=Q, f=p.f, n_abs=p.n_abs, perm=perm)


def generate(traffic: dict, path: str, sha256: str, seed: int):
    """The file's problem and ``traffic["relabellings"]`` relabellings of
    it drawn from ``seed`` (the file's numbers for seed 0)."""
    base = read(path, sha256)
    if int(seed) == 0:
        return [base]
    rng = seed_rng(seed)
    return [relabel(base, rng) for _ in range(traffic["relabellings"])]

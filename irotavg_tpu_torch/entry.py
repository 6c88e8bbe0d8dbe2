"""The flagship step on PyTorch: one robust IRLS rotation-averaging
iteration on a padded view graph, the twin of the JAX package's
``__graft_entry__.entry()``.

``entry(device=None)`` returns ``(fn, args)``; ``fn(*args)`` is
``solver.irls.irls_step`` (dense backend, f32) on a small deterministic
chain-plus-chords problem.  The device is the card unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np


def _tiny_problem(n_nodes=24, m_pad=64, dtype=np.float32):
    """Small deterministic chain+chords SO(3) problem: padded ``edges``,
    ``QQ``, the warm start ``Q0`` (node 0 at its true rotation, the rest
    identity) and ``edge_mask`` (a numpy copy of
    ``__graft_entry__._tiny_problem``)."""
    rng = np.random.default_rng(0)

    def qmul(a, b):
        x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ], axis=-1)

    v = rng.normal(size=(n_nodes, 4))
    Q_gt = v / np.linalg.norm(v, axis=1, keepdims=True)
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    edges += [(i, i + 3) for i in range(n_nodes - 3)]
    edges = np.array(edges, np.int32)
    qi = Q_gt[edges[:, 0]].copy()
    qi[:, :3] *= -1  # conj
    QQ = qmul(Q_gt[edges[:, 1]], qi)
    Q0 = np.zeros((n_nodes, 4))
    Q0[:, 3] = 1.0
    Q0[0] = Q_gt[0]
    m = len(edges)
    edge_mask = np.zeros(m_pad, bool)
    edge_mask[:m] = True
    edges_p = np.zeros((m_pad, 2), np.int32)
    edges_p[:m] = edges
    QQ_p = np.zeros((m_pad, 4), dtype)
    QQ_p[:, 3] = 1.0
    QQ_p[:m] = QQ
    return edges_p, QQ_p, Q0.astype(dtype), edge_mask


def entry(device=None):
    """(fn, example_args) — one IRLS step: ``fn(g, weights)`` returns
    ``(new_Q, new_weights, score)``."""
    import torch

    from irotavg_tpu_torch.device import pick_device
    from irotavg_tpu_torch.solver.graph import RotationGraph
    from irotavg_tpu_torch.solver.irls import IRLSConfig, irls_step

    dev = pick_device(device)
    edges, QQ, Q0, edge_mask = _tiny_problem()
    g = RotationGraph.create(edges, QQ, Q0, f=1, edge_mask=edge_mask,
                             device=dev)
    weights = torch.ones(g.m, dtype=g.dtype, device=dev)
    cfg = IRLSConfig(backend="dense")

    def fn(g, weights):
        return irls_step(g, weights, cfg)

    return fn, (g, weights)

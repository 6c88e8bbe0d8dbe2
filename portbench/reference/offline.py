"""Plain reference of one offline job (the ``irotavg_batch`` pipeline).

Everything an offline job is held to, from what the benchmark drew and
what the program handed back, in plain PyTorch in f64 on the CPU
(TensorFloat-32 off while it computes, and restored after):

- :func:`plan`: the job's plan from the program's own consecutive flows:
  greedy keyframe thinning (a frame becomes a keyframe once the flow
  accumulated since the last one reaches the gate), the window pairs
  ``(b - k, b)`` of the keyframes for ``k`` up to the window, and each
  pair's search radius ``clip(1.25 * flow between them + 30, 45, 512)``;
- :func:`edge_errors_deg`: each edge's relative rotation against the
  renderer's scene (edge ``(a, b)`` carries ``R_b = R_ab R_a`` of the
  world-to-camera rotations);
- :func:`revisits`: the ground-truth revisits, a keyframe half a lap or
  more back whose camera points within a few degrees;
- :func:`resolve`: stage 5 again from the program's own edges and
  relative rotations, by the benchmark's plain solver
  (``reference/rotavg.py``: its spanning-tree start, L1-RA, IRLS).

The final rotations' RMS error after the best gauge is
``reference/scene.py:rotation_errors_deg``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from reference import rotavg

F64 = torch.float64


@contextlib.contextmanager
def exact():
    """TensorFloat-32 off for the block, the flags restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def plan(flows, gate_px: float, win: int):
    """``(keyframes, pairs, radii)``: source frame of each keyframe,
    ``(P, 2)`` keyframe-index pairs ``(a, b)`` in the order ``b`` then
    ``b - a``, and ``(P,)`` f32 radii in pixels, from the ``(B - 1,)``
    mean displacement of each consecutive frame pair."""
    keyframes, since, acc = [0], [], 0.0
    for i, f in enumerate(np.asarray(flows).tolist(), start=1):
        acc += f
        if acc >= gate_px:
            keyframes.append(i)
            since.append(acc)
            acc = 0.0
    cum = [0.0]
    for s in since:
        cum.append(cum[-1] + s)
    pairs, radii = [], []
    for b in range(1, len(keyframes)):
        for a in range(b - 1, max(b - win, 0) - 1, -1):
            pairs.append((a, b))
            radii.append(min(max(1.25 * (cum[b] - cum[a]) + 30.0, 45.0),
                             512.0))
    return (keyframes, np.asarray(pairs, np.int64).reshape(-1, 2),
            np.asarray(radii, np.float32))


def _rotmat(q):
    """``[x y z w]`` rows -> ``(N, 3, 3)``, normalised."""
    q = q / q.norm(dim=1, keepdim=True)
    x, y, z, w = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def _angle_deg(Ra, Rb):
    """Angle of ``Ra Rb^T`` from the chordal distance (keeps its digits at
    small angles)."""
    d = (Ra - Rb).flatten(1).norm(dim=1) / (2.0 * math.sqrt(2.0))
    return torch.rad2deg(2.0 * torch.asin(d.clamp(0.0, 1.0)))


def edge_errors_deg(edges, QQ, R):
    """``(M,)`` degrees by which each edge's relative rotation ``QQ (M,
    4)`` misses the ground truth ``R_b R_a^T``; ``R (K, 3, 3)`` the
    world-to-camera rotation of each keyframe."""
    with exact():
        e = torch.as_tensor(np.asarray(edges, np.int64)).reshape(-1, 2)
        Rt = torch.as_tensor(np.asarray(R), dtype=F64)
        est = _rotmat(torch.as_tensor(np.asarray(QQ), dtype=F64))
        truth = Rt[e[:, 1]] @ Rt[e[:, 0]].transpose(1, 2)
        return _angle_deg(est, truth).numpy()


def revisits(frames, R, frames_per_lap: float, within_deg: float):
    """``(K, K)`` bool, ``[j, i]`` where keyframe ``j`` (source frame
    ``frames[j]``) revisits keyframe ``i``: half a lap or more back, with
    cameras pointing within ``within_deg``."""
    with exact():
        f = torch.as_tensor(np.asarray(frames, np.float64))
        Rt = torch.as_tensor(np.asarray(R), dtype=F64)
        far = (f[:, None] - f[None, :]) >= frames_per_lap / 2.0
        K = len(f)
        near = _angle_deg(Rt[:, None].expand(K, K, 3, 3).reshape(-1, 3, 3),
                          Rt[None].expand(K, K, 3, 3).reshape(-1, 3, 3))
        return (far & (near.reshape(K, K) <= within_deg)).numpy()


def resolve(edges, QQ, K: int, solver: dict):
    """Stage 5 of the job from its edges and relative rotations: keyframe
    0 fixed at the identity, the spanning-tree start, L1-RA, then IRLS
    (``solver``: the configuration's ``sigma_deg``, ``l1_iters``,
    ``irls_iters``, ``change_th``).  ``(K, 4)`` normalised rotations."""
    Q0 = np.zeros((K, 4))
    Q0[0] = (0.0, 0.0, 0.0, 1.0)
    edges = np.asarray(edges, np.int64)
    QQ = np.asarray(QQ, np.float64)
    Q0 = rotavg.init_mst(Q0, QQ, edges, 1)
    _, Q, _ = rotavg.solve(QQ, edges, Q0, 1,
                           sigma=math.radians(solver["sigma_deg"]),
                           l1_iters=solver["l1_iters"],
                           irls_iters=solver["irls_iters"],
                           change_th=solver["change_th"])
    return Q

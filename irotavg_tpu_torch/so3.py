"""Batched SO(3) / quaternion functions on torch tensors.

Port of ``irotavg_tpu/so3.py``.  Quaternions are ``[x, y, z, w]`` rows,
Hamilton product, ``R(qmul(a, b)) = R(a) @ R(b)``.  Every function is
shape-polymorphic over leading axes and keeps the reference's guards:
``exp_map`` maps zero-angle rows to the identity and ``log_map`` wraps the
angle to [-pi, pi) and zeroes rows with ``|xyz| < EPS``.
"""

from __future__ import annotations

import math

import torch

from irotavg_tpu_torch import prng

# Machine-epsilon guard of the reference solver (ral/l1_irls.hpp:39).
EPS = 2.2204e-16

__all__ = [
    "EPS", "qmul", "qconj", "qinv_flipw", "qnormalize", "qidentity",
    "exp_map", "log_map", "delta_rel", "quat_to_rotmat", "rotmat_to_quat",
    "qangle", "qgeodesic", "random_quat",
]


def qidentity(shape=(), dtype=torch.float32, device=None):
    """Identity quaternion(s) ``[0, 0, 0, 1]`` with leading ``shape``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def qmul(q1, q2):
    """Hamilton product of ``[x y z w]`` quaternions; broadcasts."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def qconj(q):
    """Proper conjugate ``[-x, -y, -z, w]``."""
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def qinv_flipw(q):
    """Reference-style 'inverse': negate w only (= ``-conj(q)``)."""
    return q * q.new_tensor([1.0, 1.0, 1.0, -1.0])


def qnormalize(q, eps=0.0):
    """Normalise quaternion rows to unit norm."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=max(eps, 1e-300))


def exp_map(v):
    """Rows ``[v1 v2 v3 (*)]`` -> unit quaternions; zero rows -> identity."""
    v = v[..., :3]
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = 0.5 * theta
    pos = theta > 0
    safe_theta = torch.where(pos, theta, torch.ones_like(theta))
    coef = torch.where(pos, torch.sin(half) / safe_theta,
                       torch.zeros_like(theta))
    return torch.cat([v * coef, torch.cos(half)], dim=-1)


def log_map(q):
    """Quaternion rows -> ``[r*theta, theta]`` with theta in [-pi, pi)."""
    xyz = q[..., :3]
    w = q[..., 3]
    s2 = torch.linalg.vector_norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(s2, w)
    theta = torch.where(theta < -math.pi, theta + 2.0 * math.pi, theta)
    theta = torch.where(theta >= math.pi, theta - 2.0 * math.pi, theta)
    small = s2 < EPS
    safe_s2 = torch.where(small, torch.ones_like(s2), s2)
    scale = torch.where(small, torch.zeros_like(s2), theta / safe_s2)
    return torch.cat([xyz * scale[..., None], theta[..., None]], dim=-1)


def take_rows(x, idx):
    """Rows ``x[idx]`` of ``x (n, k)``; with leading batch dims, the rows
    of each ``x[b] (n, k)`` at ``idx[b] (m,)``."""
    if x.dim() == 2:
        return x[idx]
    idx = idx.expand(*x.shape[:-2], idx.shape[-1])
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def delta_rel(edges, QQ, Q):
    """Per-edge residual ``qinv(Q[j]) * QQ[k] * Q[i]`` (batch dims lead)."""
    qi = take_rows(Q, edges[..., 0])
    qj_inv = qinv_flipw(take_rows(Q, edges[..., 1]))
    return qmul(qj_inv, qmul(QQ, qi))


def quat_to_rotmat(q):
    """Unit quaternion rows -> ``(..., 3, 3)`` rotation matrices."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rotmat_to_quat(R):
    """``(..., 3, 3)`` rotation matrices -> unit quaternion rows, with the
    reference's branchless Shepperd selection."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def nz(s):
        return torch.where(s > 0, s, torch.ones_like(s))

    s = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 2.0
    qw = torch.stack([(R[..., 2, 1] - R[..., 1, 2]) / nz(s),
                      (R[..., 0, 2] - R[..., 2, 0]) / nz(s),
                      (R[..., 1, 0] - R[..., 0, 1]) / nz(s),
                      0.25 * s], dim=-1)
    s = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 2.0
    d = nz(s)
    qx = torch.stack([0.25 * s,
                      (R[..., 0, 1] + R[..., 1, 0]) / d,
                      (R[..., 0, 2] + R[..., 2, 0]) / d,
                      (R[..., 2, 1] - R[..., 1, 2]) / d], dim=-1)
    s = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) * 2.0
    d = nz(s)
    qy = torch.stack([(R[..., 0, 1] + R[..., 1, 0]) / d,
                      0.25 * s,
                      (R[..., 1, 2] + R[..., 2, 1]) / d,
                      (R[..., 0, 2] - R[..., 2, 0]) / d], dim=-1)
    s = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) * 2.0
    d = nz(s)
    qz = torch.stack([(R[..., 0, 2] + R[..., 2, 0]) / d,
                      (R[..., 1, 2] + R[..., 2, 1]) / d,
                      0.25 * s,
                      (R[..., 1, 0] - R[..., 0, 1]) / d], dim=-1)
    use_w = (tr > 0)[..., None]
    use_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    use_y = (m11 >= m22)[..., None]
    q = torch.where(use_w, qw,
                    torch.where(use_x, qx, torch.where(use_y, qy, qz)))
    return qnormalize(q)


def qangle(q):
    """Rotation angle in radians of quaternion rows, in [0, pi]."""
    xyz = torch.linalg.vector_norm(q[..., :3], dim=-1)
    return 2.0 * torch.atan2(xyz, torch.abs(q[..., 3]))


def qgeodesic(q1, q2):
    """Geodesic angle between two unit quaternions (radians, [0, pi])."""
    return qangle(qmul(qconj(q1), q2))


def random_quat(key, shape=(), dtype=torch.float32, device=None):
    """Uniformly distributed unit quaternions (Shoemake) from the host key
    ``key`` (``prng.key``): the reference's quaternions for the same key,
    from ``jax.random.uniform``'s numbers (float32 or float64)."""
    u = prng.uniform(key, tuple(shape) + (3,), dtype, device)
    u1, u2, u3 = u.unbind(-1)
    a = torch.sqrt(1.0 - u1)
    b = torch.sqrt(u1)
    t2 = 2.0 * math.pi * u2
    t3 = 2.0 * math.pi * u3
    return torch.stack([a * torch.sin(t2), a * torch.cos(t2),
                        b * torch.sin(t3), b * torch.cos(t3)], dim=-1)

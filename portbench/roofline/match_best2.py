"""The work a gated best-2 Hamming call needs, from its inputs.

``best2(desc1, desc2, rowf, colf, gate)``: descriptors ``([B,] N, 8)``
int32 words (256 bits), gate features ``([B,] N, 8)`` f32 (rows: valid,
node, x, y, octave, threshold or radius; columns: valid, node, x, y,
octave, epipolar line a, b, c); a 2-D ``desc2`` / ``colf`` is one column
frame shared by the batch.  The work is the descriptor pairs that the
gate admits, each a 256-bit comparison counted as 2 * 256 operations on
the int8 tensor cores; the bytes are every input read once and the
outputs (two f32 distances and an int32 index a row) written once.
"""

from __future__ import annotations

from pbkit import peaks

OPS_PER_PAIR = 2 * 256


def admitted(gate: str, rowf, colf):
    """Pairs the gate admits: the upstream matcher's rules (valid on both
    sides; the same vocabulary node for ``node`` / ``epipolar``; within
    the row's radius and two octaves for ``local``; the row's point within
    its threshold of the column's epipolar line for ``epipolar*``)."""
    import torch

    r = rowf[..., :, None, :]
    c = colf[..., None, :, :]
    ok = (r[..., 0] > 0) & (c[..., 0] > 0)
    if gate in ("node", "epipolar"):
        ok &= r[..., 1] == c[..., 1]
    if gate == "local":
        rad = r[..., 5]
        ok &= torch.abs(c[..., 2] - r[..., 2]) <= rad
        ok &= torch.abs(c[..., 3] - r[..., 3]) <= rad
        ok &= ((c[..., 4] >= torch.clamp(r[..., 4] - 2, min=0))
               & (c[..., 4] <= torch.clamp(r[..., 4] + 2, max=7)))
    elif gate in ("epipolar", "epipolar_nonode"):
        a, b, cc = c[..., 5], c[..., 6], c[..., 7]
        num = a * r[..., 2] + b * r[..., 3] + cc
        ok &= num * num < r[..., 5] * (a * a + b * b)
    if ok.dim() == 2:
        ok = ok[None]
    return ok


def work(desc1, desc2, rowf, colf, gate):
    """(operations, bytes) of one call."""
    pairs = int(admitted(gate, rowf, colf).sum())
    B = desc1.shape[0] if desc1.dim() == 3 else 1
    nbytes = sum(t.numel() * t.element_size()
                 for t in (desc1, desc2, rowf, colf))
    nbytes += B * desc1.shape[-2] * 12
    return OPS_PER_PAIR * pairs, nbytes


def least_s(args, kwargs):
    names = ("desc1", "desc2", "rowf", "colf", "gate")
    a = dict(zip(names, args), **kwargs)
    ops, nbytes = work(**a)
    return max(ops / peaks.INT8_TC_OPS, nbytes / peaks.HBM_BYTES)

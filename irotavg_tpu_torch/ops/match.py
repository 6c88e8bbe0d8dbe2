"""Gated best-2 Hamming matcher: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``irotavg_tpu/ops/match_pallas.py``.  The TPU kernel
(``_make_kernel``, launched by ``_fused_best2_padded``) is replaced by
``csrc/match_best2.cu``: integer XOR + popcount over the eight 32-bit
words of a 256-bit ORB descriptor with a running per-row top-2.  It is
integer-ALU bound (8 XOR + 8 POPC per pair, about N1*N2*B*16 operations)
and reads few bytes: column tiles are staged once per block in shared
memory.

Descriptors are ``(N, 8)`` int32 tensors holding the reference's uint32
word bit patterns.  Per-row and per-column gate features are ``(N, 8)``
f32 blocks (``make_rowf`` / ``make_colf``; the column block is NOT
transposed, unlike the reference's ``make_colft``).  Every function takes
an optional leading batch axis ``B``.

:func:`best2` dispatches on the device of its tensors only: CPU tensors
go to :func:`best2_plain`, CUDA tensors launch the kernel or raise.  Each
launch adds one to ``best2.launches`` and to ``best2.launches_by_gate``
under its gate.
"""

from __future__ import annotations

import ctypes
import functools

import torch

BIG = 10_000.0
GATES = ("none", "node", "local", "epipolar", "epipolar_nonode")

# rowf columns: 0 valid, 1 node, 2 gx/x1, 3 gy/y1, 4 octave, 5 th/radius
# colf columns: 0 valid, 1 node, 2 x2, 3 y2, 4 octave, 5 a, 6 b, 7 c
FEAT_W = 8


def _block(cols, valid):
    valid = torch.as_tensor(valid)
    out = torch.zeros(valid.shape + (FEAT_W,), dtype=torch.float32,
                      device=valid.device)
    for k, v in cols.items():
        if v is not None:
            out[..., k] = torch.as_tensor(v, device=valid.device).to(
                torch.float32)
    return out


def make_rowf(valid, node=None, x=None, y=None, octave=None, th=None):
    """([B,] N, 8) f32 per-row feature block."""
    return _block({0: valid, 1: node, 2: x, 3: y, 4: octave, 5: th}, valid)


def make_colf(valid, node=None, x=None, y=None, octave=None,
              a=None, b=None, c=None):
    """([B,] N, 8) f32 per-column feature block (untransposed)."""
    return _block({0: valid, 1: node, 2: x, 3: y, 4: octave, 5: a, 6: b,
                   7: c}, valid)


def unpack_pm1(desc):
    """(..., N, 8) int32 words -> (..., N, 256) ±1 f32 rows; bit b of word
    w maps to column ``32*w + b``."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., None] >> shifts) & 1
    bits = bits.reshape(desc.shape[:-1] + (256,))
    return 2.0 * bits.to(torch.float32) - 1.0


def gate_mask(gate: str, rowf, colf):
    """(..., N1, N2) bool gate, the reference's ``_tile_mask`` with every
    product and sum rounded separately."""
    r = rowf[..., :, None, :]
    c = colf[..., None, :, :]
    mask = (r[..., 0] > 0) & (c[..., 0] > 0)
    if gate in ("node", "epipolar"):
        mask &= r[..., 1] == c[..., 1]
    if gate == "local":
        rad = r[..., 5]
        mask &= torch.abs(c[..., 2] - r[..., 2]) <= rad
        mask &= torch.abs(c[..., 3] - r[..., 3]) <= rad
        o1, o2 = r[..., 4], c[..., 4]
        mask &= (o2 >= torch.clamp(o1 - 2, min=0)) & \
                (o2 <= torch.clamp(o1 + 2, max=7))
    elif gate in ("epipolar", "epipolar_nonode"):
        a, b, cc = c[..., 5], c[..., 6], c[..., 7]
        num = a * r[..., 2] + b * r[..., 3] + cc
        den = a * a + b * b
        mask &= num * num < r[..., 5] * den
    return mask


def best2_plain(desc1, desc2, rowf, colf, gate: str):
    """Plain PyTorch version: ``128 - ½·(pm1 @ pm1ᵀ)`` in f32 (exact),
    the gate, a first-occurrence argmin, and ``d2`` as the min with the
    argmin column masked.  Returns (d1, d2, idx): f32, f32, int32."""
    pm1 = unpack_pm1(desc1)
    pm2 = unpack_pm1(desc2)
    D = 128.0 - 0.5 * (pm1 @ pm2.transpose(-1, -2))
    D = torch.where(gate_mask(gate, rowf, colf), D, torch.full_like(D, BIG))
    d1, i1 = torch.min(D, dim=-1)
    # torch.min's index among equal minima is not promised to be the
    # first: take the first column that attains d1 explicitly
    cols = torch.arange(D.shape[-1], device=D.device)
    i1 = torch.where(D == d1[..., None], cols, D.shape[-1]).amin(dim=-1)
    D2 = D.scatter(-1, i1[..., None], BIG)
    d2 = D2.amin(dim=-1)
    idx = torch.where(d1 >= BIG, torch.full_like(i1, -1), i1)
    return d1, d2, idx.to(torch.int32)


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib():
    from irotavg_tpu_torch.kernels.build import load

    lib = load("match_best2")
    fn = lib.match_best2
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def best2(desc1, desc2, rowf, colf, gate: str):
    """Per-row (d1, d2, idx) over gated columns; see module doc.

    ``desc1`` (B, N1, 8) or (N1, 8) int32; ``desc2`` (B, N2, 8) or (N2, 8)
    int32; ``rowf`` / ``colf`` matching f32 blocks.  CPU tensors run
    :func:`best2_plain`; CUDA tensors launch ``match_best2``.
    """
    if gate not in GATES:
        raise ValueError(f"unknown gate {gate!r}")
    if desc1.device.type == "cpu":
        return best2_plain(desc1, desc2, rowf, colf, gate)
    if desc1.device.type != "cuda":
        raise ValueError(f"best2 has no kernel for device {desc1.device}")
    squeeze = desc1.dim() == 2
    if squeeze:
        desc1, desc2 = desc1[None], desc2[None]
        rowf, colf = rowf[None], colf[None]
    B, n1 = desc1.shape[0], desc1.shape[1]
    n2 = desc2.shape[1]
    dev = desc1.device
    _check(desc1, "desc1", torch.int32, (B, n1, 8), dev)
    _check(desc2, "desc2", torch.int32, (B, n2, 8), dev)
    _check(rowf, "rowf", torch.float32, (B, n1, FEAT_W), dev)
    _check(colf, "colf", torch.float32, (B, n2, FEAT_W), dev)
    d1 = torch.empty((B, n1), dtype=torch.float32, device=dev)
    d2 = torch.empty((B, n1), dtype=torch.float32, device=dev)
    idx = torch.empty((B, n1), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(desc1.data_ptr(), desc2.data_ptr(), rowf.data_ptr(),
                 colf.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                 idx.data_ptr(), B, n1, n2, GATES.index(gate), stream)
    if err != 0:
        raise RuntimeError(f"match_best2 launch failed: CUDA error {err}")
    best2.launches += 1
    best2.launches_by_gate[gate] += 1
    if squeeze:
        return d1[0], d2[0], idx[0]
    return d1, d2, idx


def reset_launch_counts() -> None:
    """Zero the kernel launch counters of :func:`best2`."""
    best2.launches = 0
    best2.launches_by_gate = dict.fromkeys(GATES, 0)


# kernel launches made by best2, in total and per gate (read and reset by
# chip_smoke.py)
reset_launch_counts()

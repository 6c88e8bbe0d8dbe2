"""Gated best-2 Hamming matcher: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``irotavg_tpu/ops/match_pallas.py``.  The TPU kernel
(``_make_kernel``, launched by ``_fused_best2_padded``) is replaced by
``csrc/match_best2.cu``: descriptors expanded to ±1 int8 and multiplied
on the tensor cores (``dot = 256 - 2h`` exactly), the gate and a running
top-2 in the epilogue, the columns of each 64-row tile split over a
cluster of 8 blocks that merge through distributed shared memory.  Its
bound (:func:`bound_ms`) is the int8 tensor-core rate; the per-pair
epilogue sets its pace.

Descriptors are ``(N, 8)`` int32 tensors holding the reference's uint32
word bit patterns.  Per-row and per-column gate features are ``(N, 8)``
f32 blocks (``make_rowf`` / ``make_colf``; the column block is NOT
transposed, unlike the reference's ``make_colft``).  Every function takes
an optional leading batch axis ``B``; with it, ``desc2`` and ``colf`` may
each be a shared ``(N2, 8)`` frame.

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

# the kernel's geometry (checked against match_best2_geometry at load):
# rows per block, column chunks per row tile (one cluster), columns per
# staged tile, and the largest N2 (the column index has 22 bits)
ROWS_PER_BLOCK = 64
COL_SPLIT = 8
COL_TILE = 64
MAX_COLS = (1 << 22) - 1

# published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet)
H100_INT8_OPS_PER_S = 1979e12
H100_HBM_BYTES_PER_S = 3.35e12


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
    argmin column masked; a shared (N2, 8) ``desc2`` or ``colf``
    broadcasts over the batch.  A batch entry with no valid row is not
    computed: its rows get what no admitted pair gives, ``BIG``, ``BIG``
    and -1.  Returns (d1, d2, idx): f32, f32, int32."""
    if desc1.dim() == 3:
        live = (rowf[..., 0] > 0).any(dim=-1)
        if not bool(live.all()):
            d1 = torch.full(desc1.shape[:2], BIG, device=desc1.device)
            d2 = d1.clone()
            idx = torch.full_like(d1, -1, dtype=torch.int32)
            sel = live.nonzero().squeeze(1)
            if sel.numel():
                def lanes(t):
                    return t[sel] if t.dim() == 3 else t
                d1[sel], d2[sel], idx[sel] = best2_plain(
                    desc1[sel], lanes(desc2), rowf[sel], lanes(colf), gate)
            return d1, d2, idx
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


def best2_work(B, n1, n2):
    """(operations, bytes) of one launch with a column frame per batch
    entry.  Operations: the ±1 int8 product, 2·256 a (row, column) pair.
    Bytes: every input read once (32 B of words and 32 B of features a
    descriptor) and every output written once (12 B a row)."""
    ops = 2 * 256 * B * n1 * n2
    nbytes = B * (n1 + n2) * (32 + 4 * FEAT_W) + B * n1 * 12
    return ops, nbytes


def bound_ms(B, n1, n2):
    """(ms, "operations" or "bytes"): the least time one H100 could take
    for a launch, the larger of its operations at the int8 tensor-core
    peak and its bytes at the HBM rate (:func:`best2_work`)."""
    ops, nbytes = best2_work(B, n1, n2)
    t_ops = ops / H100_INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _check(t, name, dtype, shapes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected one "
                         f"of {shapes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _lib():
    from irotavg_tpu_torch.kernels.build import load

    lib = load("match_best2")
    geo = (ctypes.c_int * 4)()
    lib.match_best2_geometry(geo)
    want = (ROWS_PER_BLOCK, COL_SPLIT, COL_TILE, MAX_COLS)
    if tuple(geo) != want:
        raise RuntimeError(f"match_best2 geometry {tuple(geo)} differs from "
                           f"ops/match.py's {want}")
    fn = lib.match_best2
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def best2_launcher(desc1, desc2, rowf, colf, gate: str):
    """Check CUDA inputs once and allocate the outputs: returns
    ``(launch, (d1, d2, idx))``, where each ``launch()`` runs the kernel
    into those outputs and counts one launch.  :func:`best2` is one such
    launch; ``chip_smoke.py`` times back-to-back launches with it."""
    if gate not in GATES:
        raise ValueError(f"unknown gate {gate!r}")
    if desc1.device.type != "cuda":
        raise ValueError(f"match_best2 has no kernel for device "
                         f"{desc1.device}")
    squeeze = desc1.dim() == 2
    if squeeze:
        desc1, desc2, rowf, colf = (x[None] for x in (desc1, desc2, rowf,
                                                       colf))
    B, n1 = desc1.shape[0], desc1.shape[1]
    n2 = desc2.shape[-2]
    if n2 > MAX_COLS:
        raise ValueError(f"match_best2 takes at most {MAX_COLS} columns, "
                         f"got {n2}")
    dev = desc1.device
    _check(desc1, "desc1", torch.int32, [(B, n1, 8)], dev)
    _check(desc2, "desc2", torch.int32, [(B, n2, 8), (n2, 8)], dev)
    _check(rowf, "rowf", torch.float32, [(B, n1, FEAT_W)], dev)
    _check(colf, "colf", torch.float32, [(B, n2, FEAT_W), (n2, FEAT_W)],
           dev)
    # batch strides in elements; 0 for a shared column frame
    s_desc2 = n2 * 8 if desc2.dim() == 3 else 0
    s_colf = n2 * FEAT_W if colf.dim() == 3 else 0
    d1 = torch.empty((B, n1), dtype=torch.float32, device=dev)
    d2 = torch.empty((B, n1), dtype=torch.float32, device=dev)
    idx = torch.empty((B, n1), dtype=torch.int32, device=dev)
    args = (desc1.data_ptr(), desc2.data_ptr(), rowf.data_ptr(),
            colf.data_ptr(), d1.data_ptr(), d2.data_ptr(), idx.data_ptr(),
            B, n1, n2, GATES.index(gate), s_desc2, s_colf,
            torch.cuda.current_stream(dev).cuda_stream)
    fn = _lib()

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"match_best2 launch failed: CUDA error "
                               f"{err}")
        count_launch(gate)

    out = (d1[0], d2[0], idx[0]) if squeeze else (d1, d2, idx)
    return launch, out


def best2(desc1, desc2, rowf, colf, gate: str):
    """Per-row (d1, d2, idx) over gated columns; see module doc.

    ``desc1`` (B, N1, 8) or (N1, 8) int32; ``desc2`` (B, N2, 8) or (N2, 8)
    int32, the latter shared by the batch; ``rowf`` / ``colf`` matching
    f32 blocks (``colf`` likewise shared or not).  CPU tensors run
    :func:`best2_plain`; CUDA tensors launch ``match_best2``.
    """
    if gate not in GATES:
        raise ValueError(f"unknown gate {gate!r}")
    if desc1.device.type == "cpu":
        return best2_plain(desc1, desc2, rowf, colf, gate)
    launch, out = best2_launcher(desc1, desc2, rowf, colf, gate)
    launch()
    return out


def count_launch(gate: str) -> None:
    """Count one launch of the kernel under ``gate`` (a launch made by
    :func:`best2_launcher`'s ``launch``, or one replayed in a CUDA graph
    that captured such a launch)."""
    best2.launches += 1
    best2.launches_by_gate[gate] += 1


def reset_launch_counts() -> None:
    """Zero the kernel launch counters of :func:`best2`."""
    best2.launches = 0
    best2.launches_by_gate = dict.fromkeys(GATES, 0)


# kernel launches made by best2 and best2_launcher or replayed, in total
# and per gate (read and reset by chip_smoke.py)
reset_launch_counts()

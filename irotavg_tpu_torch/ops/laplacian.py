"""The solver's two fused Laplacian kernels, their wrappers, plain PyTorch
versions and per-graph plans.

* :func:`laplacian_matvec`: the CG matvec ``y = free ⊙ Aᵀ(c ⊙
  edge_mask ⊙ A(free ⊙ x))`` in one launch for every four columns, for
  ``x (*B, n, k)`` and ``c (*B, m, 1|k)``.
* :func:`laplacian_assemble`: the dense ``A' diag(coef) A`` with 1 on
  fixed and ``ridge`` on free diagonals, ``(*B, n, n)``, in one launch.

Both are the reference's XLA gathers and ``.at[].add`` scatters
(``irotavg_tpu/solver/graph.py``: ``incidence_matvec`` /
``incidence_rmatvec`` and ``laplacian_dense``) fused by hand, in the
fixed order of ``ops/segment.py``: every output adds its terms from 0.0
in the order in which the port's unfused composition (gathers, then a
sorted segment sum) adds them, so each kernel equals that composition and
its plain version bit for bit, on every run.

The plans are built once per graph (:func:`matvec_plan`,
:func:`dense_plan`) from the edges and both masks, and only the
coefficients change between a solve's iterations.  A plan holds int32
term records in each output row's order, and leaves out the terms whose
value is a selected zero: masked edges, and (dense) the blocks of fixed
endpoints.  Leaving them out is exact: each sum starts at +0.0 and so is
never −0.0, and adding ±0.0 to it changes no bit, while a NaN or inf in a
masked slot is never read.

The wrappers dispatch on the device of their tensors only: CPU tensors run
the plain version, CUDA tensors launch ``csrc/laplacian.cu`` or raise.
Each launch adds one to ``laplacian_matvec.launches`` /
``laplacian_assemble.launches``, and each plan build to
``matvec_plan.builds`` / ``dense_plan.builds``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from irotavg_tpu_torch.ops.segment import H100_ADDS_PER_S, \
    H100_HBM_BYTES_PER_S

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1}
INT32_MAX = 2**31 - 1
# columns one matvec launch keeps in registers; a wider x takes a launch
# for each group of this many columns
MATVEC_MAX_COLS = 4


class MatvecPlan(NamedTuple):
    """Term records of :func:`laplacian_matvec` over ``rows = nb·n``.

    ``records (T, 2) int32``: per term ``(edge, other)``; ``edge`` is the
    flat edge id ``b·m + t`` on the ``+e`` side (the row is ``j``) and
    ``~(b·m + t)`` on the ``−e`` side (the row is ``i``); ``other`` is the
    flat other endpoint ``b·n + o``, or −1 where that node is fixed (it
    reads 0).  ``offsets (rows+1,) int32``: row ``r`` owns the records
    ``offsets[r] : offsets[r+1]``, its ``+e`` terms in edge order, then its
    ``−e`` terms.  Masked edges and fixed rows have no records."""

    records: torch.Tensor
    offsets: torch.Tensor
    rows: int
    n: int
    m: int
    batch: tuple


class DensePlan(NamedTuple):
    """Term records of :func:`laplacian_assemble` over ``rows = nb·n``.

    ``records (T, 2) int32``: per term ``(column, edge)``, ``edge`` the
    flat edge id for ``+coef`` (the ``(i, i)`` and ``(j, j)`` blocks) and
    its complement ``~id`` for ``−coef`` (``(i, j)``, ``(j, i)``).
    ``offsets (rows+1,) int32``: row ``r``'s records, in the order
    ``(i, i)``, ``(j, j)``, ``(i, j)``, ``(j, i)``, each block in edge
    order; ``free (rows,) bool``.  Only selected terms of unmasked edges
    have records."""

    records: torch.Tensor
    offsets: torch.Tensor
    free: torch.Tensor
    rows: int
    n: int
    m: int
    batch: tuple


def _check_int32(**counts):
    for name, v in counts.items():
        if v > INT32_MAX:
            raise OverflowError(f"{name} = {v} overflows the kernels' "
                                f"int32 records")


def _flat_graph(edges, free_mask, edge_mask, n, batch):
    """Edges, free mask and edge mask broadcast over ``batch`` and
    flattened: ``(i, j, em, t)`` of shape ``(nb, m)`` with ``i, j`` flat
    node ids ``b·n + node`` and ``t`` flat edge ids; ``fr (nb·n,)``."""
    if batch is None:
        batch = torch.broadcast_shapes(edges.shape[:-2], free_mask.shape[:-1],
                                       edge_mask.shape[:-1])
    batch = tuple(batch)
    m = edges.shape[-2]
    nb = math.prod(batch)
    _check_int32(rows=nb * n, edges=nb * m, terms=4 * nb * m)
    dev = edges.device
    e = edges.expand(*batch, m, 2).reshape(nb, m, 2)
    base = torch.arange(nb, device=dev)[:, None] * n
    i, j = e[..., 0] + base, e[..., 1] + base
    fr = free_mask.expand(*batch, n).reshape(-1)
    em = edge_mask.expand(*batch, m).reshape(nb, m)
    t = torch.arange(nb * m, device=dev).view(nb, m)
    return batch, m, i, j, em, t, fr


def _sorted_records(row, first, second, keep, rows):
    """Keep the selected terms (in their order), sort them stably by row
    and return ``(records (T, 2) int32, offsets (rows+1,) int32)``."""
    row, first, second = row[keep], first[keep], second[keep]
    row, order = torch.sort(row, stable=True)
    records = torch.stack([first[order], second[order]], 1).to(torch.int32)
    offsets = torch.searchsorted(
        row, torch.arange(rows + 1, device=row.device)).to(torch.int32)
    return records.contiguous(), offsets


def matvec_plan(edges, free_mask, edge_mask, n, batch=None) -> MatvecPlan:
    """The plan of :func:`laplacian_matvec` for ``edges (*B, m, 2)`` over
    ``n`` nodes, with the free and edge masks; ``batch`` broadcasts them
    over leading dims of ``x``.  Built once per graph."""
    batch, m, i, j, em, t, fr = _flat_graph(edges, free_mask, edge_mask, n,
                                            batch)
    # the composition's terms cat(e, −e) go to cat(j, i): +e terms first
    row = torch.cat([j, i], 1)
    other = torch.cat([i, j], 1)
    other = torch.where(fr[other], other, torch.full_like(other, -1))
    edge = torch.cat([t, ~t], 1)
    keep = torch.cat([em, em], 1) & fr[row]
    records, offsets = _sorted_records(row, edge, other, keep, fr.numel())
    matvec_plan.builds += 1
    return MatvecPlan(records, offsets, fr.numel(), int(n), m, batch)


def dense_plan(edges, free_mask, edge_mask, n, batch=None) -> DensePlan:
    """The plan of :func:`laplacian_assemble` for ``edges (*B, m, 2)``
    over ``n`` nodes, with the free and edge masks, broadcast over
    ``batch`` (the coefficients' leading dims).  Sized by rows and terms,
    not by the ``nb·n·n`` outputs.  Built once per graph."""
    batch, m, i, j, em, t, fr = _flat_graph(edges, free_mask, edge_mask, n,
                                            batch)
    fi, fj = fr[i], fr[j]
    both = fi & fj
    base = (torch.arange(len(i), device=i.device) * n)[:, None]
    # the blocks (i, i), (j, j), (i, j), (j, i), each in edge order
    row = torch.cat([i, j, i, j], 1)
    col = torch.cat([i, j, j, i], 1) - base
    edge = torch.cat([t, t, ~t, ~t], 1)
    keep = torch.cat([em & fi, em & fj, em & both, em & both], 1)
    records, offsets = _sorted_records(row, col, edge, keep, fr.numel())
    dense_plan.builds += 1
    return DensePlan(records, offsets, fr.contiguous(), fr.numel(), int(n),
                     m, batch)


def _rows_of(offsets, rows):
    """The row of every record, from the CSR offsets."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(rows, device=offsets.device),
                                   counts)


def laplacian_matvec_plain(x, c, plan: MatvecPlan):
    """Plain version of :func:`laplacian_matvec`: each record's term, then
    the sequential ``index_add_`` of the terms in record order."""
    k = x.shape[-1]
    xf = x.reshape(-1, k)
    cf = c.expand(*plan.batch, plan.m, c.shape[-1]).reshape(-1, c.shape[-1])
    rec = plan.records.long()
    edge, other = rec[:, 0], rec[:, 1]
    plus = (edge >= 0)[:, None]
    rows = _rows_of(plan.offsets, plan.rows)
    xr = xf[rows]
    xo = torch.where((other >= 0)[:, None], xf[other.clamp(min=0)],
                     torch.zeros_like(xr))
    d = torch.where(plus, xr - xo, xo - xr)
    e = d * cf[torch.where(edge >= 0, edge, ~edge)]
    terms = torch.where(plus, e, -e)
    out = torch.zeros((plan.rows, k), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, terms).view(x.shape)


def laplacian_assemble_plain(coef, plan: DensePlan, ridge=0.0):
    """Plain version of :func:`laplacian_assemble`: the sequential
    ``index_add_`` of the records' ``±coef`` into the flat matrices, then
    ``+ diag_embed`` of the fixed diagonal."""
    n = plan.n
    cf = coef.reshape(-1)
    rec = plan.records.long()
    col, edge = rec[:, 0], rec[:, 1]
    v = cf[torch.where(edge >= 0, edge, ~edge)]
    v = torch.where(edge >= 0, v, -v)
    flat = _rows_of(plan.offsets, plan.rows) * n + col
    L = torch.zeros(plan.rows * n, dtype=coef.dtype, device=coef.device)
    L = L.index_add_(0, flat, v).view(*plan.batch, n, n)
    free = plan.free.view(*plan.batch, n)
    fixed_diag = torch.where(free, torch.full_like(free, ridge,
                                                   dtype=coef.dtype),
                             torch.ones_like(free, dtype=coef.dtype))
    return L + torch.diag_embed(fixed_diag)


def laplacian_matvec_work(rows, n_edges, terms, k, c_cols, itemsize):
    """(operations, bytes) of one matvec launch: a subtract, a multiply
    and an add per term and column; ``x``, ``c``, the 8-byte records and
    the 4-byte offsets read once and ``y`` written once."""
    ops = 3 * terms * k
    nbytes = (2 * rows * k * itemsize + n_edges * c_cols * itemsize
              + 8 * terms + 4 * (rows + 1))
    return ops, nbytes


def laplacian_assemble_work(rows, n, n_edges, terms, itemsize):
    """(operations, bytes) of one assembly launch: an add per term and per
    output; the ``rows·n`` outputs written once, ``coef``, the records,
    the offsets and the free mask read once."""
    ops = terms + rows * n
    nbytes = (rows * n * itemsize + n_edges * itemsize + 8 * terms
              + 4 * (rows + 1) + rows)
    return ops, nbytes


def bound_ms(ops, nbytes, dtype=torch.float64):
    """(ms, "operations" or "bytes"): the larger of the operations at one
    H100's peak for ``dtype`` and the bytes at its HBM rate."""
    t_ops = ops / H100_ADDS_PER_S[dtype] * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def matvec_bound_ms(plan: MatvecPlan, k, c_cols, dtype=torch.float64):
    """:func:`bound_ms` of one :func:`laplacian_matvec` launch by
    ``plan``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return bound_ms(*laplacian_matvec_work(
        plan.rows, math.prod(plan.batch) * plan.m, plan.records.shape[0], k,
        c_cols, itemsize), dtype)


def assemble_bound_ms(plan: DensePlan, dtype=torch.float64):
    """:func:`bound_ms` of one :func:`laplacian_assemble` launch by
    ``plan``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return bound_ms(*laplacian_assemble_work(
        plan.rows, plan.n, math.prod(plan.batch) * plan.m,
        plan.records.shape[0], itemsize), dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    from irotavg_tpu_torch.kernels.build import load

    lib = load("laplacian")
    lib.laplacian_matvec.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.laplacian_assemble.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p]
    lib.laplacian_matvec.restype = ctypes.c_int
    lib.laplacian_assemble.restype = ctypes.c_int
    return lib


def _check_cuda(what, dev, dtype, plan_tensors):
    if dev.type != "cuda":
        raise ValueError(f"{what} has no kernel for device {dev}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float64 or float32, got {dtype}")
    for name, t in plan_tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: plan.{name} lies on {t.device}, the "
                             f"values on {dev}")


def _run(what, fn, args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _matvec_shapes(x, c, plan: MatvecPlan):
    if tuple(x.shape[:-2]) != plan.batch or x.shape[-2] != plan.n:
        raise ValueError(f"x of shape {tuple(x.shape)} for a plan of batch "
                         f"{plan.batch} and {plan.n} nodes")
    if c.shape[-2] != plan.m or c.shape[-1] not in (1, x.shape[-1]):
        raise ValueError(f"c of shape {tuple(c.shape)} for a plan of "
                         f"{plan.m} edges and x of {x.shape[-1]} columns")


def laplacian_matvec_launcher(x, c, plan: MatvecPlan):
    """Check CUDA inputs once and allocate the output: returns ``(launch,
    y)``, where each ``launch()`` runs the kernel into ``y``, once for each
    group of at most ``MATVEC_MAX_COLS`` columns (the columns are
    independent), and counts each launch (``chip_smoke.py`` times
    back-to-back launches with it)."""
    _matvec_shapes(x, c, plan)
    dev = x.device
    _check_cuda("laplacian_matvec", dev, x.dtype,
                {"records": plan.records, "offsets": plan.offsets})
    if c.device != dev or c.dtype != x.dtype:
        raise ValueError(f"c ({c.dtype} on {c.device}) must match x "
                         f"({x.dtype} on {dev})")
    k, ck = x.shape[-1], c.shape[-1]
    x = x.contiguous()
    c = c.expand(*plan.batch, plan.m, ck).contiguous()
    y = torch.empty_like(x)
    size = x.element_size()
    stream = torch.cuda.current_stream(dev).cuda_stream
    groups = [(x.data_ptr() + q * size,
               c.data_ptr() + (0 if ck == 1 else q * size),
               plan.records.data_ptr(), plan.offsets.data_ptr(),
               y.data_ptr() + q * size, plan.rows, k,
               min(MATVEC_MAX_COLS, k - q), 0 if ck == 1 else ck,
               _DTYPE_CODE[x.dtype], stream)
              for q in range(0, k, MATVEC_MAX_COLS)]
    fn = _lib().laplacian_matvec

    def launch():
        if y.numel() == 0:
            return
        for args in groups:
            _run("laplacian_matvec", fn, args)
            laplacian_matvec.launches += 1

    launch.tensors = (x, c, y, plan)   # what ``groups`` points at
    return launch, y


def laplacian_matvec(x, c, plan: MatvecPlan):
    """``free ⊙ Aᵀ(c ⊙ edge_mask ⊙ A(free ⊙ x))`` by ``plan``
    (:func:`matvec_plan`): ``x (*B, n, k)``, ``c (*B, m, 1|k)`` ->
    ``(*B, n, k)``.  CPU tensors run :func:`laplacian_matvec_plain`; CUDA
    tensors launch the kernel; any other device raises."""
    if x.device.type == "cpu":
        _matvec_shapes(x, c, plan)
        return laplacian_matvec_plain(x, c, plan)
    launch, y = laplacian_matvec_launcher(x, c, plan)
    launch()
    return y


def _assemble_shapes(coef, plan: DensePlan):
    if tuple(coef.shape) != plan.batch + (plan.m,):
        raise ValueError(f"coef of shape {tuple(coef.shape)} for a plan of "
                         f"batch {plan.batch} and {plan.m} edges")


def laplacian_assemble_launcher(coef, plan: DensePlan, ridge=0.0):
    """As :func:`laplacian_matvec_launcher`, for the dense assembly."""
    _assemble_shapes(coef, plan)
    dev = coef.device
    _check_cuda("laplacian_assemble", dev, coef.dtype,
                {"records": plan.records, "offsets": plan.offsets,
                 "free": plan.free})
    coef = coef.contiguous()
    out = torch.empty(plan.batch + (plan.n, plan.n), dtype=coef.dtype,
                      device=dev)
    args = (coef.data_ptr(), plan.records.data_ptr(),
            plan.offsets.data_ptr(), plan.free.data_ptr(), out.data_ptr(),
            plan.rows, plan.n, float(ridge), _DTYPE_CODE[coef.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    fn = _lib().laplacian_assemble

    def launch():
        if out.numel() == 0:
            return
        _run("laplacian_assemble", fn, args)
        laplacian_assemble.launches += 1

    launch.tensors = (coef, out, plan)   # what ``args`` points at
    return launch, out


def laplacian_assemble(coef, plan: DensePlan, ridge=0.0):
    """Dense ``A' diag(coef) A`` by ``plan`` (:func:`dense_plan`), with
    ``ridge`` on free and 1 on fixed diagonals: ``coef (*B, m)`` ->
    ``(*B, n, n)``.  CPU tensors run :func:`laplacian_assemble_plain`;
    CUDA tensors launch the kernel; any other device raises."""
    if coef.device.type == "cpu":
        _assemble_shapes(coef, plan)
        return laplacian_assemble_plain(coef, plan, ridge)
    launch, out = laplacian_assemble_launcher(coef, plan, ridge)
    launch()
    return out


def reset_launch_counts() -> None:
    """Zero the kernel launch counters of both wrappers."""
    laplacian_matvec.launches = 0
    laplacian_assemble.launches = 0


# kernel launches and plan builds (read and reset by chip_smoke.py and the
# tests)
reset_launch_counts()
matvec_plan.builds = 0
dense_plan.builds = 0

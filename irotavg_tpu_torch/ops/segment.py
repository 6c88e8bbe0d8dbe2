"""Fixed-order segment sum: the CUDA kernel's wrapper and its plain
PyTorch version.

The solver's scatter-adds (the reference's XLA ``.at[].add`` in
``irotavg_tpu/solver/graph.py``) add many terms into few rows.  CUDA's
``index_add_`` / ``scatter_add_`` add them with atomics, in an order that
changes from run to run, so a solve on the card moved in its last bits
between two runs.  Here the terms are sorted once by destination row (a
:class:`SegmentPlan`), and ``csrc/segment_sum.cu`` adds each row's terms
in the order of their index, from 0.0, with no atomics: the order in
which ``index_add_`` on the CPU adds them, so the kernel equals the
plain version bit for bit and repeats from run to run.  The CG's Laplacian
matvec and the dense Laplacian fuse their scatter-adds, in the same
order, into kernels of their own (``ops/laplacian.py``).

:func:`segment_sum` dispatches on the device of its values only: CPU
tensors go to :func:`segment_sum_plain`, CUDA tensors launch the kernel
or raise.  Each launch adds one to ``segment_sum.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

# published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): HBM
# bandwidth, and f64 / f32 arithmetic outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12
H100_ADDS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1}


class SegmentPlan(NamedTuple):
    """Terms sorted by destination row.

    ``perm (N,)``: a stable argsort of the terms' row ids; ``ids (N,)``:
    the sorted row ids (``ids[p]`` is the row of term ``perm[p]``);
    ``offsets (R+1,)``: row ``r`` sums the terms ``perm[offsets[r] :
    offsets[r+1]]``; ``rows``: R."""

    perm: torch.Tensor
    ids: torch.Tensor
    offsets: torch.Tensor
    rows: int


def segment_plan(ids, rows: int) -> SegmentPlan:
    """The plan for term ``t`` going to row ``ids[t]`` of ``rows``; every
    id must lie in ``[0, rows)``.  Built once per graph and reused."""
    ids = ids.reshape(-1).long()
    sorted_ids, perm = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(rows + 1, device=ids.device))
    segment_plan.builds += 1
    return SegmentPlan(perm=perm, ids=sorted_ids, offsets=offsets,
                       rows=int(rows))


def segment_sum_plain(v, plan: SegmentPlan):
    """Plain version: ``(N, k)`` values -> ``(R, k)`` sums, by the
    sequential ``index_add_`` of the sorted terms."""
    out = torch.zeros((plan.rows, v.shape[-1]), dtype=v.dtype,
                      device=v.device)
    return out.index_add_(0, plan.ids, v[plan.perm])


def segment_sum_work(n_terms: int, rows: int, k: int, itemsize: int):
    """(operations, bytes) of one launch: one add per term and column;
    the values, ``perm`` and ``offsets`` read once and the sums written
    once."""
    ops = n_terms * k
    nbytes = (n_terms * (k * itemsize + 8) + (rows + 1) * 8
              + rows * k * itemsize)
    return ops, nbytes


def bound_ms(n_terms: int, rows: int, k: int, dtype=torch.float64):
    """(ms, "operations" or "bytes"): the least time one H100 could take
    for a launch, the larger of its adds at the card's peak for ``dtype``
    and its bytes at the HBM rate (:func:`segment_sum_work`)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    ops, nbytes = segment_sum_work(n_terms, rows, k, itemsize)
    t_ops = ops / H100_ADDS_PER_S[dtype] * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@functools.lru_cache(maxsize=None)
def _lib():
    from irotavg_tpu_torch.kernels.build import load

    fn = load("segment_sum").segment_sum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum_launcher(v, plan: SegmentPlan):
    """Check CUDA inputs once and allocate the output: returns ``(launch,
    out)``, where each ``launch()`` runs the kernel into ``out (R, k)``
    and counts one launch.  :func:`segment_sum` is one such launch;
    ``chip_smoke.py`` times back-to-back launches with it."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum has no kernel for device {dev}")
    if v.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_sum takes float64 or float32 values, got "
                        f"{v.dtype}")
    if v.dim() != 2 or v.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"values of shape {tuple(v.shape)} for a plan of "
                         f"{plan.perm.shape[0]} terms")
    for name, t in (("perm", plan.perm), ("offsets", plan.offsets)):
        if t.device != dev or t.dtype != torch.int64:
            raise ValueError(f"plan.{name} must be int64 on {dev}")
    v = v.contiguous()
    k = v.shape[1]
    out = torch.empty((plan.rows, k), dtype=v.dtype, device=dev)
    args = (v.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
            out.data_ptr(), plan.rows, k, _DTYPE_CODE[v.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    fn = _lib()

    def launch():
        if out.numel() == 0:
            return
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"segment_sum launch failed: CUDA error "
                               f"{err}")
        segment_sum.launches += 1

    return launch, out


def segment_sum(v, plan: SegmentPlan):
    """Row sums of the ``(N, k)`` (or ``(N,)``) values ``v`` by ``plan``:
    ``(R, k)`` (or ``(R,)``), each row's terms added in index order.  CPU
    tensors run :func:`segment_sum_plain`; CUDA tensors launch
    ``segment_sum``; any other device raises."""
    squeeze = v.dim() == 1
    v2 = v[:, None] if squeeze else v
    if v.device.type == "cpu":
        out = segment_sum_plain(v2, plan)
    else:
        launch, out = segment_sum_launcher(v2, plan)
        launch()
    return out[:, 0] if squeeze else out


def reset_launch_counts() -> None:
    """Zero the kernel launch counter of :func:`segment_sum`."""
    segment_sum.launches = 0


# kernel launches made by segment_sum and segment_sum_launcher, and plans
# built (read and reset by chip_smoke.py and the tests)
reset_launch_counts()
segment_plan.builds = 0

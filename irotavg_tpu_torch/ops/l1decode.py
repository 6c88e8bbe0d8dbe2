"""L1-RA's outer step on the card: the wrapper of ``csrc/l1_decode.cu``.

On the CPU, :func:`irotavg_tpu_torch.solver.l1ra.l1ra` runs the plain
composition (``l1ra_step``: the residuals, ``_l1decode_lanes`` and the
update), which reads the host once for each Newton step and once for each
step of the line search.  On the card it holds an :class:`L1Kernels` for
the solve and runs, for each outer step, ``init``, then for each Newton
step ``pre``, the solver's own Newton solve (``_newton_dx``) and ``post``,
then ``update``: four kernels that repeat the composition's arithmetic
(they differ from it only in the order of their sums, see the source),
and one host read of the stop test per outer step.

Each launch adds one to ``L1Kernels.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1}
LANES = 3           # the tangent axes, one decode each


@functools.lru_cache(maxsize=None)
def _lib():
    from irotavg_tpu_torch.kernels.build import load

    lib = load("l1_decode")
    p, i, d, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
        ctypes.c_int64
    lib.l1_geometry.argtypes = [p]
    lib.l1_init.argtypes = [p] * 10 + [i, i, i, d, i, p]
    lib.l1_pre.argtypes = [p] * 10 + [i, i, i, i, p]
    lib.l1_post.argtypes = [p] * 9 + [q, q, q, i, i, i, i, d, i, p]
    lib.l1_update.argtypes = [p] * 6 + [i, i, d, q, i, p]
    for fn in (lib.l1_geometry, lib.l1_init, lib.l1_pre, lib.l1_post,
               lib.l1_update):
        fn.restype = ctypes.c_int
    geo = (ctypes.c_int * 4)()
    lib.l1_geometry(geo)
    lib.geometry = tuple(geo)
    return lib


def _run(what, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    L1Kernels.launches += 1


class L1Kernels:
    """The buffers and launches of one L1-RA solve of the graph ``g``
    (a ``RotationGraph`` on a CUDA device, leading batch dims allowed),
    with ``rmatvec`` the graph's ``graph_plans(...).rmatvec`` and
    ``pdtol`` the decoder's duality-gap stop.  ``Q``,
    ``iters``, ``score`` and ``active`` (one per graph) are what
    ``l1ra`` returns and reads."""

    launches = 0

    def __init__(self, g, rmatvec, cfg, pdtol):
        dev = g.Q.device
        if dev.type != "cuda":
            raise ValueError(f"the L1-RA kernels have no version for "
                             f"device {dev}")
        if g.Q.dtype not in _DTYPE_CODE:
            raise TypeError(f"the L1-RA kernels take float64 or float32, "
                            f"got {g.Q.dtype}")
        self.batch = tuple(g.edges.shape[:-2])
        B = math.prod(self.batch)
        m, n = g.m, g.n
        if m == 0 or n == 0 or B == 0:
            raise ValueError(f"L1-RA needs edges and nodes, got m={m}, "
                             f"n={n}, batch {self.batch}")
        for t in (rmatvec.perm, rmatvec.offsets):
            if t.device != dev:
                raise ValueError(f"the rmatvec plan lies on {t.device}, the "
                                 f"graph on {dev}")
        lib = _lib()
        n_edge, n_node, n_scal, lanes = lib.geometry
        if lanes != LANES:
            raise RuntimeError(f"csrc/l1_decode.cu decodes {lanes} axes, "
                               f"the wrapper {LANES}")
        dt = g.Q.dtype
        self.B, self.m, self.n, self.cfg = B, m, n, cfg
        self.pdtol = float(pdtol)
        self.code = _DTYPE_CODE[dt]
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.Q = g.Q.reshape(B, n, 4).clone()
        self.QQ = g.QQ.reshape(B, m, 4).contiguous()
        self.edges = g.edges.reshape(B, m, 2).contiguous()
        self.em = g.edge_mask.expand(*self.batch, m).reshape(B, m) \
            .contiguous().view(torch.uint8)
        self.fm = g.free_mask().expand(*self.batch, n).reshape(B, n) \
            .contiguous().view(torch.uint8)
        self.plan = rmatvec
        self.E = torch.empty((B, LANES, n_edge, m), dtype=dt, device=dev)
        self.N = torch.empty((B, LANES, n_node, n), dtype=dt, device=dev)
        self.S = torch.empty((B, LANES, n_scal), dtype=dt, device=dev)
        self.sigx = torch.empty((B, LANES, m), dtype=dt, device=dev)
        self.w1p = torch.empty((B, LANES, n), dtype=dt, device=dev)
        self.score = torch.full((B,), math.inf, dtype=dt, device=dev)
        self.iters = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.active = torch.full((B,), int(cfg.max_iters > 0),
                                 dtype=torch.uint8, device=dev)
        self._geo = (self.E.data_ptr(), self.N.data_ptr(), self.S.data_ptr())
        self._graph = (self.edges.data_ptr(), self.em.data_ptr(),
                       self.fm.data_ptr(), rmatvec.perm.data_ptr(),
                       rmatvec.offsets.data_ptr())

    def any_active(self) -> bool:
        """The host's one read of an outer step."""
        return bool(self.active.any())

    def init(self):
        """The residuals of the current ``Q`` and each decode's start."""
        e, em, fm, perm, off = self._graph
        _run("l1_init", _lib().l1_init, self.Q.data_ptr(),
             self.QQ.data_ptr(), e, em, fm, perm, off, *self._geo, self.B,
             self.m, self.n, self.pdtol, self.code, self.stream)

    def pre(self):
        """The Newton systems' edge weights and right-hand sides, as the
        composition passes them to ``_newton_dx``: ``sigx (*B, m, L)``
        and ``w1p (*B, n, L)`` (transposed views of lane-major buffers)."""
        _run("l1_pre", _lib().l1_pre, *self._graph, *self._geo,
             self.sigx.data_ptr(), self.w1p.data_ptr(), self.B, self.m,
             self.n, self.code, self.stream)
        return (self.sigx.view(*self.batch, LANES, self.m).transpose(-1, -2),
                self.w1p.view(*self.batch, LANES, self.n).transpose(-1, -2))

    def post(self, dx, last: bool):
        """The step from the Newton direction ``dx (*B, n, L)`` (any
        strides): line search, update and stop test of every lane."""
        if tuple(dx.shape) != self.batch + (self.n, LANES) or \
                dx.dtype != self.Q.dtype or dx.device != self.Q.device:
            raise ValueError(f"dx {tuple(dx.shape)} {dx.dtype} on "
                             f"{dx.device} for {self.batch} x "
                             f"({self.n}, {LANES}) {self.Q.dtype}")
        d = dx.reshape(self.B, self.n, LANES)
        sb, sn, sl = d.stride()
        _run("l1_post", _lib().l1_post, *self._graph, *self._geo,
             d.data_ptr(), sb, sn, sl, self.B, self.m, self.n, int(last),
             self.pdtol, self.code, self.stream)
        self._dx = d    # alive until the launch has read it

    def update(self):
        """``Q <- Q exp(X)``, the mean update norm, the iteration count
        and the stop test of every graph still active."""
        _run("l1_update", _lib().l1_update, self.Q.data_ptr(),
             self.fm.data_ptr(), self.N.data_ptr(), self.score.data_ptr(),
             self.iters.data_ptr(), self.active.data_ptr(), self.B, self.n,
             float(self.cfg.change_th), int(self.cfg.max_iters), self.code,
             self.stream)

    def result(self):
        """``(Q, iters, score)`` shaped as the graph's batch."""
        return (self.Q.view(*self.batch, self.n, 4),
                self.iters.view(self.batch), self.score.view(self.batch))

"""Edge-sharded IRLS rotation averaging over ``torch.distributed``.

Port of ``irotavg_tpu/parallel/sharded.py`` (``shard_map`` + ``psum``).
The partitioning is the reference's:

* ``edges/QQ/edge_mask/weights``: each rank holds one contiguous block of
  ``m / world`` edges.  Residuals, log maps, the robust re-weighting and
  the Laplacian partials are edge-local.
* ``Q/node_mask/rhs/x``: replicated on every rank.  Node state is small
  next to the edge data (``(n, 4)`` rotations, ``(n, 3)`` CG vectors), so
  it is kept whole and the edge partials are summed with one
  ``all_reduce(SUM)`` per CG matvec, plus one for the rhs and one for the
  Jacobi diagonal of each IRLS step.  No edge data ever moves.

The CG is ``solver/graph.py:_pcg`` as it is, with a matvec that reduces
its partials over the group: its dot products are of replicated vectors
and need no collective, and its stop (read on the host once every
``CG_CHECK_EVERY`` steps) comes from the reduced residual, which is the
same on every rank, so every rank runs the same number of collectives.
The result is the single-device solver's (``solver/irls.py``) up to the
summation order of the reduction.

A group is joined with :func:`init_multihost` (NCCL on the card, gloo on
the CPU); :func:`make_graph_mesh` names it, :func:`shard_graph` gives a
rank its block.  Without a process group everything runs on one rank,
with no collective.  :func:`run_ranks` starts the ranks of one host as
spawned processes (the scaling probe and ``entry.dryrun_multichip``).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
import time

import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.device import pick_device
from irotavg_tpu_torch.ops.laplacian import laplacian_matvec
from irotavg_tpu_torch.solver.graph import (
    RotationGraph, diag_partial, graph_plans, guard_diag, incidence_matvec,
    incidence_rmatvec,
)
from irotavg_tpu_torch.solver.graph import _pcg as _graph_pcg
from irotavg_tpu_torch.solver.irls import (
    Cost, IRLSConfig, free_mean, update_weights,
)

GRAPH_AXIS = "graph"
# seconds a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 300.0
# seconds a whole run of spawned ranks may take before they are killed
RANK_TIMEOUT_S = 900.0


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   init_method: str | None = None, backend: str | None = None,
                   device=None):
    """Join a process group and return ``(rank, world_size)``.

    Decides from the arguments and the environment only: a
    ``coordinator_address`` (``host:port``, becomes ``tcp://host:port``),
    an ``init_method`` (e.g. a ``file://`` store), ``num_processes > 1``,
    or ``MASTER_ADDR`` set by ``torchrun`` (then ``env://``, and the rank
    and world size default to ``RANK`` / ``WORLD_SIZE``).  With none of
    these, or when a group is already joined, it is a no-op that returns
    the current ``(rank, world)`` — ``(0, 1)`` in a single process.
    ``backend=None`` means ``nccl`` for a CUDA ``device`` (the default,
    :func:`device.pick_device`) and ``gloo`` for the CPU; on the card the
    rank's GPU is ``LOCAL_RANK`` (else the rank) modulo the card count.
    Collectives fail after ``COLLECTIVE_TIMEOUT_S`` instead of waiting
    forever.
    """
    dist = _dist()
    if dist is not None and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    want = (coordinator_address is not None or init_method is not None
            or (num_processes or 1) > 1 or "MASTER_ADDR" in env)
    if not want:
        return 0, 1
    if dist is None:
        raise RuntimeError("torch.distributed is not available in this build")
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    dev = pick_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(env.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S),
                            device_id=dev if dev.type == "cuda" else None)
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass
class GraphMesh:
    """The 1-D edge-parallel group (the reference's ``graph`` mesh axis):
    this process's ``rank`` of ``size`` and its ``device``.  ``grouped``
    is False when no process group is joined (one rank, no collective).
    ``all_reduces`` / ``all_gathers`` count the collectives issued."""

    rank: int
    size: int
    device: torch.device
    grouped: bool
    all_reduces: int = 0
    all_gathers: int = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (in place), on every rank."""
        if self.grouped:
            _dist().all_reduce(t)
            self.all_reduces += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order."""
        if not self.grouped:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        _dist().all_gather(parts, t.contiguous())
        self.all_gathers += 1
        return torch.cat(parts)


def make_graph_mesh(n_devices: int | None = None, device=None) -> GraphMesh:
    """The edge-parallel group over every rank of the joined process group
    (or one rank when none is joined).  ``n_devices``, when given, must be
    the world size.  ``device=None`` is the card (the rank's current
    CUDA device); pass ``"cpu"`` for gloo ranks on the CPU."""
    dist = _dist()
    grouped = dist is not None and dist.is_initialized()
    rank, size = (dist.get_rank(), dist.get_world_size()) if grouped \
        else (0, 1)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"asked for a mesh of {n_devices}, but the process "
                         f"group has {size} ranks")
    dev = pick_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return GraphMesh(rank=rank, size=size, device=dev, grouped=grouped)


def _block(mesh: GraphMesh, m: int) -> slice:
    if m % mesh.size:
        raise ValueError(f"edge count {m} not divisible by mesh size "
                         f"{mesh.size}")
    b = m // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_graph(g: RotationGraph, mesh: GraphMesh) -> RotationGraph:
    """This rank's part of a (pre-padded) graph on the rank's device: its
    contiguous block of ``g.m / mesh.size`` edges and a replicated copy of
    the node fields.  ``g.m`` must divide by the mesh size (pad with
    masked edges first: ``g.pad_to``); raises ``ValueError`` otherwise."""
    sl = _block(mesh, g.m)
    dev = mesh.device
    return RotationGraph(
        edges=g.edges[sl].to(dev), QQ=g.QQ[sl].to(dev), Q=g.Q.to(dev),
        f=g.f, edge_mask=g.edge_mask[sl].to(dev),
        node_mask=g.node_mask.to(dev))


# ---------------------------------------------------------------------------
# Per-shard primitives (arrays are this rank's edge block).
# ---------------------------------------------------------------------------


# the reference's name for the raw diagonal partial
_local_diag = diag_partial


def _pcg(mesh, edges, coef, rhs, free_mask, edge_mask, plan, *, tol,
         maxiter):
    """Jacobi-preconditioned CG on replicated ``(n, 3)`` vectors, one
    ``all_reduce`` per matvec; returns ``(x, iterations)``."""
    n = rhs.shape[-2]
    c = torch.where(edge_mask, coef, torch.zeros_like(coef))[..., None]

    def matvec(x):
        # this shard's part of A' diag(c) A x, one launch of the fused
        # matvec (its plan holds the shard's edges and masks)
        return mesh.all_reduce(laplacian_matvec(x, c, plan.matvec))

    # the d > 0 guard after the reduction, so a node with no edge in some
    # shard does not pick up a 1 from it
    d = mesh.all_reduce(_local_diag(edges, c, n, plan.diag))
    dinv = 1.0 / guard_diag(d, free_mask)
    b = torch.where(free_mask[..., None], rhs, torch.zeros_like(rhs))
    x, k = _graph_pcg(matvec, dinv, b, tol, maxiter, (-2, -1))
    return x, k[..., 0, 0]


def _irls_step_shard(mesh, edges, QQ, edge_mask, weights, Q, f, node_mask,
                     cfg: IRLSConfig, plan=None):
    """One IRLS iteration on this rank's edge block; ``Q`` replicated.
    Returns (new_Q replicated, new local weights, score tensor).
    ``plan``: ``graph_plans`` of the block for CG (built here when not
    given; :func:`_run` builds it once for all its steps)."""
    n = Q.shape[-2]
    free = (torch.arange(n, device=Q.device) >= f) & node_mask
    if plan is None:
        plan = graph_plans(edges, free, edge_mask, n, "cg")
    w3 = so3.log_map(so3.delta_rel(edges, QQ, Q))[..., :3]
    w3 = torch.where(edge_mask[..., None], w3, torch.zeros_like(w3))

    wsq = weights * weights
    coef = torch.where(edge_mask, wsq, torch.zeros_like(wsq))
    rhs = mesh.all_reduce(incidence_rmatvec(edges, wsq[..., None] * w3,
                                            free, edge_mask, n, plan.rmatvec))
    X, _ = _pcg(mesh, edges, coef, rhs, free, edge_mask, plan,
                tol=cfg.cg_tol, maxiter=cfg.cg_maxiter)

    E = incidence_matvec(edges, X, free, edge_mask) - w3
    new_weights = update_weights(cfg.cost, E, weights, cfg.sigma)
    new_Q = so3.qmul(Q, so3.exp_map(X))
    return new_Q, new_weights, free_mean(X, free)


def _local_weights(mesh, g: RotationGraph, weights):
    """This rank's block of the full ``(m,)`` weights (ones when None)."""
    if weights is None:
        return torch.ones(g.m, dtype=g.dtype, device=g.Q.device)
    weights = torch.as_tensor(weights, dtype=g.dtype, device=g.Q.device)
    if weights.shape[-1] != g.m * mesh.size:
        raise ValueError(f"weights of {weights.shape[-1]} edges for a "
                         f"graph of {g.m * mesh.size}")
    return weights[_block(mesh, weights.shape[-1])]


def _run(mesh, g, weights, cfg):
    """IRLS to convergence on this rank's block: (Q, local weights, iters,
    score), the stop read from the replicated score."""
    Q, score, it = g.Q, math.inf, 0
    plan = graph_plans(g.edges, g.free_mask(), g.edge_mask, g.n, "cg")
    while score > cfg.change_th and it < cfg.max_iters:
        Q, weights, s = _irls_step_shard(mesh, g.edges, g.QQ, g.edge_mask,
                                         weights, Q, g.f, g.node_mask, cfg,
                                         plan)
        score, it = float(s), it + 1
    return Q, weights, it, score


def sharded_irls_step(mesh: GraphMesh, cfg: IRLSConfig):
    """The one-step update over ``mesh``: ``step(g, weights) -> (Q,
    weights, score)`` for this rank's shard ``g`` (:func:`shard_graph`)
    and the full ``(m,)`` weights; ``Q`` and the weights come back whole
    on every rank (the weights through one ``all_gather``)."""

    def step(g: RotationGraph, weights):
        w = _local_weights(mesh, g, weights)
        Q, w, score = _irls_step_shard(mesh, g.edges, g.QQ, g.edge_mask, w,
                                       g.Q, g.f, g.node_mask, cfg)
        return Q, mesh.all_gather(w), score

    return step


def sharded_irls(mesh: GraphMesh, cfg: IRLSConfig = IRLSConfig()):
    """Converged distributed IRLS, the contract of ``solver.irls.irls``
    edge-parallel over ``mesh``: ``solve(g, weights=None) -> (Q, weights,
    iters, score)`` with the full ``(m,)`` weights on every rank."""

    def solve(g: RotationGraph, weights=None):
        Q, w, it, score = _run(mesh, g, _local_weights(mesh, g, weights),
                               cfg)
        return Q, mesh.all_gather(w), it, score

    return solve


def sharded_ravg_pipeline(mesh: GraphMesh, *, l1_iters: int = 5,
                          cfg: IRLSConfig = IRLSConfig()):
    """The whole distributed batch solve: an IRLS warmup with ``Cost.L1``
    weights for ``l1_iters`` iterations (the L1 fixed point minimises the
    l1 decoder's objective, so gross outliers cannot poison the
    least-squares phase, ral/test.cpp:286-300), then ``cfg``'s cost from
    unit weights (ral/l1_irls.cpp:577), then ``qnormalize``.  Every
    iteration is edge-parallel.  Returns ``solve(g, weights=None) -> (Q,
    weights, iters, score)`` with ``iters`` the two phases' sum."""
    l1_cfg = dataclasses.replace(cfg, cost=Cost.L1, max_iters=l1_iters)

    def solve(g: RotationGraph, weights=None):
        w = _local_weights(mesh, g, weights)
        Q1, _, it1, _ = _run(mesh, g, w, l1_cfg)
        Q2, w, it2, score = _run(mesh, dataclasses.replace(g, Q=Q1),
                                 torch.ones_like(w), cfg)
        return so3.qnormalize(Q2), mesh.all_gather(w), it1 + it2, score

    return solve


def run_ranks(target, world, args, timeout_s=RANK_TIMEOUT_S):
    """Start ``world`` spawned processes ``target(rank, world, store,
    *args, queue)`` joined through a ``file://`` store in a fresh
    temporary directory; wait for every one (killing all on the first
    failure or after ``timeout_s``) and return what rank 0 put on the
    queue."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=target,
                             args=(r, world, store) + tuple(args) + (q,))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        try:
            status, *rest = q.get(timeout=5)
        except queue.Empty:
            status, rest = "error", [f"no result; exit codes "
                                     f"{[p.exitcode for p in procs]}"]
        if status != "ok" or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"world size {world}: {rest[0]} (exit codes "
                               f"{[p.exitcode for p in procs]})")
        return rest

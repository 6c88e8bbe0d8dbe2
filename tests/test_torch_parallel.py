"""The port's edge-sharded solver (``irotavg_tpu_torch.parallel``) in this
process at world size 1 over gloo (a ``file://`` store), against the JAX
package's sharded solver on the conftest's 8-device virtual CPU mesh and
against the port's own single-device ``irls``, all in f64.

Bounds: against JAX, ``tests/test_parallel.py``'s (max geodesic < 1e-6
deg, equal iterations, weights ``rtol = 1e-8``); against the port's
``irls``, equal iterations and geodesic < 1e-12 deg (the same operations,
the reduction of one rank being the identity)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irotavg_tpu import parallel as jpar
from irotavg_tpu.solver import RotationGraph as JGraph
from irotavg_tpu.solver import init_mst as jinit_mst
from irotavg_tpu.solver.irls import Cost as JCost
from irotavg_tpu.solver.irls import IRLSConfig as JConfig
from irotavg_tpu_torch.parallel import (
    GraphMesh, init_multihost, make_graph_mesh, shard_graph, sharded_irls,
    sharded_irls_step, sharded_ravg_pipeline,
)
from irotavg_tpu_torch.solver.graph import (
    CG_CHECK_EVERY, RotationGraph, laplacian_cg_solve,
)
from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig, irls
from synth import make_problem


def _geo_deg(Qa, Qb):
    """Per-row rotation angle (deg), sign-invariant and accurate for tiny
    angles."""
    Qa = np.asarray(Qa, np.float64)
    Qb = np.asarray(Qb, np.float64)
    Qa = Qa / np.linalg.norm(Qa, axis=-1, keepdims=True)
    Qb = Qb / np.linalg.norm(Qb, axis=-1, keepdims=True)
    s = np.sign(np.sum(Qa * Qb, axis=-1, keepdims=True))
    chord = np.linalg.norm(Qa - s * Qb, axis=-1)
    return np.degrees(4 * np.arcsin(np.clip(chord / 2, 0, 1)))


def _inputs(n=50, extra=80, outlier_frac=0.1, seed=7, noise_deg=1.5):
    """``tests/test_parallel.py:_graph``'s problem as numpy arrays."""
    p = make_problem(n=n, extra_edges=extra, noise_deg=noise_deg,
                     outlier_frac=outlier_frac, seed=seed)
    Q0 = np.asarray(jinit_mst(np.tile([0.0, 0, 0, 1], (n, 1)), p["QQ"],
                              p["edges"], 1))
    return p, Q0


def _graphs(p, Q0, m_pad, n):
    j = JGraph.create(p["edges"], p["QQ"], Q0, f=1,
                      dtype=np.float64).pad_to(m_pad, n)
    t = RotationGraph.create(p["edges"], p["QQ"], Q0, f=1,
                             dtype=torch.float64, device="cpu").pad_to(m_pad,
                                                                       n)
    return j, t


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """World size 1 over gloo, joined through a ``file://`` store."""
    store = tmp_path_factory.mktemp("dist") / "store"
    assert init_multihost(init_method=f"file://{store}", num_processes=1,
                          process_id=0, device="cpu") == (0, 1)
    yield make_graph_mesh(1, device="cpu")
    torch.distributed.destroy_process_group()


def test_init_multihost_without_arguments_is_a_no_op(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    before = torch.distributed.is_initialized()
    assert init_multihost() == (0, 1)
    assert torch.distributed.is_initialized() == before


def _jcfg(cfg: IRLSConfig) -> JConfig:
    return JConfig(cost=JCost(cfg.cost.value), sigma=cfg.sigma,
                   max_iters=cfg.max_iters, change_th=cfg.change_th,
                   backend=cfg.backend, cg_tol=cfg.cg_tol,
                   cg_maxiter=cfg.cg_maxiter)


@pytest.mark.parametrize("cost", [Cost.GEMAN_MCCLURE, Cost.CAUCHY])
def test_sharded_irls_matches_jax_sharded(mesh, cost):
    p, Q0 = _inputs()
    jg, tg = _graphs(p, Q0, 256, 50)
    cfg = IRLSConfig(cost=cost, backend="cg", cg_tol=1e-12, cg_maxiter=2000)

    jmesh = jpar.make_graph_mesh(8)
    Qj, wj, itj, _ = jpar.sharded_irls(jmesh, _jcfg(cfg))(
        jpar.shard_graph(jg, jmesh))
    Qt, wt, itt, _ = sharded_irls(mesh, cfg)(shard_graph(tg, mesh))

    assert _geo_deg(Qt.numpy(), Qj).max() < 1e-6
    assert itt == int(itj)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-8)


@pytest.mark.parametrize("cost", [Cost.GEMAN_MCCLURE, Cost.CAUCHY])
def test_sharded_irls_equals_single_device(mesh, cost):
    p, Q0 = _inputs()
    _, tg = _graphs(p, Q0, 256, 50)
    cfg = IRLSConfig(cost=cost, backend="cg", cg_tol=1e-12, cg_maxiter=2000)
    Qr, wr, itr, _ = irls(tg, cfg)
    Qs, ws, its, _ = sharded_irls(mesh, cfg)(shard_graph(tg, mesh))
    assert its == itr >= 2
    assert _geo_deg(Qs.numpy(), Qr.numpy()).max() < 1e-12
    assert ws.shape == (256,)
    np.testing.assert_allclose(ws.numpy(), wr.numpy(), rtol=1e-12)


def test_one_all_reduce_per_cg_matvec(mesh):
    """A sharded step issues one ``all_reduce`` for the rhs, one for the
    Jacobi diagonal and one per CG matvec (the CG runs in chunks of
    ``CG_CHECK_EVERY`` steps), and one ``all_gather`` for the weights."""
    p, Q0 = _inputs(seed=11)
    _, tg = _graphs(p, Q0, 256, 50)
    cfg = IRLSConfig(backend="cg")
    gs = shard_graph(tg, mesh)
    w = torch.ones(tg.m, dtype=tg.dtype)
    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.solver.graph import incidence_rmatvec

    free = tg.free_mask()
    w3 = so3.log_map(so3.delta_rel(tg.edges, tg.QQ, tg.Q))[..., :3]
    w3 = torch.where(tg.edge_mask[:, None], w3, torch.zeros_like(w3))
    rhs = incidence_rmatvec(tg.edges, w3, free, tg.edge_mask, tg.n)
    _, k = laplacian_cg_solve(tg.edges, w, rhs, free, tg.edge_mask,
                              tol=cfg.cg_tol, maxiter=cfg.cg_maxiter)
    matvecs = CG_CHECK_EVERY * math.ceil(int(k) / CG_CHECK_EVERY)

    mesh.all_reduces = mesh.all_gathers = 0
    Q1, w1, s1 = sharded_irls_step(mesh, cfg)(gs, w)
    assert (mesh.all_reduces, mesh.all_gathers) == (2 + matvecs, 1)
    Q2, w2, s2 = sharded_irls_step(mesh, cfg)(gs, w)
    assert torch.equal(Q1, Q2) and torch.equal(w1, w2)


def test_shard_graph_rejects_indivisible(mesh):
    p, Q0 = _inputs()
    _, tg = _graphs(p, Q0, 250, 50)        # 250 % 8 != 0
    with pytest.raises(ValueError):
        shard_graph(tg, GraphMesh(rank=0, size=8, device=torch.device("cpu"),
                                  grouped=False))
    with pytest.raises(ValueError):
        make_graph_mesh(8, device="cpu")   # the group has one rank
    # a block per rank of a divisible graph: rank 3 of 8 takes edges 96..127
    part = shard_graph(tg.pad_to(256, 50), GraphMesh(
        rank=3, size=8, device=torch.device("cpu"), grouped=False))
    assert part.m == 32 and torch.equal(part.edges, tg.pad_to(256, 50)
                                        .edges[96:128])
    assert torch.equal(part.Q, tg.Q)


def test_pad_to_equals_jax():
    p, Q0 = _inputs()
    jg, tg = _graphs(p, Q0, 256, 60)
    for name in ("edges", "QQ", "Q", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.f == int(jg.f) and (tg.m, tg.n) == (jg.m, jg.n)
    assert tg.QQ.dtype == torch.float64 and tg.edges.dtype == torch.int64
    with pytest.raises(ValueError):
        tg.pad_to(255, 60)
    with pytest.raises(ValueError):
        tg.pad_to(256, 59)


def test_sharded_pipeline_matches_jax_and_rejects_outliers(mesh):
    """``test_parallel.py:test_sharded_pipeline_rejects_outliers``'s
    problem: the port's pipeline lands where JAX's does, and the planted
    outliers are down-weighted."""
    from irotavg_tpu import so3 as jso3

    p, Q0 = _inputs(n=60, extra=90, outlier_frac=0.2, seed=3, noise_deg=1.0)
    jg, tg = _graphs(p, Q0, 256, 60)
    cfg = IRLSConfig(cost=Cost.GEMAN_MCCLURE, backend="cg", cg_tol=1e-12,
                     cg_maxiter=2000, max_iters=50)
    jmesh = jpar.make_graph_mesh(8)
    Qj, wj, itj, _ = jpar.sharded_ravg_pipeline(
        jmesh, l1_iters=5, cfg=_jcfg(cfg))(jpar.shard_graph(jg, jmesh))
    Q, w, iters, _ = sharded_ravg_pipeline(mesh, l1_iters=5, cfg=cfg)(
        shard_graph(tg, mesh))
    assert iters == int(itj)
    assert _geo_deg(Q.numpy(), Qj).max() < 1e-6
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-8)
    np.testing.assert_allclose(np.linalg.norm(Q.numpy(), axis=-1), 1.0,
                               atol=1e-12)

    d = jso3.qgeodesic(
        jso3.qmul(np.asarray(p["Q_gt"])[p["edges"][:, 1]] * [-1, -1, -1, 1],
                  jso3.qmul(p["QQ"], np.asarray(p["Q_gt"])[p["edges"][:, 0]])),
        jnp.array([0.0, 0, 0, 1]))
    out_mask = np.degrees(np.asarray(d)) > 5.0
    w = w.numpy()[:len(out_mask)]
    assert out_mask.any()
    assert w[out_mask].mean() < 0.5 * w[~out_mask].mean()


def test_sharded_pipeline_equals_single_device_schedule(mesh):
    """The pipeline is the single-device two-phase schedule: ``irls``
    with ``Cost.L1`` for ``l1_iters``, then the configured cost from unit
    weights, then ``qnormalize``."""
    from irotavg_tpu_torch import so3

    p, Q0 = _inputs(n=60, extra=90, outlier_frac=0.2, seed=3, noise_deg=1.0)
    _, tg = _graphs(p, Q0, 256, 60)
    cfg = IRLSConfig(backend="cg", cg_tol=1e-12, cg_maxiter=2000)
    Q, w, iters, score = sharded_ravg_pipeline(mesh, l1_iters=4, cfg=cfg)(
        shard_graph(tg, mesh))
    Q1, _, it1, _ = irls(tg, dataclasses.replace(cfg, cost=Cost.L1,
                                                 max_iters=4))
    Q2, w2, it2, s2 = irls(dataclasses.replace(tg, Q=Q1), cfg)
    assert iters == it1 + it2 and it1 == 4
    assert torch.equal(Q, so3.qnormalize(Q2)) and torch.equal(w, w2)
    assert score == s2

"""The port's matrix-free CG solve, the ``backend="cg"`` branches of IRLS
and L1-RA, and the incremental engine's large-window switch, against the
JAX reference in f64.

Tolerances: the CG solution within 1e-10 of its max norm with the same
iteration count; IRLS / L1-RA rotations within 1e-9 (quaternion entries,
after sign alignment) with equal iteration counts; the engine's CG window
within 1e-8 of the reference's CG engine (f64, ``large_dtype=None``) and
within 1e-6 deg of the port's dense path.  Both packages run the same CG
recurrence and differ only in summation order (the reference also pads).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from irotavg_tpu import so3 as jso3
from irotavg_tpu.engine.incremental import IncrementalRotAvg as JaxInc
from irotavg_tpu.solver import graph as jgraph
from irotavg_tpu.solver.irls import IRLSConfig as JIRLSConfig
from irotavg_tpu.solver.irls import irls as jirls
from irotavg_tpu.solver.l1ra import L1RAConfig as JL1RAConfig
from irotavg_tpu.solver.l1ra import l1ra as jl1ra
from irotavg_tpu_torch import so3
from irotavg_tpu_torch.engine.incremental import IncrementalRotAvg
from irotavg_tpu_torch.solver import graph as tgraph
from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig, irls
from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra
from synth import make_problem

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

T = torch.from_numpy


def _aligned_diff(Q1, Q2):
    """Max quaternion entry difference after per-row sign alignment."""
    Q1, Q2 = np.asarray(Q1), np.asarray(Q2)
    s = np.sign(np.sum(Q1 * Q2, axis=-1, keepdims=True))
    return np.abs(Q1 - s * Q2).max()


def _geo_deg(Q1, Q2):
    """Max rotation angle (deg) between two quaternion sets, accurate for
    tiny angles."""
    Q1 = np.asarray(Q1) / np.linalg.norm(Q1, axis=-1, keepdims=True)
    Q2 = np.asarray(Q2) / np.linalg.norm(Q2, axis=-1, keepdims=True)
    s = np.sign(np.sum(Q1 * Q2, axis=-1, keepdims=True))
    chord = np.linalg.norm(Q1 - s * Q2, axis=-1)
    return np.degrees(4 * np.arcsin(np.clip(chord / 2, 0, 1))).max()


def _warm(p, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    Q0 = p["Q_gt"] + rng.normal(scale=scale, size=p["Q_gt"].shape)
    return Q0 / np.linalg.norm(Q0, axis=1, keepdims=True)


@pytest.mark.parametrize("free_pattern", ["first_fixed", "padded"])
def test_laplacian_cg_solve_matches_reference(free_pattern):
    """40 views: the same x (to 1e-10 of its max norm) and the same
    iteration count, with a zero-weight edge, a fixed prefix and (second
    case) padded edges and nodes."""
    p = make_problem(n=40, extra_edges=60, seed=2)
    rng = np.random.default_rng(3)
    m = len(p["edges"])
    coef = rng.uniform(0.1, 2.0, m)
    coef[5] = 0.0
    rhs = rng.normal(size=(40, 3))
    free = np.arange(40) >= 2
    emask = np.ones(m, bool)
    if free_pattern == "padded":
        emask[-7:] = False
        free[-3:] = False
    args = (p["edges"], coef, rhs, free, emask)
    xj, itj = jgraph.laplacian_cg_solve(
        *(jnp.asarray(a) for a in args), tol=1e-10, maxiter=500)
    xt, itt = tgraph.laplacian_cg_solve(
        T(p["edges"]).long(), T(coef), T(rhs), T(free), T(emask),
        tol=1e-10, maxiter=500)
    xj = np.asarray(xj)
    assert int(itt) == int(itj) > tgraph.CG_CHECK_EVERY
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())
    # the diagonal guard: a free node whose weights are all zero reads 1
    d = tgraph.laplacian_diag(T(p["edges"]).long(), T(np.zeros(m)), T(free),
                              T(emask), 40)
    assert torch.equal(d, torch.ones(40, dtype=torch.float64))


def test_laplacian_cg_solve_stops_at_maxiter_and_per_column():
    """A cap below convergence stops at exactly ``maxiter`` (not at the
    next check); per-column lanes stop on their own counts, equal to the
    reference's CG on each column alone."""
    p = make_problem(n=30, extra_edges=20, seed=4)
    rng = np.random.default_rng(5)
    m = len(p["edges"])
    coef = rng.uniform(0.1, 2.0, (m, 3))
    rhs = rng.normal(size=(30, 3))
    rhs[:, 1] *= 1e-6
    free = np.arange(30) >= 1
    emask = np.ones(m, bool)
    e = T(p["edges"]).long()
    _, it5 = tgraph.laplacian_cg_solve(e, T(coef[:, 0]), T(rhs), T(free),
                                       T(emask), maxiter=5)
    assert int(it5) == 5
    xt, itt = tgraph.laplacian_cg_solve(e, T(coef), T(rhs), T(free),
                                        T(emask), tol=1e-9, maxiter=300,
                                        per_column=True)
    for a in range(3):
        xj, itj = jgraph.laplacian_cg_solve(
            jnp.asarray(p["edges"]), jnp.asarray(coef[:, a]),
            jnp.asarray(rhs[:, a:a + 1]), jnp.asarray(free),
            jnp.asarray(emask), tol=1e-9, maxiter=300)
        assert int(itt[a]) == int(itj)
        np.testing.assert_allclose(xt[:, a].numpy(), np.asarray(xj)[:, 0],
                                   rtol=0, atol=1e-10 * np.abs(xj).max())


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.2)])
def test_l1ra_then_irls_cg_match_reference(seed, outliers):
    p = make_problem(n=40, extra_edges=50, noise_deg=2.0,
                     outlier_frac=outliers, seed=seed)
    Q0 = _warm(p, seed)
    gj = jgraph.RotationGraph.create(p["edges"], p["QQ"], Q0, f=1)
    Qj, itj, _ = jl1ra(gj, JL1RAConfig(max_iters=20, backend="cg"))
    Qj2, wj, itj2, _ = jirls(dataclasses.replace(gj, Q=Qj),
                             JIRLSConfig(max_iters=50, backend="cg"))
    gt = tgraph.RotationGraph.create(p["edges"], p["QQ"], Q0, f=1)
    Qt, itt, _ = l1ra(gt, L1RAConfig(max_iters=20, backend="cg"))
    Qt2, wt, itt2, _ = irls(dataclasses.replace(gt, Q=Qt),
                            IRLSConfig(max_iters=50, backend="cg"))
    assert (itt, itt2) == (int(itj), int(itj2))
    assert _aligned_diff(Qt.numpy(), Qj) < 1e-9
    assert _aligned_diff(Qt2.numpy(), Qj2) < 1e-9
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-9)


def test_unknown_backend_raises():
    p = make_problem(n=8, extra_edges=4, seed=0)
    g = tgraph.RotationGraph.create(p["edges"], p["QQ"], _warm(p, 0), f=1)
    with pytest.raises(ValueError, match="backend"):
        irls(g, IRLSConfig(backend="qr"))
    with pytest.raises(ValueError, match="backend"):
        l1ra(g, L1RAConfig(backend="qr"))


# -- the reference's robust cases (tests/test_solver_robust.py) on CG --------


def _outlier_island_problem(seed=0):
    """Chain of 12 + node 12 attached only through gross-outlier edges
    (tests/test_solver_robust.py:32)."""
    prob = make_problem(n=12, extra_edges=8, noise_deg=1.0, seed=seed)
    rng = np.random.default_rng(seed + 1)
    edges = np.concatenate(
        [prob["edges"], np.array([[3, 12], [7, 12], [10, 12]], np.int32)])
    QQ = np.concatenate([prob["QQ"], Rsc.random(3, random_state=rng).as_quat()])
    Q_gt = np.concatenate(
        [prob["Q_gt"], Rsc.random(1, random_state=rng).as_quat()])
    return edges, QQ, Q_gt


def test_cg_talwar_all_outlier_node_stays_finite():
    edges, QQ, Q_gt = _outlier_island_problem()
    g = tgraph.RotationGraph.create(edges, QQ, Q_gt.copy(), f=1)
    Q1, _, _ = l1ra(g, L1RAConfig(max_iters=5, backend="cg"))
    cfg = IRLSConfig(cost=Cost.TALWAR, sigma=np.radians(2.0), max_iters=30,
                     backend="cg")
    Q, w, _, _ = irls(dataclasses.replace(g, Q=Q1), cfg)
    assert torch.isfinite(so3.qnormalize(Q)).all()
    assert torch.isfinite(w).all()
    assert (w[-3:] == 0).all(), "island edges should be Talwar-zeroed"


def test_cg_outlier_island_gm_pipeline_recovers_chain():
    edges, QQ, Q_gt = _outlier_island_problem()
    g = tgraph.RotationGraph.create(edges, QQ, Q_gt.copy(), f=1)
    Q1, _, _ = l1ra(g, L1RAConfig(max_iters=5, backend="cg"))
    Q, _, _, _ = irls(dataclasses.replace(g, Q=Q1),
                      IRLSConfig(max_iters=50, backend="cg"))
    Q = so3.qnormalize(Q).numpy()
    assert np.isfinite(Q).all()
    d = np.abs(np.sum(Q[:12] * Q_gt[:12], axis=-1))
    assert np.degrees(2 * np.arccos(np.clip(d, -1, 1))).max() < 4.0


def test_cg_disconnected_free_block_min_norm():
    """A free block with no path to a fixed node: CG's minimum-norm
    solution optimises it internally and nothing NaNs."""
    rng = np.random.default_rng(3)
    R = Rsc.random(8, random_state=rng)
    Q_gt = R.as_quat()
    edges = np.array([[0, 1], [1, 2], [2, 3], [0, 2], [4, 5], [5, 6], [6, 7],
                      [4, 6]], np.int32)
    QQ = (R[edges[:, 1]] * R[edges[:, 0]].inv()).as_quat()
    Q0 = np.zeros((8, 4))
    Q0[:, 3] = 1.0
    Q0[0] = Q_gt[0]
    g = tgraph.RotationGraph.create(edges, QQ, Q0, f=1)
    Q, _, _, _ = irls(g, IRLSConfig(max_iters=60, backend="cg",
                                    change_th=1e-8))
    Q = so3.qnormalize(Q)
    assert torch.isfinite(Q).all()
    assert _geo_deg(Q[:4].numpy(), Q_gt[:4]) < 1e-4
    res = so3.log_map(so3.delta_rel(T(edges[4:]).long(), T(QQ[4:]), Q))
    assert np.degrees(np.abs(res[:, 3].numpy())).max() < 1e-3


def test_cg_well_posed_solve_matches_oracle():
    """The CG backend agrees with the scipy oracle
    (tests/test_solver_robust.py:140, CG tolerance 5e-5)."""
    import ref_impl

    prob = make_problem(n=30, extra_edges=40, noise_deg=2.0,
                        outlier_frac=0.15, seed=7)
    Q0 = prob["Q_gt"].copy()
    g = tgraph.RotationGraph.create(prob["edges"], prob["QQ"], Q0, f=1)
    cfg = IRLSConfig(max_iters=50, backend="cg")
    Q, _, iters, _ = irls(g, cfg)
    A = ref_impl.make_A(prob["n"], 1, prob["edges"])
    Q_ref, _, it_ref, _ = ref_impl.irls(
        prob["QQ"], prob["edges"], A, "Geman-McClure", cfg.sigma, Q0.copy(),
        1, 50, cfg.change_th)
    assert iters == it_ref
    np.testing.assert_allclose(Q.numpy(), Q_ref, atol=5e-5)


# -- the incremental engine's large-window switch -----------------------------


def _sim_sequence(n, noise_deg, seed):
    """GT rotations and a noisy relative-rotation oracle
    (tests/test_incremental.py's simulation)."""
    rng = np.random.default_rng(seed)
    R_gt = Rsc.random(n, random_state=rng)

    def rel(i, j):
        noise = Rsc.from_rotvec(rng.normal(scale=np.radians(noise_deg),
                                           size=3))
        return (noise * R_gt[j] * R_gt[i].inv()).as_quat()

    return R_gt.as_quat(), rel


def _build(eng, n, seed, qmul):
    """tests/test_incremental.py:129's 220-view graph with a loop edge."""
    _, rel = _sim_sequence(n, 1.5, seed)
    for j in range(n):
        eng.add_view()
        for d in (1, 2, 3):
            if j - d >= 0:
                eng.add_edge(j - d, j, rel(j - d, j))
        if j == 0:
            eng.fix_pose(0)
        else:
            eng.Q[j] = qmul(rel(j - 1, j), eng.Q[j - 1])
    eng.add_edge(0, n - 1, rel(0, n - 1))
    return eng


def test_engine_large_window_runs_cg_like_reference():
    n = 220

    def tq(a, b):
        return so3.qmul(T(np.asarray(a)), T(np.asarray(b))).numpy()

    eng_cg = _build(IncrementalRotAvg(device="cpu", dense_n_max=128), n, 7,
                    tq)
    stats = eng_cg.rot_avg(5_000_000)
    assert stats["backend"] == "cg" and stats["n_pad"] == 256
    eng_dense = _build(IncrementalRotAvg(device="cpu"), n, 7, tq)
    assert eng_dense.rot_avg(5_000_000)["backend"] == "dense"
    eng_j = _build(JaxInc(dense_n_max=128, large_dtype=None), n, 7,
                   lambda a, b: np.asarray(jso3.qmul(a, b)))
    stats_j = eng_j.rot_avg(5_000_000)
    assert stats_j["backend"] == "cg" and stats_j["solve_dtype"] == "float64"
    assert stats["irls_iters"] == stats_j["irls_iters"]
    assert _aligned_diff(eng_cg.Q, eng_j.Q) < 1e-8
    assert _geo_deg(eng_cg.Q, eng_dense.Q) < 1e-6

"""The port's SO(3) functions, robust weights, L1-RA + IRLS and the
incremental windowed solver against the JAX reference, all in f64.

Tolerances: 1e-10 for so3; 1e-12 (relative) for the robust weights; at
most 1e-10 deg of rotation difference after the solves, and 1e-9
(relative) for the IRLS weights (the reference pads to power-of-two
buckets and factorises with XLA, the port solves the unpadded system
with LAPACK through torch, so results agree to rounding: about 6e-14 deg
measured).
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
from irotavg_tpu.solver.irls import Cost as JCost
from irotavg_tpu.solver.irls import IRLSConfig as JIRLSConfig
from irotavg_tpu.solver.irls import irls as jirls
from irotavg_tpu.solver.irls import update_weights as jweights
from irotavg_tpu.solver.l1ra import L1RAConfig as JL1RAConfig
from irotavg_tpu.solver.l1ra import l1ra as jl1ra
from irotavg_tpu_torch import interop, so3
from irotavg_tpu_torch.solver import graph as tgraph
from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig, irls
from irotavg_tpu_torch.solver.irls import update_weights
from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra
from synth import make_problem

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

T = torch.from_numpy


def _quats(n, seed):
    return Rsc.random(n, random_state=seed).as_quat()


def _rot_diff_deg(Q1, Q2):
    """Max rotation angle between two unit-quaternion sets, sign-invariant
    and accurate for tiny angles (4 asin(|q1 - s q2| / 2), not acos)."""
    Q1 = np.asarray(Q1) / np.linalg.norm(Q1, axis=-1, keepdims=True)
    Q2 = np.asarray(Q2) / np.linalg.norm(Q2, axis=-1, keepdims=True)
    s = np.sign(np.sum(Q1 * Q2, axis=-1, keepdims=True))
    chord = np.linalg.norm(Q1 - s * Q2, axis=-1)
    return np.degrees(4 * np.arcsin(np.clip(chord / 2, 0, 1))).max()


@pytest.mark.parametrize("name", [
    "qmul", "qconj", "qinv_flipw", "qnormalize", "exp_map", "log_map",
    "quat_to_rotmat", "qangle", "qgeodesic",
])
def test_so3_elementwise(name):
    q1, q2 = _quats(64, 0), _quats(64, 1)
    v = np.random.default_rng(2).normal(scale=1.5, size=(64, 3))
    v[0] = 0.0                                   # zero-angle guard
    q1[1] = [0.0, 0.0, 0.0, -1.0]                # negated identity
    q1[2] = -q1[3]                               # w < 0: theta wrap
    args = {"qmul": (q1, q2), "qgeodesic": (q1, q2), "exp_map": (v,),
            "qnormalize": (q1 * 3.0,)}.get(name, (q1,))
    ref = np.asarray(getattr(jso3, name)(*args))
    got = getattr(so3, name)(*[T(a) for a in args]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)


def test_rotmat_to_quat_and_delta_rel():
    R = Rsc.random(64, random_state=3).as_matrix()
    R[0] = Rsc.from_rotvec([np.pi - 1e-9, 0, 0]).as_matrix()   # near pi
    R[1] = np.diag([-1.0, -1.0, 1.0])                          # exactly pi
    np.testing.assert_allclose(so3.rotmat_to_quat(T(R)).numpy(),
                               np.asarray(jso3.rotmat_to_quat(R)),
                               atol=1e-10, rtol=0)
    p = make_problem(n=20, extra_edges=15, seed=4)
    Q = _quats(20, 5)
    np.testing.assert_allclose(
        so3.delta_rel(T(p["edges"]).long(), T(p["QQ"]), T(Q)).numpy(),
        np.asarray(jso3.delta_rel(p["edges"], p["QQ"], Q)),
        atol=1e-10, rtol=0)


@pytest.mark.parametrize("cost", [c.value for c in Cost])
def test_update_weights_all_costs(cost):
    rng = np.random.default_rng(6)
    E = rng.normal(scale=0.2, size=(200, 3)) * rng.uniform(0, 3, (200, 1))
    E[:5] = 0.0
    E[5:10] *= 1e-6
    prev = rng.uniform(0.1, 2.0, 200)
    sigma = 5.0 * np.pi / 180.0
    ref = np.asarray(jweights(JCost.parse(cost), jnp.asarray(E),
                              jnp.asarray(prev), sigma))
    got = update_weights(Cost.parse(cost), T(E), T(prev), sigma).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.2)])
def test_l1ra_then_irls_match_reference(seed, outliers):
    p = make_problem(n=40, extra_edges=50, noise_deg=2.0,
                     outlier_frac=outliers, seed=seed)
    rng = np.random.default_rng(seed)
    Q0 = p["Q_gt"] + rng.normal(scale=0.05, size=p["Q_gt"].shape)
    Q0 /= np.linalg.norm(Q0, axis=1, keepdims=True)

    gj = jgraph.RotationGraph.create(p["edges"], p["QQ"], Q0, f=1)
    Qj, itj, _ = jl1ra(gj, JL1RAConfig(max_iters=20))
    Qj2, wj, itj2, _ = jirls(dataclasses.replace(gj, Q=Qj),
                             JIRLSConfig(max_iters=50))

    gt = tgraph.RotationGraph.create(p["edges"], p["QQ"], Q0, f=1)
    Qt, itt, _ = l1ra(gt, L1RAConfig(max_iters=20))
    Qt2, wt, itt2, _ = irls(dataclasses.replace(gt, Q=Qt),
                            IRLSConfig(max_iters=50))

    assert (itt, itt2) == (int(itj), int(itj2))
    assert _rot_diff_deg(Qt.numpy(), np.asarray(Qj)) < 1e-10
    assert _rot_diff_deg(Qt2.numpy(), np.asarray(Qj2)) < 1e-10
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-9)


def test_cho_solve_rescue_matches_reference():
    """A free node with no edges makes the Laplacian singular; both
    packages rescue it to a zero update."""
    edges = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    n = 4                                        # node 3 has no edges
    coef = np.array([1.0, 2.0, 0.5])
    rhs = np.random.default_rng(7).normal(size=(n, 3))
    free = np.array([False, True, True, True])
    emask = np.ones(3, bool)
    ref = np.asarray(jgraph.laplacian_cho_solve(
        jnp.asarray(edges), jnp.asarray(coef), jnp.asarray(rhs),
        jnp.asarray(free), jnp.asarray(emask), n))
    got = tgraph.laplacian_cho_solve(T(edges).long(), T(coef), T(rhs),
                                     T(free), T(emask), n).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=1e-8)


def _replay(eng, steps):
    for op, *a in steps:
        if op == "view":
            eng.add_view()
        elif op == "edge":
            eng.add_edge(*a)
        elif op == "warm":
            j, q = a
            eng.Q[j] = q
        elif op == "fix":
            eng.fix_pose(*a)
        elif op == "solve":
            eng.rot_avg(a[0])


def _stream(n, seed):
    """A keyframe stream: views, windowed noisy edges, warm starts, one
    GT pin, and windowed solves (test_incremental.py's simulation)."""
    rng = np.random.default_rng(seed)
    R_gt = Rsc.random(n, random_state=rng)
    steps = []
    for j in range(n):
        steps.append(("view",))
        for d in range(1, 5):
            if j - d >= 0:
                r = R_gt[j] * R_gt[j - d].inv()
                noise = Rsc.from_rotvec(rng.normal(scale=0.02, size=3))
                steps.append(("edge", j - d, j, (noise * r).as_quat()))
        if j > 0:
            steps.append(("warm", j, R_gt[j].as_quat()))
        if j == 7:
            steps.append(("fix", 7, R_gt[7].as_quat()))
        if j > 0:
            steps.append(("solve", 10 if j % 6 else 50))
    return steps


def test_incremental_replay_through_interop():
    """Replay the same calls on both solvers, handing the reference's
    state to the port halfway through interop."""
    steps = _stream(24, 8)
    half = next(i for i, s in enumerate(steps)
                if s[0] == "view" and sum(t[0] == "view"
                                          for t in steps[:i]) == 12)
    jeng = JaxInc()
    _replay(jeng, steps[:half])
    teng = interop.incremental_from_arrays(jeng.Q, jeng.fixed, jeng.edges,
                                           jeng.QQ, device="cpu")
    assert teng.num_views == jeng.num_views == 12
    np.testing.assert_array_equal(teng.edges, jeng.edges)
    _replay(jeng, steps[half:])
    _replay(teng, steps[half:])
    assert _rot_diff_deg(teng.Q, np.asarray(jeng.Q)) < 1e-10
    assert teng.fixed[7] and jeng.fixed[7]


def test_incremental_skip_rules_and_lazy():
    eng = interop.incremental_from_arrays(np.zeros((0, 4)), [], np.zeros(
        (0, 2)), np.zeros((0, 4)), device="cpu")
    eng.add_view()
    assert eng.rot_avg(10) is None
    eng.add_view()
    eng.add_edge(0, 1, [0, 0, 0, 1])
    assert eng.rot_avg(2) is None                 # 1 edge < window of 2
    eng.add_view()
    eng.add_edge(1, 2, Rsc.from_rotvec([0, 0.1, 0]).as_quat())
    eng.add_edge(0, 2, Rsc.from_rotvec([0, 0.1, 0]).as_quat())
    stats = eng.rot_avg(3, lazy=True)
    assert stats["lazy"] and eng._pending is not None
    Q = eng.Q                                     # resolves
    assert eng._pending is None and np.all(np.isfinite(Q))


def test_incremental_window_above_dense_bound_raises():
    """A window above the dense bound no longer raises: it is solved with
    the matrix-free CG backend (agreement with the dense path and the
    reference is held by test_torch_cg.py)."""
    from irotavg_tpu_torch.engine.incremental import DENSE_N_MAX

    n = DENSE_N_MAX + 2
    rng = np.random.default_rng(9)
    R = Rsc.from_rotvec(np.cumsum(rng.normal(scale=0.05, size=(n, 3)), 0))
    edges = np.concatenate([np.stack([np.arange(n - d), np.arange(d, n)], 1)
                            for d in (1, 2)])
    noise = Rsc.from_rotvec(rng.normal(scale=0.01, size=(len(edges), 3)))
    QQ = (noise * R[edges[:, 1]] * R[edges[:, 0]].inv()).as_quat()
    Q0 = (Rsc.from_rotvec(rng.normal(scale=0.02, size=(n, 3))) * R).as_quat()
    eng = interop.incremental_from_arrays(Q0, np.zeros(n, bool), edges, QQ,
                                          device="cpu")
    stats = eng.rot_avg(n, l1_iters=1, irls_iters=2)
    assert stats["backend"] == "cg" and stats["n_pad"] == 2 * DENSE_N_MAX
    assert np.all(np.isfinite(eng.Q))
    assert not np.array_equal(eng.Q[1:], Q0[1:])

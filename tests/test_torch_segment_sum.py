"""The fixed-order segment sum (``ops/segment.py``) and the solver's
scatter-adds built on it (``solver/graph.py``), on the CPU.

* The plan plus the plain sum equals a sequential numpy sum in index order
  bit for bit (the order the CUDA kernel adds in), and the unsorted
  ``index_add_`` within 1e-12.
* ``incidence_rmatvec``, ``diag_partial`` + ``guard_diag`` (the port's
  ``laplacian_diag``) and ``laplacian_dense`` against the JAX package's
  scatter-adds on the same numpy inputs within 1e-12 relative, unbatched
  and batched (the JAX functions run per batch entry), with duplicate
  edges, masked padding edges ``(0, 0)`` and nodes that no edge touches.
* A solve repeats bit for bit on the CPU and equals the JAX package's
  IRLS.

The CUDA kernel runs only on a card: ``chip_smoke.py`` phase 2 holds it
to the plain version bit for bit at the solver's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irotavg_tpu.solver import graph as jgraph
from irotavg_tpu_torch.ops import segment
from irotavg_tpu_torch.solver import graph as tgraph

torch.set_num_threads(1)

T = torch.from_numpy
TOL = 1e-12


def _graph(rng, batch, n, m, n_pad=8, n_dup=10, n_lonely=5):
    """Random edges over ``n`` nodes: ``n_dup`` repeated edges, ``n_pad``
    masked ``(0, 0)`` padding edges at the end, and the last ``n_lonely``
    nodes touched by no edge; free mask with node 0 fixed."""
    hi = n - n_lonely
    i = rng.integers(0, hi, batch + (m,))
    j = (i + rng.integers(1, hi, batch + (m,))) % hi
    edges = np.stack([i, j], -1)
    edges[..., m - n_pad - n_dup:m - n_pad, :] = edges[..., :n_dup, :]
    edges[..., m - n_pad:, :] = 0
    emask = np.ones(batch + (m,), bool)
    emask[..., m - n_pad:] = False
    emask[..., :3] = False                       # masked real edges too
    free = np.ones(batch + (n,), bool)
    free[..., 0] = False
    return edges.astype(np.int64), emask, free


def _per_entry(fn, batch, *arrays):
    """``fn`` of the JAX package on every batch entry, stacked."""
    out = [np.asarray(fn(*(a[idx] for a in arrays)))
           for idx in np.ndindex(*batch)]
    return np.stack(out).reshape(batch + out[0].shape)


def _close(got, ref):
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("n_terms,rows,k", [(0, 4, 3), (1, 1, 1),
                                            (500, 40, 3), (3000, 7, 2),
                                            (200, 1000, 1)])
def test_plan_sum_is_sequential_sum(n_terms, rows, k):
    rng = np.random.default_rng(n_terms + rows)
    ids = rng.integers(0, max(rows // 2, 1), n_terms)  # leaves empty rows
    v = rng.standard_normal((n_terms, k)) * 10.0 ** rng.integers(
        -6, 6, (n_terms, 1))
    plan = segment.segment_plan(T(ids), rows)
    got = segment.segment_sum(T(v), plan).numpy()
    ref = np.zeros((rows, k))
    for t in range(n_terms):                   # index order, from 0.0
        ref[ids[t]] += v[t]
    np.testing.assert_array_equal(got, ref)
    unsorted = torch.zeros(rows, k, dtype=torch.float64).index_add_(
        0, T(ids), T(v)).numpy()
    _close(got, unsorted)
    assert plan.offsets[0] == 0 and plan.offsets[-1] == n_terms
    assert segment.segment_sum(T(v[:, 0]), plan).shape == (rows,)


def test_plan_layout():
    ids = T(np.array([2, 0, 2, 2, 0, 3]))
    plan = segment.segment_plan(ids, 5)
    assert plan.perm.tolist() == [1, 4, 0, 2, 3, 5]   # stable
    assert plan.ids.tolist() == [0, 0, 2, 2, 2, 3]
    assert plan.offsets.tolist() == [0, 2, 2, 5, 6, 6]
    assert plan.rows == 5


def test_float32_and_other_devices():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 10, 300)
    v = rng.standard_normal((300, 3)).astype(np.float32)
    plan = segment.segment_plan(T(ids), 10)
    got = segment.segment_sum(T(v), plan)
    assert got.dtype == torch.float32
    ref = np.zeros((10, 3), np.float32)
    for t in range(300):
        ref[ids[t]] += v[t]
    np.testing.assert_array_equal(got.numpy(), ref)
    # no fallback: a tensor on neither the CPU nor a card raises
    meta = torch.empty((300, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        segment.segment_sum(meta, plan)


def test_bound():
    ops, nbytes = segment.segment_sum_work(500_000, 50_000, 3, 8)
    assert ops == 1_500_000
    assert nbytes == 500_000 * 32 + 50_001 * 8 + 50_000 * 24
    ms, by = segment.bound_ms(500_000, 50_000, 3)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_rmatvec_against_jax(batch):
    rng = np.random.default_rng(10 + len(batch))
    n, m = 40, 160
    edges, emask, free = _graph(rng, batch, n, m)
    e = rng.standard_normal(batch + (m, 3))
    got = tgraph.incidence_rmatvec(T(edges), T(e), T(free), T(emask), n)
    ref = _per_entry(lambda a, b, c, d: jgraph.incidence_rmatvec(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d), n),
        batch, edges, e, free, emask)
    _close(got.numpy(), ref)
    # an explicit plan, built once, gives the same sums
    plan = tgraph.rmatvec_plan(T(edges), n)
    again = tgraph.incidence_rmatvec(T(edges), T(e), T(free), T(emask), n,
                                     plan)
    assert torch.equal(got, again)
    assert np.all(got.numpy()[..., n - 5:, :] == 0)   # untouched nodes


def test_rmatvec_broadcasts_edges():
    """One graph's edges against a stack of edge values."""
    rng = np.random.default_rng(4)
    n, m = 30, 90
    edges, emask, free = _graph(rng, (), n, m)
    e = rng.standard_normal((4, m, 3))
    got = tgraph.incidence_rmatvec(T(edges), T(e), T(free), T(emask), n)
    for b in range(4):
        one = tgraph.incidence_rmatvec(T(edges), T(e[b]), T(free),
                                       T(emask), n)
        assert torch.equal(got[b], one)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_diag_against_jax(batch):
    rng = np.random.default_rng(20 + len(batch))
    n, m = 40, 160
    edges, emask, free = _graph(rng, batch, n, m)
    coef = rng.random(batch + (m,))
    got = tgraph.laplacian_diag(T(edges), T(coef), T(free), T(emask), n)
    c = np.where(emask, coef, 0.0)[..., None]
    raw = tgraph.guard_diag(tgraph.diag_partial(T(edges), T(c), n), T(free))
    assert torch.equal(got, raw[..., 0])
    ref = _per_entry(lambda a, b, c_, d: jgraph.laplacian_diag(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c_), jnp.asarray(d), n),
        batch, edges, coef, free, emask)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_dense_against_jax(batch):
    rng = np.random.default_rng(30 + len(batch))
    n, m = 24, 100
    edges, emask, free = _graph(rng, batch, n, m, n_lonely=3)
    coef = rng.random(batch + (m,))
    got = tgraph.laplacian_dense(T(edges), T(coef), T(free), T(emask), n,
                                 ridge=1e-3)
    ref = _per_entry(lambda a, b, c, d: jgraph.laplacian_dense(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d), n,
        ridge=1e-3), batch, edges, coef, free, emask)
    _close(got.numpy(), ref)


def test_solve_repeats_and_matches_jax():
    """L1-RA then IRLS, with CG, on a small graph with outliers: two runs
    equal bit for bit, and the JAX package's answer within 1e-9 with the
    same iteration counts."""
    import dataclasses

    from irotavg_tpu.solver.irls import IRLSConfig as JIRLSConfig
    from irotavg_tpu.solver.irls import irls as jirls
    from irotavg_tpu.solver.l1ra import L1RAConfig as JL1RAConfig
    from irotavg_tpu.solver.l1ra import l1ra as jl1ra
    from irotavg_tpu_torch.solver.irls import IRLSConfig, irls
    from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra
    from synth import make_problem

    p = make_problem(n=40, extra_edges=50, outlier_frac=0.2, seed=6)
    rng = np.random.default_rng(6)
    Q0 = p["Q_gt"] + rng.normal(scale=0.05, size=p["Q_gt"].shape)
    Q0 /= np.linalg.norm(Q0, axis=1, keepdims=True)

    def port():
        g = tgraph.RotationGraph.create(p["edges"], p["QQ"], Q0, f=1)
        Q, it, _ = l1ra(g, L1RAConfig(max_iters=20, backend="cg"))
        Q2, w, it2, _ = irls(dataclasses.replace(g, Q=Q),
                             IRLSConfig(max_iters=50, backend="cg"))
        return Q2, w, (it, it2)

    Qa, wa, ita = port()
    Qb, wb, itb = port()
    assert ita == itb and torch.equal(Qa, Qb) and torch.equal(wa, wb)
    gj = jgraph.RotationGraph.create(p["edges"], p["QQ"], Q0, f=1)
    Qj, itj, _ = jl1ra(gj, JL1RAConfig(max_iters=20, backend="cg"))
    Qj2, _, itj2, _ = jirls(dataclasses.replace(gj, Q=Qj),
                            JIRLSConfig(max_iters=50, backend="cg"))
    assert ita == (int(itj), int(itj2))
    Qa, Qj2 = Qa.numpy(), np.asarray(Qj2)
    s = np.sign(np.sum(Qa * Qj2, -1, keepdims=True))
    assert np.abs(Qa - s * Qj2).max() < 1e-9

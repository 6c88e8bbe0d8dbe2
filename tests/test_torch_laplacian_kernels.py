"""The fused Laplacian kernels' plans and plain versions
(``ops/laplacian.py``) and the solves built on them, on the CPU.

* ``laplacian_matvec`` (the CG matvec) and ``laplacian_assemble`` (the
  dense Laplacian) equal the unfused composition they replace
  (``composed_laplacian.composed_matvec`` / ``composed_dense``: gathers,
  masks and a fixed-order segment sum) bit for bit, with batch shapes
  ``()``, ``(3,)`` and ``(2, 2)``, coefficients of one column and of one
  per column, three and five columns of ``x`` (the kernel takes five in
  two launches), f32 and f64, NaN and inf in masked edges' slots and on fixed
  nodes, fixed and padded nodes, nodes no edge touches, duplicate edges,
  masked ``(0, 0)`` padding edges and a non-zero ``ridge``.
* Both against the JAX package's matvec (``incidence_rmatvec`` of
  ``incidence_matvec``) and ``laplacian_dense`` on the same numpy inputs
  within 1e-12 relative, the tolerance of ``test_torch_segment_sum.py``
  (the two packages add in different orders).
* Whole ``irls`` / ``l1ra`` runs with each backend, one graph and a batch
  of windows, give the same bits as on the composition
  (``composed_laplacian.composed_route``), and each plan is built once per call
  whatever the iteration count.
* The plans' layout, the int32 overflow and device checks, the bounds,
  and SIFT's histograms as a segment sum equal to ``scatter_add``.

The CUDA kernels run only on a card: ``chip_smoke.py`` phase 2 holds them
to these plain versions bit for bit at the solver's shapes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composed_laplacian import composed_dense, composed_matvec, \
    composed_route
from irotavg_tpu.solver import graph as jgraph
from irotavg_tpu_torch.frontend import sift
from irotavg_tpu_torch.ops import laplacian as lap
from irotavg_tpu_torch.ops import segment
from irotavg_tpu_torch.solver import graph as tgraph
from irotavg_tpu_torch.solver.irls import IRLSConfig, irls
from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra
from synth import make_problem

torch.set_num_threads(1)

T = torch.from_numpy
TOL = 1e-12
DTYPES = {"f64": torch.float64, "f32": torch.float32}
BATCHES = [(), (3,), (2, 2)]


def _graph(rng, batch, n, m, n_pad=8, n_dup=10, n_lonely=4, n_padded=2):
    """Random edges over ``n`` nodes: ``n_dup`` repeated edges, ``n_pad``
    masked ``(0, 0)`` padding edges at the end and 3 masked real edges,
    the last ``n_lonely`` nodes touched by no edge, of which the last
    ``n_padded`` are padding (not free); nodes 0 and 5 fixed."""
    hi = n - n_lonely
    i = rng.integers(0, hi, batch + (m,))
    j = (i + rng.integers(1, hi, batch + (m,))) % hi
    edges = np.stack([i, j], -1)
    edges[..., m - n_pad - n_dup:m - n_pad, :] = edges[..., :n_dup, :]
    edges[..., m - n_pad:, :] = 0
    emask = np.ones(batch + (m,), bool)
    emask[..., m - n_pad:] = False
    emask[..., :3] = False
    free = np.ones(batch + (n,), bool)
    free[..., [0, 5]] = False
    free[..., n - n_padded:] = False
    return edges.astype(np.int64), emask, free


def _poison(v, mask):
    """NaN and inf in the slots ``mask`` marks as unused."""
    v = v.copy()
    bad = np.broadcast_to(~mask, v.shape).copy()
    idx = np.flatnonzero(bad)
    flat = v.reshape(-1)
    flat[idx[::2]] = np.nan
    flat[idx[1::2]] = np.inf
    return v


def _bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    ints = {8: torch.int64, 4: torch.int32}[a.element_size()]
    assert torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _per_entry(fn, batch, *arrays):
    out = [np.asarray(fn(*(a[idx] for a in arrays)))
           for idx in np.ndindex(*batch)]
    return np.stack(out).reshape(batch + out[0].shape)


def _close(got, ref):
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


def _matvec_inputs(batch, ck, dtype, seed, k=3):
    rng = np.random.default_rng(seed)
    n, m = 30, 120
    edges, emask, free = _graph(rng, batch, n, m)
    x = rng.standard_normal(batch + (n, k))
    # a fixed node's and a masked edge's values must never be read
    x = _poison(x, free[..., None])
    c = rng.random(batch + (m, ck)) + 0.1
    c = _poison(c, emask[..., None])
    return (T(edges), T(emask), T(free), T(x).to(dtype), T(c).to(dtype), n,
            (edges, emask, free, x, c))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ck", [1, 3])
@pytest.mark.parametrize("batch", BATCHES)
def test_matvec_equals_composition(batch, ck, dtype):
    edges, emask, free, x, c, n, _ = _matvec_inputs(batch, ck,
                                                    DTYPES[dtype], len(batch))
    plan = lap.matvec_plan(edges, free, emask, n, batch)
    got = lap.laplacian_matvec(x, c, plan)
    ref = composed_matvec(edges, c, x, free, emask, n,
                          tgraph.rmatvec_plan(edges, n))
    _bits(got, ref)
    assert torch.isfinite(got).all()
    assert torch.all(got[..., ~free[(0,) * len(batch)], :] == 0)
    # the same plan built from one graph broadcast over the batch
    if batch:
        one = lap.matvec_plan(edges[(0,) * len(batch)],
                              free[(0,) * len(batch)],
                              emask[(0,) * len(batch)], n, batch)
        xb = x.clone()
        cb = c[(0,) * len(batch)].expand_as(c)
        got_b = lap.laplacian_matvec(xb, cb, one)
        ref_b = composed_matvec(
            edges[(0,) * len(batch)], cb, xb, free[(0,) * len(batch)],
            emask[(0,) * len(batch)], n,
            tgraph.rmatvec_plan(edges[(0,) * len(batch)], n, batch))
        _bits(got_b, ref_b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ck", [1, 5])
@pytest.mark.parametrize("batch", BATCHES)
def test_matvec_five_columns(batch, ck, dtype):
    """Five columns of ``x``, more than one launch keeps in registers (the
    kernel takes them in two launches, four columns and one; the plan and
    the plain version take any number)."""
    assert lap.MATVEC_MAX_COLS < 5
    edges, emask, free, x, c, n, _ = _matvec_inputs(
        batch, ck, DTYPES[dtype], 60 + len(batch), k=5)
    plan = lap.matvec_plan(edges, free, emask, n, batch)
    got = lap.laplacian_matvec(x, c, plan)
    _bits(got, composed_matvec(edges, c, x, free, emask, n,
                               tgraph.rmatvec_plan(edges, n)))
    # each group of columns alone gives the same bits
    for q in range(0, 5, lap.MATVEC_MAX_COLS):
        cols = slice(q, q + lap.MATVEC_MAX_COLS)
        _bits(lap.laplacian_matvec(x[..., cols].contiguous(),
                                   c if ck == 1 else c[..., cols].contiguous(),
                                   plan), got[..., cols])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("batch", BATCHES)
def test_assemble_equals_composition(batch, lanes, dtype):
    rng = np.random.default_rng(40 + len(batch))
    n, m = 24, 100
    edges, emask, free = _graph(rng, batch, n, m)
    cb = batch + ((lanes,) if lanes else ())
    coef = rng.standard_normal(cb + (m,))
    edges, emask, free = T(edges), T(emask), T(free)
    if lanes:
        edges, emask, free = (edges[..., None, :, :], emask[..., None, :],
                              free[..., None, :])
    coef = T(_poison(coef, emask.numpy())).to(DTYPES[dtype])
    ridge = 1e-3 if lanes is None else 0.0
    plan = lap.dense_plan(edges, free, emask, n, cb)
    got = lap.laplacian_assemble(coef, plan, ridge)
    ref = composed_dense(edges, coef, free, emask, n, ridge)
    _bits(got, ref)
    assert got.shape == cb + (n, n) and torch.isfinite(got).all()
    # the solver's entry point builds the same plan itself
    _bits(tgraph.laplacian_dense(edges, coef, free, emask, n, ridge), ref)


@pytest.mark.parametrize("batch", BATCHES)
def test_matvec_against_jax(batch):
    edges, emask, free, x, c, n, raw = _matvec_inputs(batch, 1,
                                                      torch.float64, 7)
    plan = lap.matvec_plan(edges, free, emask, n, batch)
    cm = torch.where(emask[..., None], c, torch.zeros_like(c))
    got = lap.laplacian_matvec(x, cm, plan).numpy()
    e_np, em_np, fr_np, x_np, c_np = raw
    c_np = np.where(em_np[..., None], c_np, 0.0)[..., 0]

    def ref(e, em, fr, xx, cc):
        e, em, fr = jnp.asarray(e), jnp.asarray(em), jnp.asarray(fr)
        ax = jgraph.incidence_matvec(e, jnp.asarray(xx), fr, em)
        return jgraph.incidence_rmatvec(e, ax * jnp.asarray(cc)[:, None], fr,
                                        em, n)

    _close(got, _per_entry(ref, batch, e_np, em_np, fr_np, x_np, c_np))


@pytest.mark.parametrize("batch", BATCHES)
def test_assemble_against_jax(batch):
    rng = np.random.default_rng(50 + len(batch))
    n, m = 24, 100
    edges, emask, free = _graph(rng, batch, n, m)
    coef = rng.random(batch + (m,))
    got = tgraph.laplacian_dense(T(edges), T(coef), T(free), T(emask), n,
                                 ridge=1e-3)
    ref = _per_entry(lambda a, b, c, d: jgraph.laplacian_dense(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d), n,
        ridge=1e-3), batch, edges, coef, free, emask)
    _close(got.numpy(), ref)


def _problem(batch):
    """A warm-started graph with outliers (one, or a batch of three
    windows of the same size)."""
    def one(seed):
        p = make_problem(n=30, extra_edges=40, outlier_frac=0.2, seed=seed)
        rng = np.random.default_rng(seed)
        Q0 = p["Q_gt"] + rng.normal(scale=0.05, size=p["Q_gt"].shape)
        return p["edges"], p["QQ"], Q0 / np.linalg.norm(Q0, axis=1,
                                                        keepdims=True)

    if not batch:
        return tgraph.RotationGraph.create(*one(8), f=1)
    parts = [one(20 + k) for k in range(3)]
    m = min(len(e) for e, _, _ in parts)
    return tgraph.RotationGraph.create(
        np.stack([e[:m] for e, _, _ in parts]),
        np.stack([q[:m] for _, q, _ in parts]),
        np.stack([q for _, _, q in parts]), f=np.array([1, 2, 1]))


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("backend", ["dense", "cg"])
def test_solves_equal_composition(backend, batch):
    """L1-RA then IRLS: the same bits and iterations on the fused kernels
    as on the unfused composition."""
    g = _problem(batch)

    def run():
        Q, it, _ = l1ra(g, L1RAConfig(max_iters=3, backend=backend))
        Q2, w, it2, _ = irls(dataclasses.replace(g, Q=Q),
                             IRLSConfig(max_iters=20, backend=backend))
        return Q, Q2, w, it, it2

    fused = run()
    with composed_route():
        composed = run()
    for a, b in zip(fused, composed):
        if isinstance(a, torch.Tensor):
            _bits(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("backend", ["dense", "cg"])
def test_plans_built_once_per_call(backend):
    g = _problem(False)
    builders = (segment.segment_plan, lap.matvec_plan, lap.dense_plan)
    seen = []
    for iters in (1, 6):
        for fn in builders:
            fn.builds = 0
        irls(g, IRLSConfig(max_iters=iters, change_th=0.0, backend=backend))
        l1ra(g, L1RAConfig(max_iters=iters, change_th=0.0, backend=backend))
        seen.append(tuple(fn.builds for fn in builders))
    # per call: the rmatvec plan, and the diagonal's and the matvec's
    # (CG) or the dense one (dense)
    want = (4, 2, 0) if backend == "cg" else (2, 0, 2)
    assert seen == [want, want]


def test_matvec_plan_layout():
    # 0 fixed; edge 2 masked; node 3 padding, touched by no edge
    edges = torch.tensor([[0, 1], [1, 2], [2, 0], [2, 1]])
    emask = torch.tensor([True, True, False, True])
    free = torch.tensor([False, True, True, False])
    plan = lap.matvec_plan(edges, free, emask, 4)
    assert plan.offsets.tolist() == [0, 0, 3, 5, 5]
    # row 1: +e of edges 0 and 3, then -e of edge 1; row 2: +e of edge 1,
    # then -e of edge 3; node 0 is fixed, so it reads -1
    assert plan.records.tolist() == [[0, -1], [3, 2], [~1, 2],
                                     [1, 1], [~3, 1]]
    assert plan.records.dtype == torch.int32
    assert (plan.rows, plan.n, plan.m, plan.batch) == (4, 4, 4, ())


def test_dense_plan_layout():
    edges = torch.tensor([[0, 1], [1, 2], [2, 1]])
    emask = torch.tensor([True, True, True])
    free = torch.tensor([False, True, True])
    plan = lap.dense_plan(edges, free, emask, 3)
    assert plan.offsets.tolist() == [0, 0, 5, 9]
    # row 1: (i,i) edge 1, (j,j) edges 0 and 2, (i,j) edge 1, (j,i) edge
    # 2; row 2: (i,i) edge 2, (j,j) edge 1, (i,j) edge 2, (j,i) edge 1
    assert plan.records.tolist() == [[1, 1], [1, 0], [1, 2], [2, ~1],
                                     [2, ~2], [2, 2], [2, 1], [1, ~2],
                                     [1, ~1]]
    assert plan.free.tolist() == [False, True, True]


def test_int32_and_device_checks():
    edges = torch.zeros((4, 2), dtype=torch.int64)
    emask = torch.ones(4, dtype=torch.bool)
    free = torch.ones((1, 4096), dtype=torch.bool)
    for build in (lap.matvec_plan, lap.dense_plan):
        with pytest.raises(OverflowError, match="int32"):
            build(edges, free, emask, 4096, (2**20,))
    plan = lap.matvec_plan(edges, free[0], emask, 4096)
    # no fallback: a tensor on neither the CPU nor a card raises
    meta = torch.empty((4096, 3), dtype=torch.float64, device="meta")
    c = torch.empty((4, 1), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lap.laplacian_matvec(meta, c, plan)
    with pytest.raises(ValueError, match="no kernel"):
        lap.laplacian_assemble(c[:, 0], lap.dense_plan(edges, free[0], emask,
                                                       4096))
    # a card's values with the plan left on the CPU
    with pytest.raises(ValueError, match="lies on cpu"):
        lap._check_cuda("laplacian_matvec", torch.device("cuda", 0),
                        torch.float64, {"records": plan.records})
    with pytest.raises(ValueError, match="x of shape"):
        lap.laplacian_matvec(torch.zeros(5, 3, dtype=torch.float64),
                             torch.zeros(4, 1, dtype=torch.float64), plan)


def test_bounds():
    ops, nbytes = lap.laplacian_matvec_work(50_000, 250_000, 500_000, 3, 1,
                                            8)
    assert ops == 4_500_000
    assert nbytes == (2 * 50_000 * 24 + 250_000 * 8 + 500_000 * 8
                      + 50_001 * 4)
    ms, by = lap.bound_ms(ops, nbytes)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    ops, nbytes = lap.laplacian_assemble_work(13, 13, 36, 100, 8)
    assert ops == 100 + 169
    assert nbytes == 169 * 8 + 36 * 8 + 800 + 14 * 4 + 13


def test_sift_histograms_equal_scatter_add():
    rng = np.random.default_rng(3)
    for n_bins, samples in ((36, 289), (128, 256)):
        bins = T(rng.integers(0, n_bins, (60, samples)))
        vals = T(rng.random((60, samples)).astype(np.float32))
        ref = torch.zeros((60, n_bins)).scatter_add(1, bins, vals)
        _bits(sift._bin_sums(bins, vals, n_bins), ref)

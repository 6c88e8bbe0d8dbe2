"""The port's batched window solver against the JAX reference's
``solve_windows`` in f64, and against the port's own single-window solve.

The windows come from bench.py:520-535's generator
(``chip_smoke.bench_windows``, which phase 5 runs on the card).
Tolerances: Q and weights within 1e-9 (quaternion entries after sign
alignment; weights relative) with equal per-window iteration counts.
Both packages run the same masked arithmetic on the same padded windows;
they differ in summation order only.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bench_windows
from irotavg_tpu.engine.batched import solve_windows as jsolve_windows
from irotavg_tpu_torch.engine.batched import (
    batched_window_solver, pack_windows, solve_windows,
)
from irotavg_tpu_torch.engine.incremental import _window_solve
from synth import make_problem

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

SIGMA = float(np.radians(5.0))


def _aligned_diff(Q1, Q2):
    s = np.sign(np.sum(Q1 * Q2, axis=-1, keepdims=True))
    return np.abs(Q1 - s * Q2).max()


def test_solve_windows_matches_reference():
    problems = bench_windows(8)
    Qj, wj, itj, _ = jsolve_windows(problems, dtype=np.float64, m_pad=64,
                                    n_pad=16)
    Qt, wt, itt, _ = solve_windows(problems, m_pad=64, n_pad=16,
                                   device="cpu")
    np.testing.assert_array_equal(itt, np.asarray(itj))
    assert len(set(itt.tolist())) > 1       # windows stop on their own
    for k in range(8):
        assert Qt[k].shape == problems[k][2].shape
        assert _aligned_diff(Qt[k], np.asarray(Qj[k])) < 1e-9
        np.testing.assert_allclose(wt[k], np.asarray(wj[k]), rtol=1e-9,
                                   atol=0)


def test_batched_equals_single_window_solves():
    """The port's batch against its own per-window engine solve."""
    problems = bench_windows(5, seed=4)
    Qb, wb, itb, _ = solve_windows(problems, m_pad=64, n_pad=16,
                                   device="cpu")
    for k, (e, qq, q0, f) in enumerate(problems):
        Q1, w1, it1, _ = _window_solve(
            torch.as_tensor(e).long(), torch.as_tensor(qq),
            torch.as_tensor(q0), f, l1_iters=100, irls_iters=100,
            sigma=SIGMA, change_th=1e-3, cost="Geman-McClure")
        assert int(itb[k]) == it1
        assert _aligned_diff(Qb[k], Q1.numpy()) < 1e-9
        np.testing.assert_allclose(wb[k], w1.numpy(), rtol=1e-9, atol=0)


def test_fixed_rotations_untouched():
    """A mirror of tests/test_batched_windows.py:86."""
    problems = bench_windows(4, seed=9)
    problems = [(e, qq, q0, f + k % 2) for k, (e, qq, q0, f)
                in enumerate(problems)]
    Q_list, _, _, _ = solve_windows(problems, device="cpu")
    for (e, qq, q0, f), Qk in zip(problems, Q_list):
        np.testing.assert_allclose(Qk[:f], q0[:f], atol=0)


def test_mixed_convergence_iters_are_per_window():
    """A mirror of tests/test_batched_windows.py:93: an already-converged
    window is not dragged through the hard window's iterations, and its
    result equals its solve alone."""
    easy = bench_windows(1, seed=5)[0]
    p = make_problem(n=12, extra_edges=12, noise_deg=0.01, outlier_frac=0.0,
                     seed=77)
    trivial = (p["edges"].astype(np.int32), p["QQ"], p["Q_gt"].copy(), 2)
    Q_list, _, iters, _ = solve_windows([easy, trivial], device="cpu")
    assert int(iters[1]) < int(iters[0])
    Q_alone, _, it_alone, _ = solve_windows([trivial], device="cpu")
    assert int(it_alone[0]) == int(iters[1])
    assert _aligned_diff(Q_list[1], Q_alone[0]) < 1e-12


def test_padding_and_device_policy(monkeypatch):
    problems = bench_windows(2)
    with pytest.raises(ValueError, match="exceeds padding"):
        pack_windows(problems, m_pad=8, n_pad=16)
    packed = pack_windows(problems, m_pad=64, n_pad=16)
    solve = batched_window_solver(64, 32)
    with pytest.raises(ValueError, match="expected"):
        solve(*packed)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        solve_windows(problems)

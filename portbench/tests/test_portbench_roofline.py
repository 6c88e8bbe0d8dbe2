"""The roofline work functions against counts made by hand."""

import pytest
import torch

from pbkit import peaks, spec


def test_match_best2_counts_the_pairs_the_gate_admits():
    m = spec.roofline("match_best2")
    desc1 = torch.zeros(3, 8, dtype=torch.int32)
    desc2 = torch.zeros(4, 8, dtype=torch.int32)
    rowf = torch.zeros(3, 8)
    colf = torch.zeros(4, 8)
    rowf[:, 0] = torch.tensor([1, 1, 0.0])            # row 2 invalid
    colf[:, 0] = torch.tensor([1, 1, 1, 0.0])         # column 3 invalid
    rowf[:, 1] = torch.tensor([5, 6, 5.0])
    colf[:, 1] = torch.tensor([5, 5, 6, 5.0])
    # none: 2 valid rows x 3 valid columns; node: same node id as well
    assert m.work(desc1, desc2, rowf, colf, "none")[0] == 2 * 256 * 6
    assert m.work(desc1, desc2, rowf, colf, "node")[0] == 2 * 256 * 3
    nbytes = (3 + 4) * (32 + 32) + 3 * 12
    assert m.work(desc1, desc2, rowf, colf, "node")[1] == nbytes
    # local: |dx|, |dy| within the row's radius, octaves within two
    rowf[0, 2:6] = torch.tensor([10.0, 10.0, 0.0, 2.0])
    colf[:3, 2] = torch.tensor([11.0, 13.0, 9.0])
    colf[:3, 3] = torch.tensor([10.0, 10.0, 12.0])
    colf[:3, 4] = torch.tensor([2.0, 0.0, 3.0])
    rowf[1, 5] = -1.0                                 # admits nothing
    assert m.work(desc1, desc2, rowf, colf, "local")[0] == 2 * 256 * 1
    t = m.least_s((desc1, desc2, rowf, colf, "local"), {})
    assert t == max(512 / peaks.INT8_TC_OPS, nbytes / peaks.HBM_BYTES)


def test_match_best2_shared_column_frame_and_epipolar():
    m = spec.roofline("match_best2")
    desc1 = torch.zeros(2, 2, 8, dtype=torch.int32)
    desc2 = torch.zeros(3, 8, dtype=torch.int32)
    rowf = torch.zeros(2, 2, 8)
    colf = torch.zeros(3, 8)
    rowf[..., 0] = 1
    colf[:, 0] = 1
    rowf[..., 2] = torch.tensor([[0.0, 5.0], [0.0, 0.0]])   # x
    rowf[..., 5] = 4.0                                      # th: d^2 < 4
    colf[:, 5] = 1.0                                        # line x = c
    colf[:, 7] = torch.tensor([0.0, -1.0, -5.0])
    # distances |x - (-c)|: row x=0 -> 0, 1, 5; x=5 -> 5, 4, 0
    ops, nbytes = m.work(desc1, desc2, rowf, colf, "epipolar_nonode")
    assert ops == 2 * 256 * (2 + 1 + 2 + 2)
    assert nbytes == (4 + 3) * 64 + 4 * 12


def test_cho_solve_counts_factorisations_and_solves():
    c = spec.roofline("cho_solve")
    n, m, k = 10, 17, 3
    edges = torch.zeros(m, 2, dtype=torch.int64)
    coef = torch.zeros(m, dtype=torch.float64)
    rhs = torch.zeros(n, k, dtype=torch.float64)
    free = torch.ones(n, dtype=torch.bool)
    emask = torch.ones(m, dtype=torch.bool)
    flops, nbytes = c.work((edges, coef, rhs, free, emask, n), {})
    assert flops == pytest.approx(n ** 3 / 3 + k * 2 * n ** 2)
    assert nbytes == m * 16 + m * 8 + 2 * n * k * 8 + n + m

    class Cfg:
        backend = "dense"

    sigx = torch.zeros(m, 3, dtype=torch.float64)
    w1p = torch.zeros(n, 3, dtype=torch.float64)
    flops, _ = c.work((edges, sigx, w1p, free, emask, n, Cfg, None), {})
    assert flops == pytest.approx(3 * (n ** 3 / 3 + 2 * n ** 2))
    Cfg.backend = "cg"
    assert c.least_s((edges, sigx, w1p, free, emask, n, Cfg, None), {}) \
        is None

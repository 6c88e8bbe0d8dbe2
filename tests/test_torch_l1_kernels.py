"""L1-RA's route on the card (``ops/l1decode.py``, ``csrc/l1_decode.cu``)
as far as the CPU can check it: the CPU runs the plain composition and no
kernel, the kernels' wrapper refuses any device but CUDA before it builds
anything, and the card's outer loop (driven here by a stand-in for the
kernels) runs init, every Newton step through the solver's own
``_newton_dx`` and the update, reading the host once per outer step.
``chip_smoke.py`` holds the kernels to the composition on the card."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from irotavg_tpu_torch.ops import l1decode
from irotavg_tpu_torch.solver.graph import RotationGraph
from irotavg_tpu_torch.solver.irls import _plans

from synth import make_problem

l1 = importlib.import_module("irotavg_tpu_torch.solver.l1ra")


def _graph(seed=0, n=30):
    pr = make_problem(n=n, extra_edges=40, noise_deg=2.0, outlier_frac=0.2,
                      seed=seed, window_chords=2)
    return RotationGraph.create(pr["edges"], pr["QQ"], pr["Q_gt"], f=1,
                                dtype=torch.float64)


@pytest.mark.parametrize("backend", ["dense", "cg"])
def test_cpu_runs_the_composition_and_no_kernel(backend):
    g = _graph(1)
    cfg = l1.L1RAConfig(max_iters=20, backend=backend)
    before = l1decode.L1Kernels.launches
    Q, it, score = l1.l1ra(g, cfg)
    Qp, itp, scp, steps = l1._l1ra_plain(g, cfg, _plans(g, backend, lanes=3))
    assert l1decode.L1Kernels.launches == before
    assert torch.equal(Q, Qp) and it == int(itp) and score == float(scp)
    assert steps == it


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernels_refuse_other_devices(device):
    g = _graph(2)
    plan = _plans(g, "dense", lanes=3).rmatvec
    gd = dataclasses.replace(g, Q=g.Q.to(device), QQ=g.QQ.to(device))
    with pytest.raises(ValueError, match="no version for device"):
        l1decode.L1Kernels(gd, plan, l1.L1RAConfig(), l1.PDTOL)


class _StandIn:
    """Records the calls the card's loop makes and stops after ``steps``
    outer steps; the Newton inputs it hands out are the composition's
    shapes and layouts (transposed lane-major buffers)."""

    def __init__(self, g, rmatvec, cfg, pdtol, steps=3):
        assert pdtol == l1.PDTOL
        self.g, self.cfg, self.calls = g, cfg, []
        self.left = steps
        B, m, n = 1, g.m, g.n
        self.sigx = torch.ones((B, 3, m), dtype=g.dtype)
        self.w1p = torch.linspace(-1, 1, B * 3 * n,
                                  dtype=g.dtype).view(B, 3, n)
        _StandIn.last = self

    def any_active(self):
        self.calls.append("read")
        return self.left > 0

    def init(self):
        self.calls.append("init")

    def pre(self):
        self.calls.append("pre")
        n, m = self.g.n, self.g.m
        return (self.sigx.view(3, m).transpose(-1, -2),
                self.w1p.view(3, n).transpose(-1, -2))

    def post(self, dx, last):
        assert tuple(dx.shape) == (self.g.n, 3)
        self.calls.append(("post", last))

    def update(self):
        self.calls.append("update")
        self.left -= 1

    def result(self):
        return self.g.Q, torch.tensor(3), torch.tensor(0.5)


@pytest.mark.parametrize("pd_iters", [1, 2])
def test_card_loop_order_and_newton_through_the_module(monkeypatch,
                                                       pd_iters):
    g = _graph(3)
    cfg = l1.L1RAConfig(max_iters=5, pd_iters=pd_iters)
    newton = []
    orig = l1._newton_dx

    def spy(*args):
        newton.append(args[1].shape)
        return orig(*args)

    monkeypatch.setattr(l1, "L1Kernels", _StandIn)
    monkeypatch.setattr(l1, "_newton_dx", spy)   # the benchmark wraps it so
    Q, it, score, steps = l1._l1ra_kernels(g, cfg, _plans(g, "dense",
                                                          lanes=3))
    step = ["init"] + ["pre", ("post", False)] * (pd_iters - 1) + \
        ["pre", ("post", True), "update"]
    assert _StandIn.last.calls == ["read"] + (step + ["read"]) * 3
    assert steps == 3 and len(newton) == 3 * pd_iters
    assert all(s == (g.m, 3) for s in newton)


def test_newton_inputs_keep_the_composition_layout():
    """``_newton_dx`` receives ``sigx (m, L)`` and ``w1p (n, L)`` whose
    transposes are the lane-major buffers, so the dense assembly and the
    solve read them without a copy; the result equals that of contiguous
    inputs bit for bit."""
    g = _graph(4)
    plan = _plans(g, "dense", lanes=3)
    cfg = l1.L1RAConfig()
    rng = np.random.default_rng(0)
    sig_lm = torch.as_tensor(rng.uniform(0.5, 2.0, (3, g.m)))
    w_lm = torch.as_tensor(rng.normal(size=(3, g.n)))
    free = g.free_mask()
    a = l1._newton_dx(g.edges, sig_lm.transpose(0, 1), w_lm.transpose(0, 1),
                      free, g.edge_mask, g.n, cfg, plan)
    b = l1._newton_dx(g.edges, sig_lm.t().contiguous(),
                      w_lm.t().contiguous(), free, g.edge_mask, g.n, cfg,
                      plan)
    assert sig_lm.transpose(0, 1).transpose(-1, -2).is_contiguous()
    assert torch.equal(a, b)


def test_kernel_constants_are_the_decoders():
    """The line search's constants in ``csrc/l1_decode.cu`` are
    ``solver/l1ra.py``'s."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(l1decode.__file__), os.pardir,
                            "csrc", "l1_decode.cu")).read()

    def const(name):
        return float(re.search(rf"constexpr \w+ {name} = ([0-9.]+);",
                               src).group(1))

    assert const("kMaxBacktrack") == l1._MAX_BACKTRACK
    assert const("kAlpha") == l1._ALPHA
    assert const("kBeta") == l1._BETA
    assert const("kTwoMu") == 2.0 * l1._MU
    assert const("kLanes") == l1decode.LANES

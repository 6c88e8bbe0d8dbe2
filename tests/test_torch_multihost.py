"""The port's distributed solve across real processes on the CPU: two gloo
ranks joined through a ``file://`` store, each a fresh interpreter that
imports only the port.  Mirrors ``tests/test_multihost.py`` (its 120-node
problem and schedule) in f64: rank 0's rotations must match the JAX
package's single-device two-phase schedule on the same problem within
1e-6 deg (f64, so only the summation order differs), and both ranks must
report the same iterations.  The CG runs to ``tests/test_parallel.py``'s
tolerance (1e-12, 2000 steps): at ``test_multihost.py``'s 100 steps it
stops unconverged in the ill-conditioned L1 phase, and even the two
packages' single-device solves then differ by 1.2e-4 deg.  Also
``entry.dryrun_multichip(2)`` and the scaling probe's layout over 1 and 2
ranks."""

import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120

PROBLEM_DEF = """
import numpy as np
from scipy.spatial.transform import Rotation as Rsc

L1_ITERS = 2
CFG = dict(backend="cg", cg_tol=1e-12, cg_maxiter=2000, max_iters=6,
           change_th=1e-5)


def make_inputs():
    rng = np.random.default_rng(4)
    n = 120
    R_gt = Rsc.from_rotvec(rng.normal(scale=0.4, size=(n, 3)))
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    ii = rng.integers(0, n - 4, 160)
    jj = ii + rng.integers(2, 4, 160)
    edges = np.concatenate([chain, np.stack([ii, jj], 1)]).astype(np.int32)
    Rrel = R_gt[edges[:, 1]] * R_gt[edges[:, 0]].inv()
    noise = Rsc.from_rotvec(rng.normal(scale=np.radians(2.0),
                                       size=(len(edges), 3)))
    QQ = (noise * Rrel).as_quat()
    Q0 = np.zeros((n, 4))
    Q0[:, 3] = 1.0
    Q0[0] = R_gt[0].as_quat()
    return edges, QQ, Q0
"""

WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tmp!r})
rank, world, store, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
import torch
torch.set_num_threads(1)
from irotavg_tpu_torch.parallel import (
    init_multihost, make_graph_mesh, shard_graph, sharded_ravg_pipeline,
)
from irotavg_tpu_torch.solver.graph import RotationGraph
from irotavg_tpu_torch.solver.irls import IRLSConfig
from problem_def import CFG, L1_ITERS, make_inputs

assert init_multihost(init_method="file://" + store, num_processes=world,
                      process_id=rank, device="cpu") == (rank, world)
mesh = make_graph_mesh(device="cpu")
edges, QQ, Q0 = make_inputs()
g = RotationGraph.create(edges, QQ, Q0, f=1, dtype=torch.float64,
                         device="cpu")
g = g.pad_to(-(-g.m // world) * world, g.n)
Q, w, iters, score = sharded_ravg_pipeline(
    mesh, l1_iters=L1_ITERS, cfg=IRLSConfig(**CFG))(shard_graph(g, mesh))
if rank == 0:
    import numpy as np
    np.savez(out_path, Q=Q.numpy(), w=w.numpy())
print(json.dumps({{"rank": rank, "iters": iters, "m_local": shard_graph(
    g, mesh).m, "all_reduces": mesh.all_reduces, "ok": True}}), flush=True)
torch.distributed.destroy_process_group()
"""


def _geo_deg(Qa, Qb):
    Qa = Qa / np.linalg.norm(Qa, axis=-1, keepdims=True)
    Qb = Qb / np.linalg.norm(Qb, axis=-1, keepdims=True)
    s = np.sign(np.sum(Qa * Qb, axis=-1, keepdims=True))
    chord = np.linalg.norm(Qa - s * Qb, axis=-1)
    return np.degrees(4 * np.arcsin(np.clip(chord / 2, 0, 1)))


def test_two_process_distributed_solve(tmp_path):
    (tmp_path / "problem_def.py").write_text(PROBLEM_DEF)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=REPO, tmp=str(tmp_path)))
    store = str(tmp_path / "store")
    out_path = str(tmp_path / "q0.npz")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "RANK", "WORLD_SIZE")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "2", store, out_path],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail("a gloo worker timed out")
            assert p.returncode == 0, e[-2000:]
            outs.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(o["ok"] for o in outs)
    assert outs[0]["iters"] == outs[1]["iters"] >= 3
    assert outs[0]["all_reduces"] == outs[1]["all_reduces"]
    assert [o["m_local"] for o in outs] == [140, 140]

    # the JAX package's single-device schedule on the same problem, f64
    sys.path.insert(0, str(tmp_path))
    try:
        import problem_def
    finally:
        sys.path.pop(0)
    from irotavg_tpu import so3
    from irotavg_tpu.solver.graph import RotationGraph
    from irotavg_tpu.solver.irls import Cost, IRLSConfig, irls

    edges, QQ, Q0 = problem_def.make_inputs()
    g = RotationGraph.create(edges, QQ, Q0, f=1, dtype=np.float64)
    cfg = IRLSConfig(**problem_def.CFG)
    Q1, _, it1, _ = irls(g, dataclasses.replace(
        cfg, cost=Cost.L1, max_iters=problem_def.L1_ITERS))
    Qr, _, it2, _ = irls(dataclasses.replace(g, Q=Q1), cfg)
    Qr = np.asarray(so3.qnormalize(Qr))
    assert outs[0]["iters"] == int(it1) + int(it2)
    got = np.load(out_path)
    assert got["w"].shape == (280,)
    assert _geo_deg(got["Q"], Qr).max() < 1e-6


def test_dryrun_multichip_two_cpu_ranks():
    from irotavg_tpu_torch.entry import DRYRUN_TOL_DEG, dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    assert out["iters"] == out["single_iters"] >= 3
    assert out["max_geodesic_deg"] < DRYRUN_TOL_DEG


def _run_probe(args):
    from irotavg_tpu_torch.parallel import scaling_probe

    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        assert scaling_probe.main(args) == 0
    finally:
        sys.stdout = old
    return json.loads(buf.getvalue())


def test_probe_multi_size_layout():
    """``tests/test_scaling_probe.py:test_probe_multi_size_layout`` on
    CPU ranks (spawned gloo processes)."""
    out = _run_probe([
        "--device", "cpu", "--sizes", "1000:3000,2000:6000",
        "--devices", "1,2", "--outer-iters", "1", "--cg-iters", "5",
        "--reps", "1",
    ])
    assert out["platform"] == "cpu"
    assert set(out["by_size"]) == {"1k", "2k"}
    for blk in out["by_size"].values():
        assert set(blk["by_devices"]) == {"1", "2"}
        for row in blk["by_devices"].values():
            # fixed work: every world size runs every outer iteration
            assert row["iters"] == 1
            assert row["solve_s"] > 0
            assert row["solve_s_min"] <= row["solve_s"]
        assert "work_conservation" in blk["by_devices"]["2"]
        assert blk["host_cores"] >= 1
    # multi-size output has no ambiguous flat block
    assert "by_devices" not in out


def test_probe_needs_a_card_unless_cpu(capsys):
    import torch

    from irotavg_tpu_torch.parallel import scaling_probe

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert scaling_probe.main(["--devices", "1"]) == 2
    assert "--device cpu" in capsys.readouterr().err

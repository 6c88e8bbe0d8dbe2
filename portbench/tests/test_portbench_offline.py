"""The offline cell's comparison: a sound job passes, and the control and
every fault fail the number aimed at them.

The program runs on the CPU on a short job of the cell's own frames (the
cell's frame size, features and settings; ``SHORT_JOB`` frames, one job,
the harness's look for a card skipped), with the timed path broken
underneath for each fault.  A job that short holds no revisit, so
``loops_missed`` is driven on a fabricated two-lap job of the cell's
orbit, whose answers are known."""

import math
import types

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from drivers import offline
from gen import ring_orbit
from pbkit import runner, spec

NAME = "kitti00_offline.pairs"
SHORT_JOB = 8
# the number each planted fault, and the control, must fail
AIMS = {"control": "solve_gap_deg", "state_unchanged": "solve_gap_deg",
        "rotation_altered": "bad_edge_share",
        "pairs_dropped": "pair_shortfall",
        "loops_missed": "revisit_miss_share"}


def _cell():
    cell = spec.load_cell(NAME)
    cell.config = dict(cell.config, frames_per_job=SHORT_JOB)
    cell.traffic = dict(cell.traffic, jobs=1)
    return cell


@pytest.fixture(scope="module")
def shared():
    torch.set_num_threads(4)
    return {}


CASES = [({}, None), ({"control": True}, "control"),
         ({"fault": "state_unchanged"}, "state_unchanged"),
         ({"fault": "rotation_altered"}, "rotation_altered"),
         ({"fault": "pairs_dropped"}, "pairs_dropped")]


@pytest.mark.parametrize("kw,aim", CASES,
                         ids=[a or "program" for _, a in CASES])
def test_correct_only_for_the_program(kw, aim, shared):
    out = runner.run_cell(_cell(), 2 ** 31 + 17, 1.0, False,
                          torch.device("cpu"), shared=shared, **kw)
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["correct"] is (aim is None), out["compared"]
    if aim is not None:
        got = out["compared"][AIMS[aim]]
        assert got["value"] > got["limit"], out["compared"]


def test_every_fault_is_tested():
    planted = {a for _, a in CASES if a not in (None, "control")}
    assert planted | {"loops_missed"} == set(offline.FAULTS)


def _two_laps(loops=True, tilt_deg=0.0):
    """The numbers of a fabricated job on the cell's orbit: every frame a
    keyframe (flows of 10 px), every window pair, a loop edge closing
    each revisit (when ``loops``), relative rotations from the scene
    tilted ``tilt_deg`` about the x axis, rotations exact."""
    cell = spec.load_cell(NAME)
    t, cfg = cell.traffic, cell.config
    n = cfg["frames_per_job"]
    R, _ = ring_orbit.orbit(n, t["frames_per_lap"], t["radius_m"],
                          t["shrink_per_lap_m"])
    W = cfg["offline"]["win_size"]
    win = [(a, b) for b in range(n) for a in range(max(0, b - W), b)]
    # each keyframe from 116 on (13.4 degrees short of a lap) to the one
    # a lap back, or to keyframe 0
    back = [(max(b - 120, 0), b) for b in range(116, n)]
    edges = np.asarray(win + (back if loops else []), np.int64)
    tilt = Rotation.from_rotvec([math.radians(tilt_deg), 0, 0]).as_matrix()
    rel = tilt @ R[edges[:, 1]] @ R[edges[:, 0]].transpose(0, 2, 1)
    res = types.SimpleNamespace(
        flows=np.full(n - 1, 10.0, np.float32), keyframes=list(range(n)),
        edges=edges, QQ=Rotation.from_matrix(rel).as_quat(),
        Q=Rotation.from_matrix(R).as_quat(),
        loop_mask=np.arange(len(edges)) >= len(win),
        stats={"pairs_total": len(win)})
    return offline.job_numbers(res, R, t, cfg)


def test_a_sound_two_lap_job_reads_its_work():
    got = _two_laps()
    assert got["plan_gap"] == 0 and got["pair_shortfall"] == 0
    assert got["revisit_miss_share"] == 0 and got["due"] > 100
    assert got["bad_edge_share"] == 0 and got["rot_rmse_deg"] < 1e-6
    assert got["solve_gap_deg"] < 1e-6


def test_loops_missed_reads_every_revisit_missed():
    limits = spec.load_cell(NAME).traffic["limits"]
    got = _two_laps(loops=False)
    assert got["revisit_miss_share"] == 1.0 > limits["revisit_miss_share"]


def test_tilted_edges_read_as_bad():
    assert _two_laps(tilt_deg=3.0)["bad_edge_share"] == 1.0

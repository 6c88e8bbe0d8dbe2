"""The SLAM check's numbers of the work done (frames kept, window edges,
loops, rotations against the ground truth) on fabricated windows of the
revisit orbit, whose answers are known: a sound window, and the window
that each fault would leave (``loops_missed`` needs a lap of frames, more
than a run in a test holds, so it is driven here only)."""

import types

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from drivers import slam
from gen import ring_orbit
from pbkit import spec

W = 4
LAP = 60


def _work(views, links, *, frames=None, err_deg=0.0):
    """``slam._work`` of a finished window over the first ``frames`` frames
    of the revisit orbit, its first ``views`` kept, with the connections
    ``links`` and every other rotation ``err_deg`` off about the vertical."""
    t = spec.load_cell("kitti00_mono.revisit").traffic
    assert t["frames_per_lap"] == LAP
    R, _ = ring_orbit.orbit(views, LAP, t["radius_m"], t["shrink_per_lap_m"])
    a = np.radians(err_deg) * (np.arange(views) % 2)
    off = Rotation.from_rotvec(np.c_[np.zeros(views), a, np.zeros(views)])
    run = types.SimpleNamespace(
        traffic=t, pc=types.SimpleNamespace(vg_win_size=W,
                                            global_win_size=5000000),
        scene=types.SimpleNamespace(R=R),
        latencies=[0.1] * (frames or views), solves=[],
        outputs={"source": list(range(views)),
                 "Q": (off * Rotation.from_matrix(R)).as_quat(),
                 "connections": list(links)})
    return slam._work(run)


def _sound(views):
    win = [(i, j) for j in range(views) for i in range(max(0, j - W), j)]
    loops = [(j - LAP, j) for j in range(LAP + 4, views)]
    return win, loops


def test_a_sound_window_reads_its_work():
    win, loops = _sound(100)
    got = _work(100, win + loops)
    assert got["skipped_share"] == 0.0
    assert got["window_edge_shortfall"] == 0.0
    assert got["views_per_loop_edge"] == pytest.approx(100 / 36)
    # due: views 58..99, each within two frames' turn of one a lap back
    assert got["revisit_miss_share"] == pytest.approx(1 - 36 / 42)
    assert got["rot_rmse_deg"] < 1e-9


def test_loops_missed_reads_every_revisit_missed():
    win, _ = _sound(100)
    got = _work(100, win)
    assert got["revisit_miss_share"] == 1.0
    assert got["views_per_loop_edge"] == 100.0


def test_edges_dropped_reads_the_window_edges_missing():
    win, loops = _sound(100)
    got = _work(100, [(i, j) for i, j in win if j - i == 1] + loops)
    assert got["window_edge_shortfall"] == pytest.approx(
        1 - 99 / (1 + 2 + 3 + 4 * 96))


def test_frames_skipped_reads_the_frames_not_kept():
    win, _ = _sound(50)
    assert _work(50, win, frames=100)["skipped_share"] == 0.5


def test_rotations_off_the_ground_truth_read_after_the_gauge():
    win, loops = _sound(100)
    # half the views 3 degrees off about the axis every view turns about:
    # the best gauge splits it, 1.5 degrees each
    got = _work(100, win + loops, err_deg=3.0)
    assert got["rot_rmse_deg"] == pytest.approx(1.5, rel=1e-9)

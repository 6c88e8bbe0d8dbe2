"""The comparison that decides ``correct`` fails its control and every
fault the cells can have, and passes the program, at a size a test run
holds: the CPU, a dozen frames of the SLAM cells (the cells' own frame
size and features) and the golden cell's own problem.  The harness's look
for a card is skipped; the rest of a run is driven as the command drives
it, with the timed path broken underneath for each fault."""

import pytest
import torch

from pbkit import runner, spec

SLAM_FRAMES = 12


def _cell(name):
    cell = spec.load_cell(name)
    if cell.config["driver"] == "slam":
        cell.traffic = dict(cell.traffic, max_frames=SLAM_FRAMES,
                            frames_per_second=1000, warmup_frames=2)
    return cell


@pytest.fixture(scope="module")
def shared():
    torch.set_num_threads(4)
    return {}


def _run(name, shared, **kw):
    return runner.run_cell(_cell(name), 2 ** 31 + 9, 1e9 if
                           name.startswith("kitti") else 1.0, False,
                           torch.device("cpu"), shared=shared, **kw)


CASES = [("kitti00_mono.revisit", {}, True),
         ("kitti00_mono.revisit", {"control": True}, False),
         ("kitti00_mono.revisit", {"fault": "state_unchanged"}, False),
         ("kitti00_mono.revisit", {"fault": "pairs_altered"}, False),
         ("kitti00_mono.revisit", {"fault": "rotation_altered"}, False),
         ("kitti00_mono.revisit", {"fault": "frames_skipped"}, False),
         ("kitti00_mono.revisit", {"fault": "edges_dropped"}, False),
         ("ral_golden.solve", {}, True),
         ("ral_golden.solve", {"control": True}, False),
         ("ral_golden.solve", {"fault": "state_unchanged"}, False),
         ("ral_golden.solve", {"fault": "answer_altered"}, False)]


@pytest.mark.parametrize("name,kw,want", CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'program'}"
                              for n, k, _ in CASES])
def test_correct_only_for_the_program(name, kw, want, shared):
    out = _run(name, shared, **kw)
    assert out["correct"] is want, out["compared"]


# faults that need a lap of frames, more than a test run holds: their
# numbers are driven on fabricated windows (test_portbench_work.py)
NEED_A_LAP = {"loops_missed"}


def test_every_fault_of_a_driver_is_tested():
    for name in ("kitti00_mono.revisit", "ral_golden.solve"):
        faults = {k["fault"] for n, k, _ in CASES if n == name and
                  "fault" in k}
        assert faults | NEED_A_LAP >= set(spec.load_cell(name).driver().FAULTS)
        assert not faults & NEED_A_LAP

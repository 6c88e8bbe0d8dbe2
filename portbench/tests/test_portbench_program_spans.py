"""The readers of the program's own spans, on a fabricated reading: a
device trace of known operations and spans, the values they must give,
and None where there is no span, no device trace or no recorder.  Every
span name a reader reads is one the program opens."""

import os
import re

import pytest
import torch

from pbkit import spec
from pbkit.runner import Reading
from pbkit.trace import DeviceTrace, Tracer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
READERS = ("ransac_calls_per_frame", "ransac_host_reads_per_call",
           "ransac_idle_pct", "ransac_lane_loops_ms", "whole_graph_solve_ms",
           "init_mst_ms", "l1ra_idle_pct")
WINDOW = (1000, 10000)
DTOH = "Memcpy DtoH (Device -> Pageable)"
OPS = [("kernel", 2100, 2300, "ransac_hyp"),
       ("gpu_memcpy", 2400, 2450, DTOH),
       ("gpu_memcpy", 2500, 2550, "Memcpy HtoD (Pageable -> Device)"),
       ("gpu_memcpy", 2950, 3050, DTOH),          # across a span's end
       ("gpu_memcpy", 4000, 4100, DTOH),          # outside every span
       ("gpu_memcpy", 5100, 5200, DTOH),
       ("kernel", 6000, 6500, "ransac_vote")]
SPANS = [("geometry.ransac", 500, 900, None, {"lanes": 1}),  # before it
         ("solver.init_mst", 1500, 2500, None, {}),
         ("geometry.ransac", 2000, 3000, None, {"lanes": 1}),
         ("geometry.ransac.lanes", 2600, 2800, 2, {}),
         ("solver.init_mst", 3000, 3500, None, {}),
         ("geometry.ransac", 5000, 7000, None, {"lanes": 3}),
         ("solver.l1ra", 5000, 7000, None, {"iters": 1}),
         ("geometry.ransac.lanes", 6600, 6900, 5, {}),
         ("engine.rot_avg", 7500, 8000, None,
          {"view": 3, "win_size": 10, "n": 5, "m": 9, "backend": "dense"}),
         ("engine.rot_avg", 8000, 9000, None,
          {"view": 4, "win_size": 5_000_000, "n": 20, "m": 40,
           "backend": "dense"}),
         ("engine.rot_avg", 9000, 9500, None,      # skipped: no solve
          {"view": 5, "win_size": 5_000_000}),
         ("engine.process_frame", 9600, None, None, {"view": 6})]  # open
# busy inside the first RANSAC span 200 + 50 + 50 + 50 ns, inside the
# second (and the L1-RA span) 100 + 500 ns
EXPECTED = {"ransac_calls_per_frame": 2 / 4,
            "ransac_host_reads_per_call": 2 / 2,
            "ransac_idle_pct": 100.0 * (1 - 950 / 3000),
            "ransac_lane_loops_ms": 500 / 1e6 / 4,
            "whole_graph_solve_ms": 1000 / 1e6,
            "init_mst_ms": 1500 / 1e6 / 2,
            "l1ra_idle_pct": 100.0 * (1 - 600 / 2000)}


class _Event:
    def __init__(self, kind, start, end, name):
        self._k, self._s, self._e, self._n = kind, start, end, name

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def name(self):
        return self._n


def _reading(device=True):
    dev = DeviceTrace([_Event(*op) for op in OPS],
                      {"traced": [WINDOW]}) if device else None
    return Reading(tracer=Tracer(False, torch.device("cpu")), device=dev,
                   units={"frames": 4, "solves": 2})


def _layer(name):
    return spec.load_module(os.path.join(HERE, "layers", f"{name}.py"),
                            f"portbench_layer_{name}")


@pytest.fixture
def recorder(monkeypatch):
    from irotavg_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "recorded_spans", lambda: list(SPANS))
    return timing


@pytest.mark.parametrize("name", READERS)
def test_reader_value(name, recorder):
    assert _layer(name).read(_reading()) == pytest.approx(EXPECTED[name],
                                                          rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_spans(name, recorder, monkeypatch):
    monkeypatch.setattr(recorder, "recorded_spans", lambda: [])
    assert _layer(name).read(_reading()) is None
    # a program without the recorder (the parent of the spans) gives none
    monkeypatch.delattr(recorder, "recorded_spans")
    assert _layer(name).read(_reading()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_a_device_trace(name, recorder):
    assert _layer(name).read(_reading(device=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_every_span_read_is_opened_by_the_program(name):
    src = []
    for root, _, files in os.walk(os.path.join(ROOT, "irotavg_tpu_torch")):
        src += [open(os.path.join(root, f)).read() for f in files
                if f.endswith(".py")]
    opened = set(re.findall(r'span\("([\w.]+)"', "\n".join(src)))
    assert _layer(name).SPANS and set(_layer(name).SPANS) <= opened

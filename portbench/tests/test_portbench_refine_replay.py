"""The readers of the program's ``geometry.refine`` spans on a fabricated
reading: ``refine_replay_share`` (Σ replays / Σ iters),
``refine_captures`` (Σ captures) and ``refine_match_best2_roofline``
(the re-matches' bytes at the HBM rate over the device time of the
``match_best2`` kernels inside the spans) over the spans that start in
the traced window, and None where there is no such span, no device trace
or no recorder."""

import os
import re

import pytest
import torch

from pbkit import peaks, spec
from pbkit.runner import Reading
from pbkit.trace import DeviceTrace, Tracer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
READERS = ("refine_replay_share", "refine_captures",
           "refine_match_best2_roofline")
WINDOW = (1000, 10000)
KERNEL = "void match_best2_kernel<3>(int const*, int const*, float const*)"
OPS = [("kernel", 600, 700, KERNEL),                   # before the window
       ("kernel", 2200, 2240, KERNEL),
       ("kernel", 2300, 2500, "ransac_hyp"),
       ("kernel", 2600, 2640, KERNEL),
       ("kernel", 3100, 3160, KERNEL),
       ("gpu_memcpy", 3200, 3210, "Memcpy DtoH (Device -> Pageable)"),
       ("kernel", 3300, 3360, KERNEL),
       ("kernel", 3500, 3560, KERNEL),
       ("kernel", 4100, 4150, KERNEL),                 # outside a refine
       ("kernel", 5100, 5900, "match_best2_plain?")]   # no: eager span
SHAPE1 = {"width": 1, "rows": 2000, "cols": 2000, "shared": 1,
          "gate": "epipolar"}
SHAPE4 = {"width": 4, "rows": 2000, "cols": 1800, "shared": 1,
          "gate": "epipolar"}
SPANS = [("geometry.refine", 500, 900, None,                 # before it
          {"lanes": 1, **SHAPE1, "iters": 4, "replays": 4, "captures": 1}),
         ("geometry.refine_window", 2000, 4000, None, {"iters": 5}),
         ("geometry.refine", 2100, 2900, 1,
          {"lanes": 1, **SHAPE1, "iters": 2, "replays": 2, "captures": 0}),
         ("geometry.refine", 3000, 3900, 1,                  # a capture
          {"lanes": 3, **SHAPE4, "iters": 2, "replays": 2, "captures": 1}),
         ("geometry.refine", 5000, 6000, None,               # eager
          {"lanes": 8, "width": 8, "rows": 2000, "cols": 2000,
           "shared": 0, "gate": "epipolar_nonode", "iters": 5,
           "replays": 0, "captures": 0}),
         ("geometry.refine", 7000, 7100, None,               # no lane ran
          {"lanes": 0, **SHAPE1, "iters": 0, "replays": 0, "captures": 0}),
         ("geometry.refine", 9600, None, None, {"lanes": 1})]  # open


def _bytes(width, n1, n2, shared):
    return (32 * (width * n1 + (n2 if shared else width * n2)
                  + width * n1 + width * n2) + 12 * width * n1)


EXPECTED = {
    "refine_replay_share": 100.0 * 4 / 9,
    "refine_captures": 1.0,
    "refine_match_best2_roofline": 100.0 * (
        2 * _bytes(1, 2000, 2000, True) + 3 * _bytes(4, 2000, 1800, True)
    ) / peaks.HBM_BYTES / ((40 + 40 + 60 + 60 + 60) / 1e9)}


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


def _layer(name):
    return spec.load_module(os.path.join(HERE, "layers", f"{name}.py"),
                            f"portbench_layer_{name}")


def _reading(device=True):
    dev = DeviceTrace([_Event(*op) for op in OPS],
                      {"traced": [WINDOW]}) if device else None
    return Reading(tracer=Tracer(False, torch.device("cpu")), device=dev,
                   units={"frames": 4})


@pytest.fixture
def recorder(monkeypatch):
    from irotavg_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "recorded_spans", lambda: list(SPANS))
    return timing


@pytest.mark.parametrize("name", READERS)
def test_reader_value(name, recorder):
    assert _layer(name).read(_reading()) == pytest.approx(EXPECTED[name],
                                                          rel=1e-12)


def test_no_capture_reads_zero(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "recorded_spans",
                        lambda: [s for s in SPANS if s[1] != 3000])
    assert _layer("refine_captures").read(_reading()) == 0.0


def test_match_roofline_at_a_per_lane_shape():
    layer = _layer("refine_match_best2_roofline")
    a = {"width": 8, "rows": 2000, "cols": 1500, "shared": 0}
    assert layer.launch_bytes(a) == _bytes(8, 2000, 1500, False)
    assert layer.launch_bytes(dict(a, shared=True)) == _bytes(8, 2000, 1500,
                                                              True)


def test_none_without_an_iteration(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "recorded_spans", lambda: [])
    assert _layer("refine_replay_share").read(_reading()) is None
    monkeypatch.setattr(recorder, "recorded_spans", lambda: [SPANS[5]])
    assert _layer("refine_replay_share").read(_reading()) is None
    # a program without the recorder gives none
    monkeypatch.delattr(recorder, "recorded_spans")
    assert _layer("refine_replay_share").read(_reading()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_spans(name, recorder, monkeypatch):
    monkeypatch.setattr(recorder, "recorded_spans", lambda: [])
    assert _layer(name).read(_reading()) is None
    # spans without the attributes a reader needs (``refine_replay_share``
    # needs ``iters``)
    monkeypatch.setattr(recorder, "recorded_spans", lambda: [
        ("geometry.refine", 2100, 2900, None, {"lanes": 1})])
    assert _layer(name).read(_reading()) is None
    monkeypatch.delattr(recorder, "recorded_spans")
    assert _layer(name).read(_reading()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_a_device_trace(name, recorder):
    assert _layer(name).read(_reading(device=False)) is None


def test_the_span_is_opened_by_the_program():
    src = []
    for root, _, files in os.walk(os.path.join(ROOT, "irotavg_tpu_torch")):
        src += [open(os.path.join(root, f)).read() for f in files
                if f.endswith(".py")]
    opened = set(re.findall(r'span\("([\w.]+)"', "\n".join(src)))
    for name in READERS:
        assert set(_layer(name).SPANS) <= opened, name

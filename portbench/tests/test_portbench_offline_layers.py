"""The offline cell's readers of the program's own spans, on a fabricated
reading: a device trace of known operations and ``offline.*`` spans, the
values they must give, and None where there is no span, no device trace
or no recorder.  Every span name a reader reads is one the program
opens."""

import os
import re

import pytest
import torch

from pbkit import spec
from pbkit.runner import Reading
from pbkit.trace import DeviceTrace, Tracer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
READERS = ("offline_extract_ms", "offline_pairs_ms", "offline_loop_ms",
           "offline_solve_ms", "offline_pairs_idle_pct",
           "offline_host_reads_per_chunk")
WINDOW = (1000, 20000)
DTOH = "Memcpy DtoH (Device -> Pageable)"
OPS = [("kernel", 1500, 1900, "orb"),
       ("kernel", 3100, 3300, "ransac_hyp"),
       ("gpu_memcpy", 3400, 3450, DTOH),
       ("gpu_memcpy", 3500, 3550, "Memcpy HtoD (Pageable -> Device)"),
       ("gpu_memcpy", 3950, 4050, DTOH),           # across a chunk's end
       ("gpu_memcpy", 4200, 4300, DTOH),
       ("kernel", 6000, 6400, "ransac_vote"),
       ("gpu_memcpy", 6500, 6600, DTOH),          # in the loop's chunk
       ("kernel", 8000, 8100, "potrf")]
SPANS = [("offline.job", 900, 19000, None, {"frames": 8, "keyframes": 8}),
         ("offline.extract", 500, 900, None, {"frames": 8}),  # before it
         ("offline.extract", 1400, 2400, 0, {"frames": 8, "batches": 1}),
         ("offline.flow", 2400, 2900, 0, {"pairs": 7}),
         ("offline.pairs", 3000, 5000, 0, {"pairs": 22}),
         ("offline.pair_chunk", 3000, 4000, 4, {"lanes": 8, "refined": 8}),
         ("offline.pair_chunk", 4100, 4500, 4, {"lanes": 8, "refined": 2}),
         ("offline.loop", 5500, 7000, 0, {"candidates": 1}),
         ("offline.pair_chunk", 5600, 6800, 7, {"lanes": 1, "refined": 1}),
         ("offline.solve", 7500, 9500, 0, {"n": 8, "m": 22}),
         ("offline.job", 19500, None, None, {"frames": 8})]   # open
# device busy inside the pairs span: 200 + 50 + 50 + 100 + 100 ns
EXPECTED = {"offline_extract_ms": 1000 / 1e6 / 4,
            "offline_pairs_ms": 2000 / 1e6 / 4,
            "offline_loop_ms": 1500 / 1e6 / 4,
            "offline_solve_ms": 2000 / 1e6 / 2,
            "offline_pairs_idle_pct": 100.0 * (1 - 500 / 2000),
            "offline_host_reads_per_chunk": 3 / 3}


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
                   units={"frames": 4, "jobs": 2})


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
    # a program without the recorder gives none
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

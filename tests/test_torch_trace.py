"""The port's program spans (``utils/timing.py:span``) on the CPU.

Off (no profiler session) the recorder holds nothing after a SLAM run.
Under a CPU ``torch.profiler`` session it records the tree: every child
inside its parent, the parents the layers name, and the ``lanes`` /
``trials`` / ``iters`` / loop-closure / window attributes equal to what
the code ran, counted by wrappers around the functions that do the work.
A span reads nothing from the device: the same run makes the same tensor
reads with the recorder on as off and never synchronises, and every
attribute handed to a span is an expression that calls nothing but
``len``.  The CLI's ``--trace_dir`` file holds the program's span names."""

import ast
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from irotavg_tpu_torch.app import irotavg as port_cli
from irotavg_tpu_torch.engine.viewgraph import ViewGraph
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.geometry import fused
from irotavg_tpu_torch.solver import graph as tgraph
from irotavg_tpu_torch.solver.init import init_mst
from irotavg_tpu_torch.solver.irls import IRLSConfig, irls
from irotavg_tpu_torch.solver.l1ra import L1RAConfig, l1ra
from irotavg_tpu_torch.utils import timing
from irotavg_tpu_torch.utils.sequence import write_pgm
from seqgen import make_sequence
from synth import make_problem

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

WHOLE_GRAPH = 5_000_000
# the tensor methods through which the host reads a tensor's values
READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
         "__float__", "__index__")
PARENTS = {
    "geometry.initial_pose": {"engine.process_frame"},
    "geometry.refine_window": {"engine.process_frame"},
    "geometry.ransac": {"geometry.initial_pose", "geometry.refine_window",
                        "placerec.loop_closure"},
    "geometry.ransac.lanes": {"geometry.ransac"},
    "geometry.ransac.kernels": {"geometry.ransac"},
    "solver.l1ra": {"engine.rot_avg"},
    "solver.irls": {"engine.rot_avg"},
}
ROOTS = {"engine.process_frame", "placerec.loop_closure", "engine.rot_avg"}


@pytest.fixture(scope="module")
def scene():
    ims, K, _ = make_sequence(n_frames=6, seed=1, step=0.3,
                              yaw_deg_per_frame=-1.0)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
                 height=480)
    ext = ORBExtractor(n_features=1200, n_levels=8, device="cpu")
    return cam, [Frame(i, im, ext, cam) for i, im in enumerate(ims)]


class _Calls:
    """Host intervals and results of the calls the wrappers saw."""

    def __init__(self):
        self.ransac, self.local, self.refine = [], [], []
        self.loops, self.rot_avg = [], []
        self.reads = 0


def _slam(cam, frames):
    """The CLI's per-frame order on a fresh graph: ``process_frame``, the
    loop-closure block (candidates forced from view 3 on: view 0, so the
    verification runs) and ``rot_avg`` (the whole graph after a new loop
    edge)."""
    vg = ViewGraph(cam, min_matches=60, device="cpu")
    vg.detect_loop_candidates = lambda v: [0] if v >= 3 else []
    vg.check_loop_consistency = lambda cands: list(cands)
    for f in frames:
        if not vg.process_frame(f, win_size=4):
            continue
        new = port_cli._loop_closure(vg, vg.num_views - 1, 60)
        vg.rot_avg(WHOLE_GRAPH if new else 10)
    return vg


def _counted_run(cam, frames, traced):
    """One SLAM run with every wrapper and read counter in place; returns
    the spans recorded and what the wrappers saw."""
    calls = _Calls()
    mp = pytest.MonkeyPatch()

    def interval(store, fn, result=lambda args, out: None):
        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            out = fn(*args, **kwargs)
            store.append((t0, time.time_ns(), result(args, out)))
            return out
        return wrapped

    mp.setattr(fused, "_ransac_lanes", interval(
        calls.ransac, fused._ransac_lanes, lambda a, o: a[2].shape[0]))
    mp.setattr(fused, "_match_locally_core", interval(
        calls.local, fused._match_locally_core))
    mp.setattr(fused, "fused_refine", interval(
        calls.refine, fused.fused_refine, lambda a, o: o[5]))
    mp.setattr(port_cli, "_loop_closure", interval(
        calls.loops, port_cli._loop_closure))
    rot_avg = ViewGraph.rot_avg

    def counted_rot_avg(self, win_size, **kw):
        stats = rot_avg(self, win_size, **kw)
        calls.rot_avg.append((win_size, stats))
        return stats

    mp.setattr(ViewGraph, "rot_avg", counted_rot_avg)
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            calls.reads += 1
            return _orig(self, *a, **k)
        mp.setattr(torch.Tensor, name, counted)

    def no_sync(*a, **k):
        raise AssertionError("a span synchronised the device")

    mp.setattr(torch.cuda, "synchronize", no_sync)
    timing.clear_spans()
    try:
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                _slam(cam, frames)
        else:
            _slam(cam, frames)
    finally:
        mp.undo()
    spans = timing.recorded_spans()
    timing.clear_spans()
    return spans, calls


@pytest.fixture(scope="module")
def runs(scene):
    cam, frames = scene
    return _counted_run(cam, frames, False), _counted_run(cam, frames, True)


def _inside(store, s, e):
    return [x for x in store if s <= x[0] and x[1] <= e]


def test_off_records_nothing(runs):
    (spans, calls), _ = runs
    assert spans == []
    assert calls.ransac and calls.rot_avg


def test_spans_read_nothing_from_the_device(runs):
    """The recorder on makes not one tensor read more than off, never
    synchronises, and every attribute is a plain host number or name."""
    (_, off), (spans, on) = runs
    assert on.reads == off.reads > 0
    for _, _, _, _, attrs in spans:
        for v in attrs.values():
            assert type(v) in (int, str), (attrs, type(v))


def test_span_attributes_call_nothing_but_len():
    """Every attribute handed to a span (``span(name, k=...)``,
    ``sp.set(k=...)``) is a host value: an expression that calls nothing
    but ``len``, so it cannot read a tensor, in either mode."""
    pkg = os.path.dirname(os.path.dirname(timing.__file__))
    seen = 0
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and (
                        getattr(node.func, "id", None) == "span"
                        or getattr(node.func, "attr", None) == "set"
                        and getattr(node.func.value, "id", None) == "sp")):
                    continue
                seen += 1
                for kw in node.keywords:
                    calls = [c for c in ast.walk(kw.value)
                             if isinstance(c, ast.Call)
                             and getattr(c.func, "id", None) != "len"]
                    assert not calls, (path, node.lineno, kw.arg)
    assert seen >= 15


def test_the_tree_nests(runs):
    _, (spans, _) = runs
    assert spans and all(e is not None and e >= s for _, s, e, _, _ in spans)
    for name, s, e, parent, _ in spans:
        if parent is None:
            assert name in ROOTS, name
            continue
        pname, ps, pe = spans[parent][:3]
        assert ps <= s and e <= pe, (name, pname)
        assert pname in PARENTS[name], (name, pname)
    names = {n for n, *_ in spans}
    assert set(PARENTS) | ROOTS <= names


def test_ransac_spans_equal_the_calls(runs):
    """One ``geometry.ransac`` span a ``_ransac_lanes`` call, with its
    lanes, and a lane-loop and a kernel span under each."""
    _, (spans, calls) = runs
    rs = [(i, s, e, a) for i, (n, s, e, _, a) in enumerate(spans)
          if n == "geometry.ransac"]
    assert len(rs) == len(calls.ransac)
    for (i, s, e, attrs), (c0, c1, lanes) in zip(rs, calls.ransac):
        assert c0 <= s and e <= c1 and attrs == {"lanes": lanes}
        kids = {spans[k][0] for k in range(len(spans))
                if spans[k][3] == i}
        assert kids == {"geometry.ransac.lanes", "geometry.ransac.kernels"}
    # the verification's RANSAC under the loop-closure block
    assert any(spans[spans[i][3]][0] == "placerec.loop_closure"
               for i, *_ in rs)


def test_trials_and_iters_equal_what_ran(runs):
    """``trials``: the local matches of the initial-pose search; ``iters``:
    the refine iterations of the pose and of the window walk."""
    _, (spans, calls) = runs
    n_pose = n_refine = 0
    for name, s, e, _, attrs in spans:
        if name == "geometry.initial_pose":
            n_pose += 1
            assert attrs["trials"] == len(_inside(calls.local, s, e)) >= 1
        elif name == "geometry.refine_window":
            n_refine += 1
            ran = _inside(calls.refine, s, e)
            assert attrs["iters"] == sum(it for *_, it in ran) >= 1
    frames = sum(1 for n, *_ in spans if n == "engine.process_frame")
    assert n_pose == frames - 1 and 1 <= n_refine <= n_pose


def test_loop_closure_and_rot_avg_attributes(runs):
    _, (spans, calls) = runs
    loops = [(s, e, a) for n, s, e, _, a in spans
             if n == "placerec.loop_closure"]
    assert len(loops) == len(calls.loops)
    for s, e, attrs in loops:
        forced = 1 if attrs["view"] >= 3 else 0
        assert attrs["candidates"] == attrs["consistent"] == forced
        assert attrs["connected"] <= forced
    assert sum(a["connected"] for *_, a in loops) >= 1
    rots = [(i, a) for i, (n, _, _, _, a) in enumerate(spans)
            if n == "engine.rot_avg"]
    assert len(rots) == len(calls.rot_avg)
    assert any(w == WHOLE_GRAPH for w, _ in calls.rot_avg)
    for (i, attrs), (w, stats) in zip(rots, calls.rot_avg):
        assert attrs["win_size"] == w
        if stats is None:
            assert "n" not in attrs
            continue
        assert (attrs["n"], attrs["m"], attrs["backend"]) == (
            stats["n"], stats["m"], stats["backend"])
        kids = {spans[k][0]: spans[k][4] for k in range(len(spans))
                if spans[k][3] == i}
        assert kids["solver.irls"]["iters"] == stats["irls_iters"]
        assert kids["solver.l1ra"]["iters"] >= 1


def test_golden_path_spans():
    """``init_mst`` -> ``l1ra`` -> ``irls`` as the ``l1_irls`` CLI runs
    them: three root spans, the solvers' iterations as they return them."""
    p = make_problem(n=30, extra_edges=40, noise_deg=2.0, seed=3)
    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        Q0 = init_mst(np.tile([0.0, 0, 0, 1], (30, 1)), p["QQ"], p["edges"],
                      1)
        g = tgraph.RotationGraph.create(p["edges"], p["QQ"], Q0, f=1)
        Q1, it1, _ = l1ra(g, L1RAConfig(max_iters=20))
        _, _, it2, _ = irls(dataclasses.replace(g, Q=Q1),
                            IRLSConfig(max_iters=50))
    spans = timing.recorded_spans()
    timing.clear_spans()
    assert [(n, parent) for n, _, _, parent, _ in spans] == [
        ("solver.init_mst", None), ("solver.l1ra", None),
        ("solver.irls", None)]
    assert spans[1][4] == {"iters": it1} and spans[2][4] == {"iters": it2}


def test_cli_trace_dir_holds_the_program_spans(tmp_path):
    ims, K, _ = make_sequence(n_frames=3, seed=1, step=0.3,
                              yaw_deg_per_frame=-1.0)
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, im in enumerate(ims):
        write_pgm(str(seq / f"{i:06d}.pgm"), im)
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
        f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        "ORBextractor.nFeatures: 1200\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    trace = tmp_path / "trace"
    assert port_cli.main(["none", str(yaml), str(seq), "--image_ext", ".pgm",
                          "--out_dir", str(tmp_path / "out"), "--trace_dir",
                          str(trace), "--device", "cpu"]) == 0
    timing.clear_spans()
    (path,) = trace.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"frame_creation", "frame_processing", "rotavg",
            "engine.process_frame", "geometry.initial_pose",
            "geometry.refine_window", "geometry.ransac",
            "geometry.ransac.lanes", "geometry.ransac.kernels",
            "engine.rot_avg", "solver.l1ra", "solver.irls"} <= names

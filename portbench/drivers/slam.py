"""Driver of the ``irotavg`` incremental SLAM path.

The window runs the per-frame loop of ``irotavg_tpu_torch/app/irotavg.py:
main`` with the CLI's ``PipelineConfig``: ``FramePrefetcher.frame`` ->
``ViewGraph.process_frame`` -> the CLI's ``_loop_closure`` block ->
``ViewGraph.rot_avg`` (the whole graph after a new loop edge), with the
CLI's synchronisation after each stage, on a fresh ``ViewGraph`` at frame
0.  It leaves out what writes files (poses, ids, checkpoints) and the
per-frame printout.  A frame's latency runs from its hand-in to its poses
on the host after ``rot_avg``.  Set-up renders the frames on the card,
loads the vocabulary and warms every path the window takes on a throwaway
graph (the loop-closure verification and a whole-graph solve included).

``check`` holds what the window produced to the reference
(``reference/``): every window solve re-solved from the engine's own state
before it (the widest gap of a view), every connection's pose against its
own matched keypoints (the median distance of a keypoint from its epipolar
line, in pixels, at the worst connection), and every connection's matched
keypoints carried through the ground-truth scene (the share that lands
more than ``TRANSFER_PX`` away).  It holds the work itself to the
renderer's ground truth too: the share of frames not kept as views, the
share of window edges not made, views per loop edge, the share of
ground-truth revisits that no loop edge closes, and the final keyframe
rotations' RMS error against the scene's.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import math
import os
import sys
import tempfile
import time

import numpy as np

from gen import ring_orbit
from pbkit.trace import Tracer
from reference import rotavg, scene as gt

# what a NaN reading counts as: the largest finite f64, over any limit
BROKEN = float(np.finfo(np.float64).max)

PIPELINE_KEYS = {"vg_win_size": "vg_win_size",
                 "rotavg_win_size": "rotavg_win_size",
                 "vg_min_matches": "vg_min_matches",
                 "global_win_size": "global_win_size",
                 "sampling_step": "sampling_step"}
# pixels by which a matched keypoint may miss its ground-truth transfer
# before the pair counts as a bad match
TRANSFER_PX = 4.0
# degrees within which two cameras half a lap or more apart look the same
# way: a place seen again (two frames' turn at 6 degrees a frame, plus one)
REVISIT_DEG = 15.0


def frame_count(traffic: dict, seconds: float) -> int:
    """Frames rendered for the window: the camera's rate times the window,
    at most ``max_frames``."""
    n = int(math.ceil(traffic["frames_per_second"] * seconds))
    cap = traffic.get("max_frames")
    return max(n, traffic["warmup_frames"]) if cap is None else \
        max(min(n, cap), traffic["warmup_frames"])


def load_vocabulary(cfg: dict, root: str, device):
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary

    spec = cfg["vocabulary"]
    with open(os.path.join(root, spec["file"]), "rb") as fh:
        raw = fh.read()
    if hashlib.sha256(raw).hexdigest() != spec["sha256"]:
        raise ValueError(f"{spec['file']}: sha256 differs from the "
                         f"configuration's")
    with tempfile.NamedTemporaryFile(suffix=".txt") as tmp:
        tmp.write(gzip.decompress(raw))
        tmp.flush()
        return Vocabulary.load_text(tmp.name, device=device)


def _check_pipeline(cfg: dict):
    """The CLI's ``PipelineConfig``, held to the configuration file."""
    from irotavg_tpu_torch.config import PipelineConfig

    pc = PipelineConfig()
    p, s = cfg["pipeline"], cfg["solver"]
    want = {k: p[k] for k in PIPELINE_KEYS}
    want.update(loop_min_matches=p["loop_min_matches"],
                loop_closure=p["loop_closure"], cost=s["cost"],
                sigma_deg=s["sigma_deg"], l1_iters=s["l1_iters"],
                irls_iters=s["irls_iters"], change_th=s["change_th"])
    got = {k: getattr(pc, v) for k, v in PIPELINE_KEYS.items()}
    got.update(loop_min_matches=pc.loop.min_matches,
               loop_closure=pc.loop.enabled, cost=pc.solver.cost,
               sigma_deg=pc.solver.sigma_deg, l1_iters=pc.solver.l1_iters,
               irls_iters=pc.solver.irls_iters,
               change_th=pc.solver.change_th)
    if got != want:
        raise ValueError(f"the CLI's PipelineConfig {got} differs from the "
                         f"configuration {want}")
    return pc


@dataclasses.dataclass
class Run:
    """One SLAM run: the program's objects and what the window recorded."""
    cfg: dict
    traffic: dict
    pc: object
    device: object
    tracer: object
    frames: list
    scene: object
    extractor: object
    camera: object
    vocab: object
    vg: object = None
    pf: object = None
    frame_id: int = 0
    source_of_view: list = dataclasses.field(default_factory=list)
    solves: list = dataclasses.field(default_factory=list)
    latencies: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    undo: list = dataclasses.field(default_factory=list)
    outputs: dict = None


def _fresh(run: Run, frames):
    from irotavg_tpu_torch.engine.viewgraph import ViewGraph
    from irotavg_tpu_torch.frontend.prefetch import FramePrefetcher

    run.vg = ViewGraph(run.camera, min_matches=run.pc.vg_min_matches,
                       device=run.device)
    run.pf = FramePrefetcher(frames, run.extractor, run.camera,
                             batch=run.cfg["pipeline"]["prefetch"],
                             vocab=run.vocab)
    run.frame_id = 0
    run.source_of_view = []
    run.solves = []


def _step(run: Run, k: int, loop_closure) -> None:
    """One frame of the CLI's loop (app/irotavg.py:main)."""
    vg, tr, pc = run.vg, run.tracer, run.pc
    with tr.span("frame_creation"):
        frame = run.pf.frame(k)
        frame.id = run.frame_id
        _sync(run)
    with tr.span("process_frame"):
        selected = vg.process_frame(frame, win_size=pc.vg_win_size)
        _sync(run)
    if not selected:
        return
    run.source_of_view.append(k)
    view_id = vg.num_views - 1
    new = False
    if run.cfg["pipeline"]["loop_closure"] and run.vocab is not None:
        with tr.span("loop_closure"):
            new = loop_closure(vg, view_id, pc.loop.min_matches)
            _sync(run)
    win = pc.global_win_size if new else pc.rotavg_win_size
    before = (vg.ra.Q.copy(), vg.ra.fixed.copy(), vg.ra.num_edges, win)
    with tr.span("rot_avg"):
        vg.rot_avg(win)
        _sync(run)
        after = vg.ra.Q.copy()          # the poses on the host
    run.solves.append(before + (after,))
    run.frame_id += 1


def _sync(run: Run) -> None:
    import torch

    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def setup(ctx) -> Run:
    import torch

    from irotavg_tpu_torch.engine import incremental
    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.orb import ORBExtractor

    cfg, traffic = ctx.config, ctx.traffic
    pc = _check_pipeline(cfg)
    dtype = torch.float32 if ctx.control else torch.float64
    if cfg["solver"]["dtype"] != "float64":
        raise ValueError("the engine's solves are f64")
    old = incremental.SOLVER_DTYPE
    incremental.SOLVER_DTYPE = dtype
    undo = [(incremental, "SOLVER_DTYPE", old)]
    n = frame_count(traffic, ctx.seconds)
    t0 = time.perf_counter()
    frames, scene = ring_orbit.generate(traffic, cfg, ctx.seed, n,
                                        ctx.device)
    t1 = time.perf_counter()
    vocab = ctx.shared.get("vocab")
    if vocab is None:
        vocab = ctx.shared["vocab"] = load_vocabulary(cfg, ctx.root,
                                                      ctx.device)
    t2 = time.perf_counter()
    cam = cfg["camera"]
    camera = Camera(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                    k1=cam["k1"], k2=cam["k2"], p1=cam["p1"], p2=cam["p2"],
                    width=cam["width"], height=cam["height"])
    extractor = ORBExtractor(**cfg["orb"], device=ctx.device)
    run = Run(cfg=cfg, traffic=traffic, pc=pc, device=ctx.device,
              tracer=ctx.tracer, frames=frames, scene=scene,
              extractor=extractor, camera=camera, vocab=vocab, undo=undo)
    _warm(run)
    _fresh(run, frames)
    print(f"portbench: rendered {n} frames in {t1 - t0:.3f} s, vocabulary "
          f"{t2 - t1:.3f} s, warm-up {time.perf_counter() - t2:.3f} s",
          file=sys.stderr)
    return run


def _warm(run: Run) -> None:
    """Every path of the window on a throwaway graph: the warm-up frames,
    a forced loop verification and a whole-graph solve."""
    from irotavg_tpu_torch.app.irotavg import _loop_closure

    tracer, run.tracer = run.tracer, Tracer(False, run.device)
    w = run.traffic["warmup_frames"]
    _fresh(run, run.frames[:w])
    for k in range(w):
        _step(run, k, _loop_closure)
    vg = run.vg
    vg.close_loop(vg.num_views - 1, 0, min_matches=run.pc.loop.min_matches)
    vg.rot_avg(run.pc.global_win_size)
    _ = vg.ra.Q
    _sync(run)
    run.tracer = tracer


def window(run: Run, seconds: float) -> dict:
    from irotavg_tpu_torch.app.irotavg import _loop_closure
    from irotavg_tpu_torch.engine.viewgraph import FrameConnectionError

    t0 = time.perf_counter()
    t_end = t0
    for k in range(len(run.frames)):
        t_in = time.perf_counter()
        run.attempted += 1
        try:
            _step(run, k, _loop_closure)
        except FrameConnectionError:
            run.failed += 1
            t_end = time.perf_counter()
            break
        t_end = time.perf_counter()
        run.latencies.append(t_end - t_in)
        if t_end - t0 >= seconds:
            break
    run.window_s = t_end - t0
    lat = np.asarray(run.latencies)
    metrics = {}
    if len(lat):
        metrics["frames_per_s"] = len(lat) / run.window_s
        metrics["frame_p90_ms"] = 1e3 * float(np.percentile(lat, 90))
    return {"attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "units": {"frames": len(lat)},
            "window_s": run.window_s}


def collect(run: Run) -> None:
    """Copy what the window produced to the host and let go of the
    program's state (before the reference runs)."""
    vg = run.vg
    ra = vg.ra
    Q = ra.Q
    conns = []
    for (i, j), c in sorted(vg.connections.items()):
        fi, fj = vg.frames[i], vg.frames[j]
        p = np.asarray(c.pairs)
        conns.append((i, j, np.asarray(c.pose.R, np.float64),
                      np.asarray(c.pose.t, np.float64).reshape(3),
                      np.stack([fi.xu[p[:, 0]], fi.yu[p[:, 0]]], -1),
                      np.stack([fj.xu[p[:, 1]], fj.yu[p[:, 1]]], -1)))
    run.outputs = {"Q": Q.copy(), "edges": ra.edges.copy(),
                   "QQ": ra.QQ.copy(), "connections": conns,
                   "source": list(run.source_of_view)}
    run.vg = run.pf = run.frames = None
    release(run)


def release(run: Run) -> None:
    for mod, attr, old in reversed(run.undo):
        setattr(mod, attr, old)
    run.undo.clear()


def _windows_solve_gap(run: Run) -> float:
    """Widest gap of a view, every window solve against the reference's
    re-solve from the engine's state before it."""
    out = run.outputs
    s = run.cfg["solver"]
    sigma = math.radians(s["sigma_deg"])
    edges, QQ = out["edges"], out["QQ"]
    gap = 0.0
    for Qb, fixed, ne, win, Qa in run.solves:
        ref = rotavg.window_solve(Qb, fixed, edges[:ne], QQ[:ne], win,
                                  sigma=sigma, l1_iters=s["l1_iters"],
                                  irls_iters=s["irls_iters"],
                                  change_th=s["change_th"])
        # a NaN (a solve that broke down on either side) reads as a failure
        g = rotavg.geodesic_deg(ref, Qa)
        gap = max(gap, float(np.nan_to_num(g, nan=BROKEN).max()))
    return gap


def _pairs(run: Run) -> dict:
    """Each connection's pose against its own keypoints (the median
    distance from the epipolar line, worst connection) and its keypoints
    carried through the ground-truth scene (the share that misses)."""
    sc, src = run.scene, run.outputs["source"]
    epi, n_pairs, n_bad = 0.0, 0, 0
    for i, j, R, t, pi, pj in run.outputs["connections"]:
        a, b = src[i], src[j]
        pi, pj = pi.astype(np.float64), pj.astype(np.float64)
        epi = max(epi, float(np.nan_to_num(np.median(
            gt.epipolar_px(pi, pj, R, t, sc.K)), nan=BROKEN)))
        to = gt.transfer(pi, sc.K, sc.R[a], sc.C[a], sc.R[b], sc.C[b],
                         sc.corners, sc.width, sc.height)
        err = np.linalg.norm(to - pj, axis=1)
        known = np.isfinite(err)
        n_pairs += int(known.sum())
        n_bad += int((err[known] > TRANSFER_PX).sum())
    return {"epipolar_px": epi, "bad_pair_share": n_bad / max(n_pairs, 1)}


def _work(run: Run) -> dict:
    """What the window did, held to the ground truth: frames kept as
    views, window edges made, revisits closed, rotations reached."""
    out, sc, W = run.outputs, run.scene, run.pc.vg_win_size
    src = out["source"]
    V, F = len(src), len(run.latencies)
    R = sc.R[src]
    links = [(i, j) for i, j, *_ in out["connections"]]
    window = [(i, j) for i, j in links if j - i <= W]
    loops = [(i, j) for i, j in links if j - i > W]
    possible = sum(min(W, v) for v in range(1, V))
    # a revisit: two views half a lap or more apart whose cameras point
    # within REVISIT_DEG of each other
    half = run.traffic["frames_per_lap"] / 2.0
    far = np.abs(np.subtract.outer(src, src)) >= half
    near = gt.angle_deg(R[:, None], R[None, :]) <= REVISIT_DEG
    revisit = np.tril(far & near, -1)          # [j, i]: view j revisits i
    due = np.flatnonzero(revisit.any(1))
    closing = [j for i, j in loops if revisit[j, i]]
    closed = set(closing)
    whole = sum(1 for *_, win, _ in run.solves
                if win == run.pc.global_win_size)
    print(f"portbench: {F} frames, {V} views, {len(window)} of {possible} "
          f"window edges, {len(loops)} loop edges ({len(closed)} views "
          f"closing a ground-truth revisit of {len(due)} due, "
          f"{len(loops) - len(closing)} short-range), {whole} whole-graph "
          f"solves", file=sys.stderr)
    rmse = float(np.sqrt(np.mean(gt.rotation_errors_deg(out["Q"][:V], R)
                                 ** 2))) if V else BROKEN
    return {"skipped_share": 1.0 - V / F if F else 0.0,
            "window_edge_shortfall": 1.0 - len(window) / possible
            if possible else 0.0,
            "views_per_loop_edge": V / max(len(loops), 1),
            "revisit_miss_share": 1.0 - len(closed) / len(due)
            if len(due) else 0.0,
            "rot_rmse_deg": float(np.nan_to_num(rmse, nan=BROKEN))}


def check(run: Run) -> dict:
    """The numbers compared, each ``name -> value``: those that the
    traffic file's ``limits`` name, which hold the limits too."""
    numbers = {"window_rot_gap_deg": _windows_solve_gap(run),
               **_pairs(run), **_work(run),
               "lost_frames": float(run.failed)}
    return {k: numbers[k] for k in run.traffic["limits"]}


def plant(run: Run, fault: str) -> None:
    """Break the timed path underneath (for the checks' own tests)."""
    from irotavg_tpu_torch.engine import incremental, viewgraph

    vg_cls = viewgraph.ViewGraph
    if fault == "state_unchanged":
        cls = incremental.IncrementalRotAvg
        old = cls.rot_avg
        cls.rot_avg = lambda self, *a, **k: None
        run.undo.append((cls, "rot_avg", old))
    elif fault in ("pairs_altered", "rotation_altered"):
        old = vg_cls.connect
        c, s = math.cos(math.radians(3.0)), math.sin(math.radians(3.0))
        tilt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

        def connect(self, i, j, pairs, rel):
            if fault == "pairs_altered":
                pairs = np.stack([pairs[:, 0], np.roll(pairs[:, 1], 1)], -1)
            else:
                rel = dataclasses.replace(rel, R=tilt @ rel.R)
            return old(self, i, j, pairs, rel)

        vg_cls.connect = connect
        run.undo.append((vg_cls, "connect", old))
    elif fault == "frames_skipped":
        # every other frame turned away at the keyframe gate
        old = vg_cls.process_frame
        calls = [0]

        def process_frame(self, frame, *a, **k):
            calls[0] += 1
            if calls[0] % 2 == 0:
                return False
            return old(self, frame, *a, **k)

        vg_cls.process_frame = process_frame
        run.undo.append((vg_cls, "process_frame", old))
    elif fault == "edges_dropped":
        # the window walk's edges left out: each view joins its predecessor
        old = vg_cls.connect
        W = run.pc.vg_win_size

        def connect(self, i, j, pairs, rel):
            if 1 < j - i <= W:
                return None
            return old(self, i, j, pairs, rel)

        vg_cls.connect = connect
        run.undo.append((vg_cls, "connect", old))
    elif fault == "loops_missed":
        # every loop candidate turned away unverified
        old = vg_cls.close_loop
        vg_cls.close_loop = lambda self, *a, **k: False
        run.undo.append((vg_cls, "close_loop", old))
    else:
        raise ValueError(f"no fault {fault!r} for this driver")


FAULTS = ("state_unchanged", "pairs_altered", "rotation_altered",
          "frames_skipped", "edges_dropped", "loops_missed")

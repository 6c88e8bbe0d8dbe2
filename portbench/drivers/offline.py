"""Driver of the offline ``irotavg_batch`` path.

A job is ``app/irotavg_batch.py:main`` without its disk reads and file
writes: ``pipeline.run_offline`` over one recorded segment's decoded
frames with the CLI's arguments (``PipelineConfig()``, ``batch`` 8,
``chunk`` 8, ``win_size`` 4, the pipeline's own ``refine_iters`` 10 and
5 px keyframe gate, loop closure on).  Set-up renders the traffic's
``jobs`` segments on the card to host ``uint8`` frames (one world for
every seed, each job's sensor noise drawn from the seed and the job's
index), loads the vocabulary and runs one whole job on a throwaway to
warm every path.  The window runs the jobs in turn, back to back, and
ends with the first job that finishes after ``--seconds``;
``frames_per_s`` is the frames of the jobs finished in it over its
length.  A job that raises counts as failed.

``check`` holds every job of the window to the reference
(``reference/offline.py``): its keyframes and window pairs against the
plan the reference derives from the job's own consecutive flows
(``plan_gap``, exact), its rotations against the reference's re-solve
from the job's own edges (``solve_gap_deg``), its edges' relative
rotations against the renderer's scene (``bad_edge_share``: those off by
more than ``EDGE_DEG``), the window pairs it did not connect
(``pair_shortfall``), the ground-truth revisits no loop edge closes
(``revisit_miss_share``) and its rotations' RMS error after the best
gauge (``rot_rmse_deg``); each the worst job's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import math
import sys
import time
import traceback

import numpy as np

from drivers import slam
from gen import ring_orbit
from reference import offline as ref, rotavg, scene as gt

BROKEN = slam.BROKEN
# degrees by which an edge's relative rotation may miss the scene's before
# it counts as a bad edge: 1.2-2.4% of a sound job's edges miss by more,
# 99.6% of a job's edges tilted by 3 degrees (PERF.md section 2)
EDGE_DEG = 2.0
# degrees within which two keyframes half a lap or more apart look the
# same way: a place seen again
REVISIT_DEG = 15.0


def _check_offline(cfg: dict) -> dict:
    """The ``irotavg_batch`` CLI's arguments to ``run_offline``, held to
    the configuration file's ``offline`` settings."""
    from irotavg_tpu_torch.app import irotavg_batch
    from irotavg_tpu_torch.pipeline import offline

    cli = irotavg_batch.build_parser().parse_args(["vocab", "cfg", "seq"])
    own = inspect.signature(offline.run_offline).parameters
    got = {"batch": cli.batch, "chunk": cli.chunk, "win_size": cli.win_size,
           "refine_iters": own["refine_iters"].default,
           "keyframe_gate_px": own["keyframe_gate_px"].default,
           "seed": own["seed"].default,
           "loop_closure": not cli.no_loop_closure}
    if got != cfg["offline"]:
        raise ValueError(f"the irotavg_batch CLI's settings {got} differ "
                         f"from the configuration {cfg['offline']}")
    return {k: got[k] for k in ("batch", "chunk", "win_size",
                                "refine_iters", "keyframe_gate_px", "seed")}


def job_seed(seed: int, job: int) -> int:
    """The seed of job ``job``'s sensor noise: from the run's seed and the
    job's index."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), job])
    return int(state.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def render_jobs(traffic: dict, cfg: dict, seed: int, device):
    """``traffic["jobs"]`` segments of ``cfg["frames_per_job"]`` frames
    (lists of host uint8 arrays) and their :class:`ring_orbit.Scene`: one
    orbit, each job with its own noise (none where ``noise_sigma`` is 0)."""
    import torch

    cam = cfg["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1.0]])
    corners, textures = ring_orbit.ring_world(
        ring_orbit.seed_rng(traffic["world_seed"]), device)
    R, C = ring_orbit.orbit(cfg["frames_per_job"], traffic["frames_per_lap"],
                            traffic["radius_m"], traffic["shrink_per_lap_m"])
    sigma = float(traffic.get("noise_sigma") or 0.0)
    jobs = []
    for j in range(traffic["jobs"]):
        noise = None
        if sigma:
            gen = torch.Generator(device=device)
            gen.manual_seed(job_seed(seed, j))
            noise = (sigma, gen)
        host = ring_orbit.render(corners, textures, R, C, K, cam["width"],
                                 cam["height"], noise=noise).cpu().numpy()
        jobs.append([host[k] for k in range(len(host))])
    return jobs, ring_orbit.Scene(corners=corners, R=R, C=C, K=K,
                                  width=cam["width"], height=cam["height"])


@dataclasses.dataclass
class Run:
    cfg: dict
    traffic: dict
    pc: object
    args: dict
    device: object
    jobs: list
    scene: object
    camera: object
    extractor: object
    vocab: object
    done: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    undo: list = dataclasses.field(default_factory=list)


def _job(run: Run, frames):
    """One job as the CLI runs it, looked up at call time (a fault may
    replace it)."""
    from irotavg_tpu_torch import pipeline

    return pipeline.run_offline(frames, run.camera, run.extractor,
                                vocab=run.vocab, cfg=run.pc, **run.args)


def setup(ctx) -> Run:
    import torch

    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.pipeline import offline
    from irotavg_tpu_torch.solver import RotationGraph

    cfg, traffic = ctx.config, ctx.traffic
    if "flows" not in {f.name for f in
                       dataclasses.fields(offline.OfflineResult)}:
        raise RuntimeError("this program's OfflineResult has no flows, "
                           "which the check derives the job's plan from")
    pc = slam._check_pipeline(cfg)
    args = _check_offline(cfg)
    if cfg["solver"]["dtype"] != "float64":
        raise ValueError("the offline solve is f64")
    undo = []
    if ctx.control:
        # the control: stage 5 in f32
        class F32Graph:
            create = staticmethod(lambda *a, **k: RotationGraph.create(
                *a, **dict(k, dtype=torch.float32)))

        undo.append((offline, "RotationGraph", offline.RotationGraph))
        offline.RotationGraph = F32Graph
    t0 = time.perf_counter()
    jobs, scene = render_jobs(traffic, cfg, ctx.seed, ctx.device)
    t1 = time.perf_counter()
    vocab = ctx.shared.get("vocab")
    if vocab is None:
        vocab = ctx.shared["vocab"] = slam.load_vocabulary(cfg, ctx.root,
                                                           ctx.device)
    t2 = time.perf_counter()
    cam = cfg["camera"]
    camera = Camera(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                    k1=cam["k1"], k2=cam["k2"], p1=cam["p1"], p2=cam["p2"],
                    width=cam["width"], height=cam["height"])
    extractor = ORBExtractor(**cfg["orb"], device=ctx.device)
    run = Run(cfg=cfg, traffic=traffic, pc=pc, args=args, device=ctx.device,
              jobs=jobs, scene=scene, camera=camera, extractor=extractor,
              vocab=vocab, undo=undo)
    _job(run, jobs[0])              # the throwaway: every path warmed
    print(f"portbench: rendered {len(jobs)} jobs of "
          f"{cfg['frames_per_job']} frames in {t1 - t0:.3f} s, vocabulary "
          f"{t2 - t1:.3f} s, warm-up job {time.perf_counter() - t2:.3f} s",
          file=sys.stderr)
    return run


def window(run: Run, seconds: float) -> dict:
    t0 = time.perf_counter()
    t_end = t0
    frames = k = 0
    while True:
        j = k % len(run.jobs)
        k += 1
        run.attempted += 1
        try:
            res = _job(run, run.jobs[j])
        except (ValueError, RuntimeError):
            traceback.print_exc()
            run.failed += 1
        else:
            run.done.append((j, res))
            frames += len(run.jobs[j])
        t_end = time.perf_counter()
        if t_end - t0 >= seconds:
            break
    run.window_s = t_end - t0
    metrics = {"frames_per_s": frames / run.window_s} if frames else {}
    return {"attempted": run.attempted, "failed": run.failed,
            "metrics": metrics,
            "units": {"frames": frames, "jobs": len(run.done)},
            "window_s": run.window_s}


def collect(run: Run) -> None:
    """The jobs' answers are host arrays already; the frames are let go."""
    run.jobs = None
    release(run)


def release(run: Run) -> None:
    for mod, attr, old in reversed(run.undo):
        setattr(mod, attr, old)
    run.undo.clear()


def edge_digest(edges) -> str:
    """16 hex digits of the SHA-256 of the ``(i, j)`` edges in order (as
    ``chip_smoke.py`` digests loop edges)."""
    text = json.dumps([[int(i), int(j)] for i, j in edges])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _worst(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.nan_to_num(x, nan=BROKEN).max()) if x.size else 0.0


def job_numbers(res, R_frames, traffic: dict, cfg: dict) -> dict:
    """The numbers compared for one job's ``OfflineResult`` ``res``,
    with the scene's world-to-camera rotation ``R_frames`` of every frame
    of the segment."""
    off = cfg["offline"]
    kf_ref, pairs_ref, _ = ref.plan(res.flows, off["keyframe_gate_px"],
                                    off["win_size"])
    planned = {(kf_ref[a], kf_ref[b]) for a, b in pairs_ref.tolist()}
    kf = np.asarray(res.keyframes, np.int64)
    edges = np.asarray(res.edges, np.int64).reshape(-1, 2)
    loop = np.asarray(res.loop_mask, bool)
    made = {(int(kf[a]), int(kf[b])) for a, b in edges[~loop].tolist()}
    plan_gap = (len(set(kf.tolist()) ^ set(kf_ref)) + len(made - planned)
                + abs(res.stats["pairs_total"] - len(pairs_ref)))
    R = R_frames[kf]
    err = ref.edge_errors_deg(edges, res.QQ, R)
    Q_ref = ref.resolve(edges, res.QQ, len(kf), cfg["solver"])
    rev = ref.revisits(kf, R, traffic["frames_per_lap"], REVISIT_DEG)
    due = np.flatnonzero(rev.any(1))
    closed = {b for a, b in edges[loop].tolist() if rev[b, a]}
    rms = np.sqrt(np.mean(gt.rotation_errors_deg(
        np.asarray(res.Q, np.float64), R) ** 2))
    return {"plan_gap": float(plan_gap),
            "solve_gap_deg": _worst(rotavg.geodesic_deg(Q_ref, res.Q)),
            "bad_edge_share": float(np.mean(np.nan_to_num(err, nan=BROKEN)
                                            > EDGE_DEG)) if len(err) else 1.0,
            "pair_shortfall": 1.0 - len(made & planned) / len(planned)
            if planned else 0.0,
            "revisit_miss_share": 1.0 - len(closed) / len(due)
            if len(due) else 0.0,
            "rot_rmse_deg": _worst(rms),
            # reported, not compared
            "edge_err_p50_deg": float(np.median(err)) if len(err) else 0.0,
            "edge_err_max_deg": _worst(err), "due": len(due)}


def check(run: Run) -> dict:
    """The numbers compared, each the worst job's: those that the traffic
    file's ``limits`` name, which hold the limits too."""
    worst: dict = {}
    for j, res in run.done:
        nums = job_numbers(res, run.scene.R, run.traffic, run.cfg)
        st = res.stats
        loops = np.asarray(res.edges)[np.asarray(res.loop_mask, bool)]
        print(f"portbench: job {j}: {len(res.flows) + 1} frames, "
              f"{len(res.keyframes)} keyframes, {len(res.edges)} edges "
              f"({res.loop_edges} loop, digest {edge_digest(loops)}; "
              f"{st['pairs_connected']} of {st['pairs_total']} window pairs, "
              f"{st.get('loop_candidate_pairs', 0)} loop candidates, "
              f"{nums['due']} keyframes due a revisit); stages extract "
              f"{st['extract_s']:.3f} flow {st['flow_s']:.3f} pairs "
              f"{st['pairs_s']:.3f} loop {st.get('loop_s', 0.0):.3f} solve "
              f"{st['solve_s']:.3f} s; "
              + ", ".join(f"{k} {v!r}" for k, v in nums.items()
                          if k != "due"), file=sys.stderr)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    if not run.done:
        return {k: BROKEN for k in run.traffic["limits"]}
    return {k: worst[k] for k in run.traffic["limits"]}


def plant(run: Run, fault: str) -> None:
    """Break the timed path underneath (for the checks' own tests)."""
    from irotavg_tpu_torch import pipeline
    from irotavg_tpu_torch.pipeline import offline

    if fault == "state_unchanged":
        # stage 5 returns its spanning-tree start
        run.undo += [(offline, "l1ra", offline.l1ra),
                     (offline, "irls", offline.irls)]
        offline.l1ra = lambda g, cfg: (g.Q, 0, math.inf)
        offline.irls = lambda g, cfg: (g.Q, None, 0, math.inf)
    elif fault == "rotation_altered":
        # every edge's relative rotation tilted 3 degrees
        old = offline._to_quat
        c, s = math.cos(math.radians(3.0)), math.sin(math.radians(3.0))
        tilt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        run.undo.append((offline, "_to_quat", old))
        offline._to_quat = lambda R: old(tilt @ R)
    elif fault == "loops_missed":
        # no loop candidate returned
        run.undo.append((offline, "_loop_candidates",
                         offline._loop_candidates))
        offline._loop_candidates = lambda *a, **k: []
    elif fault == "pairs_dropped":
        # only each keyframe's predecessor pair estimated
        old = pipeline.run_offline
        run.undo.append((pipeline, "run_offline", old))
        pipeline.run_offline = lambda *a, **k: old(*a, **dict(k,
                                                              win_size=1))
    else:
        raise ValueError(f"no fault {fault!r} for this driver")


FAULTS = ("state_unchanged", "rotation_altered", "loops_missed",
          "pairs_dropped")

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout.  Phases (any failure exits non-zero and
prints no result line):

0. device — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit (``nvidia-smi``) and the torch / CUDA versions.
1. build — compiles every CUDA source of the main path from
   ``irotavg_tpu_torch/csrc`` (``match_best2``, ``segment_sum``,
   ``laplacian``, ``ransac_hyp``, ``ransac_vote``, ``ransac_tail``,
   ``l1_decode``),
   one nvcc each, all started together, and prints the
   build seconds and ptxas's ``-v`` report (registers, shared memory,
   spills).
2. kernels — each kernel against its plain PyTorch version on the card,
   required exactly equal.  ``segment_sum`` (the solver's remaining
   fixed-order scatter-adds) bit for bit against ``segment_sum_plain`` on
   the same inputs moved to the CPU, at the shapes it is given
   (:func:`segment_cases`: ``A.T @ e`` and the Jacobi diagonal on 5b's
   graph in f64 and f32 and on 5c's, the window server's batch, a
   main-path window, SIFT's two histograms), timed beside its bound, the
   plain version on the card and one atomic ``index_add_``
   (``library_ms``).  The fused Laplacian kernels of ``csrc/laplacian.cu``
   (``laplacian_matvec``, the CG matvec; ``laplacian_assemble``, the dense
   Laplacian) bit for bit against their plain versions on the CPU and
   against the unfused composition they replace on the card
   (``tests/composed_laplacian.py``), at ``MATVEC_CASES`` and
   ``ASSEMBLE_CASES`` (5b's graph in f64 and f32, 5c's 4541-view graph
   with one coefficient column and L1-RA's three, the window server's
   batch, a 13-view main-path window with three L1-RA lanes, and five
   columns of ``x`` on 5c's graph: two launches a call), timed beside
   their bounds, the plain version, the composition and the library
   yardstick (``torch.sparse.mm`` of the CSR Laplacian, block-diagonal
   over per-column coefficients; ``to_dense`` of the COO tensor of the
   dense terms and the diagonal); and the assembly of a 30,000-view
   chain, whose rows exceed a block's shared memory and go in chunks,
   against its plain version on the card.  ``match_best2``: at the main
   path's shapes under every gate,
   and on adversarial cases (exact duplicate columns on both sides of
   every column-split and tile boundary, rows with no and with one
   passing column, N2 = split*tile +- 1, N1 under one row tile, shared
   column frames at B=3; :func:`adversarial_match_cases`).  Times are
   medians over 7 windows of 50 back-to-back launches between one CUDA
   event pair (per launch; L2 warm, as for the real caller), beside the
   bound (``ops/match.py:bound_ms``), the plain version's time and
   ``library_ms``: one ``torch.matmul`` of the ±1 bf16 expansions, which
   gives the distances only (no gate, no top-2) and is never called by
   the port.  Also at the offline pipeline's shape: 8 pairs, each lane
   with its own column frame, under ``local`` and ``epipolar_nonode``.
   ``ransac_hyp`` (every lane's minimal-sample hypotheses: the draws
   from JAX's threefry keys, the 8-point E projected onto (1, 1, 0), the
   4-point H) and ``ransac_vote`` (Sampson and transfer masks and
   counts, on the kernel's own hypotheses) bit for bit against their
   plain versions on the same inputs moved to the CPU, at ``DRAW_CASES``
   (the engine's 512 + 192 draws and find_relative_pose's 1024 + 192 over
   2000 flags, the offline chunk's 8 lanes, none / one / all valid, 70
   lanes in two launches, 20,000 flags) and ``DUPLICATE_CASE`` (samples
   at given positions, each drawing a correspondence twice), timed at
   the engine's, ``find_relative_pose``'s and the offline chunk's shapes
   beside their bounds, the plain versions on the card,
   ``torch.linalg.svd`` of the same designs and the eager Sampson
   composition they replaced; then the RANSAC parity check: 48
   ``ransac_essential`` + ``recover_pose`` calls at phase 3's shape on
   the card and on the CPU with the same keys, every inlier mask and
   cheirality count equal and E within one f32 rounding.  Then RANSAC's
   five tail kernels (``csrc/ransac_tail.cu``: the homography refit, the
   pool's 8 motions, the cheirality re-rank, the 8-point refit, the refit's
   check with the pose) at the same cases, each step fed the card's
   outputs of the steps before and held to its plain version on the same
   inputs moved to the CPU (decisions equal, f64 outputs within
   ``TAIL_MAX_DIFF``; the line says how many were bit-identical), timed
   beside its bound and its plain version on the card, a whole RANSAC
   call against the lane-by-lane route it replaced
   (``tests/ransac_lane_oracle.py``), and RANSAC batches of 1, 3 and 8
   lanes with no device-to-host copy and no solver-library kernel
   (``ransac_call_check``: the sync debug mode "error" and a CUDA
   profiler session).  In every CLI run below each RANSAC batch runs
   under the sync debug mode "error", and the first
   ``RANSAC_PROFILED_CALLS`` are traced for copies and solver kernels
   (``RANSAC_CALLS``).  Last, the epipolar refine
   (``geometry/fused.py:fused_refine``) at the main paths' lane counts
   (``REFINE_CASES``: 1 and 3 lanes on a shared column frame under
   ``epipolar``, 8 lanes with their own under ``epipolar_nonode``, the
   last lane of a batch frozen), its loop replayed from CUDA graphs at
   ``fused_refine``'s width (at least ``fused.REFINE_LANES`` lanes, the
   padding frozen) against the same loop run eagerly at its own: every
   output bit for bit, equal iterations, one replay an iteration, and
   the host time of an iteration both ways (:func:`phase_refine_graphs`).
3. main path — renders the first 150 frames of a one-lap synthetic
   KITTI-sized sequence (1241x376, KITTI 00 intrinsics, 300 frames a lap)
   with numpy, writes them as PGM with a GT file and an ORB-SLAM YAML
   (2000 features), runs the port's ``irotavg`` CLI on them with
   ``VOCAB=none``, ``--device cuda``, the default ``--prefetch 8`` and GT
   pins every 20 frames, launch counters reset just before, and checks
   the kernel counts, the output files and the rotation RMSE against GT,
   and that keyframes, launches by gate, connections and RMSE are those
   of the port on the CPU with per-frame extraction
   (``PER_FRAME_PHASE3``, :func:`hold_to_cpu`), and that every plan the
   window
   solves use was built once per ``irls`` / ``l1ra`` call, none inside an
   iteration (:func:`counting_plans`).  Then the prefetch check: the first
   16 frames through ``FramePrefetcher(batch=8)`` against ``Frame`` built
   one at a time, without and with the vocabulary (desc, valid, octave,
   x, y, angle, BoW and node ids equal), and the extraction ms per frame
   batched and one at a time (CUDA events).
4. loop closure — renders a one-way orbit of two laps (241 frames, the
   orbit shrinking by 1 m, so lap 2 revisits lap 1 from a slightly
   different pose) at the same size, decompresses the repo's k=10, L=5
   DBoW2 vocabulary (``tests/data/product_vocab_k10_L5_v1.txt.gz``), times
   its parse and the per-frame tree descent, and runs the CLI twice
   (``--device cuda``) with no GT pins so that drift accumulates: A with
   loop closure, B with ``--no_loop_closure``.  Fails unless both runs succeed, A makes a loop
   edge spanning more than 10 views, A launches the matcher under the
   ``node`` and ``epipolar`` gates, 2 * RMSE_A < RMSE_B (the payoff
   tests/test_loop_payoff.py asserts for the reference), and both runs
   give the port's CPU values (``LOOP_PHASE4``: keyframes, launches by
   gate, connections, loop edges, RMSE).  Then the
   extraction parity: the 241 frames extracted on the card and on the
   CPU, batched by 8, must be equal bit for bit (x, y, octave, valid,
   response, angle, descriptors).
5. solver surfaces (f64 on the card) — (a) the port's ``l1_irls`` CLI on
   the golden problem (1832 views, 3655 edges): row counts, and
   bench.py:321-322's quality rule against the scipy oracle
   ``tests/ref_impl.py``; (b) bench.py:379-401's 50k-view problem with
   the reference's f64 CG configuration, twice: converged, finite, mean
   error vs GT within 0.01 deg of the JAX package's f64 value, CG
   iterations, seconds, and the two runs bit-identical, then a third
   run on the unfused composition (``tests/composed_laplacian.py``)
   bit-identical to them;
   (c) a KITTI-length (4541-view) graph through ``IncrementalRotAvg``'s
   ``rot_avg(5_000_000)``: the CG window (bucket 8192 > 2048) against the
   same graph solved dense, max geodesic < 1e-6 deg; (d) bench.py's 384
   windows through ``solve_windows`` against the per-window engine
   solve: equal iteration counts, quaternions within 1e-9, windows/s.
6. checkpoint/resume — phase 3's sequence through the CLI in two parts
   (75 keyframes with ``--checkpoint`` and ``--prefetch 1``, then
   ``--resume`` to 150): the same keyframe ids and connections as phase
   3's batched extraction, poses equal bit for bit (extraction and every
   solve are independent of the card's order of additions), the matcher
   launched in both parts.
7. offline — the port's ``irotavg_batch`` CLI (``--device cuda``) on
   phase 4's frames with phase 4's vocabulary, launch counters reset just
   before: keyframes, edges, loop edges and their keyframe spans, stage
   seconds, frames/s, launches by gate, rotation RMSE against GT.  Fails
   unless it succeeds, launches the matcher under ``local`` and
   ``epipolar_nonode``, gives the port's CPU values (``PORT_OFFLINE``:
   keyframes, edges, loop candidates, loop edges, launches by gate,
   RMSE), its RMSE is finite and at most 1.1x the JAX package's on the
   same frames, it makes a loop edge spanning more than 10 keyframes,
   and 2 * its RMSE < phase 4's RMSE_B.
8. distributed — ``parallel/`` at world size 1 over NCCL on phase 5b's
   50k-view f64 problem: ``sharded_irls`` and ``sharded_ravg_pipeline``
   against the single-device ``irls`` on the same schedules, in the
   default mode (equal IRLS and CG iterations, max geodesic 0 deg), the
   sharded solve's mean error within 0.01 deg of the JAX f64 value,
   seconds; then the scaling probe at world size 1 (one card: no
   multi-GPU scaling is measured).
9. vocabulary training — ``train_vocabulary_flat`` (k=10, L=5) on
   descriptors sampled from phase 4's frames on the card, with its IDF
   descent on the card and on the CPU: equal trees and weights; seconds.
10. surfaces — on phase 3's first two frames (2000 ORB features,
   extracted on the card), launch counters reset just before: the
   Frame-level ``match_locally``, ``match_by_bow`` without node ids
   (gate ``none``) and with phase 4's vocabulary (``node``),
   ``find_relative_pose``, ``match_epipolar`` with its F (``epipolar``
   and ``epipolar_nonode``) and ``refine_pose`` for three seeds; every
   matcher equal row for row to the same call on the frames' tensors
   moved to the CPU, the refined support >= the initial, the refined R
   within 0.5 deg of the CPU's calls (median over the seeds).
   ``hamming_matrix`` at 2000x2000 equal to the CPU's, its row minima
   the kernel's ``d1`` under ``none``.  ``SIFTExtractor`` (2000
   features, 4 octaves) on the card twice, bit-identical (its histograms
   are ``segment_sum``s), and against the CPU: every one of the CPU's
   keypoints at the same (octave, x0, y0), descriptors within 1e-3 on >=
   98% of them (the share bit-identical reported), ``match_sift`` equal
   on >= 99% of rows; extraction ms, in turns against the route before
   the fixed-order sums (one atomic ``scatter_add`` a histogram).
   Then the CLI with ``--plot_matches`` on the first 20 frames, and with
   it and ``--trace_dir`` on the first 3 (a trace grows by tens of MB a
   frame):
   one decodable side-by-side PNG per connected consecutive keyframe
   pair, phase 3's first keyframes, and a ``torch.profiler`` trace naming
   ``match_best2_kernel`` among its CUDA kernel events.

Every path that runs the solver (phases 3-8 and phase 10's CLI runs and
SIFT) counts the launches of ``segment_sum``, ``laplacian_matvec`` and
``laplacian_assemble`` from 0 and fails if it launched a kernel of its
backend no time (``DENSE_PATH``, ``CG_PATH``); every CLI run counts
RANSAC's kernels the same way and fails unless it launched ``ransac_hyp``
and ``ransac_vote`` and the five tail kernels (``RANSAC_LAUNCHES``).

The second-to-last stdout line is the kernel report
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# main-path shapes of the matcher: 2000 ORB features, K = 3 window
# candidates (vg_win_size - 1), plus a ragged case
MATCH_SHAPES = ((1, 2000, 2000), (3, 2000, 2000), (1, 1999, 2001))
# the offline pipeline's shape: a chunk of 8 pairs, each lane with its own
# column frame, under the gates its flow, pair match and refine use
OFFLINE_SHAPE = (8, 2000, 2000)
OFFLINE_GATES = ("local", "epipolar_nonode")
# frame size and intrinsics of KITTI odometry sequence 00
# (ORB-SLAM2 Examples/Monocular/KITTI00-02.yaml)
KITTI_W, KITTI_H = 1241, 376
KITTI_K = (718.856, 718.856, 607.1928, 185.2157)
# rotation RMSE bound (deg) for the synthetic sequence, GT-anchored every
# 20 frames like the reference CLI; the JAX reference reaches 0.61 deg on
# the 300-frame sequence (run on a CPU)
RMSE_BOUND_DEG = 1.0
MAIN_LAP_FRAMES = 300          # frames in phase 3's one-lap sequence
MAIN_FRAMES = 150              # phase 3 runs the first half of the lap
# phase 4: two laps over an odd frame count on an orbit that shrinks by
# 1 m, so lap 2 passes lap 1's places half a frame step later and 0.5 m
# further in (a revisit under a pose change, not a copy of lap 1)
LOOP_FRAMES = 241
LOOP_SPIRAL = 1.0
# the loop-closure payoff asserted for the reference
# (tests/test_loop_payoff.py) and the shortest loop edge that counts as a
# revisit (beyond the 4-view window walk and its chains)
LOOP_PAYOFF = 2.0
LOOP_MIN_SPAN = 10
VOCAB_FIXTURE = os.path.join(HERE, "tests", "data",
                             "product_vocab_k10_L5_v1.txt.gz")
# phase 5: the repo's golden problem (the reference's bundled
# ral/data/ravg_input.txt)
GOLDEN = os.path.join(HERE, "tests", "data", "ravg_input.txt.gz")
GOLDEN_N, GOLDEN_M = 1832, 3655
# bench.py:379-401's 50k-view quasi-global problem and the reference's
# own f64 cross-check configuration (bench.py:481-482)
LARGE_N, LARGE_EXTRA = 50_000, 200_000
# the JAX package's f64 mean error vs GT on that problem with that
# configuration, computed once on a CPU through the JAX package (41 IRLS
# iterations)
LARGE_JAX_F64_MEAN_ERR_DEG = 3.7716418809615866
LARGE_TOL_DEG = 0.01
KITTI_VIEWS = 4541            # keyframes of a KITTI 00 run
KITTI_TOL_DEG = 1e-6          # CG vs dense engine solve, both f64
N_WINDOWS = 384               # bench.py:500's batch of windows
# phase 6: phase 3's run cut after this many keyframes, then resumed
RESUME_AT = 75
# The port's outputs on the CPU, recorded once by
# ``tools/record_cpu_values.py`` (the same CLI calls with ``--device cpu``;
# matcher calls by gate counted there, one launch each on the card; loop
# edges by count and :func:`edge_digest`).  Both devices draw the same
# RANSAC samples (JAX's threefry keys), extract the same features and
# solve RANSAC in f64 with basis-free null directions, so the card must
# give the same keyframes, matcher launches by gate, connections and loop
# edges, and the RMSE within CPU_RMSE_TOL_DEG: the window solves' last
# bits (the card's RMSEs were within 1.1e-8 deg of these in PR 11).
CPU_RMSE_TOL_DEG = 1e-6
# phase 3 with per-frame extraction (``--prefetch 1``): the card's batched
# extraction must give the same
PER_FRAME_PHASE3 = {"keyframes": 150, "rmse": 0.45808474776391495,
                    "connections": 590,
                    "by_gate": {"none": 0, "node": 0, "local": 149,
                                "epipolar": 0, "epipolar_nonode": 1352}}
# phase 4's runs A (loop closure) and B (--no_loop_closure); loop edges
# sorted
LOOP_PHASE4 = {
    "A": {"keyframes": 241, "rmse": 1.959817824668, "connections": 1096,
          "by_gate": {"none": 0, "node": 148, "local": 258, "epipolar": 2749,
                      "epipolar_nonode": 0},
          "loop_edges": 148, "loop_edge_digest": "b677225072244d11"},
    "B": {"keyframes": 241, "rmse": 11.181975737055277, "connections": 948,
          "by_gate": {"none": 0, "node": 0, "local": 258, "epipolar": 2150,
                      "epipolar_nonode": 0},
          "loop_edges": 0, "loop_edge_digest": "4f53cda18c2baa0c"}}
# the prefetch check: frames and batch width
PREFETCH_FRAMES = 16
PREFETCH_BATCH = 8
# phase 7: the JAX package's offline rotation RMSE (deg) on phase 4's
# frames with phase 4's vocabulary, computed once on a CPU through the
# JAX ``irotavg_batch`` CLI (default settings: 241 keyframes, 1091
# edges, 137 loop edges spanning 117-123 keyframes); the port may reach
# at most OFFLINE_RMSE_FACTOR times it.  With the JAX package's draws the
# port gives 1.3868 deg (1.087x) on the card and the CPU alike (PR 11;
# 1.5x before, when the card drew its own stream: 1.5487 deg)
JAX_OFFLINE_RMSE_DEG = 1.2757557007946743
JAX_OFFLINE_LOOP_EDGES = 137
OFFLINE_RMSE_FACTOR = 1.1
# the port's offline run on the same frames on the CPU
# (tools/record_cpu_values.py --run phase7): keyframes, edges, loop
# candidates and loop edges (in the run's order) the card must make, and
# its RMSE.  JAX's f32 orientation sums also make (0, 122) and (1, 122)
# candidates
PORT_OFFLINE_LOOP_CANDIDATES = 135
PORT_OFFLINE = {"keyframes": 241, "edges": 1089, "loop_edges": 135,
                "loop_candidates": PORT_OFFLINE_LOOP_CANDIDATES,
                "loop_edge_digest": "9bd5dffe951b9f97",
                "by_gate": {"none": 0, "node": 0, "local": 167,
                            "epipolar": 0, "epipolar_nonode": 863},
                "rmse": 1.3867674306683442}
# phase 10: SIFT agreement card vs CPU, the two-view tolerance, the CLI
# run's frames and the kernel's symbol in the trace.  Every keypoint of
# the CPU's is found by the card (NVIDIA H100 80GB HBM3): the detection
# compares sums that both devices add in one order; the descriptors'
# f32 exp / atan2 / sqrt round differently on the two devices
SIFT_KEYPOINT_SHARE = 1.0
SIFT_DESC_TOL = 1e-3
SIFT_DESC_SHARE = 0.98
SIFT_MATCH_SHARE = 0.99
# one RANSAC at this small baseline lands on different models from seed
# to seed on one device (see the supports printed per seed), so the two
# devices' poses are compared after refine_pose, by their median over
# the seeds
TWOVIEW_TOL_DEG = 0.5
TWOVIEW_SEEDS = (0, 1, 2)
SURFACE_CLI_FRAMES = 20
SURFACE_TRACE_FRAMES = 3
KERNEL_SYMBOL = "match_best2_kernel"


# the sources of the port's hand-written kernels
# (irotavg_tpu_torch/csrc/<name>.cu), one nvcc each
KERNELS = ("match_best2", "segment_sum", "laplacian", "ransac_hyp",
           "ransac_vote", "ransac_tail", "l1_decode")
# the solver's kernels: segment_sum (ops/segment.py) and the fused
# Laplacian matvec and assembly (ops/laplacian.py, csrc/laplacian.cu)
SOLVER_KERNELS = ("segment_sum", "laplacian_matvec", "laplacian_assemble")
# what a path that runs the dense solver launches, and the CG solver
DENSE_PATH = ("segment_sum", "laplacian_assemble")
CG_PATH = ("segment_sum", "laplacian_matvec")
# launches of each solver kernel per driven path, each counted from 0 just
# before the path runs (read at the end for the kernel report)
SOLVER_LAUNCHES: dict[str, dict[str, int]] = {}
# launches of RANSAC's kernels per CLI run, counted the same way: the
# hypotheses, the vote and the five tail kernels (each must launch)
RANSAC_LAUNCHES: dict[str, dict[str, int]] = {}
# per CLI run: RANSAC batches made, and the device-to-host copies and
# solver-library kernels inside the traced ones (both must be 0; every
# batch runs under the sync debug mode "error", so a read raises)
RANSAC_CALLS: dict[str, dict[str, int]] = {}


class SmokeError(RuntimeError):
    pass


def _solver_wrappers():
    from irotavg_tpu_torch.ops import laplacian, segment

    return {"segment_sum": segment.segment_sum,
            "laplacian_matvec": laplacian.laplacian_matvec,
            "laplacian_assemble": laplacian.laplacian_assemble}


@contextlib.contextmanager
def counting_solver(path, need=DENSE_PATH):
    """Sets the solver kernels' launch counts to 0 just before the block
    and records them under ``path`` just after; fails if the block (a
    path that runs the solver) launched a kernel of ``need`` no time."""
    from irotavg_tpu_torch.ops import laplacian, segment

    segment.reset_launch_counts()
    laplacian.reset_launch_counts()
    yield
    counts = SOLVER_LAUNCHES[path] = {
        name: fn.launches for name, fn in _solver_wrappers().items()}
    missing = [name for name in need if counts[name] <= 0]
    if missing:
        raise SmokeError(f"{path} never launched {', '.join(missing)}")


@contextlib.contextmanager
def counting_plans(stats):
    """Counts, inside the block, the plans built of each kind and the
    engine's solver calls (``irls`` and ``l1ra``) with their iterations,
    into ``stats``."""
    from irotavg_tpu_torch.engine import incremental
    from irotavg_tpu_torch.ops import laplacian, segment

    builders = {"segment_plan": segment.segment_plan,
                "matvec_plan": laplacian.matvec_plan,
                "dense_plan": laplacian.dense_plan}
    for fn in builders.values():
        fn.builds = 0
    calls = {"irls": [0, 0], "l1ra": [0, 0]}
    saved = {name: getattr(incremental, name) for name in calls}

    def counting(name, fn):
        def solve(*a, **kw):
            out = fn(*a, **kw)
            calls[name][0] += 1
            calls[name][1] += int(out[-2])       # the iteration count
            return out
        return solve

    for name, fn in saved.items():
        setattr(incremental, name, counting(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(incremental, name, fn)
        stats.update({k: fn.builds for k, fn in builders.items()})
        stats["calls"] = sum(c for c, _ in calls.values())
        stats["iterations"] = sum(i for _, i in calls.values())


def card_name(torch) -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if r.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {r.stderr.strip()}")
    idx = torch.cuda.current_device()
    lines = [ln.strip() for ln in r.stdout.strip().splitlines()]
    return lines[idx] if idx < len(lines) else lines[0]


def _median_ms(torch, fn, reps=20):
    fn()                                   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: this smoke "
                         "run needs a CUDA card")
    card = card_name(torch)
    print(card)                  # name, power limit exactly as nvidia-smi
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; python "
          f"{sys.version.split()[0]}")
    return card


def phase_build(card):
    """Builds every kernel's source at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from irotavg_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.load, KERNELS))
    print(f"[build] {', '.join(KERNELS)} in parallel: "
          f"{time.perf_counter() - t0:.2f} s  ({card})")
    for name in KERNELS:
        print(f"[build] {name}: nvcc {build.build_seconds[name]:.2f} s")
        report = build.ptxas_report.get(name)
        if report is None:
            print(f"[build] {name}: library was already built; no ptxas "
                  f"report")
            continue
        for line in report.splitlines():
            if line.strip():
                print(f"[build] ptxas: {line.strip()}")


def _time_ms(torch, fn, per_window=50, windows=7):
    """Median over ``windows`` CUDA-event windows of ``per_window``
    back-to-back calls of ``fn``, per call (ms)."""
    fn()                                   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_window):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_window)
    return statistics.median(times)


def _match_inputs(torch, B, n1, n2, gate, gen, dev):
    """Random words with planted near-duplicates and gate features at the
    KITTI frame size."""
    from irotavg_tpu_torch.ops.match import make_colf, make_rowf

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen,
                             dtype=torch.int64, device=dev).to(torch.int32)

    def unif(n, hi):
        return torch.rand(n, generator=gen, device=dev) * hi

    d1 = words(B, n1, 8)
    d2 = words(B, n2, 8)
    k = min(n1, n2) // 4
    flip = words(B, k, 8) & words(B, k, 8) & words(B, k, 8) & \
        words(B, k, 8) & words(B, k, 8)
    d2[:, :k] = d1[:, :k] ^ flip              # ~8 differing bits each
    d2[:, k:2 * k] = d1[:, :k]                # exact duplicates -> ties
    rows, cols = [], []
    F = torch.tensor([[0, 1e-4, -0.02], [-1e-4, 0, 0.03], [0.02, -0.03, 1]],
                     device=dev)
    for _ in range(B):
        v1 = torch.rand(n1, generator=gen, device=dev) > 0.1
        v2 = torch.rand(n2, generator=gen, device=dev) > 0.1
        nd1 = torch.randint(0, 12, (n1,), generator=gen, device=dev)
        nd2 = torch.randint(0, 12, (n2,), generator=gen, device=dev)
        x1, y1 = unif(n1, KITTI_W), unif(n1, KITTI_H)
        x2, y2 = unif(n2, KITTI_W), unif(n2, KITTI_H)
        o1 = torch.randint(0, 8, (n1,), generator=gen, device=dev)
        o2 = torch.randint(0, 8, (n2,), generator=gen, device=dev)
        if gate in ("none", "node"):
            rows.append(make_rowf(v1, node=nd1))
            cols.append(make_colf(v2, node=nd2))
        elif gate == "local":
            rows.append(make_rowf(v1, x=x1, y=y1, octave=o1,
                                  th=torch.full((n1,), 60.0, device=dev)))
            cols.append(make_colf(v2, x=x2, y=y2, octave=o2))
        else:
            a = x2 * F[0, 0] + y2 * F[1, 0] + F[2, 0]
            b = x2 * F[0, 1] + y2 * F[1, 1] + F[2, 1]
            c = x2 * F[0, 2] + y2 * F[1, 2] + F[2, 2]
            th = 3.84 * (1.2 ** o1.float()) ** 2 * 40
            rows.append(make_rowf(v1, node=nd1, x=x1, y=y1, th=th))
            cols.append(make_colf(v2, node=nd2, a=a, b=b, c=c))
    return d1, d2, torch.stack(rows), torch.stack(cols)


# -- adversarial matcher cases (numpy; tests/test_torch_match_ties.py runs
# the same cases against the JAX reference on the CPU) -----------------------


def column_boundaries(n2, split, tile):
    """Columns at which the kernel starts a new column chunk (one block of
    a cluster) or a new staged tile inside a chunk, for ``n2`` columns."""
    chunk = -(-n2 // split)
    out = set()
    for r in range(split):
        lo, hi = r * chunk, min(n2, (r + 1) * chunk)
        out.update(range(lo, hi, tile))
    return sorted(c for c in out if 0 < c < n2)


def _bit_flips(rng, n_bits):
    """(8,) uint32 words with ``n_bits`` distinct bits set."""
    out = np.zeros(256, np.uint32)
    out[rng.choice(256, n_bits, replace=False)] = 1
    return (out.reshape(8, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)


def _adversarial_case(rng, gate, name, B, n1, n2, mode, split, tile):
    """One case; see :func:`adversarial_match_cases`."""
    f32 = np.float32
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    nd1 = rng.integers(0, 12, n1).astype(f32)
    x1 = rng.uniform(0, KITTI_W, n1).astype(f32)
    y1 = rng.uniform(0, KITTI_H, n1).astype(f32)
    o1 = rng.integers(0, 8, n1).astype(f32)
    v1 = np.ones(n1, f32)
    th = np.full(n1, 100.0 if gate == "local" else 0.0, f32)
    if gate.startswith("epipolar"):
        th = (3.84 * (1.2 ** o1) ** 2 * 40).astype(f32)

    F = np.array([[0, 1e-4, -0.02], [-1e-4, 0, 0.03], [0.02, -0.03, 1]],
                 f32)

    def col_features(n):
        x2 = rng.uniform(0, KITTI_W, n).astype(f32)
        y2 = rng.uniform(0, KITTI_H, n).astype(f32)
        return np.stack([
            (rng.random(n) > 0.1).astype(f32),
            rng.integers(0, 12, n).astype(f32), x2, y2,
            rng.integers(0, 8, n).astype(f32),
            x2 * F[0, 0] + y2 * F[1, 0] + F[2, 0],
            x2 * F[0, 1] + y2 * F[1, 1] + F[2, 1],
            x2 * F[0, 2] + y2 * F[1, 2] + F[2, 2]], axis=1).astype(f32)

    cf = col_features(n2)
    fixed = set()                       # columns whose features are planted

    def plant(col, row):
        """Column ``col`` passes row ``row`` under every gate."""
        a = f32(rng.uniform(-0.01, 0.01))
        cf[col] = [1.0, nd1[row], x1[row] + f32(rng.uniform(-20, 20)),
                   y1[row] + f32(rng.uniform(-20, 20)), o1[row], a, 1.0,
                   -(a * x1[row] + y1[row])]          # line through the row
        fixed.add(col)

    rows = iter(range(n1))
    if mode == "one_col":
        # every column invalid but one, a duplicate of row 0
        cf[:, 0] = 0.0
        col = n2 // 2
        d2[col] = d1[next(rows)]
        plant(col, 0)
    else:
        # exact duplicates on both sides of every boundary (adjacent
        # boundaries share one run of copies), and distance-3 ties
        # straddling each run
        runs = []
        for c in column_boundaries(n2, split, tile):
            if runs and c <= runs[-1][1] + 1:
                runs[-1][1] = c
            else:
                runs.append([c, c])
        for lo, hi in runs:
            r = next(rows)
            for col in range(lo - 1, hi + 1):
                d2[col] = d1[r]
                plant(col, r)
            left, right = lo - 2, hi + 1
            if left >= 0 and right < n2 and not {left, right} & fixed:
                r = next(rows)
                d2[left] = d1[r] ^ _bit_flips(rng, 3)
                d2[right] = d1[r] ^ _bit_flips(rng, 3)
                plant(left, r)
                plant(right, r)
        free = [c for c in range(n2) if c not in fixed]
        for k in range(4):
            # a valid row that no column passes (except under "none")
            r = next(rows)
            nd1[r] = 1000 + k
            x1[r] = -5000.0 - 1000.0 * k
            th[r] = 0.0 if gate.startswith("epipolar") else th[r]
            # a valid row that exactly one column passes (except "none")
            r = next(rows)
            col = free[(k * 37) % len(free)]
            nd1[r] = 2000 + k
            x1[r] = -100000.0 - 1000.0 * k
            if gate.startswith("epipolar"):
                th[r] = 1e-6
            cf[col] = [1.0, nd1[r], x1[r], y1[r], o1[r], 0.0, 1.0, -y1[r]]
            fixed.add(col)
        for _ in range(3):
            v1[next(rows)] = 0.0         # invalid rows
    rowf = np.zeros((n1, 8), f32)
    rowf[:, :6] = np.stack([v1, nd1, x1, y1, o1, th], axis=1)

    # lanes: the rows permuted; the column frame shared ("both": words
    # and features; "desc2": words only, features re-drawn per lane except
    # the planted ones) or not (B = 1)
    perms = [np.arange(n1)] + [rng.permutation(n1) for _ in range(B - 1)]
    desc1 = np.stack([d1[p] for p in perms])
    rowfs = np.stack([rowf[p] for p in perms])
    if mode == "desc2":
        colf = []
        for _ in range(B):
            lane = col_features(n2)
            keep = sorted(fixed)
            lane[keep] = cf[keep]
            colf.append(lane)
        colf = np.stack(colf)
    elif mode == "both":
        colf = cf
    else:
        colf = np.broadcast_to(cf, (B,) + cf.shape).copy()
    desc2 = d2 if mode in ("both", "desc2") else \
        np.broadcast_to(d2, (B,) + d2.shape).copy()
    return {"name": name, "gate": gate, "desc1": desc1, "desc2": desc2,
            "rowf": rowfs, "colf": colf}


def adversarial_match_cases(seed=0):
    """The matcher's adversarial cases for every gate, as numpy arrays:
    ``desc1`` (B, N1, 8) uint32, ``desc2`` (B, N2, 8) or shared (N2, 8),
    ``rowf`` (B, N1, 8) f32, ``colf`` (B, N2, 8) or shared (N2, 8).  The
    split and tile sizes are the kernel's (``ops/match.py``)."""
    from irotavg_tpu_torch.ops.match import (
        COL_SPLIT, COL_TILE, GATES, ROWS_PER_BLOCK,
    )

    st = COL_SPLIT * COL_TILE
    specs = (
        (f"N2=split*tile+1={st + 1}", 1, ROWS_PER_BLOCK + 6, st + 1, None),
        (f"N2=split*tile-1={st - 1}", 1, ROWS_PER_BLOCK + 6, st - 1, None),
        ("N2=1100 (tiles in each chunk)", 1, 2 * ROWS_PER_BLOCK + 2, 1100,
         None),
        (f"N1=37<{ROWS_PER_BLOCK}", 1, 37, 300, None),
        ("B=3, shared desc2 and colf", 3, ROWS_PER_BLOCK + 6, st + 1,
         "both"),
        ("B=3, shared desc2", 3, ROWS_PER_BLOCK + 6, st + 1, "desc2"),
        ("one valid column", 1, 40, 200, "one_col"),
    )
    rng = np.random.default_rng(seed)
    return [_adversarial_case(rng, gate, name, B, n1, n2, mode, COL_SPLIT,
                              COL_TILE)
            for gate in GATES for name, B, n1, n2, mode in specs]


def _equal_or_fail(got, ref, what):
    errs = [float((g.double() - r.double()).abs().max())
            for g, r in zip(got, ref)]
    if any(e != 0.0 for e in errs):
        raise SmokeError(f"match_best2 != plain on {what}: max |d1,d2,idx| "
                         f"{errs}")
    return max(errs)


def phase_kernels(card):
    """Kernel against plain version at the main-path shapes and on the
    adversarial cases, all gates; times, bounds and the library call."""
    import torch

    from irotavg_tpu_torch.ops import match

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(7)
    max_err = 0.0
    timed = {}
    cases = [(shape, match.GATES) for shape in MATCH_SHAPES]
    cases.append((OFFLINE_SHAPE, OFFLINE_GATES))
    for (B, n1, n2), gates in cases:
        lib_ms = None
        for gate in gates:
            # a column frame per lane (distinct words and features)
            args = _match_inputs(torch, B, n1, n2, gate, gen, dev)
            got = match.best2(*args, gate)
            ref = match.best2_plain(*args, gate)
            torch.cuda.synchronize()
            max_err = max(max_err, _equal_or_fail(
                got, ref, f"B={B} {n1}x{n2} gate={gate}"))
            n_match = int((ref[0] < match.BIG).sum())
            launch, _ = match.best2_launcher(*args, gate)
            k_ms = _time_ms(torch, launch)
            p_ms = _time_ms(torch, lambda: match.best2_plain(*args, gate),
                            per_window=10, windows=5)
            if lib_ms is None:
                # the library yardstick: distances only, from the ±1 bf16
                # expansions made outside the timed window
                a = match.unpack_pm1(args[0]).to(torch.bfloat16)
                bt = match.unpack_pm1(args[1]).to(torch.bfloat16) \
                    .transpose(-1, -2).contiguous()
                dots = torch.empty((B, n1, n2), dtype=torch.bfloat16,
                                   device=dev)
                lib_ms = _time_ms(torch,
                                  lambda: torch.matmul(a, bt, out=dots))
            b_ms, b_by = match.bound_ms(B, n1, n2)
            print(f"[kernel] match_best2 B={B} {n1}x{n2} {gate:>15}: equal "
                  f"(rows matched {n_match}); kernel {k_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}), share of bound "
                  f"{b_ms / k_ms:.4f}; plain {p_ms:.4f} ms; library "
                  f"{lib_ms:.4f} ms  ({card})")
            timed[(B, n1, n2, gate)] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "bound_share": b_ms / k_ms,
                "library_ms": lib_ms}
    n_adv = 0
    for case in adversarial_match_cases(seed=0):
        t = {k: torch.from_numpy(np.ascontiguousarray(case[k])).to(dev)
             for k in ("desc1", "desc2", "rowf", "colf")}
        t["desc1"] = t["desc1"].view(torch.int32)
        t["desc2"] = t["desc2"].view(torch.int32)
        args = (t["desc1"], t["desc2"], t["rowf"], t["colf"])
        got = match.best2(*args, case["gate"])
        ref = match.best2_plain(*args, case["gate"])
        torch.cuda.synchronize()
        max_err = max(max_err, _equal_or_fail(
            got, ref, f"{case['name']} gate={case['gate']}"))
        B, n1 = case["desc1"].shape[:2]
        n_adv += 1
        print(f"[kernel] adversarial {case['gate']:>15} {case['name']} "
              f"(B={B}, N1={n1}, N2={case['desc2'].shape[-2]}): equal, "
              f"rows matched {int((ref[0] < match.BIG).sum())}")
    print(f"[kernel] match_best2 exactly equal to best2_plain in "
          f"{len(timed)} main-shape and offline-shape cases and {n_adv} "
          f"adversarial cases  ({card})")
    main = timed[(3, 2000, 2000, "epipolar_nonode")]
    B8 = OFFLINE_SHAPE
    return {"name": "match_best2", "route": "cuda",
            "source": "irotavg_tpu_torch/csrc/match_best2.cu",
            "replaces": "irotavg_tpu/ops/match_pallas.py:80",
            "max_abs_err": max_err, **main,
            "cases": {"B3_2000x2000_epipolar_nonode": main,
                      "B1_2000x2000_epipolar":
                          timed[(1, 2000, 2000, "epipolar")],
                      "B8_2000x2000_local_per_lane":
                          timed[B8 + ("local",)],
                      "B8_2000x2000_epipolar_nonode_per_lane":
                          timed[B8 + ("epipolar_nonode",)]}}


# -- phase 2, segment_sum: the solver's scatter-adds ---------------------------

# a main-path window of the per-keyframe CLI: the views of a 10-keyframe
# window and its neighbours, 3 sequential edges a view
MAIN_WINDOW_VIEWS = 13


def segment_cases(dev):
    """``segment_sum``'s inputs at the shapes the solver gives it, as
    ``(name, values, plan)`` on ``dev``: ``A.T @ e`` over 3 columns (the
    IRLS right-hand side and L1-RA's ``Atop``) and the Jacobi diagonal on
    5b's 50k-view graph (``A.T @ e`` also in the scaling probe's f32) and
    on 5c's 4541-view graph, ``A.T @ e`` on the window server's 384
    windows (m_pad 64, n_pad 16, flattened) and on a main-path window, and
    SIFT's two histograms.  Values are random normals from a seeded
    generator."""
    import torch

    from irotavg_tpu_torch.ops.segment import segment_plan
    from irotavg_tpu_torch.solver import graph

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    cases = []

    def add(name, plan, k, dtype=torch.float64):
        v = torch.randn((plan.perm.numel(), k), generator=gen, dtype=dtype,
                        device=dev)
        cases.append((name, v, plan))

    graphs = solver_graphs(dev)
    e5b, n5b = graphs["5b"][0], graphs["5b"][3]
    rplan = graph.rmatvec_plan(e5b, n5b)
    add("5b_rmatvec_f64", rplan, 3)
    add("5b_rmatvec_f32", rplan, 3, torch.float32)
    add("5b_diag_f64", graph.diag_plan(e5b, n5b), 1)
    e5c, n5c = graphs["5c"][0], graphs["5c"][3]
    add("5c_rmatvec_f64", graph.rmatvec_plan(e5c, n5c), 3)
    add("5c_diag_f64", graph.diag_plan(e5c, n5c), 1)
    add("windows_rmatvec_f64", graph.rmatvec_plan(graphs["windows"][0], 16),
        3)
    we, nw = graphs["window"][0], graphs["window"][3]
    add("window_rmatvec_f64", graph.rmatvec_plan(we, nw), 3)
    # SIFT's histograms (frontend/sift.py:_bin_sums): 2000 keypoints,
    # 289 samples into 36 orientation bins and 256 into 128 descriptor bins
    for name, samples, bins in (("sift_orientation_f32", 289, 36),
                                ("sift_descriptor_f32", 256, 128)):
        ids = torch.randint(0, bins, (2000, samples), generator=gen,
                            device=dev)
        ids += torch.arange(2000, device=dev)[:, None] * bins
        add(name, segment_plan(ids, 2000 * bins), 1, torch.float32)
    return cases


def phase_segment_kernel(card):
    """``segment_sum`` on the card against its plain version on the same
    inputs moved to the CPU, bit for bit, at :func:`segment_cases`'
    shapes; times of the kernel, the plain version on the card and one
    atomic ``index_add_`` of the unsorted terms (``library_ms``, never
    called by the port), beside the bound."""
    import torch

    from composed_laplacian import bits_equal

    from irotavg_tpu_torch.ops import segment

    dev = _device(torch)
    timed = {}
    for name, v, plan in segment_cases(dev):
        got = segment.segment_sum(v, plan)
        cpu_plan = segment.SegmentPlan(*(t.cpu() for t in plan[:3]),
                                       plan.rows)
        ref = segment.segment_sum_plain(v.cpu(), cpu_plan)
        torch.cuda.synchronize()
        if not bits_equal(got.cpu(), ref):
            d = float((got.cpu().double() - ref.double()).abs().max())
            raise SmokeError(f"segment_sum != plain on {name}: max |d| {d}")
        launch, _ = segment.segment_sum_launcher(v, plan)
        k_ms = _time_ms(torch, launch)
        p_ms = _time_ms(torch, lambda: segment.segment_sum_plain(v, plan),
                        per_window=10, windows=5)
        # the library yardstick: CUDA's atomic index_add_ of the terms in
        # their original order (the scatter the port used to make)
        ids = torch.empty_like(plan.ids).scatter_(0, plan.perm, plan.ids)
        acc = torch.zeros((plan.rows, v.shape[1]), dtype=v.dtype,
                          device=dev)
        lib_ms = _time_ms(torch, lambda: acc.index_add_(0, ids, v))
        b_ms, b_by = segment.bound_ms(v.shape[0], plan.rows, v.shape[1],
                                      v.dtype)
        n_empty = int((plan.offsets[1:] == plan.offsets[:-1]).sum())
        print(f"[kernel] segment_sum {name}: {v.shape[0]} terms x "
              f"{v.shape[1]} into {plan.rows} rows ({n_empty} empty): "
              f"bit-identical to the plain version; kernel {k_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}), share of bound "
              f"{b_ms / k_ms:.4f}; plain {p_ms:.4f} ms; index_add_ "
              f"{lib_ms:.4f} ms  ({card})")
        timed[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_share": b_ms / k_ms,
                       "library_ms": lib_ms}
    print(f"[kernel] segment_sum bit-identical to segment_sum_plain in "
          f"{len(timed)} cases  ({card})")
    return {"name": "segment_sum", "route": "cuda",
            "source": "irotavg_tpu_torch/csrc/segment_sum.cu",
            "replaces": "irotavg_tpu/solver/graph.py:133 (XLA .at[].add "
                        "in incidence_rmatvec; also :158-159, :180-184; "
                        "no Pallas kernel)",
            "max_abs_err": 0.0, **timed["5b_rmatvec_f64"], "cases": timed}


# -- phase 2, the fused Laplacian kernels and the composition they replace ----


_GRAPHS: dict = {}


def solver_graphs(dev):
    """The graphs the solver's kernels see, as ``name -> (edges, free
    mask, edge mask, n)`` on ``dev``: 5b's 50k-view problem, 5c's
    4541-view KITTI-length graph (view 0 fixed), bench.py's 384 windows as
    the window server packs them (m_pad 64, n_pad 16), and a
    ``MAIN_WINDOW_VIEWS``-view main-path window (view 0 fixed)."""
    import torch

    from irotavg_tpu_torch.engine.batched import pack_windows

    if dev in _GRAPHS:
        return _GRAPHS[dev]

    def chain(n):
        edges = torch.as_tensor(kitti_chain(n)[1], device=dev).long()
        free = torch.arange(n, device=dev) >= 1
        return (edges, free, torch.ones(len(edges), dtype=torch.bool,
                                        device=dev), n)

    _, g, _ = large_problem(dev)
    edges, _, _, f, emask, nmask = (torch.as_tensor(a, device=dev) for a in
                                    pack_windows(bench_windows(N_WINDOWS),
                                                 64, 16))
    wfree = (torch.arange(16, device=dev) >= f[:, None].long()) & nmask
    out = _GRAPHS[dev] = {
        "5b": (g.edges, g.free_mask(), g.edge_mask, g.n),
        "5c": chain(KITTI_VIEWS),
        "windows": (edges.long(), wfree, emask, 16),
        "window": chain(MAIN_WINDOW_VIEWS)}
    return out


# the fused matvec at the solver's shapes: (name, graph, columns of x,
# columns of c, dtype): 5b's IRLS CG in f64 and the scaling probe's f32,
# 5c's IRLS CG and its L1-RA CG (a coefficient column per lane), the
# window server's batch and a main-path window's three L1-RA lanes; and
# five columns on 5c's graph, shared and per-column coefficients (two
# launches a call: four columns, then one)
MATVEC_CASES = (("5b_f64", "5b", 3, 1, "float64"),
                ("5b_f32", "5b", 3, 1, "float32"),
                ("5c_f64", "5c", 3, 1, "float64"),
                ("5c_l1_lanes_f64", "5c", 3, 3, "float64"),
                ("windows_f64", "windows", 3, 1, "float64"),
                ("window_l1_lanes_f64", "window", 3, 3, "float64"),
                ("5c_5cols_f64", "5c", 5, 1, "float64"),
                ("5c_5lanes_f64", "5c", 5, 5, "float64"))
# the dense assembly: (name, graph, L1-RA lanes or None, ridge): 5c's
# graph solved dense (IRLS, and L1-RA's three lanes), the window server's
# batch and a main-path window, each for IRLS and for L1-RA
ASSEMBLE_CASES = (("5c_f64", "5c", None, 0.0),
                  ("5c_l1_lanes_f64", "5c", 3, 0.0),
                  ("windows_f64", "windows", None, 0.0),
                  ("windows_l1_lanes_f64", "windows", 3, 0.0),
                  ("window_f64", "window", None, 1e-6),
                  ("window_l1_lanes_f64", "window", 3, 0.0))
# views of the chain whose dense rows exceed a block's shared memory
LONG_ROW_VIEWS = 30_000


def _coefficients(torch, shape, lanes, emask, gen, dtype, dev):
    """Random IRLS weights (positive) or L1-RA ``sigx`` (either sign),
    with NaN in the masked edges' slots, which no kernel may read."""
    v = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    if not lanes:
        v = v.abs() + 0.1
    return torch.where(emask, v, torch.full_like(v, float("nan")))


def _laplacian_csr(torch, plan, c):
    """The Laplacian ``A' diag(c) A`` over the plan's rows as one CSR
    matrix, block-diagonal over ``c``'s coefficient columns (one block a
    column), for the library yardstick; built outside any timing."""
    counts = (plan.offsets[1:] - plan.offsets[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(plan.rows, device=counts.device), counts)
    rec = plan.records.long()
    edge, other = rec[:, 0], rec[:, 1]
    keep = other >= 0
    cf = c.reshape(-1, c.shape[-1])
    idx, val = [], []
    for q in range(cf.shape[1]):
        w = cf[torch.where(edge >= 0, edge, ~edge), q]
        base = q * plan.rows
        idx += [torch.stack([rows, rows]) + base,
                torch.stack([rows[keep], other[keep]]) + base]
        val += [w, -w[keep]]
    size = cf.shape[1] * plan.rows
    return torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(val),
                                   (size, size)).coalesce().to_sparse_csr()


def _dense_coo(torch, plan, coef, ridge):
    """The assembly's output ``(rows, n)`` as an uncoalesced COO tensor of
    the records' ``±coef`` and the diagonal terms (``ridge`` on free rows,
    1 on fixed), for the library yardstick (``to_dense`` sums the
    duplicates); built outside any timing."""
    counts = (plan.offsets[1:] - plan.offsets[:-1]).long()
    r = torch.arange(plan.rows, device=counts.device)
    rows = torch.repeat_interleave(r, counts)
    rec = plan.records.long()
    col, edge = rec[:, 0], rec[:, 1]
    v = coef.reshape(-1)[torch.where(edge >= 0, edge, ~edge)]
    v = torch.where(edge >= 0, v, -v)
    ones = torch.ones(plan.rows, dtype=coef.dtype, device=coef.device)
    dg = torch.where(plan.free, ones * ridge, ones)
    idx = torch.cat([torch.stack([rows, col]), torch.stack([r, r % plan.n])],
                    1)
    return torch.sparse_coo_tensor(idx, torch.cat([v, dg]),
                                   (plan.rows, plan.n))


def _yardstick_error(torch, lib, got, what):
    """Max |lib - got| of a library yardstick against the kernel's output;
    fails beyond 1e-9 of the output's largest magnitude (the yardstick
    adds in another order, so it need not be bit-equal)."""
    torch.cuda.synchronize()
    d = float((lib.double() - got.double()).abs().max()) if got.numel() \
        else 0.0
    scale = float(got.double().abs().max()) if got.numel() else 0.0
    tol = 1e-9 if got.dtype == torch.float64 else 1e-4
    if not d <= tol * max(scale, 1.0):
        raise SmokeError(f"library yardstick of the {what} computes another "
                         f"function: max |d| {d}")
    return d


def phase_laplacian_kernels(card):
    """``laplacian_matvec`` and ``laplacian_assemble`` on the card against
    their plain versions on the same inputs moved to the CPU and against
    the unfused composition on the card, bit for bit, at
    ``MATVEC_CASES`` and ``ASSEMBLE_CASES``; times of the kernel, the
    plain version and the composition on the card and the library
    yardstick (never called by the port, held to the kernel's output to
    1e-9): ``torch.sparse.mm`` of the CSR Laplacian for the matvec
    (block-diagonal over per-column coefficients), ``to_dense`` of the
    COO tensor of the terms and the diagonal for the assembly."""
    import torch

    from composed_laplacian import bits_equal, composed_dense, composed_matvec

    from irotavg_tpu_torch.ops import laplacian as lap
    from irotavg_tpu_torch.solver import graph

    dev = _device(torch)
    graphs = solver_graphs(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    report = {"laplacian_matvec": {}, "laplacian_assemble": {}}

    def check(name, what, got, ref, comp):
        torch.cuda.synchronize()
        for other, label in ((ref, "its plain version"),
                             (comp, "the unfused composition")):
            if not bits_equal(got.cpu(), other.cpu()):
                d = float((got.cpu().double() - other.cpu().double())
                          .abs().max())
                raise SmokeError(f"{what} {name} != {label}: max |d| {d}")

    def line(what, name, shape, k_ms, b_ms, b_by, p_ms, c_ms, lib_ms, extra):
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"[kernel] {what} {name}: {shape}: bit-identical to the plain "
              f"version and the composition; kernel {k_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), share of bound {b_ms / k_ms:.4f}; "
              f"plain {p_ms:.4f} ms; composition {c_ms:.4f} ms; library "
              f"{lib}{extra}  ({card})")
        report[what][name] = {"ms": k_ms, "plain_ms": p_ms,
                              "composed_ms": c_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "bound_share": b_ms / k_ms,
                              "library_ms": lib_ms}

    for name, gname, k, ck, dtype in MATVEC_CASES:
        dtype = getattr(torch, dtype)
        edges, free, emask, n = graphs[gname]
        batch, m = tuple(edges.shape[:-2]), edges.shape[-2]
        plan = lap.matvec_plan(edges, free, emask, n, batch)
        x = torch.randn(batch + (n, k), generator=gen, dtype=dtype,
                        device=dev)
        c = _coefficients(torch, batch + (m, ck), ck > 1, emask[..., None],
                          gen, dtype, dev)
        rplan = graph.rmatvec_plan(edges, n)
        cpu_plan = plan._replace(records=plan.records.cpu(),
                                 offsets=plan.offsets.cpu())
        got = lap.laplacian_matvec(x, c, plan)
        check(name, "laplacian_matvec", got,
              lap.laplacian_matvec_plain(x.cpu(), c.cpu(), cpu_plan),
              composed_matvec(edges, c, x, free, emask, n, rplan))
        launch, _ = lap.laplacian_matvec_launcher(x, c, plan)
        lap.reset_launch_counts()
        launch()
        launches = lap.laplacian_matvec.launches
        k_ms = _time_ms(torch, launch)
        p_ms = _time_ms(torch, lambda: lap.laplacian_matvec_plain(x, c, plan),
                        per_window=10, windows=5)
        c_ms = _time_ms(torch, lambda: composed_matvec(
            edges, c, x, free, emask, n, rplan), per_window=10, windows=5)
        # the library yardstick: cuSPARSE's SpMM of the CSR Laplacian,
        # block-diagonal over per-column coefficients (x column-major)
        L = _laplacian_csr(torch, plan, c)
        xl = x.reshape(-1, k) if ck == 1 else \
            x.reshape(-1, k).T.contiguous().reshape(-1, 1)
        lib_ms = _time_ms(torch, lambda: torch.sparse.mm(L, xl))
        lib_d = _yardstick_error(torch, torch.sparse.mm(L, xl) if ck == 1
                                 else torch.sparse.mm(L, xl).view(k, -1).T,
                                 got.reshape(-1, k), f"matvec {name}")
        b_ms, b_by = lap.matvec_bound_ms(plan, k, ck, dtype)
        line("laplacian_matvec", name,
             f"x {tuple(x.shape)}, c {tuple(c.shape)}, "
             f"{plan.records.shape[0]} terms, {launches} launch(es) a call",
             k_ms, b_ms, b_by, p_ms, c_ms, lib_ms,
             f" (max |d| {lib_d:.2e} from the kernel)")
    for name, gname, lanes, ridge in ASSEMBLE_CASES:
        edges, free, emask, n = graphs[gname]
        batch, m = tuple(edges.shape[:-2]), edges.shape[-2]
        if lanes:
            edges, free, emask = (edges[..., None, :, :], free[..., None, :],
                                  emask[..., None, :])
            batch += (lanes,)
        plan = lap.dense_plan(edges, free, emask, n, batch)
        coef = _coefficients(torch, batch + (m,), lanes, emask, gen,
                             torch.float64, dev)
        cpu_plan = plan._replace(records=plan.records.cpu(),
                                 offsets=plan.offsets.cpu(),
                                 free=plan.free.cpu())
        check(name, "laplacian_assemble",
              lap.laplacian_assemble(coef, plan, ridge),
              lap.laplacian_assemble_plain(coef.cpu(), cpu_plan, ridge),
              composed_dense(edges, coef, free, emask, n, ridge))
        launch, out = lap.laplacian_assemble_launcher(coef, plan, ridge)
        k_ms = _time_ms(torch, launch)
        p_ms = _time_ms(torch, lambda: lap.laplacian_assemble_plain(
            coef, plan, ridge), per_window=10, windows=5)
        c_ms = _time_ms(torch, lambda: composed_dense(
            edges, coef, free, emask, n, ridge), per_window=10, windows=5)
        # the library yardstick: the COO tensor of the records' terms and
        # the diagonal made dense
        coo = _dense_coo(torch, plan, coef, ridge)
        lib_ms = _time_ms(torch, coo.to_dense, per_window=10, windows=5)
        lib_d = _yardstick_error(torch, coo.to_dense(), out.view(plan.rows,
                                                                 n),
                                 f"assembly {name}")
        b_ms, b_by = lap.assemble_bound_ms(plan, coef.dtype)
        del out, coo
        line("laplacian_assemble", name,
             f"coef {tuple(coef.shape)} -> {batch + (n, n)}, "
             f"{plan.records.shape[0]} terms", k_ms, b_ms, b_by, p_ms, c_ms,
             lib_ms, f" (max |d| {lib_d:.2e} from the kernel)")
    # a dense row longer than shared memory holds (n > 29,056 in f64)
    # goes in chunks of columns: a 30,000-view chain, whose entries have at
    # most two terms each, so the plain version on the card (an atomic
    # index_add_) gives the same bits in any order
    n = LONG_ROW_VIEWS
    nodes = torch.arange(n, device=dev)
    edges = torch.stack([nodes[:-1], nodes[1:]], 1)
    emask = torch.ones(n - 1, dtype=torch.bool, device=dev)
    plan = lap.dense_plan(edges, nodes >= 1, emask, n)
    coef = _coefficients(torch, (n - 1,), None, emask, gen, torch.float64,
                         dev)
    launch, out = lap.laplacian_assemble_launcher(coef, plan, 1e-6)
    launch()
    same = bits_equal(out, lap.laplacian_assemble_plain(coef, plan, 1e-6))
    k_ms = _time_ms(torch, launch, per_window=5, windows=3)
    b_ms, b_by = lap.assemble_bound_ms(plan, coef.dtype)
    del out
    print(f"[kernel] laplacian_assemble {n}-view chain (rows in chunks of "
          f"columns): bit-identical to the plain version on the card: "
          f"{same}; kernel {k_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})  "
          f"({card})")
    if not same:
        raise SmokeError(f"laplacian_assemble differs from its plain version "
                         f"on the {n}-view chain")
    for what, cases in report.items():
        print(f"[kernel] {what} bit-identical to its plain version and the "
              f"unfused composition in {len(cases)} cases  ({card})")
    mv, asm = report["laplacian_matvec"], report["laplacian_assemble"]
    src = "irotavg_tpu_torch/csrc/laplacian.cu"
    return [{"name": "laplacian_matvec", "route": "cuda", "source": src,
             "replaces": "irotavg_tpu/solver/graph.py:119-134 (XLA gathers "
                         "and .at[].add of incidence_matvec / "
                         "incidence_rmatvec; no Pallas kernel)",
             "max_abs_err": 0.0, **mv["5b_f64"], "cases": mv},
            {"name": "laplacian_assemble", "route": "cuda", "source": src,
             "replaces": "irotavg_tpu/solver/graph.py:167-186 (XLA .at[].add "
                         "of laplacian_dense; no Pallas kernel)",
             "max_abs_err": 0.0, **asm["window_l1_lanes_f64"], "cases": asm}]


# -- phase 2, RANSAC's cases ------------------------------------------------

# (name, lanes, N, valid share or "none" / "one" / "all", draw shapes): the
# engine's RANSAC (N = 2000 features, 512 8-point and 192 4-point draws),
# find_relative_pose's 1024, the offline chunk's 8 lanes (a valid row and
# a key per lane), the edge cases, 70 lanes (two launches) and a row too
# long for 48 KB of shared memory
DRAW_MAIN = ((512, 8), (192, 4))
DRAW_CASES = (("engine_512x8_192x4", 1, 2000, 0.6, DRAW_MAIN),
              ("twoview_1024x8_192x4", 1, 2000, 0.6, ((1024, 8), (192, 4))),
              ("offline_8_lanes", 8, 2000, 0.6, DRAW_MAIN),
              ("none_valid", 1, 2000, "none", DRAW_MAIN),
              ("one_valid", 1, 2000, "one", DRAW_MAIN),
              ("all_valid", 1, 2000, "all", DRAW_MAIN),
              ("lanes_70", 70, 1999, 0.3, DRAW_MAIN),
              ("n_20000", 1, 20000, 0.6, DRAW_MAIN))
DRAW_TIMED = ("engine_512x8_192x4", "twoview_1024x8_192x4", "offline_8_lanes")
# the hypotheses kernel's case at given positions: an offline chunk of 8
# lanes whose samples all drew their first correspondence twice
DUPLICATE_CASE = ("duplicate_draws", 8, 2000, 0.6, DRAW_MAIN)
# the RANSAC parity check: calls at phase 3's shapes (2000 correspondence
# slots, 120 to 500 of them valid, so that many minimal samples draw a
# correspondence twice; the engine's 512 samples) on the card and on the
# CPU with the same keys.  The draws are equal, so what could differ comes
# from the hypothesis solves (cuSOLVER against LAPACK).  Bounds from the
# runs: with f64 solves every mask and cheirality count equal and the f32
# E equal to the bit (f32 solves gave 44 and 40 of 48 calls at 500 valid,
# |E| differing by up to 0.888); the E bound is one f32 rounding step
RANSAC_PARITY_CALLS = 48
RANSAC_PARITY_MIN_SHARE = 1.0
RANSAC_PARITY_MAX_E_DIFF = 1e-7


# L1-RA on the card (ops/l1decode.py) against the plain composition on
# the CPU: (name, problem, dtype, backend, max_iters, largest |Q| gap); the
# two differ only in the order of their sums, so the iterations are equal
# and the rotations within rounding
L1RA_CASES = (("golden_f64", "golden", "float64", "dense", 5, 1e-9),
              ("golden_f32", "golden", "float32", "dense", 5, 1e-4),
              ("synth0_f64", "synth0", "float64", "dense", 100, 1e-9),
              ("synth1_f64", "synth1", "float64", "dense", 100, 1e-9),
              ("synth2_f64", "synth2", "float64", "dense", 100, 1e-9),
              ("synth0_cg_f64", "synth0", "float64", "cg", 100, 1e-9),
              ("batch3_padded_f64", "batch3", "float64", "dense", 100, 1e-9))


def l1ra_problems():
    """The problems of ``L1RA_CASES`` on the CPU: the upstream golden
    problem from its spanning tree, three chain-and-chord graphs with 20%
    outlier edges, and those three padded into one batch of windows
    (fixed views 1, 3, 2)."""
    import numpy as np
    import torch

    from synth import make_problem

    from irotavg_tpu_torch.solver.graph import RotationGraph
    from irotavg_tpu_torch.solver.init import init_mst
    from irotavg_tpu_torch.solver.io import read_problem

    p = read_problem(os.path.join(HERE, "tests", "data",
                                  "ravg_input.txt.gz"))
    Q0 = init_mst(p["Q"], p["QQ"], p["edges"], max(p["n_abs_given"],
                                                   p["f"]))
    out = {"golden": RotationGraph.create(p["edges"], p["QQ"], Q0,
                                          f=max(p["f"], 1),
                                          dtype=torch.float64)}
    syn = []
    for s in range(3):
        pr = make_problem(n=60 + 10 * s, extra_edges=90, noise_deg=2.0,
                          outlier_frac=0.2, seed=s, window_chords=3)
        Qi = init_mst(np.tile([0, 0, 0, 1.0], (len(pr["Q_gt"]), 1)),
                      pr["QQ"], pr["edges"], 1)
        syn.append(RotationGraph.create(pr["edges"], pr["QQ"], Qi, f=1,
                                        dtype=torch.float64))
        out[f"synth{s}"] = syn[-1]
    pads = [g.pad_to(max(g.m for g in syn), max(g.n for g in syn))
            for g in syn]
    out["batch3"] = RotationGraph(
        edges=torch.stack([g.edges for g in pads]),
        QQ=torch.stack([g.QQ for g in pads]),
        Q=torch.stack([g.Q for g in pads]), f=torch.tensor([1, 3, 2]),
        edge_mask=torch.stack([g.edge_mask for g in pads]),
        node_mask=torch.stack([g.node_mask for g in pads]))
    return out


def _graph_on(g, dev, dtype):
    import dataclasses

    return dataclasses.replace(
        g, edges=g.edges.to(dev), QQ=g.QQ.to(dev, dtype),
        Q=g.Q.to(dev, dtype),
        f=g.f if isinstance(g.f, int) else g.f.to(dev),
        edge_mask=g.edge_mask.to(dev), node_mask=g.node_mask.to(dev))


def phase_l1ra_kernels(card):
    """L1-RA's kernels (``csrc/l1_decode.cu``) at ``L1RA_CASES``: each
    solve on the card against the plain composition on the CPU (equal
    iteration counts, rotations within the case's gap), and its time on
    the card beside the composition's on the card (median of 3)."""
    import importlib

    import numpy as np
    import torch

    from irotavg_tpu_torch.ops.l1decode import L1Kernels
    from irotavg_tpu_torch.solver.irls import _plans

    l1 = importlib.import_module("irotavg_tpu_torch.solver.l1ra")
    dev = torch.device("cuda")
    problems = l1ra_problems()
    rows = []

    def timed(fn):
        ts, out = [], None
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return out, statistics.median(ts)

    for name, prob, dt, backend, iters, gap in L1RA_CASES:
        dtype = getattr(torch, dt)
        cfg = l1.L1RAConfig(max_iters=iters, backend=backend)
        gc = _graph_on(problems[prob], "cpu", dtype)
        gd = _graph_on(problems[prob], dev, dtype)
        Qc, itc, _ = l1.l1ra(gc, cfg)
        L1Kernels.launches = 0
        (Qd, itd, _), t_k = timed(lambda: l1.l1ra(gd, cfg))
        launches = L1Kernels.launches
        plan = _plans(gd, backend, lanes=3)
        _, t_c = timed(lambda: l1._l1ra_plain(gd, cfg, plan))
        itc = np.asarray(itc).tolist()
        itd = np.asarray(itd.cpu() if torch.is_tensor(itd) else itd).tolist()
        dq = (Qd.cpu() - Qc).abs().max().item()
        print(f"[l1ra] {name}: n {gc.n} m {gc.m} iterations CPU {itc} card "
              f"{itd}, max |dQ| {dq:.3e} (gap {gap:g}); kernels {t_k:.2f} "
              f"ms, composition on the card {t_c:.2f} ms, {launches} "
              f"launches over 3 solves  ({card})")
        if itc != itd or not dq <= gap or launches == 0:
            raise SmokeError(f"L1-RA kernels at {name}: iterations {itd} vs "
                             f"{itc}, |dQ| {dq:.3e} > {gap:g}, or no launch")
        rows.append({"case": name, "n": gc.n, "m": gc.m, "iters": itd,
                     "max_dq": dq, "kernels_ms": t_k, "composition_ms": t_c})
    return {"name": "l1_decode", "cases": rows}


def draw_cases(dev, seed=0):
    """``(name, valid (L, N), keys, shapes)`` on ``dev`` for DRAW_CASES."""
    import torch

    from irotavg_tpu_torch import prng

    rng = np.random.default_rng(seed)
    out = []
    for name, lanes, n, share, shapes in DRAW_CASES:
        if share == "none":
            v = np.zeros((lanes, n), bool)
        elif share == "all":
            v = np.ones((lanes, n), bool)
        elif share == "one":
            v = np.zeros((lanes, n), bool)
            v[:, rng.integers(n)] = True
        else:
            v = rng.random((lanes, n)) < share
        keys = prng.split(prng.key(int(rng.integers(2**32))), lanes)
        out.append((name, torch.from_numpy(v).to(dev), keys, shapes))
    return out


def _two_views(rng, m):
    """``m`` normalised correspondences of a 3-D scene seen at KITTI's
    focal length after a 1 deg, 0.3 m step (0.5 px noise, 20%
    outliers): ``q1``, ``q2`` (m, 2) f64."""
    f = KITTI_K[0]
    X = rng.uniform([-8, -3, 5], [8, 3, 40], (m, 3))
    ax = rng.normal(size=3)
    ang = np.radians(1.0)
    k = ax / np.linalg.norm(ax)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    X2 = X @ R.T + np.array([0.02, 0.01, -0.3])
    q1 = X[:, :2] / X[:, 2:] + rng.normal(0, 0.5 / f, (m, 2))
    q2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 0.5 / f, (m, 2))
    out = rng.random(m) < 0.2
    q2[out] = rng.uniform([-0.8, -0.25], [0.8, 0.25], (int(out.sum()), 2))
    return q1, q2


def ransac_parity_inputs(seed):
    """Phase 3's RANSAC shape from numpy: 2000 slots, 120, 250 or 500
    valid correspondences of :func:`_two_views`, f32."""
    rng = np.random.default_rng(seed)
    n, m = 2000, (120, 250, 500)[seed % 3]
    q1, q2 = _two_views(rng, m)
    slots = np.sort(rng.choice(n, m, replace=False))
    p1 = rng.uniform(-0.8, 0.8, (n, 2))
    p2 = rng.uniform(-0.8, 0.8, (n, 2))
    p1[slots], p2[slots] = q1, q2
    valid = np.zeros(n, bool)
    valid[slots] = True
    return p1.astype(np.float32), p2.astype(np.float32), valid


def _case_points(rng, lanes, n):
    """:func:`_two_views` of ``n`` correspondences per lane, rounded to
    f32 and held in f64 (the precision RANSAC solves in): ``p1``, ``p2``
    (L, n, 2)."""
    views = [_two_views(rng, n) for _ in range(lanes)]
    return tuple(np.stack([v[i] for v in views]).astype(np.float32)
                 .astype(np.float64) for i in (0, 1))


def ransac_kernel_cases(dev, seed=0):
    """``(name, p1, p2, valid, keys, positions, shapes)`` on ``dev``: the
    correspondences of :func:`_case_points` at every ``DRAW_CASES`` shape
    and valid share (``positions`` None: the kernel draws from
    ``keys``), and :data:`DUPLICATE_CASE`, whose samples are given with
    their second correspondence forced equal to their first (every
    design rank-deficient)."""
    import torch

    from irotavg_tpu_torch.ops import draw

    rng = np.random.default_rng(seed)
    out = []
    for name, valid, keys, shapes in draw_cases(torch.device("cpu"), seed):
        p1, p2 = _case_points(rng, *valid.shape)
        out.append((name, torch.from_numpy(p1).to(dev),
                    torch.from_numpy(p2).to(dev), valid.to(dev), keys, None,
                    shapes))
    name, lanes, n, share, shapes = DUPLICATE_CASE
    valid = torch.from_numpy(rng.random((lanes, n)) < share)
    keys = [(0, int(k)) for k in rng.integers(2**32, size=lanes)]
    idx, idx_h = draw.draw_positions_plain(valid, keys, shapes)
    idx[..., 1], idx_h[..., 1] = idx[..., 0], idx_h[..., 0]
    p1, p2 = _case_points(rng, lanes, n)
    out.append((name, torch.from_numpy(p1).to(dev),
                torch.from_numpy(p2).to(dev), valid.to(dev), None,
                (idx.to(dev), idx_h.to(dev)), shapes))
    return out


def _same_bits(a, b):
    """Bit for bit: f64 tensors as int64 words (NaN and -0.0 included)."""
    import torch

    if a.dtype == torch.float64:
        a, b = a.contiguous().view(torch.int64), b.contiguous().view(
            torch.int64)
    return a.shape == b.shape and torch.equal(a, b)


def phase_ransac_kernels(card):
    """``ransac_hyp`` and ``ransac_vote`` on the card against their plain
    versions on the same inputs moved to the CPU, bit for bit, at
    :func:`ransac_kernel_cases` (both vote modes, on the kernel's own
    hypotheses, on ``candidate_pool``'s models and on one model); times
    at ``DRAW_TIMED`` (the Sampson vote over the pool) beside the bound,
    the plain version on the card and a yardstick: ``torch.linalg.svd``
    of the same designs for the hypotheses, today's eager composition
    (``sampson_distance``, compare, sum) for the vote."""
    import torch

    from irotavg_tpu_torch.geometry.essential import (candidate_pool,
                                                      sampson_distance)
    from irotavg_tpu_torch.ops import ransac

    dev = _device(torch)
    th = float(np.float32(1.0 / KITTI_K[0]))
    th2 = torch.tensor(th, dtype=torch.float64, device=dev) ** 2
    th2h = 4.0 * th2
    timed = {"ransac_hypotheses": {}, "ransac_vote": {}}
    for name, p1, p2, valid, keys, pos, shapes in ransac_kernel_cases(dev):
        (S, _), (Hs, _) = shapes
        got = ransac.ransac_hypotheses(p1, p2, valid, keys, S, Hs, pos)
        host = [t.cpu() for t in (p1, p2, valid)]
        hpos = None if pos is None else tuple(t.cpu() for t in pos)
        stats = {}
        ref = ransac.ransac_hypotheses_plain(*host, keys, S, Hs, hpos,
                                             stats=stats)
        torch.cuda.synchronize()
        for g, r, what in zip(got, ref, ("E", "H")):
            if not _same_bits(g.cpu(), r):
                bad = int((g.cpu() != r).any(-1).any(-1).sum())
                raise SmokeError(f"ransac_hyp != plain on {name}: {bad} of "
                                 f"{r.shape[0] * r.shape[1]} {what} differ")
        # what the main path votes on: the transfer vote of the H samples,
        # the Sampson vote of candidate_pool's models (S + 8, and S + 9
        # with E_seed) and votes of one model in both modes, as for the
        # rescued H and the refit E (the last two are partial blocks of
        # the kernel's 16 models); the raw S samples besides
        pool, _ = candidate_pool(p1, p2, valid, th2, keys=keys,
                                 positions=pos, n_samples=S, h_samples=Hs)
        ballots = [(got[1], "transfer", th2h), (got[1][:, -1:], "transfer",
                                                th2h),
                   (got[0], "sampson", th2), (pool, "sampson", th2),
                   (pool[:, -1:], "sampson", th2)]
        if name == "engine_512x8_192x4":
            seeded, _ = candidate_pool(p1, p2, valid, th2, keys=keys,
                                       n_samples=S, h_samples=Hs,
                                       E_seed=got[0][:, 0])
            ballots.append((seeded, "sampson", th2))
        votes = {}
        for models, mode, t2 in ballots:
            vm, vc = ransac.ransac_vote(models, p1, p2, valid, t2, mode)
            rm, rc = ransac.ransac_vote_plain(models.cpu(), *host, t2.cpu(),
                                              mode)
            torch.cuda.synchronize()
            C = models.shape[1]
            if not (torch.equal(vm.cpu(), rm) and torch.equal(vc.cpu(), rc)):
                raise SmokeError(
                    f"ransac_vote ({mode}, C = {C}) != plain on {name}: "
                    f"{int((vm.cpu() != rm).sum())} mask entries, "
                    f"{int((vc.cpu() != rc).sum())} counts differ")
            votes[f"{mode} C={C}"] = int(rc.sum())
        L, n = valid.shape
        nv = valid.sum(dim=1).tolist()
        line = (f"[kernel] ransac_hyp / ransac_vote {name}: {L} lane(s) x "
                f"{n} slots (valid {min(nv)}-{max(nv)}), {S} + {Hs} "
                f"samples{' at given positions' if pos is not None else ''}"
                f", {stats['rank_deficient']} rank-deficient designs, "
                f"inliers {votes}: equal to the plain versions bit for bit")
        if name in DRAW_TIMED:
            launch, _ = ransac.hypotheses_launcher(p1, p2, valid, keys, S, Hs)
            k_ms = _time_ms(torch, launch)
            p_ms = _time_ms(torch, lambda: ransac.ransac_hypotheses_plain(
                p1, p2, valid, keys, S, Hs), per_window=2, windows=3)
            designs = _designs_on(p1, p2, valid, keys, shapes)
            s_ms = _time_ms(torch, lambda: torch.linalg.svd(designs),
                            per_window=5, windows=5)
            b_ms, b_by = ransac.bound_ms(ransac.hypotheses_work(
                L, n, S, Hs, stats))
            timed["ransac_hypotheses"][name] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "bound_share": b_ms / k_ms,
                "library_ms": s_ms, "qr_ops": stats["qr_ops"],
                "jacobi3_pairs": stats["pairs3"]}
            line += (f"; ransac_hyp {k_ms:.4f} ms, bound {b_ms:.6f} ms "
                     f"({b_by}), share {b_ms / k_ms:.4f}, plain {p_ms:.3f} "
                     f"ms, svd of the designs {s_ms:.4f} ms")
            for mode, models, t2 in (("sampson", pool, th2),
                                     ("transfer", got[1], th2h)):
                launch, _ = ransac.vote_launcher(models, p1, p2, valid, t2,
                                                 mode)
                k_ms = _time_ms(torch, launch)
                p_ms = _time_ms(torch, lambda: ransac.ransac_vote_plain(
                    models, p1, p2, valid, t2, mode), per_window=5,
                    windows=5)
                b_ms, b_by = ransac.bound_ms(ransac.vote_work(
                    L, n, models.shape[1], mode))
                entry = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bound_share": b_ms / k_ms,
                         "library_ms": None, "models": models.shape[1]}
                if mode == "sampson":
                    entry["composition_ms"] = _time_ms(
                        torch, lambda: [
                            ((sampson_distance(models[k], p1[k], p2[k]) < t2)
                             & valid[k]).sum(dim=-1) for k in range(L)],
                        per_window=5, windows=5)
                timed["ransac_vote"][f"{name}_{mode}"] = entry
                line += (f"; vote {mode} of {models.shape[1]} models "
                         f"{k_ms:.4f} ms, bound {b_ms:.6f} ms "
                         f"({b_by}), share {b_ms / k_ms:.4f}, plain "
                         f"{p_ms:.3f} ms"
                         + (f", composition {entry['composition_ms']:.4f} ms"
                            if mode == "sampson" else ""))
        print(f"{line}  ({card})")
    n_cases = len(DRAW_CASES) + 1
    print(f"[kernel] ransac_hyp and ransac_vote (both modes) bit-identical to "
          f"their plain versions in {n_cases} cases  ({card})")
    parity = ransac_parity(card)
    main = "engine_512x8_192x4"
    return [
        {"name": "ransac_hypotheses", "route": "cuda",
         "source": "irotavg_tpu_torch/csrc/ransac_hyp.cu",
         "replaces": "irotavg_tpu/geometry/essential.py:309 "
                     "_eight_point_samples, :543 _project_essential, :353 "
                     "_homography_samples and the draws of :620-641 "
                     "(no Pallas kernel)",
         "max_abs_err": 0, **timed["ransac_hypotheses"][main],
         "library_note": "torch.linalg.svd of the same (S + H, 8, 9) "
                         "designs: the solve only",
         "cases": timed["ransac_hypotheses"], "ransac_parity": parity},
        {"name": "ransac_vote", "route": "cuda",
         "source": "irotavg_tpu_torch/csrc/ransac_vote.cu",
         "replaces": "irotavg_tpu/geometry/essential.py:160 "
                     "sampson_distance with its compare and count "
                     "(:660-662, :672-673), :456 _transfer_inliers / :468 "
                     "_transfer_support (no Pallas kernel)",
         "max_abs_err": 0, **timed["ransac_vote"][f"{main}_sampson"],
         "library_note": "none: no one PyTorch call computes the masks and "
                         "counts; composition_ms is today's eager "
                         "composition",
         "cases": timed["ransac_vote"]}]


def _designs_on(p1, p2, valid, keys, shapes):
    """The (L (S + H), 8, 9) designs that ``ransac_hyp`` solves, on the
    points' device (the yardstick's input)."""
    import torch

    from irotavg_tpu_torch.ops import draw, ransac

    idx, idx_h = draw.draw_positions_plain(valid, keys, shapes)
    lane = torch.arange(valid.shape[0], device=p1.device)[:, None, None]
    out = []
    for pos, k, essential in ((idx, 8, True), (idx_h, 4, False)):
        n1 = ransac._hartley(p1[lane, pos].reshape(-1, k, 2))[0]
        n2 = ransac._hartley(p2[lane, pos].reshape(-1, k, 2))[0]
        out.append(ransac._designs(n1, n2, essential))
    return torch.cat(out)


# -- phase 2, ransac_tail: RANSAC's tail for every lane -----------------------

# the tail kernels, in the order a RANSAC call launches them
TAIL_KERNELS = ("homography_refit", "homography_pool", "cheirality_rerank",
                "essential_refit", "ransac_finish")
# a tail kernel's f64 outputs may differ from its plain version's by this
# much at most (its decisions not at all); the kernels are written to
# equal them bit for bit, and the line says how many did
TAIL_MAX_DIFF = 1e-12
# lanes of the RANSAC batches checked for host reads and solver kernels
RANSAC_CALL_LANES = (1, 3, 8)
# kernel names of a linear-algebra library's routines (cuSOLVER, MAGMA)
SOLVER_MARKS = ("cusolver", "syev", "gesvd", "jacobi", "potrf", "getrf",
                "geqrf", "trsm", "trsv", "magma")
# the first RANSAC calls of each CLI run traced for host reads and solver
# kernels (every call runs under the sync debug mode "error")
RANSAC_PROFILED_CALLS = 4


def _cpu(a):
    """``a`` (a tensor, a tuple of them, or anything else) on the CPU."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.cpu()
    if isinstance(a, tuple):
        return tuple(_cpu(x) for x in a)
    return a


def _held(name, got, ref, case):
    """Max |difference| of the f64 outputs, after checking every other
    output equal; raises beyond :data:`TAIL_MAX_DIFF`.  Returns (max
    difference, bit-identical?)."""
    import torch

    worst, same = 0.0, True
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.cpu()
        if r.dtype == torch.float64:
            same = same and _same_bits(g, r)
            d = float((g - r).abs().max()) if r.numel() else 0.0
            if not d <= TAIL_MAX_DIFF:
                raise SmokeError(f"{name} output {i} departs from the plain "
                                 f"version on {case} by {d:.3e}")
            worst = max(worst, d)
        elif not torch.equal(g.to(r.dtype), r):
            raise SmokeError(f"{name} output {i} ({r.dtype}) != plain on "
                             f"{case}: {int((g.to(r.dtype) != r).sum())} "
                             f"of {r.numel()} entries differ")
    return worst, same


def ransac_call_check(fn, *args):
    """``fn(*args)`` (one RANSAC batch) under the sync debug mode "error"
    (a synchronising read raises) inside a CUDA profiler session: (its
    result, device-to-host copies, kernels of a solver library)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from irotavg_tpu_torch.utils import timing

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    timing.clear_spans()
    names = [e.name for e in prof.events()]
    dtoh = sum("DtoH" in n for n in names)
    solver = sum(any(m in n.lower() for m in SOLVER_MARKS) for n in names)
    return out, dtoh, solver


def phase_ransac_tail(card):
    """The five tail kernels on the card against their plain versions on
    the same inputs moved to the CPU at :func:`ransac_kernel_cases`, each
    step fed the card's outputs of the steps before (decisions equal,
    f64 outputs within :data:`TAIL_MAX_DIFF`); times at ``DRAW_TIMED``
    beside the bound and the plain version on the card; a whole RANSAC
    call against the lane-by-lane route it replaced
    (``tests/ransac_lane_oracle.py``); and RANSAC batches of
    :data:`RANSAC_CALL_LANES` lanes with no host read and no solver
    kernel."""
    import torch

    from irotavg_tpu_torch import prng
    from irotavg_tpu_torch.geometry import essential, fused
    from irotavg_tpu_torch.ops import ransac
    import ransac_lane_oracle as oracle

    dev = _device(torch)
    th = torch.tensor(float(np.float32(1.0 / KITTI_K[0])), dtype=torch.float64,
                      device=dev)
    th2, th2h = th * th, 4.0 * th * th
    worst = dict.fromkeys(TAIL_KERNELS, 0.0)
    exact = dict.fromkeys(TAIL_KERNELS, 0)
    checks = dict.fromkeys(TAIL_KERNELS, 0)
    timed = {k: {} for k in TAIL_KERNELS}
    for case, p1, p2, valid, keys, pos, shapes in ransac_kernel_cases(dev):
        (S, _), (Hs, _) = shapes
        E_cand, Hc = ransac.ransac_hypotheses(p1, p2, valid, keys, S, Hs, pos)
        hmask, sup_h = ransac.ransac_vote(Hc, p1, p2, valid, th2h, "transfer")
        first = {}                   # each kernel's first arguments

        def hold(kernel, args):
            got = getattr(ransac, kernel)(*args)
            ref = getattr(ransac, f"{kernel}_plain")(*_cpu(args))
            d, same = _held(kernel, got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,), case)
            worst[kernel] = max(worst[kernel], d)
            exact[kernel] += same
            checks[kernel] += 1
            first.setdefault(kernel, args)
            return got

        H_ref, hbest = hold("homography_refit", (Hc, hmask, sup_h, p1, p2))
        _, sup_ref = ransac.ransac_vote(H_ref, p1, p2, valid, th2h,
                                        "transfer")
        pool = hold("homography_pool", (E_cand, None, Hc, hbest, sup_h,
                                        H_ref, sup_ref))
        if case == "engine_512x8_192x4":
            hold("homography_pool", (E_cand, E_cand[:, 0], Hc, hbest, sup_h,
                                     H_ref, sup_ref))
        inl, scores = ransac.ransac_vote(pool, p1, p2, valid, th2, "sampson")
        top, che = hold("cheirality_rerank", (pool, inl, scores, p1, p2,
                                              essential.RERANK_K))
        best, che_max, E_ref = hold("essential_refit", (top, che, inl, p1,
                                                        p2))
        inl_ref, _ = ransac.ransac_vote(E_ref, p1, p2, valid, th2, "sampson")
        hold("ransac_finish", (E_ref, inl_ref, p1, p2, True,
                               (pool, inl, best, che_max)))
        hold("ransac_finish", (E_ref, inl_ref, p1, p2, False))
        L, n = valid.shape
        line = (f"[kernel] ransac_tail {case}: {L} lane(s) x {n} slots, pool "
                f"{pool.shape[1]}: every tail kernel held to its plain "
                f"version")
        if case in DRAW_TIMED:
            for kernel, args in first.items():
                fn = getattr(ransac, kernel)
                plain = getattr(ransac, f"{kernel}_plain")
                k_ms = _time_ms(torch, lambda: fn(*args))
                p_ms = _time_ms(torch, lambda: plain(*args), per_window=2,
                                windows=3)
                b_ms, b_by = ransac.bound_ms(ransac.tail_work(
                    kernel, L, n, pool.shape[1], top.shape[1]))
                timed[kernel][case] = {
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "bound_share": b_ms / k_ms,
                    "library_ms": None}
                line += (f"; {kernel} {k_ms:.4f} ms (bound {b_ms:.6f} ms, "
                         f"{b_by}; plain {p_ms:.3f} ms)")
            args = (p1.float(), p2.float(), valid, th.float())
            kw = {"keys": keys, "n_samples": S, "h_samples": Hs}
            new_ms = _time_ms(torch, lambda: essential.ransac_pose_lanes(
                *args, **kw), per_window=10, windows=5)

            def lane_loops():
                E, m = oracle.ransac_lanes(*args, **kw)
                return [oracle.recover_pose(E[k], args[0][k], args[1][k],
                                            m[k]) for k in range(L)]

            old_ms = _time_ms(torch, lane_loops, per_window=2, windows=3)
            timed["ransac_finish"][case]["whole_call_ms"] = new_ms
            timed["ransac_finish"][case]["lane_loops_call_ms"] = old_ms
            line += (f"; a whole RANSAC call {new_ms:.3f} ms against "
                     f"{old_ms:.3f} ms lane by lane")
        print(f"{line}  ({card})")
    summary = ", ".join(f"{k} {exact[k]}/{checks[k]} bit-identical (max "
                        f"{worst[k]:.1e})" for k in TAIL_KERNELS)
    print(f"[kernel] ransac_tail held to the plain versions: {summary}  "
          f"({card})")
    calls = {}
    rng = np.random.default_rng(7)
    for L in RANSAC_CALL_LANES:
        p1, p2 = (torch.from_numpy(a).to(dev).float()
                  for a in _case_points(rng, L, 2000))
        valid = torch.from_numpy(rng.random((L, 2000)) < 0.6).to(dev)
        keys = prng.split(prng.key(L), L)
        before = ransac.tail_launches()
        _, dtoh, solver = ransac_call_check(fused._ransac_lanes, p1, p2,
                                            valid, keys, th.float())
        launches = ransac.tail_launches() - before
        calls[L] = {"dtoh": dtoh, "solver_kernels": solver,
                    "tail_launches": launches}
        print(f"[ransac] a RANSAC batch of {L} lane(s): {dtoh} device-to-host "
              f"copies, {solver} solver kernels, {launches} tail launches  "
              f"({card})")
        if dtoh or solver or launches != len(TAIL_KERNELS):
            raise SmokeError(f"a RANSAC batch of {L} lanes read the card "
                             f"({dtoh}), ran a solver library ({solver}) or "
                             f"launched {launches} tail kernels")
    main = "engine_512x8_192x4"
    return [{"name": k, "route": "cuda",
             "source": "irotavg_tpu_torch/csrc/ransac_tail.cu",
             "replaces": "the port's lane-by-lane loops after "
                         "irotavg_tpu/geometry/essential.py:409 "
                         "_homography_ls, :472 _decompose_homography, :543 "
                         "_project_essential, :553 _cheirality_counts, :256 "
                         "_eight_point, :713 recover_pose (no Pallas "
                         "kernel)",
             "max_abs_err": worst[k], "bit_identical": exact[k],
             "checks": checks[k], **timed[k].get(main, {}),
             "library_note": "none: the route it replaced was eager "
                             "torch.linalg (cuSOLVER) lane by lane",
             "cases": timed[k], "ransac_calls": calls}
            for k in TAIL_KERNELS]


def ransac_parity(card):
    """:data:`RANSAC_PARITY_CALLS` calls of ``ransac_essential`` (and
    ``recover_pose``) at phase 3's shape, each with its key, on the card
    and on the CPU: the share of equal inlier masks, of equal cheirality
    decisions and the largest |E| difference (up to sign)."""
    import torch

    from irotavg_tpu_torch import prng
    from irotavg_tpu_torch.geometry.essential import (
        ransac_essential, recover_pose,
    )

    dev = _device(torch)
    th = torch.tensor(np.float32(1.0 / KITTI_K[0]))
    same_mask = same_n = 0
    e_diff = 0.0
    for i in range(RANSAC_PARITY_CALLS):
        p1, p2, valid = ransac_parity_inputs(1000 + i)
        res = {}
        for where in (dev, torch.device("cpu")):
            t = [torch.from_numpy(a).to(where) for a in (p1, p2, valid)]
            E, inl, _ = ransac_essential(*t, prng.key(i), th_norm=th.to(
                where), n_samples=512)
            _, _, n_che, _ = recover_pose(E, t[0], t[1], inl)
            res[where.type] = (E.cpu().double().numpy(), inl.cpu().numpy(),
                               int(n_che))
        (Ec, mc, nc), (Eh, mh, nh) = res["cuda"], res["cpu"]
        sgn = 1.0 if np.sum(Ec * Eh) >= 0 else -1.0
        e_diff = max(e_diff, float(np.abs(sgn * Ec - Eh).max()))
        same_mask += bool(np.array_equal(mc, mh))
        same_n += nc == nh
    share = min(same_mask, same_n) / RANSAC_PARITY_CALLS
    print(f"[kernel] RANSAC parity, {RANSAC_PARITY_CALLS} calls at phase 3's "
          f"shape with the same keys on the card and the CPU: inlier masks "
          f"equal in {same_mask}, cheirality counts in {same_n} (share "
          f"{share:.4f}; bound {RANSAC_PARITY_MIN_SHARE}), largest |E| "
          f"difference {e_diff:.3e} (bound "
          f"{RANSAC_PARITY_MAX_E_DIFF})  ({card})")
    if share < RANSAC_PARITY_MIN_SHARE or e_diff > RANSAC_PARITY_MAX_E_DIFF:
        # with the same draws only the solves can differ
        raise SmokeError(f"RANSAC on the card departs from the CPU's beyond "
                         f"the eigensolvers' bounds: masks equal "
                         f"{share:.4f}, |E| difference {e_diff:.3e}")
    return {"calls": RANSAC_PARITY_CALLS, "equal_masks": same_mask,
            "equal_cheirality": same_n, "max_E_diff": e_diff}


# -- phase 3: the synthetic KITTI-sized sequence and the CLI ------------------


# fused_refine's calls on the main paths: (name, lanes, a column frame
# per lane, vocabulary node ids); the last lane of a batch is a padding
# lane, frozen from the start
REFINE_CASES = (("pose_and_loop_1_shared_epipolar", 1, False, True),
                ("window_walk_3_shared_epipolar", 3, False, True),
                ("offline_8_per_lane_epipolar_nonode", 8, True, False))
REFINE_SLOTS = 2000
REFINE_TIMED_CALLS = 5


def _random_desc(rng, n):
    return rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64).astype(
        np.int32)


def _refine_frame(rng, n, u, v, nodes, octave, angle, desc):
    """Frame arrays ``(desc, nodes, valid, angle, x, y, octave)`` of ``n``
    slots: the given features first, random ones after (a third of them
    invalid)."""
    m = len(u)
    extra = n - m
    valid = np.ones(n, bool)
    valid[m:] = rng.random(extra) > 1 / 3
    return (np.concatenate([desc, _random_desc(rng, extra)]),
            np.concatenate([nodes, rng.integers(0, 100, extra)]).astype(
                np.int32),
            valid,
            np.concatenate([angle, rng.uniform(0, 2 * np.pi, extra)]).astype(
                np.float32),
            np.concatenate([u, rng.uniform(0, KITTI_W, extra)]).astype(
                np.float32),
            np.concatenate([v, rng.uniform(0, KITTI_H, extra)]).astype(
                np.float32),
            np.concatenate([octave, rng.integers(0, 8, extra)]).astype(
                np.int32))


def _rotation(rng, deg):
    """A rotation by ``deg`` about a random axis."""
    ax = rng.normal(size=3)
    k = ax / np.linalg.norm(ax)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    a = np.radians(deg)
    return np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx


def _refine_scene(rng, n):
    """A column frame of 900 scene points seen by KITTI's camera: (the
    points, their descriptors, node ids, octaves and angles, the frame)."""
    fx, fy, cx, cy = KITTI_K
    m = 900
    X2 = rng.uniform([-12, -3, 6], [12, 3, 50], (m, 3))
    feats = (_random_desc(rng, m), rng.integers(0, 100, m),
             rng.integers(0, 4, m), rng.uniform(0, 2 * np.pi, m))
    desc, nodes, octave, angle = feats
    cols = _refine_frame(rng, n, fx * X2[:, 0] / X2[:, 2] + cx,
                         fy * X2[:, 1] / X2[:, 2] + cy, nodes, octave, angle,
                         desc)
    return X2, feats, cols


def _refine_lane(rng, n, scene):
    """One lane of refine inputs against ``scene``'s column frame: a row
    frame seeing 700 of its points after a 1-3 deg, 0.3 m step (0.5 px
    noise, 10 of 256 bits flipped, 15% of them outliers) with the rows'
    slots shuffled, and a start from 40% of the true matches under the
    true E turned by 0.1 deg.  Returns (rows, E0, R0, t0, m12_0) as
    numpy."""
    fx, fy, cx, cy = KITTI_K
    X2, (desc2, nodes2, oct2, ang2), _ = scene
    m, seen = len(X2), 700
    R = _rotation(rng, rng.uniform(1.0, 3.0))
    t = np.array([0.02, 0.01, -0.3])
    X1 = (X2 - t) @ R                       # x2 = R x1 + t
    pick = rng.choice(m, seen, replace=False)
    flips = rng.integers(0, 256, (seen, 10))
    desc1 = desc2[pick].view(np.uint32).copy()
    for j in range(10):
        w, b = flips[:, j] // 32, flips[:, j] % 32
        desc1[np.arange(seen), w] ^= (np.uint32(1) << b.astype(np.uint32))
    desc1 = desc1.view(np.int32)
    out = rng.random(seen) < 0.15
    desc1[out] = _random_desc(rng, int(out.sum()))
    u1 = fx * X1[pick, 0] / X1[pick, 2] + cx + rng.normal(0, 0.5, seen)
    v1 = fy * X1[pick, 1] / X1[pick, 2] + cy + rng.normal(0, 0.5, seen)
    rows = _refine_frame(rng, n, u1, v1, nodes2[pick], oct2[pick],
                         ang2[pick] + rng.normal(0, 0.02, seen), desc1)
    perm = rng.permutation(n)                # rows' slots shuffled
    rows = tuple(a[perm] for a in rows)
    where = np.argsort(perm)                 # old slot -> new slot
    m12_0 = np.full(n, -1, np.int64)
    keep = np.flatnonzero(~out & (rng.random(seen) < 0.4))
    m12_0[where[keep]] = pick[keep]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    R0 = _rotation(rng, 0.1) @ R
    return rows, tx @ R0, R0, t, m12_0


def refine_case(torch, B, per_lane, has_nodes, dev, seed=0,
                n=REFINE_SLOTS):
    """``fused_refine``'s arguments for ``B`` lanes (one column frame per
    lane, or lane 0's shared) of :func:`_refine_lane`, on ``dev``:
    (f1, f2, E0, R0, t0, n0, m12_0, K_inv, sigma2, cam, th_norm, keys,
    min_pairs, has_nodes)."""
    from irotavg_tpu_torch import prng

    rng = np.random.default_rng(seed)
    scenes = [_refine_scene(rng, n) for _ in range(B if per_lane else 1)]
    lanes = [_refine_lane(rng, n, scenes[b if per_lane else 0])
             for b in range(B)]

    def stack(arrays):
        return torch.from_numpy(np.stack(arrays)).to(dev)

    f1 = tuple(stack([lane[0][k] for lane in lanes]) for k in range(7))
    f2 = tuple(stack([sc[2][k] for sc in scenes]) for k in range(6))
    if not per_lane:
        f2 = tuple(a[0] for a in f2)
    if not has_nodes:
        f1 = f1[:1] + (torch.zeros_like(f1[1]),) + f1[2:]
        f2 = f2[:1] + (torch.zeros_like(f2[1]),) + f2[2:]
    E0, R0, t0 = (stack([lane[k] for lane in lanes]).float()
                  for k in (1, 2, 3))
    m12_0 = stack([lane[4] for lane in lanes])
    fx, fy, cx, cy = KITTI_K
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    f32 = torch.float32
    K_inv = torch.tensor(np.linalg.inv(K), dtype=f32, device=dev)
    sigma2 = torch.tensor((1.2 ** np.arange(8)) ** 2, dtype=f32, device=dev)
    cam = torch.tensor(KITTI_K, dtype=f32, device=dev)
    th_norm = torch.tensor(np.float32(1.0 / fx), device=dev)
    return (f1, f2, E0, R0, t0, (m12_0 >= 0).sum(dim=1), m12_0, K_inv,
            sigma2, cam, th_norm, prng.split(prng.key(seed), B), 113,
            has_nodes)


def phase_refine_graphs(card):
    """``fused_refine`` at each of :data:`REFINE_CASES`' calls on the
    card, its loop replayed from CUDA graphs (at ``fused_refine``'s
    width) against the same loop run eagerly (at its lanes): every
    output bit for bit and the iterations equal, one
    replay an iteration; then the host time of an iteration both ways,
    the median of :data:`REFINE_TIMED_CALLS` calls each, in turns."""
    import torch

    from irotavg_tpu_torch.geometry import fused

    dev = _device(torch)
    rows = []
    for name, B, per_lane, has_nodes in REFINE_CASES:
        args = refine_case(torch, B, per_lane, has_nodes, dev)
        frozen = [B > 1 and b == B - 1 for b in range(B)]

        def run(replay):
            # replayed at fused_refine's width, eager at B
            width = (max(fused.REFINE_LANES, 1 << (B - 1).bit_length())
                     if replay else B)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, replays, _ = fused._refine(*args, fused.MAX_ITERS,
                                            fused.N_SAMPLES, frozen, replay,
                                            width)
            torch.cuda.synchronize()
            return out, replays, time.perf_counter() - t0

        t0 = time.perf_counter()
        graph, replays, _ = run(True)
        first_s = time.perf_counter() - t0
        eager, eager_replays, _ = run(False)
        iters = graph[5]
        for i, (g, e) in enumerate(zip(graph[:5], eager[:5])):
            if not _same_bits(g, e):
                raise SmokeError(f"refine {name}: output {i} replayed from "
                                 f"graphs differs from the eager loop")
        if not (iters == eager[5] >= 1 and replays == iters
                and eager_replays == 0):
            raise SmokeError(f"refine {name}: iterations {iters} / "
                             f"{eager[5]}, replays {replays} / "
                             f"{eager_replays}")
        times = {True: [], False: []}
        for k in range(REFINE_TIMED_CALLS):
            for replay in ((False, True) if k % 2 else (True, False)):
                out, _, s = run(replay)
                if not all(_same_bits(a, b)
                           for a, b in zip(out, graph[:5])):
                    raise SmokeError(f"refine {name}: a repeated call "
                                     f"differs")
                times[replay].append(1e3 * s / iters)
        row = {"case": name, "lanes": B, "iters": iters,
               "matches": int((graph[4] >= 0).sum()),
               "eager_ms_per_iter": statistics.median(times[False]),
               "replayed_ms_per_iter": statistics.median(times[True]),
               "first_call_s": first_s}
        rows.append(row)
        print(f"[refine] {name}: replayed == eager bit for bit, {iters} "
              f"iterations, {replays} replays; per iteration "
              f"{row['eager_ms_per_iter']:.3f} ms eager, "
              f"{row['replayed_ms_per_iter']:.3f} ms replayed (host clock, "
              f"median of {REFINE_TIMED_CALLS}); first call with its "
              f"capture {first_s:.3f} s  ({card})")
    return rows


def _blur(img, sigma):
    """Separable Gaussian blur (numpy, edge-replicated)."""
    r = int(3 * sigma + 0.5)
    x = np.arange(-r, r + 1)
    k = np.exp(-x * x / (2 * sigma * sigma))
    k /= k.sum()
    p = np.pad(img.astype(np.float64), r, mode="edge")
    p = sum(k[i] * p[:, i:i + img.shape[1]] for i in range(2 * r + 1))
    return sum(k[i] * p[i:i + img.shape[0]] for i in range(2 * r + 1))


def _texture(rng, size=512):
    """Blurred noise with rectangles and discs (the texture recipe of
    tests/seqgen.py, drawn with numpy)."""
    tex = _blur(rng.integers(60, 200, (size, size)), 1.2)
    yy, xx = np.mgrid[:size, :size]
    for _ in range(150):
        x0, y0 = rng.integers(10, size - 30, 2)
        w, h = rng.integers(6, 40, 2)
        tex[y0:y0 + h + 1, x0:x0 + w + 1] = rng.integers(0, 255)
    for _ in range(100):
        cx, cy = rng.integers(15, size - 15, 2)
        r = rng.integers(3, 14)
        tex[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = rng.integers(0, 255)
    return np.clip(tex, 0, 255).astype(np.float32)


def _ring_world(rng):
    """Concentric rings of textured panels facing the centre: a far wall
    and two sparser foreground rings (several depth layers per view)."""
    planes = []
    for radius, n_panels, fill, height, y0s in (
            (16.0, 14, 1.04, 8.0, (0.0,)),
            (11.0, 9, 0.42, 3.4, (-1.6, 1.8)),
            (7.5, 7, 0.30, 2.2, (1.2, -1.0, 0.2))):
        span = 2 * np.pi * radius / n_panels * fill
        for p in range(n_panels):
            phi = 2 * np.pi * (p + (radius * 7 % 1.0)) / n_panels
            c = np.array([radius * np.sin(phi), y0s[p % len(y0s)],
                          radius * np.cos(phi)])
            tvec = np.array([np.cos(phi), 0.0, -np.sin(phi)]) * span / 2
            up = np.array([0.0, height / 2, 0.0])
            corners = np.stack([c - tvec - up, c + tvec - up,
                                c + tvec + up, c - tvec + up])
            planes.append((corners, _texture(rng)))
    return planes


def _homography(src, dst):
    """3x3 H with dst ~ H src from four point pairs (DLT)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    return np.linalg.svd(np.asarray(A))[2][-1].reshape(3, 3)


def _render(planes, R, t, K, w, h):
    """Textured quads drawn far to near with bilinear texture sampling."""
    canvas = np.full((h, w), 90.0, np.float32)
    cams = [(corners @ R.T + t, tex) for corners, tex in planes]
    cams = [(c, tex) for c, tex in cams if (c[:, 2] > 0.5).all()]
    cams.sort(key=lambda ct: -ct[0][:, 2].mean())
    for cam, tex in cams:
        proj = cam @ K.T
        proj = proj[:, :2] / proj[:, 2:3]
        if (np.abs(proj) > 8 * max(w, h)).any():
            continue
        th, tw = tex.shape
        src = np.array([[0, 0], [tw, 0], [tw, th], [0, th]], np.float64)
        Hinv = np.linalg.inv(_homography(src, proj))
        x0, y0 = np.floor(proj.min(0)).astype(int)
        x1, y1 = np.ceil(proj.max(0)).astype(int)
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        q = np.stack([xx, yy, np.ones_like(xx)], -1).astype(np.float64) \
            @ Hinv.T
        u = q[..., 0] / q[..., 2]
        v = q[..., 1] / q[..., 2]
        inside = (u >= 0) & (u <= tw - 1) & (v >= 0) & (v <= th - 1)
        ui = np.clip(np.floor(u).astype(int), 0, tw - 2)
        vi = np.clip(np.floor(v).astype(int), 0, th - 2)
        fu = np.clip(u - ui, 0, 1)
        fv = np.clip(v - vi, 0, 1)
        val = ((1 - fv) * ((1 - fu) * tex[vi, ui] + fu * tex[vi, ui + 1])
               + fv * ((1 - fu) * tex[vi + 1, ui] + fu * tex[vi + 1, ui + 1]))
        region = canvas[y0:y1, x0:x1]
        region[inside] = val[inside]
    return np.clip(np.rint(canvas), 0, 255).astype(np.uint8)


def render_sequence(n_frames, seed=0, laps=1.0, cam_radius=4.0, spiral=0.0,
                    first=None):
    """A one-way orbit inside the panel ring at the KITTI 00 frame size and
    intrinsics, ``laps`` laps over ``n_frames`` frames, of which the
    ``first`` (default all) are rendered.  The orbit's radius shrinks
    linearly by ``spiral`` over the run, so a later lap passes the earlier
    one's places from further in.  Returns (frames [uint8 (376, 1241)], K,
    R_gt world->cam)."""
    from scipy.spatial.transform import Rotation as Rsc

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = KITTI_K
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    planes = _ring_world(rng)
    frames, R_gt = [], []
    for k in range(n_frames if first is None else first):
        phi = 2 * np.pi * laps * k / n_frames
        radius = cam_radius - spiral * k / n_frames
        C = np.array([radius * np.sin(phi), 0.0, radius * np.cos(phi)])
        R = Rsc.from_euler("y", -phi).as_matrix()
        frames.append(_render(planes, R, -R @ C, K, KITTI_W, KITTI_H))
        R_gt.append(R)
    return frames, K, np.stack(R_gt)


KITTI_YAML = """%YAML:1.0
# KITTI odometry 00-02 (ORB-SLAM2 Examples/Monocular/KITTI00-02.yaml)
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def write_sequence(out, n_frames, **render):
    """Render and write the PGM frames, the 9-column GT and the YAML."""
    from irotavg_tpu_torch.utils.sequence import write_pgm

    frames, K, R_gt = render_sequence(n_frames, **render)
    seq = os.path.join(out, "seq")
    os.makedirs(seq, exist_ok=True)
    for i, im in enumerate(frames):
        write_pgm(os.path.join(seq, f"{i:06d}.pgm"), im)
    gt = os.path.join(out, "gt.txt")
    np.savetxt(gt, R_gt.reshape(-1, 9))
    yaml = os.path.join(out, "kitti00.yaml")
    fx, fy, cx, cy = KITTI_K
    with open(yaml, "w") as fh:
        fh.write(KITTI_YAML.format(fx=fx, fy=fy, cx=cx, cy=cy))
    return seq, gt, yaml, R_gt


def rotation_rmse_deg(poses_path, ids_path, R_gt):
    """RMSE (deg) of the saved rotations against GT after aligning both
    to the first keyframe; keyframes map to source frames through the
    1-based ids file."""
    from scipy.spatial.transform import Rotation as Rsc

    rows = np.loadtxt(poses_path, ndmin=2)
    ids = np.loadtxt(ids_path, dtype=int, ndmin=1) - 1
    if rows.shape != (len(ids), 8) or not np.all(np.isfinite(rows)):
        raise SmokeError(f"poses file has shape {rows.shape} (expected "
                         f"({len(ids)}, 8)) or non-finite values")
    if not np.allclose(np.linalg.norm(rows[:, 1:5], axis=1), 1.0, atol=1e-6):
        raise SmokeError("saved rotations are not unit quaternions")
    est = Rsc.from_quat(rows[:, [2, 3, 4, 1]])       # [qx qy qz qw]
    gt = Rsc.from_matrix(R_gt[ids])
    est = est * est[0].inv()
    gt = gt * gt[0].inv()
    err = np.degrees(np.linalg.norm((est * gt.inv()).as_rotvec(), axis=1))
    return float(np.sqrt(np.mean(err ** 2))), len(ids)


def _run_logged(main_fn, argv, out, name):
    """``main_fn(argv)`` in-process, stdout to ``out/name.log``, with the
    matcher's and RANSAC's kernel launch counters set to 0 just before and
    read just after, and the solver kernels' counted under ``name``.
    Returns (log, wall seconds, launches, launches by gate); raises when
    it returns non-zero or never launched one of RANSAC's kernels."""
    import contextlib

    from irotavg_tpu_torch.geometry import fused
    from irotavg_tpu_torch.ops import match, ransac

    run = fused._ransac_lanes
    seen = {"calls": 0, "dtoh": 0, "solver_kernels": 0}

    def checked(*args):
        """Every RANSAC batch under the sync debug mode "error", the
        first :data:`RANSAC_PROFILED_CALLS` traced as well (unless the run
        holds a profiler session of its own, ``--trace_dir``: sessions do
        not nest)."""
        import torch

        seen["calls"] += 1
        if (seen["calls"] <= RANSAC_PROFILED_CALLS
                and not torch.autograd._profiler_enabled()):
            out, dtoh, solver = ransac_call_check(run, *args)
            seen["dtoh"] += dtoh
            seen["solver_kernels"] += solver
            return out
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    log_path = os.path.join(out, f"{name}.log")
    with open(log_path, "w", buffering=1) as fh:           # line-buffered
        match.reset_launch_counts()
        ransac.reset_launch_counts()
        t0 = time.perf_counter()
        fused._ransac_lanes = checked
        try:
            with counting_solver(name), contextlib.redirect_stdout(fh):
                rc = main_fn(argv)
        finally:
            fused._ransac_lanes = run
        wall = time.perf_counter() - t0
        launches = match.best2.launches
        by_gate = dict(match.best2.launches_by_gate)
        RANSAC_LAUNCHES[name] = {
            "ransac_hypotheses": ransac.ransac_hypotheses.launches,
            "ransac_vote": ransac.ransac_vote.launches,
            **{k: getattr(ransac, k).launches for k in TAIL_KERNELS}}
        RANSAC_CALLS[name] = dict(seen)
    with open(log_path) as fh:
        log = fh.read()
    if rc != 0:
        raise SmokeError(f"{name} returned {rc}; log tail:\n" + log[-2000:])
    counts = RANSAC_LAUNCHES[name]
    print(f"[ransac] {name}: launches {json.dumps(counts)}; calls "
          f"{json.dumps(seen)}")
    if min(counts[k] for k in ("ransac_hypotheses", "ransac_vote")
           + TAIL_KERNELS) <= 0:
        raise SmokeError(f"{name} never launched one of RANSAC's kernels: "
                         f"{counts}")
    if seen["dtoh"] or seen["solver_kernels"]:
        raise SmokeError(f"{name}: a RANSAC call read the card or ran a "
                         f"solver library: {seen}")
    return log, wall, launches, by_gate


def run_cli(argv, out, name):
    """The port's ``irotavg`` CLI through :func:`_run_logged`.  Returns
    (log, wall seconds, launches, launches by gate, the run's view
    graph)."""
    from irotavg_tpu_torch.app import irotavg
    from irotavg_tpu_torch.engine.viewgraph import ViewGraph

    graphs = []
    process_frame = ViewGraph.process_frame

    def recording(self, *a, **kw):
        graphs[:] = [self]
        return process_frame(self, *a, **kw)

    ViewGraph.process_frame = recording
    try:
        run = _run_logged(irotavg.main, argv, out, name)
    finally:
        ViewGraph.process_frame = process_frame
    return run + (graphs[0] if graphs else None,)


def _stage_lines(tag, log, card):
    for line in log.splitlines():
        if " frames (mean " in line:
            print(f"[{tag}] {line}  ({card})")


def _stage_totals(log):
    """stage name -> total seconds from the CLI's summary lines."""
    out = {}
    for line in log.splitlines():
        if " frames (mean " in line:
            name, rest = line.split(": total ", 1)
            out[name] = float(rest.split("s over")[0])
    return out


def edge_digest(edges):
    """16 hex digits of the SHA-256 of the ``(i, j)`` edges, in order."""
    import hashlib

    text = json.dumps([[int(i), int(j)] for i, j in edges])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def hold_to_cpu(tag, card, got, want):
    """The card's values ``got`` against the port's on the CPU ``want``:
    every key equal, the RMSE within CPU_RMSE_TOL_DEG."""
    bad = []
    for key, w in want.items():
        g = got[key]
        ok = (abs(g - w) <= CPU_RMSE_TOL_DEG if key == "rmse" else g == w)
        if not ok:
            bad.append(f"{key}: card {g!r}, CPU {w!r}")
    print(f"[{tag}] held to the port's CPU values (keys {sorted(want)}; "
          f"RMSE card {got['rmse']!r}, CPU {want['rmse']!r}, tolerance "
          f"{CPU_RMSE_TOL_DEG}): {'equal' if not bad else 'DIFFER'}  "
          f"({card})")
    if bad:
        raise SmokeError(f"{tag} differs from the port's CPU run: "
                         + "; ".join(bad))


def phase_main_path(card, out):
    t0 = time.perf_counter()
    seq, gt, yaml, R_gt = write_sequence(out, MAIN_LAP_FRAMES,
                                         first=MAIN_FRAMES)
    print(f"[main] rendered {MAIN_FRAMES} of {MAIN_LAP_FRAMES} frames "
          f"{KITTI_W}x{KITTI_H} in {time.perf_counter() - t0:.1f} s "
          f"(host numpy)")
    res = os.path.join(out, "out")
    plans = {}
    with counting_plans(plans):
        log, wall, launches, by_gate, vg = run_cli(
            ["none", yaml, seq, "--image_ext", ".pgm", "--gt", gt,
             "--out_dir", res, "--max_frames", str(MAIN_FRAMES),
             "--device", "cuda"],
            out, "irotavg")
    if launches <= 0:
        raise SmokeError("the main path never launched match_best2")
    print(f"[main] window solves: {plans['calls']} irls / l1ra calls, "
          f"{plans['iterations']} iterations; plans built: segment "
          f"{plans['segment_plan']}, dense {plans['dense_plan']}, matvec "
          f"{plans['matvec_plan']}; solver launches "
          f"{SOLVER_LAUNCHES['irotavg']}  ({card})")
    if not (plans["segment_plan"] == plans["dense_plan"] == plans["calls"]
            and plans["matvec_plan"] == 0):
        raise SmokeError(f"phase 3 built plans inside solver iterations: "
                         f"{plans}")
    rmse, n_key = rotation_rmse_deg(os.path.join(res, "rotavg_poses.txt"),
                                    os.path.join(res, "rotavg_poses_ids.txt"),
                                    R_gt)
    print(f"[main] frames {MAIN_FRAMES}, keyframes {n_key}, match_best2 "
          f"launches {launches}, by gate {json.dumps(by_gate)}  ({card})")
    print(f"[main] rotation RMSE {rmse:.4f} deg (bound {RMSE_BOUND_DEG})  "
          f"({card})")
    _stage_lines("main", log, card)
    print(f"[main] {MAIN_FRAMES / wall:.3f} frames/s end to end ({wall:.1f} "
          f"s, first frame includes CUDA start-up)  ({card})")
    if not np.isfinite(rmse) or rmse >= RMSE_BOUND_DEG:
        raise SmokeError(f"rotation RMSE {rmse} deg is not under "
                         f"{RMSE_BOUND_DEG}")
    # batched extraction on the card against per-frame extraction on the
    # CPU
    hold_to_cpu("main", card, {"keyframes": n_key, "rmse": rmse,
                               "by_gate": by_gate,
                               "connections": len(vg.connections)},
                PER_FRAME_PHASE3)
    return launches, by_gate, (seq, gt, yaml, (vg, res))


def phase_prefetch(card, seq, vocab_path):
    """The first frames of phase 3's sequence through ``FramePrefetcher``
    against ``Frame`` built one at a time, without and with the
    vocabulary; extraction ms per frame, batched and one at a time."""
    import torch

    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.frame import Frame
    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.frontend.prefetch import FramePrefetcher
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
    from irotavg_tpu_torch.utils.sequence import load_gray

    dev = torch.device("cuda", torch.cuda.current_device())
    names = sorted(os.listdir(seq))[:PREFETCH_FRAMES]
    imgs = [load_gray(os.path.join(seq, n)) for n in names]
    fx, fy, cx, cy = KITTI_K
    cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy, width=KITTI_W, height=KITTI_H)
    ext = ORBExtractor(n_features=2000, n_levels=8, device=dev)
    vocab = Vocabulary.load_text(vocab_path, device=dev)
    words = 0
    for voc in (None, vocab):
        pf = FramePrefetcher(imgs, ext, cam, batch=PREFETCH_BATCH, vocab=voc)
        for i, im in enumerate(imgs):
            got, want = pf.frame(i), Frame(i, im, ext, cam, vocab=voc)
            for k in ("desc", "valid", "octave", "x", "y", "angle"):
                if not np.array_equal(getattr(got, k), getattr(want, k)):
                    raise SmokeError(f"prefetch: frame {i} {k} differs from "
                                     f"per-frame extraction (vocabulary "
                                     f"{voc is not None})")
            if voc is not None:
                if got.bow != want.bow or not np.array_equal(
                        got.feat_nodes, want.feat_nodes):
                    raise SmokeError(f"prefetch: frame {i} BoW or node ids "
                                     f"differ from the per-frame transform")
                words += len(got.bow)
    batch = torch.from_numpy(np.stack(imgs[:PREFETCH_BATCH])).to(dev)
    batched_ms = _median_ms(torch, lambda: ext.extract_batch(batch),
                            reps=5) / PREFETCH_BATCH
    one_ms = _median_ms(torch, lambda: ext(batch[0]), reps=5)
    print(f"[prefetch] {PREFETCH_FRAMES} frames through FramePrefetcher("
          f"batch={PREFETCH_BATCH}) equal to per-frame Frames without and "
          f"with the vocabulary (desc, valid, octave, x, y, angle, BoW "
          f"over {words} words, node ids)  ({card})")
    print(f"[prefetch] extraction {batched_ms:.3f} ms a frame batched "
          f"(B={PREFETCH_BATCH}) against {one_ms:.3f} ms one at a time "
          f"(median of 5, CUDA events, images on the device)  ({card})")
    return {"batched_ms_per_frame": batched_ms, "per_frame_ms": one_ms}


# -- phase 4: place recognition and loop closure ------------------------------


def _vocab_timings(card, vocab_path, seq):
    """Parse seconds of the vocabulary, and the tree descent of one real
    frame's 2000 descriptors: device ms (CUDA events) and the whole
    transform's ms (descent + one fetch + host assembly)."""
    import torch

    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
    from irotavg_tpu_torch.utils.sequence import load_gray

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    vocab = Vocabulary.load_text(vocab_path, device=dev)
    parse_s = time.perf_counter() - t0
    ext = ORBExtractor(n_features=2000, n_levels=8, device=dev)
    out = ext(load_gray(os.path.join(seq, "000000.pgm")))
    desc, valid = out["desc"], out["valid"]
    descend_ms = _median_ms(torch, lambda: vocab.descend(desc, valid))
    vocab.transform(desc, valid)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        bow, nodes = vocab.transform(desc, valid)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[loop] vocabulary k={vocab.k} L={vocab.L}: {len(vocab.children)} "
          f"nodes, {vocab.n_words} words, parsed in {parse_s:.3f} s (host "
          f"numpy)  ({card})")
    print(f"[loop] tree descent of {int(valid.sum())} descriptors: "
          f"{descend_ms:.4f} ms on the device (median of 20, CUDA events); "
          f"transform with fetch and host assembly "
          f"{statistics.median(times):.4f} ms ({len(bow)} words)  ({card})")


def vocab_file(out):
    """The repo's k=10, L=5 DBoW2 vocabulary, decompressed into ``out``."""
    import gzip

    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "vocab.txt")
    with gzip.open(VOCAB_FIXTURE, "rb") as src, open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return path


def phase_loop_closure(card, out, vocab):
    """Runs A and B on the two-lap orbit.  Returns (launches and launches
    by gate per run, the frames' directory, the YAML, the GT rotations,
    run B's RMSE); the caller removes the frames."""
    n_frames = LOOP_FRAMES
    t0 = time.perf_counter()
    seq, _gt, yaml, R_gt = write_sequence(out, n_frames, laps=2.0,
                                          spiral=LOOP_SPIRAL)
    print(f"[loop] rendered {n_frames} frames (two laps, orbit shrinking by "
          f"{LOOP_SPIRAL} m) {KITTI_W}x{KITTI_H} in "
          f"{time.perf_counter() - t0:.1f} s (host numpy)")
    runs = {}
    _vocab_timings(card, vocab, seq)
    for name, extra in (("A", []), ("B", ["--no_loop_closure"])):
        res = os.path.join(out, f"out_{name}")
        log, wall, launches, by_gate, vg = run_cli(
            [vocab, yaml, seq, "--image_ext", ".pgm", "--out_dir", res,
             "--device", "cuda"] + extra, out, f"irotavg_{name}")
        rmse, n_key = rotation_rmse_deg(
            os.path.join(res, "rotavg_poses.txt"),
            os.path.join(res, "rotavg_poses_ids.txt"), R_gt)
        runs[name] = dict(log=log, wall=wall, launches=launches,
                          by_gate=by_gate, rmse=rmse, n_key=n_key,
                          connections=len(vg.connections))
    edges = [tuple(int(v) for v in line.split("(")[1].split(")")[0]
                   .split(","))
             for line in runs["A"]["log"].splitlines()
             if line.strip().startswith("new connection:")]
    spans = [j - i for i, j in edges]
    for name, r in runs.items():
        label = "with loop closure" if name == "A" else "--no_loop_closure"
        print(f"[loop] run {name} ({label}): frames {n_frames}, keyframes "
              f"{r['n_key']}, rotation RMSE {r['rmse']:.4f} deg, "
              f"match_best2 launches {r['launches']}, by gate "
              f"{json.dumps(r['by_gate'])}  ({card})")
        _stage_lines(f"loop {name}", r["log"], card)
        print(f"[loop] run {name}: {n_frames / r['wall']:.3f} frames/s end "
              f"to end ({r['wall']:.1f} s)  ({card})")
    totals = _stage_totals(runs["A"]["log"])
    share = totals.get("loop_closure", 0.0) / totals["frame_processing"]
    hist = dict(sorted(collections.Counter(spans).items()))
    print(f"[loop] loop edges {len(edges)}, edges by view span {hist}; "
          f"loop_closure share of frame_processing in run A {share:.4f}  "
          f"({card})")
    ra, rb = runs["A"]["rmse"], runs["B"]["rmse"]
    print(f"[loop] payoff RMSE_B / RMSE_A = {rb / ra:.3f} (bound "
          f"{LOOP_PAYOFF})  ({card})")
    for name, r in runs.items():
        hold_to_cpu(f"loop {name}", card, {
            "keyframes": r["n_key"], "rmse": r["rmse"],
            "by_gate": r["by_gate"], "connections": r["connections"],
            "loop_edges": len(edges) if name == "A" else 0,
            "loop_edge_digest": edge_digest(sorted(edges) if name == "A"
                                            else [])}, LOOP_PHASE4[name])
    if not spans or max(spans) <= LOOP_MIN_SPAN:
        raise SmokeError(f"run A made no loop edge spanning more than "
                         f"{LOOP_MIN_SPAN} views (spans {spans})")
    for gate in ("node", "epipolar"):
        if runs["A"]["by_gate"][gate] <= 0:
            raise SmokeError(f"run A never launched match_best2 under the "
                             f"{gate!r} gate")
    if not (np.isfinite(ra) and np.isfinite(rb)
            and LOOP_PAYOFF * ra < rb):
        raise SmokeError(f"loop-closure payoff below {LOOP_PAYOFF}x: RMSE "
                         f"{ra} deg with against {rb} deg without")
    return ({name: (r["launches"], r["by_gate"]) for name, r in runs.items()},
            seq, yaml, R_gt, rb)


def _slots_differ(a, b):
    """``(frames, slots)`` bool: where the two arrays' bytes differ."""
    f, k = a.shape[:2]
    return (a.view(np.uint8).reshape(f, k, -1)
            != b.view(np.uint8).reshape(f, k, -1)).any(-1)


def phase_extraction_parity(card, seq):
    """Phase 4's frames extracted on the card and on the CPU, batched by 8
    as the CLI's prefetcher does: x, y, octave, valid, response, angle
    and descriptors must be equal bit for bit."""
    import torch

    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.utils.sequence import load_gray

    names = sorted(os.listdir(seq))
    imgs = np.stack([load_gray(os.path.join(seq, n)) for n in names])
    keys = ("x", "y", "octave", "valid", "response", "angle", "desc")
    outs, secs = {}, {}
    for where in ("cuda", "cpu"):
        ext = ORBExtractor(n_features=2000, n_levels=8, device=where)
        parts, t0 = [], time.perf_counter()
        for b in range(0, len(names), PREFETCH_BATCH):
            o = ext.extract_batch(imgs[b:b + PREFETCH_BATCH])
            parts.append({k: o[k].cpu().numpy() for k in keys})
        secs[where] = time.perf_counter() - t0
        outs[where] = {k: np.concatenate([p[k] for p in parts])
                       for k in keys}
    card_o, cpu_o = outs["cuda"], outs["cpu"]
    valid = cpu_o["valid"]
    slots = {k: _slots_differ(card_o[k], cpu_o[k]) for k in keys}
    differ = {k: int(v.sum()) for k, v in slots.items()}
    desc_bad = slots["desc"] & valid
    print(f"[parity] phase 4's {len(names)} frames extracted on the card in "
          f"{secs['cuda']:.1f} s and on the CPU in "
          f"{secs['cpu']:.1f} s ({torch.get_num_threads()} threads), "
          f"batched by {PREFETCH_BATCH}: {int(valid.sum())} valid keypoints; "
          f"keypoint slots differing by key {json.dumps(differ)}; "
          f"descriptors differing {int(desc_bad.sum())} of "
          f"{int(valid.sum())}  ({card})")
    if any(differ.values()):
        f, k = np.argwhere(np.any(list(slots.values()), axis=0))[0]
        raise SmokeError(
            f"extraction differs between the card and the CPU; first at "
            f"frame {f} slot {k}: octave {cpu_o['octave'][f, k]}, x "
            f"{cpu_o['x'][f, k]}, y {cpu_o['y'][f, k]}, angle card "
            f"{card_o['angle'][f, k]!r} / CPU {cpu_o['angle'][f, k]!r}")


# -- phase 7: the offline pipeline --------------------------------------------


def phase_offline(card, out, seq, yaml, vocab, R_gt, rmse_b):
    """The port's ``irotavg_batch`` CLI on phase 4's frames with phase 4's
    vocabulary; see the module doc for the checks."""
    from irotavg_tpu_torch import pipeline
    from irotavg_tpu_torch.app import irotavg_batch

    results = []
    run_offline = pipeline.run_offline

    def recording(*a, **kw):
        results.append(run_offline(*a, **kw))
        return results[-1]

    res = os.path.join(out, "out_offline")
    pipeline.run_offline = recording
    try:
        log, wall, launches, by_gate = _run_logged(
            irotavg_batch.main,
            [vocab, yaml, seq, "--image_ext", ".pgm", "--out_dir", res,
             "--device", "cuda"], out, "irotavg_batch")
    finally:
        pipeline.run_offline = run_offline
    r = results[0]
    rmse, n_key = rotation_rmse_deg(os.path.join(res, "rotavg_poses.txt"),
                                    os.path.join(res, "rotavg_poses_ids.txt"),
                                    R_gt)
    spans = (r.edges[r.loop_mask, 1] - r.edges[r.loop_mask, 0]).tolist()
    hist = dict(sorted(collections.Counter(spans).items()))
    st = r.stats
    print(f"[offline] frames {LOOP_FRAMES}, keyframes {n_key}, edges "
          f"{len(r.edges)} ({r.loop_edges} loop, {st['pairs_connected']} of "
          f"{st['pairs_total']} window pairs, "
          f"{st.get('loop_candidate_pairs', 0)} loop candidates), loop "
          f"edges by keyframe span {hist}  ({card})")
    print(f"[offline] stages: extract {st['extract_s']:.3f} s, flow "
          f"{st['flow_s']:.3f} s, pairs {st['pairs_s']:.3f} s, loop "
          f"{st.get('loop_s', 0.0):.3f} s, solve {st['solve_s']:.3f} s "
          f"({st['irls_iters']} IRLS iterations); total {st['total_s']:.3f} "
          f"s = {LOOP_FRAMES / st['total_s']:.3f} frames/s (CLI wall "
          f"{wall:.1f} s)  ({card})")
    print(f"[offline] match_best2 launches {launches}, by gate "
          f"{json.dumps(by_gate)}  ({card})")
    print(f"[offline] rotation RMSE {rmse:.4f} deg (JAX package, CPU: "
          f"{JAX_OFFLINE_RMSE_DEG:.4f}; bound "
          f"{OFFLINE_RMSE_FACTOR * JAX_OFFLINE_RMSE_DEG:.4f}); phase 4 "
          f"RMSE_B {rmse_b:.4f}  ({card})")
    for gate in ("local", "epipolar_nonode"):
        if by_gate[gate] <= 0:
            raise SmokeError(f"the offline run never launched match_best2 "
                             f"under the {gate!r} gate")
    hold_to_cpu("offline", card, {
        "keyframes": n_key, "edges": len(r.edges),
        "loop_edges": int(r.loop_edges),
        "loop_candidates": st.get("loop_candidate_pairs", 0),
        "loop_edge_digest": edge_digest(r.edges[r.loop_mask]),
        "by_gate": by_gate, "rmse": rmse}, PORT_OFFLINE)
    if not (np.isfinite(rmse)
            and rmse <= OFFLINE_RMSE_FACTOR * JAX_OFFLINE_RMSE_DEG):
        raise SmokeError(f"offline RMSE {rmse} deg is not within "
                         f"{OFFLINE_RMSE_FACTOR}x the JAX package's "
                         f"{JAX_OFFLINE_RMSE_DEG}")
    if JAX_OFFLINE_LOOP_EDGES > 0:
        if not spans or max(spans) <= LOOP_MIN_SPAN:
            raise SmokeError(f"the offline run made no loop edge spanning "
                             f"more than {LOOP_MIN_SPAN} keyframes")
        if not LOOP_PAYOFF * rmse < rmse_b:
            raise SmokeError(f"offline RMSE {rmse} deg is not under "
                             f"1/{LOOP_PAYOFF} of phase 4's RMSE_B {rmse_b}")
    return launches, by_gate


# -- phase 5: the solver surfaces ---------------------------------------------


def bench_windows(W, seed=21):
    """Windows from bench.py:520-535's generator (numpy): n 12-15 views,
    2n extra edges, 2 deg noise, 10% outliers, warm start GT perturbed by
    3 deg, f = 2.  Returns ``[(edges, QQ, Q0, f)]``."""
    from scipy.spatial.transform import Rotation as Rsc
    from synth import make_problem

    rng = np.random.default_rng(seed)
    problems = []
    for k in range(W):
        nk = int(rng.integers(12, 16))
        p = make_problem(n=nk, extra_edges=nk * 2, noise_deg=2.0,
                         outlier_frac=0.1, seed=500 + k)
        pert = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0),
                                          size=(nk, 3)))
        Q0 = (pert * Rsc.from_quat(p["Q_gt"])).as_quat()
        Q0[:2] = p["Q_gt"][:2]
        problems.append((p["edges"].astype(np.int32), p["QQ"], Q0, 2))
    return problems


def kitti_chain(n, seed=5):
    """A KITTI-length keyframe graph (numpy): a trajectory of ``n``
    rotations (a random walk of 2 deg steps), 3 sequential edges per view
    with 0.5 deg noise, and a loop edge every 37 views from view 400 on
    back to a view 300-1500 earlier where there is one (a drive that
    keeps revisiting its streets).  Returns (R_gt quats, edges, QQ, warm start chained along
    the sequential edges)."""
    from scipy.spatial.transform import Rotation as Rsc

    rng = np.random.default_rng(seed)
    R = Rsc.from_rotvec(np.cumsum(
        rng.normal(scale=np.radians(2.0), size=(n, 3)), axis=0))
    edges = [(j - d, j) for j in range(n) for d in (1, 2, 3) if j >= d]
    for j in range(400, n, 37):
        i = j - int(rng.integers(300, 1500))
        if i >= 0:
            edges.append((i, j))
    edges = np.array(edges)
    noise = Rsc.from_rotvec(rng.normal(scale=np.radians(0.5),
                                       size=(len(edges), 3)))
    QQ = (noise * R[edges[:, 1]] * R[edges[:, 0]].inv()).as_quat()
    Q0 = np.empty((n, 4))
    Q0[0] = R[0].as_quat()
    first = {int(j): k for k, (i, j) in enumerate(edges) if j - i == 1}
    for j in range(1, n):
        Q0[j] = (Rsc.from_quat(QQ[first[j]]) * Rsc.from_quat(Q0[j - 1])
                 ).as_quat()
    return R.as_quat(), edges, QQ, Q0


def geo_deg(Qa, Qb):
    """Per-row rotation angle (deg) between two quaternion sets,
    sign-invariant and accurate for tiny angles."""
    Qa = Qa / np.linalg.norm(Qa, axis=-1, keepdims=True)
    Qb = Qb / np.linalg.norm(Qb, axis=-1, keepdims=True)
    s = np.sign(np.sum(Qa * Qb, axis=-1, keepdims=True))
    chord = np.linalg.norm(Qa - s * Qb, axis=-1)
    return np.degrees(4 * np.arcsin(np.clip(chord / 2, 0, 1)))


def _device(torch):
    """The card the solver phases run on."""
    return torch.device("cuda", torch.cuda.current_device())


def _sync_s(torch, fn):
    """(result, seconds) of ``fn()`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


class CountCG:
    """Collects the iteration counts of every CG solve made inside the
    ``with`` block (device tensors, summed at the end): by default the
    ``laplacian_cg_solve`` calls of the IRLS and L1-RA modules; with
    ``sharded=True`` the CG of ``parallel/sharded.py``."""

    def __init__(self, sharded=False):
        self._targets = ((("parallel.sharded",), "_graph_pcg") if sharded
                         else (("solver.irls", "solver.l1ra"),
                               "laplacian_cg_solve"))

    def __enter__(self):
        import importlib

        self.its = []
        mods, self._attr = self._targets
        self._mods = [importlib.import_module(f"irotavg_tpu_torch.{m}")
                      for m in mods]
        orig = self._orig = getattr(self._mods[0], self._attr)

        def counting(*a, **kw):
            x, it = orig(*a, **kw)
            self.its.append(it.sum())
            return x, it

        for m in self._mods:
            setattr(m, self._attr, counting)
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            setattr(m, self._attr, self._orig)

    def total(self):
        return int(sum(int(i) for i in self.its))


def phase_golden(card, out):
    """(a) The port's ``l1_irls`` CLI on the golden problem against the
    scipy oracle, with bench.py:321-322's quality rule."""
    import contextlib

    import ref_impl as oracle
    import torch

    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.app import l1_irls
    from irotavg_tpu_torch.solver.init import init_mst
    from irotavg_tpu_torch.solver.io import read_problem

    sol = os.path.join(out, "l1_irls_out.txt")
    log_path = os.path.join(out, "l1_irls.log")
    with open(log_path, "w") as fh, contextlib.redirect_stdout(fh), \
            counting_solver("phase5a_l1_irls"):
        t0 = time.perf_counter()
        rc = l1_irls.main([GOLDEN, sol, "--device", "cuda"])
        wall = time.perf_counter() - t0
    with open(log_path) as fh:
        log = fh.read()
    if rc != 0:
        raise SmokeError(f"l1_irls returned {rc}:\n{log[-2000:]}")
    with open(sol) as fh:
        lines = fh.read().splitlines()
    if len(lines) != GOLDEN_N + GOLDEN_M:
        raise SmokeError(f"l1_irls wrote {len(lines)} rows, expected "
                         f"{GOLDEN_N} rotations + {GOLDEN_M} weights")
    wxyz = np.array([[float(v) for v in ln.split()]
                     for ln in lines[:GOLDEN_N]])
    w = np.array([float(v) for v in lines[GOLDEN_N:]])
    Qf = wxyz[:, [1, 2, 3, 0]]
    if Qf.shape != (GOLDEN_N, 4) or not (np.isfinite(Qf).all()
                                         and np.isfinite(w).all()):
        raise SmokeError("l1_irls wrote malformed or non-finite rows")

    prob = read_problem(GOLDEN)
    f = max(prob["f"], 1)
    if prob["f"] == 0:
        prob["Q"][0] = [0, 0, 0, 1]
    edges, QQ = prob["edges"], prob["QQ"]
    Q0 = init_mst(prob["Q"], QQ, edges, f)
    A = oracle.make_A(len(Q0), f, edges)
    t0 = time.perf_counter()
    Q_b, l1_b, _ = oracle.l1ra(QQ, edges, A, Q0.copy(), f, max_iters=5,
                               change_th=1e-3)
    Q_b, _, irls_b, _ = oracle.irls(QQ, edges, A, "Geman-McClure",
                                    np.deg2rad(5.0), Q_b, f, max_iters=50,
                                    change_th=1e-3)
    oracle_s = time.perf_counter() - t0
    Q_b = Q_b / np.linalg.norm(Q_b, axis=1, keepdims=True)

    def mean_res_deg(Q):
        r = so3.log_map(so3.delta_rel(torch.from_numpy(edges).long(),
                                      torch.from_numpy(QQ),
                                      torch.from_numpy(Q)))[:, 3]
        return float(np.degrees(np.abs(r.numpy())).mean())

    res, res_b = mean_res_deg(Qf), mean_res_deg(Q_b)
    g = geo_deg(Qf, Q_b)
    ok = res < max(1.05 * res_b, 0.05) and float(g.max()) < 0.5
    for line in log.splitlines():
        if "iterations =" in line or "runtime" in line:
            print(f"[solver] golden {line.strip()}  ({card})")
    print(f"[solver] golden problem {GOLDEN_N} views, {GOLDEN_M} edges: CLI "
          f"wall {wall:.3f} s (process-internal; first CUDA solver calls "
          f"included); mean edge residual {res:.6f} deg (oracle "
          f"{res_b:.6f}, {l1_b} + {irls_b} iterations, {oracle_s:.3f} s on "
          f"the host); geodesic to the oracle max {g.max():.6f} mean "
          f"{g.mean():.7f} deg; quality_ok {ok}  ({card})")
    if not ok:
        raise SmokeError("golden problem fails bench.py's quality rule")


def large_problem(dev):
    """bench.py:379-401's 50k-view problem on ``dev`` in f64 with the
    reference's f64 CG configuration: (problem dict, graph, IRLSConfig)."""
    import torch
    from scipy.spatial.transform import Rotation as Rsc
    from synth import make_problem

    from irotavg_tpu_torch.solver.graph import RotationGraph
    from irotavg_tpu_torch.solver.irls import IRLSConfig

    p = make_problem(n=LARGE_N, extra_edges=LARGE_EXTRA, noise_deg=3.0,
                     outlier_frac=0.1, seed=11)
    rng = np.random.default_rng(12)
    perturb = Rsc.from_rotvec(rng.normal(scale=np.radians(3.0),
                                         size=(LARGE_N, 3)))
    Q0 = (perturb * Rsc.from_quat(p["Q_gt"])).as_quat()
    Q0[0] = p["Q_gt"][0]
    g = RotationGraph.create(p["edges"], p["QQ"], Q0, f=1,
                             dtype=torch.float64, device=dev)
    cfg = IRLSConfig(max_iters=100, change_th=1e-4, backend="cg",
                     cg_tol=1e-10, cg_maxiter=400)
    return p, g, cfg


def phase_large(card):
    """(b) bench.py:379-401's 50k-view quasi-global solve, f64 CG, twice
    on the fused kernels, then once on the unfused composition they
    replace (``composed_laplacian.composed_route``); all three
    bit-identical."""
    import torch

    from composed_laplacian import bits_equal, composed_route

    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.solver.irls import irls

    t0 = time.perf_counter()
    p, g, cfg = large_problem(_device(torch))
    print(f"[solver] 50k problem: {LARGE_N} views, {g.m} edges, built in "
          f"{time.perf_counter() - t0:.1f} s (host numpy)")
    runs = []
    for r in (1, 2, "composed"):
        route = composed_route() if r == "composed" else \
            contextlib.nullcontext()
        need = ("segment_sum",) if r == "composed" else CG_PATH
        with route, CountCG() as cg, counting_solver(f"phase5b_run{r}",
                                                      need):
            (Q, w, iters, score), secs = _sync_s(
                torch, lambda: irls(g, cfg))
        runs.append((Q, iters, secs, cg.total(), w))
    Q, iters, _, cg_total, _ = runs[1]
    identical = bool(bits_equal(runs[0][0], runs[1][0])
                     and bits_equal(runs[0][4], runs[1][4]))
    composed = bool(bits_equal(runs[0][0], runs[2][0])
                    and bits_equal(runs[0][4], runs[2][4])
                    and runs[2][1] == iters and runs[2][3] == cg_total)
    Qn = so3.qnormalize(Q).cpu().numpy()
    err = float(np.degrees(2 * np.arccos(np.clip(
        np.abs(np.sum(Qn * p["Q_gt"], axis=-1)), -1, 1))).mean())
    print(f"[solver] 50k f64 CG: IRLS iterations {runs[0][1]} / {iters}, CG "
          f"iterations {runs[0][3]} / {cg_total}, solve {runs[0][2]:.3f} / "
          f"{runs[1][2]:.3f} s (run 1 / run 2), final score {score:.3e}; "
          f"mean error vs GT {err:.10f} deg (JAX f64 "
          f"{LARGE_JAX_F64_MEAN_ERR_DEG:.10f}); second run bit-identical "
          f"(rotations and weights): {identical}; solver launches "
          f"{SOLVER_LAUNCHES['phase5b_run1']} / "
          f"{SOLVER_LAUNCHES['phase5b_run2']}  ({card})")
    print(f"[solver] 50k f64 CG on the unfused composition: IRLS "
          f"iterations {runs[2][1]}, CG iterations {runs[2][3]}, solve "
          f"{runs[2][2]:.3f} s, launches "
          f"{SOLVER_LAUNCHES['phase5b_runcomposed']}; bit-identical to the "
          f"fused kernels' solve: {composed}  ({card})")
    if not identical or runs[0][1] != iters or runs[0][3] != cg_total:
        raise SmokeError("50k solve: two runs in the default mode are not "
                         "bit-identical")
    if not composed:
        raise SmokeError("50k solve: the fused kernels' solve differs from "
                         "the unfused composition's")
    if not (iters < cfg.max_iters and np.isfinite(Qn).all()):
        raise SmokeError(f"50k solve: {iters} IRLS iterations or non-finite")
    if abs(err - LARGE_JAX_F64_MEAN_ERR_DEG) >= LARGE_TOL_DEG:
        raise SmokeError(f"50k solve: mean error {err} deg is not within "
                         f"{LARGE_TOL_DEG} of the JAX package's f64 "
                         f"{LARGE_JAX_F64_MEAN_ERR_DEG}")


def phase_kitti_resolve(card):
    """(c) A KITTI-length global re-solve through the engine: the CG
    window against the same graph solved dense."""
    import torch

    from irotavg_tpu_torch.engine.incremental import IncrementalRotAvg

    R_gt, edges, QQ, Q0 = kitti_chain(KITTI_VIEWS)
    dev = _device(torch)
    out = {}
    for name, dense_n_max in (("cg", 2048), ("dense", 8192)):
        eng = IncrementalRotAvg(device=dev, dense_n_max=dense_n_max)
        for _ in range(KITTI_VIEWS):
            eng.add_view()
        for (i, j), q in zip(edges, QQ):
            eng.add_edge(int(i), int(j), q)
        eng.Q = Q0.copy()
        eng.fix_pose(0)
        with CountCG() as cg, counting_solver(
                f"phase5c_{name}", CG_PATH if name == "cg" else DENSE_PATH):
            stats, secs = _sync_s(torch, lambda: eng.rot_avg(5_000_000))
        out[name] = (eng.Q.copy(), stats, secs, cg.total())
        print(f"[solver] KITTI-length re-solve, {name}: {KITTI_VIEWS} views, "
              f"{len(edges)} edges, bucket {stats['n_pad']}, backend "
              f"{stats['backend']}, IRLS iterations {stats['irls_iters']}, "
              f"CG iterations {cg.total()}, {secs:.3f} s; mean error vs GT "
              f"{geo_deg(out[name][0], R_gt).mean():.4f} deg (warm start "
              f"{geo_deg(Q0, R_gt).mean():.4f})  ({card})")
    if out["cg"][1]["backend"] != "cg" or out["dense"][1]["backend"] != \
            "dense":
        raise SmokeError("the engine did not switch backends at dense_n_max")
    d = float(geo_deg(out["cg"][0], out["dense"][0]).max())
    print(f"[solver] KITTI-length re-solve: CG vs dense max geodesic "
          f"{d:.3e} deg (bound {KITTI_TOL_DEG})  ({card})")
    if not np.isfinite(d) or d >= KITTI_TOL_DEG:
        raise SmokeError(f"CG and dense engine solves differ by {d} deg")


def phase_windows(card):
    """(d) bench.py:520-535's 384 windows in one batched call against the
    port's single-window solve, window by window, on the card."""
    import torch

    from irotavg_tpu_torch.engine.batched import solve_windows
    from irotavg_tpu_torch.engine.incremental import _window_solve

    dev = _device(torch)
    problems = bench_windows(N_WINDOWS)
    times = []
    for r in range(4):           # the first call includes CUDA start-up
        with counting_solver(f"phase5d_batched{r}"):
            (Qb, wb, itb, _), secs = _sync_s(torch, lambda: solve_windows(
                problems, m_pad=64, n_pad=16, device=dev))
        times.append(secs)
    t_batch = statistics.median(times[1:])
    worst, iters_equal, singles = 0.0, True, []
    for k, (e, qq, q0, f) in enumerate(problems):
        (Q1, _w, it1, _), secs = _sync_s(torch, lambda: _window_solve(
            torch.as_tensor(e, device=dev).long(),
            torch.as_tensor(qq, device=dev), torch.as_tensor(q0, device=dev),
            f, l1_iters=100, irls_iters=100, sigma=float(np.radians(5.0)),
            change_th=1e-3, cost="Geman-McClure"))
        singles.append(secs)
        iters_equal &= int(itb[k]) == it1
        Q1 = Q1.cpu().numpy()
        s = np.sign(np.sum(Qb[k] * Q1, axis=-1, keepdims=True))
        worst = max(worst, float(np.abs(Qb[k] - s * Q1).max()))
    print(f"[solver] batched windows: {N_WINDOWS} windows (n 12-15, m_pad "
          f"64, n_pad 16, f64) in {t_batch:.4f} s = "
          f"{N_WINDOWS / t_batch:.1f} windows/s (median of 3 calls); IRLS "
          f"iterations {int(itb.min())}-{int(itb.max())}; the per-window "
          f"loop {sum(singles):.3f} s = {N_WINDOWS / sum(singles):.1f} "
          f"windows/s; iterations equal {iters_equal}, max |dq| "
          f"{worst:.3e}  ({card})")
    if not iters_equal or worst >= 1e-9:
        raise SmokeError(f"batched windows differ from the per-window solve "
                         f"(iterations equal {iters_equal}, max |dq| {worst})")


def phase_solver(card, out):
    os.makedirs(out, exist_ok=True)
    phase_golden(card, out)
    phase_large(card)
    phase_kitti_resolve(card)
    phase_windows(card)


# -- phase 8: the distributed solver ------------------------------------------

DIST_L1_ITERS = 5             # sharded_ravg_pipeline's default warmup


def _mean_err_deg(Q, Q_gt):
    from irotavg_tpu_torch import so3

    Qn = so3.qnormalize(Q).cpu().numpy()
    return float(np.degrees(2 * np.arccos(np.clip(
        np.abs(np.sum(Qn * Q_gt, axis=-1)), -1, 1))).mean())


def phase_distributed(card, out):
    """8. ``parallel/`` on the card: phase 5b's 50k-view f64 problem
    through ``sharded_irls`` and ``sharded_ravg_pipeline`` at world size 1
    over NCCL, against the single-device ``irls`` on the same schedules,
    then the scaling probe at world size 1.  Every scatter-add is the
    fixed-order ``segment_sum``, so in the default mode the sharded solve
    must be the single-device one to the bit (0 deg apart, the same IRLS
    and CG iterations), and its mean error within 0.01 deg of JAX's."""
    import contextlib
    import dataclasses
    import io

    import torch
    import torch.distributed as dist

    from composed_laplacian import bits_equal

    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.parallel import (
        init_multihost, make_graph_mesh, scaling_probe, shard_graph,
        sharded_irls, sharded_ravg_pipeline,
    )
    from irotavg_tpu_torch.solver.irls import Cost, irls

    dev = _device(torch)
    p, g, cfg = large_problem(dev)
    os.makedirs(out, exist_ok=True)
    store = os.path.abspath(os.path.join(out, "dist_store"))
    if os.path.exists(store):
        os.remove(store)
    init_multihost(init_method=f"file://{store}", num_processes=1,
                   process_id=0, device=dev)
    try:
        mesh = make_graph_mesh(1, device=dev)
        gs = shard_graph(g, mesh)
        l1_cfg = dataclasses.replace(cfg, cost=Cost.L1,
                                     max_iters=DIST_L1_ITERS)

        def single_pipeline():
            Q1, _, it1, _ = irls(g, l1_cfg)
            Q2, w, it2, s = irls(dataclasses.replace(g, Q=Q1), cfg)
            return so3.qnormalize(Q2), w, it1 + it2, s

        solves = (
            ("irls", lambda: irls(g, cfg), False),
            ("sharded_irls", lambda: sharded_irls(mesh, cfg)(gs), True),
            ("two-phase irls", single_pipeline, False),
            ("sharded_ravg_pipeline", lambda: sharded_ravg_pipeline(
                mesh, l1_iters=DIST_L1_ITERS, cfg=cfg)(gs), True))
        runs = {}
        for name, fn, sharded in solves:
            mesh.all_reduces = 0
            with CountCG(sharded) as cg, \
                    counting_solver(f"phase8_{name}", CG_PATH):
                (Q, _w, iters, _s), secs = _sync_s(torch, fn)
            runs[name] = (Q, iters, cg.total(), secs, mesh.all_reduces)
        print(f"[dist] world size {mesh.size}, backend "
              f"{dist.get_backend()}, 50k problem: {LARGE_N} views, {g.m} "
              f"edges, f64  ({card})")
        failures = []
        for single, sharded in (("irls", "sharded_irls"),
                                ("two-phase irls", "sharded_ravg_pipeline")):
            Qa, ia, ca, sa, _ = runs[single]
            Qb, ib, cb, sb, nb = runs[sharded]
            geo = float(geo_deg(Qa.cpu().numpy(), Qb.cpu().numpy()).max())
            same = bits_equal(Qa, Qb)
            err = _mean_err_deg(Qb, p["Q_gt"])
            print(f"[dist] {sharded} IRLS iterations {ib}, CG iterations "
                  f"{cb}, {nb} all_reduces, {sb:.3f} s; {single} {ia} / "
                  f"{ca}, {sa:.3f} s; max geodesic {geo:.3e} deg, "
                  f"bit-identical {same}; mean error vs GT {err:.10f} deg; "
                  f"solver launches "
                  f"{SOLVER_LAUNCHES['phase8_' + sharded]}  ({card})")
            if not (ia == ib and ca == cb and geo == 0.0):
                failures.append(f"{sharded}: iterations {ib}/{cb} vs "
                                f"{ia}/{ca}, geodesic {geo}")
            if sharded == "sharded_irls" and abs(
                    err - LARGE_JAX_F64_MEAN_ERR_DEG) >= LARGE_TOL_DEG:
                failures.append(f"sharded_irls mean error {err} deg not "
                                f"within {LARGE_TOL_DEG} of "
                                f"{LARGE_JAX_F64_MEAN_ERR_DEG}")
        if failures:
            raise SmokeError("distributed solve: " + "; ".join(failures))
    finally:
        dist.destroy_process_group()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = scaling_probe.main(["--device", "cuda", "--devices", "1"])
    if rc != 0:
        raise SmokeError(f"scaling_probe returned {rc}")
    print(f"[dist] scaling probe (one card; no multi-GPU scaling measured): "
          f"{buf.getvalue().strip()}  ({card})")


# -- phase 9: vocabulary training ---------------------------------------------

# the shipped vocabulary's shape (k=10, L=5: 100k words), trained on every
# fourth frame of phase 4's sequence, at most 400 descriptors a frame
VOCAB_TRAIN = dict(k=10, L=5, seed=0, iters=6)
VOCAB_SAMPLE = dict(batch=8, cap=400, stride=4)


def phase_vocab_training(card, seq):
    """9. ``train_vocabulary_flat`` on descriptors sampled from phase 4's
    frames (``frontend/prefetch.py:sample_descriptors`` on the card),
    with its IDF descent on the card and again on the CPU: equal trees
    and weights."""
    import torch

    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.frontend.prefetch import sample_descriptors
    from irotavg_tpu_torch.placerec.vocabulary import train_vocabulary_flat
    from irotavg_tpu_torch.utils.sequence import load_gray

    dev = _device(torch)
    images = [(lambda p=os.path.join(seq, n): load_gray(p))
              for n in sorted(os.listdir(seq))]
    ext = ORBExtractor(n_features=2000, n_levels=8, device=dev)
    sample, t_sample = _sync_s(torch, lambda: sample_descriptors(
        images, ext, **VOCAB_SAMPLE))
    vocabs = []
    for where in (dev, torch.device("cpu")):
        v, secs = _sync_s(torch, lambda: train_vocabulary_flat(
            sample, device=where, **VOCAB_TRAIN))
        vocabs.append(v)
        print(f"[vocab] train_vocabulary_flat k={VOCAB_TRAIN['k']} "
              f"L={VOCAB_TRAIN['L']} on {sum(map(len, sample))} descriptors "
              f"of {len(sample)} frames, IDF descent on {where.type}: "
              f"{secs:.3f} s  ({card})")
    a, b = vocabs
    same = all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
        "children", "node_desc", "word_id", "is_leaf", "weight"))
    print(f"[vocab] sampled in {t_sample:.3f} s ({VOCAB_SAMPLE}); "
          f"{a.n_words} words, {int((a.weight > 0).sum())} with a positive "
          f"IDF weight; card and CPU trees and weights equal: {same}  "
          f"({card})")
    if not same or not (a.weight > 0).any():
        raise SmokeError("vocabulary training differs between the card's "
                         "and the CPU's IDF descent, or has no weight")


# -- phase 6: checkpoint / resume ---------------------------------------------


def phase_resume(card, out, seq, gt, yaml, full):
    """Phase 3's sequence in two parts through the CLI: ``--max_frames``
    half with ``--checkpoint`` and per-frame extraction (``--prefetch
    1``), then ``--resume`` with the default batched extraction; the kept
    frames, connections and poses must be phase 3's, the poses bit for
    bit (``full``: its view graph and output directory)."""
    res = os.path.join(out, "out_resume")
    base = ["none", yaml, seq, "--image_ext", ".pgm", "--gt", gt,
            "--out_dir", res, "--device", "cuda", "--checkpoint"]
    ck = os.path.join(res, "checkpoint.npz")
    _, wall_a, la, gate_a, _ = run_cli(
        base + ["--max_frames", str(RESUME_AT), "--prefetch", "1"], out,
        "irotavg_part1")
    log, wall_b, lb, gate_b, vg = run_cli(
        base + ["--max_frames", str(MAIN_FRAMES), "--resume", ck], out,
        "irotavg_part2")
    resumed = [ln for ln in log.splitlines() if ln.startswith("resumed at")]
    vg3, res3 = full
    with open(os.path.join(res, "rotavg_poses_ids.txt")) as fh:
        ids = fh.read()
    with open(os.path.join(res3, "rotavg_poses_ids.txt")) as fh:
        ids3 = fh.read()
    same_conn = set(vg.connections) == set(vg3.connections)
    d = geo_deg(vg.ra.Q, vg3.ra.Q) if vg.ra.Q.shape == vg3.ra.Q.shape \
        else np.array([np.inf])
    bit_equal = np.array_equal(vg.ra.Q, vg3.ra.Q)
    print(f"[resume] {resumed[0] if resumed else 'no resume line'}; part 1 "
          f"{RESUME_AT} keyframes in {wall_a:.1f} s, part 2 to "
          f"{MAIN_FRAMES} in {wall_b:.1f} s; match_best2 launches {la} + "
          f"{lb}, by gate {json.dumps(gate_a)} + {json.dumps(gate_b)}  "
          f"({card})")
    print(f"[resume] keyframes {vg.num_views} (phase 3: {vg3.num_views}), "
          f"ids equal {ids == ids3}, connections {len(vg.connections)} equal "
          f"{same_conn}; poses max {np.radians(d.max()):.3e} rad from phase "
          f"3's, bit-equal {bit_equal}  ({card})")
    if not resumed or la <= 0 or lb <= 0:
        raise SmokeError("the two-part run did not resume or never launched "
                         "match_best2")
    if ids != ids3 or not same_conn or not bit_equal:
        raise SmokeError("the resumed run differs from phase 3's "
                         "uninterrupted run")
    return la + lb, {"part1": gate_a, "part2": gate_b}


# -- phase 10: the remaining public surfaces ----------------------------------


def _sift_agreement(card_out, cpu_out):
    """(share of the CPU's valid keypoints found by the card at the same
    (octave, x0, y0), bit for bit, share of those with descriptors within
    SIFT_DESC_TOL, worst descriptor error, share of those with
    descriptors bit-identical)."""
    def keyed(o):
        o = {k: v.cpu().numpy() for k, v in o.items()}
        return o, {(int(a), float(x), float(y)): i for i, (a, x, y, v) in
                   enumerate(zip(o["octave"], o["x0"], o["y0"], o["valid"]))
                   if v}

    g, kg = keyed(card_out)
    c, kc = keyed(cpu_out)
    common = sorted(set(kg) & set(kc))
    if not kc or not common:
        raise SmokeError("SIFT found no keypoints on the card or the CPU")
    ig = np.array([kg[k] for k in common])
    ic = np.array([kc[k] for k in common])
    err = np.abs(g["desc"][ig] - c["desc"][ic]).max(axis=1)
    same = (g["desc"][ig].view(np.int32) == c["desc"][ic].view(np.int32))
    return (len(common) / len(kc), float((err <= SIFT_DESC_TOL).mean()),
            float(err.max()), float(same.all(axis=1).mean()))


def _trace_kernels(trace_dir):
    """(trace file, its size in bytes, events, names of its CUDA kernel
    events)."""
    files = sorted(os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                   if f.endswith(".pt.trace.json"))
    if len(files) != 1:
        raise SmokeError(f"--trace_dir wrote {len(files)} trace files")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    return files[0], os.path.getsize(files[0]), len(events), kernels


def phase_surfaces(card, out, seq, yaml, vocab_path, res3):
    """10. The Frame-level matchers, the two-view API, ``hamming_matrix``,
    SIFT and ``match_sift`` on the card against the same calls on the
    CPU, then the CLI's ``--plot_matches`` and ``--trace_dir``.  Returns
    (launches, launches by gate) of the matcher and two-view calls and of
    the CLI run."""
    import torch

    from composed_laplacian import bits_equal

    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.frame import Frame
    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.frontend.sift import SIFTExtractor
    from irotavg_tpu_torch.geometry.twoview import (
        find_relative_pose, refine_pose,
    )
    from irotavg_tpu_torch.matching import matchers
    from irotavg_tpu_torch.ops import match
    from irotavg_tpu_torch.ops.hamming import hamming_matrix
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
    from irotavg_tpu_torch.utils.sequence import load_gray
    from irotavg_tpu_torch.utils.viz import read_png

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    cpu = torch.device("cpu")
    fx, fy, cx, cy = KITTI_K
    cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy, width=KITTI_W, height=KITTI_H)
    K_inv = np.linalg.inv(cam.K)
    imgs = [load_gray(os.path.join(seq, f"{i:06d}.pgm")) for i in (0, 1)]
    ext = ORBExtractor(n_features=2000, n_levels=8, device=dev)
    vocab = Vocabulary.load_text(vocab_path, device=dev)
    keys = ("x", "y", "xu", "yu", "octave", "angle", "response", "size",
            "desc", "valid")

    def on(device, frames):
        """The frames' features as Frames on ``device`` (node ids kept)."""
        return [Frame.restore(f.id, cam, {k: getattr(f, k) for k in keys},
                              feat_nodes=f.feat_nodes, device=device)
                for f in frames]

    card_plain = [Frame(i, im, ext, cam) for i, im in enumerate(imgs)]
    card_nodes = [Frame(i, im, ext, cam, vocab=vocab)
                  for i, im in enumerate(imgs)]
    torch.cuda.synchronize()

    def calls(plain, nodes, F=None):
        """Every Frame-level call of this phase on one device's frames:
        the matchers, then the two-view API for each of TWOVIEW_SEEDS."""
        f0, f1 = plain
        out = {"local": matchers.match_locally(f1, f0),
               "bow_none": matchers.match_by_bow(f0, f1),
               "bow_node": matchers.match_by_bow(*nodes)}
        pairs = matchers.matches_to_pairs(matchers.match_locally(f0, f1))
        poses = []
        for seed in TWOVIEW_SEEDS:
            rel0 = find_relative_pose(f0, f1, pairs, cam, seed=seed)
            if rel0 is None:
                raise SmokeError(f"find_relative_pose failed on "
                                 f"{f0.device} (seed {seed})")
            inl = pairs[rel0.inlier_mask]
            rel1, pairs1 = refine_pose(f0, f1, rel0, inl, cam, seed=seed + 1)
            poses.append((rel0, rel1, len(inl), len(pairs1)))
        if F is None:          # the card's F gates both devices' matchers
            F = K_inv.T @ poses[0][0].E @ K_inv
        out["epipolar_nonode"] = matchers.match_epipolar(f0, f1, F)
        out["epipolar"] = matchers.match_epipolar(*nodes, F)
        return out, F, poses

    match.reset_launch_counts()
    t0 = time.perf_counter()
    got, F, poses = calls(card_plain, card_nodes)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches = match.best2.launches
    by_gate = dict(match.best2.launches_by_gate)
    t0 = time.perf_counter()
    ref, _, poses_c = calls(on(cpu, card_plain), on(cpu, card_nodes), F)
    t_cpu = time.perf_counter() - t0
    for name, m in got.items():
        if not np.array_equal(m, ref[name]):
            raise SmokeError(f"{name}: the card's assignment differs from "
                             f"the CPU's in {int((m != ref[name]).sum())} "
                             f"rows")
    counts = {k: int((v >= 0).sum()) for k, v in got.items()}
    print(f"[surfaces] Frame-level matchers on 2000 ORB features, equal to "
          f"the CPU row for row; matches {json.dumps(counts)}; launches "
          f"{launches}, by gate {json.dumps(by_gate)}; card {t_card:.2f} s, "
          f"CPU {t_cpu:.2f} s  ({card})")
    d_find, d_refine = [], []
    for seed, (a0, a1, n0, n1), (b0, b1, m0, m1) in zip(
            TWOVIEW_SEEDS, poses, poses_c):
        d_find.append(geo_deg_R(a0.R, b0.R))
        d_refine.append(geo_deg_R(a1.R, b1.R))
        print(f"[surfaces] seed {seed}: find_relative_pose support {n0} / "
              f"CPU {m0}, R {d_find[-1]:.4f} deg apart; refine_pose "
              f"{n0} -> {n1} / CPU {m0} -> {m1}, R {d_refine[-1]:.4f} deg "
              f"apart  ({card})")
        if n1 < n0 or m1 < m0:
            raise SmokeError("refine_pose lost support")
    if not np.median(d_refine) < TWOVIEW_TOL_DEG:
        raise SmokeError(f"refined poses {d_refine} deg from the CPU's")
    for gate in match.GATES:
        if by_gate[gate] <= 0:
            raise SmokeError(f"phase 10 never launched the {gate!r} gate")

    # the dense FORB distance, against the CPU and the kernel's d1
    d0, d1 = (f.dev("desc") for f in card_plain)
    ham = hamming_matrix(d0, d1)
    ham_cpu = hamming_matrix(d0.cpu(), d1.cpu())
    ones = torch.ones(d0.shape[0], dtype=torch.bool, device=dev)
    k_d1, _, _ = match.best2(d0, d1, match.make_rowf(ones),
                             match.make_colf(ones), "none")
    same_cpu = torch.equal(ham.cpu(), ham_cpu)
    same_d1 = torch.equal(ham.min(dim=1).values.float(), k_d1)
    ham_ms = _median_ms(torch, lambda: hamming_matrix(d0, d1), reps=10)
    print(f"[surfaces] hamming_matrix {tuple(ham.shape)}: equal to the CPU "
          f"{same_cpu}, row minima equal to the kernel's d1 (gate none) "
          f"{same_d1}; {ham_ms:.3f} ms (median of 10)  ({card})")
    if not (same_cpu and same_d1):
        raise SmokeError("hamming_matrix disagrees with the CPU or the "
                         "kernel")

    # SIFT on the card against the CPU, and match_sift
    sift = SIFTExtractor(device=dev)
    sift_cpu = SIFTExtractor(device="cpu")
    with counting_solver("phase10_sift", ("segment_sum",)):
        s_card = [sift(im) for im in imgs]
        torch.cuda.synchronize()
    s_again = sift(imgs[0])
    repeats = all(bits_equal(s_card[0][k], s_again[k])
                  if s_again[k].is_floating_point()
                  else torch.equal(s_card[0][k], s_again[k])
                  for k in s_again)
    s_cpu = sift_cpu(imgs[0])
    kp_share, desc_share, worst, desc_bits = _sift_agreement(s_card[0],
                                                             s_cpu)
    sframes = [Frame.from_extracted(i, o, cam) for i, o in enumerate(s_card)]
    m_card = matchers.match_sift(*sframes)
    m_cpu = matchers.match_sift(*[Frame.from_extracted(
        i, {k: v.cpu() for k, v in o.items()}, cam)
        for i, o in enumerate(s_card)])
    rows = s_card[0]["valid"].cpu().numpy()
    m_share = float((m_card == m_cpu)[rows].mean())
    img_dev = torch.from_numpy(imgs[0]).to(dev)
    sift_ms = _median_ms(torch, lambda: sift(img_dev), reps=10)
    n_valid = int(s_card[0]["valid"].sum())
    print(f"[surfaces] SIFT 2000 features, {len(s_card[0]['valid'])} slots, "
          f"{n_valid} valid on the card: {kp_share:.4f} of the CPU's "
          f"keypoints at the same (octave, x0, y0), descriptors within "
          f"{SIFT_DESC_TOL} on {desc_share:.4f} of them (worst "
          f"{worst:.3e}), bit-identical on {desc_bits:.4f}; match_sift "
          f"valid rows equal to the CPU's {m_share:.4f} "
          f"({int((m_card >= 0).sum())} matches); a second run on the card "
          f"bit-identical: {repeats}; segment_sum launches "
          f"{SOLVER_LAUNCHES['phase10_sift']['segment_sum']}  ({card})")
    print(f"[surfaces] SIFT extraction {sift_ms:.3f} ms a frame "
          f"({KITTI_W}x{KITTI_H}, median of 10, CUDA events)  ({card})")
    # in turns against the route before the fixed-order sums: each
    # histogram one atomic scatter_add (patched in here only)
    from irotavg_tpu_torch.frontend import sift as sift_mod

    def scatter_bin_sums(bins, vals, n_bins):
        hist = torch.zeros((bins.shape[0], n_bins), dtype=vals.dtype,
                           device=vals.device)
        return hist.scatter_add(1, bins, vals)

    turns = {"segment_sum": [], "scatter_add": []}
    saved = sift_mod._bin_sums
    for route in ("segment_sum", "scatter_add", "scatter_add",
                  "segment_sum"):
        sift_mod._bin_sums = saved if route == "segment_sum" else \
            scatter_bin_sums
        try:
            turns[route].append(_median_ms(torch, lambda: sift(img_dev),
                                           reps=10))
        finally:
            sift_mod._bin_sums = saved
    print(f"[surfaces] SIFT ms a frame in turns (segment_sum, scatter_add, "
          f"scatter_add, segment_sum; median of 10 each): segment_sum "
          f"{turns['segment_sum'][0]:.3f} / {turns['segment_sum'][1]:.3f}, "
          f"scatter_add {turns['scatter_add'][0]:.3f} / "
          f"{turns['scatter_add'][1]:.3f}  ({card})")
    if not repeats:
        raise SmokeError("SIFT on the card differs between two runs")
    if kp_share < SIFT_KEYPOINT_SHARE or desc_share < SIFT_DESC_SHARE \
            or m_share < SIFT_MATCH_SHARE:
        raise SmokeError("SIFT on the card disagrees with the CPU")

    # the CLI: --plot_matches on the first 20 frames, then both flags on
    # the first 3 (a trace grows by tens of MB a frame)
    sub = os.path.join(out, "surfaces")
    names = sorted(os.listdir(seq))
    runs = {}
    for tag, n_frames, extra in (
            ("plot", SURFACE_CLI_FRAMES, []),
            ("trace", SURFACE_TRACE_FRAMES, ["--trace_dir"])):
        d = os.path.join(sub, tag)
        os.makedirs(os.path.join(d, "seq"), exist_ok=True)
        for name in names[:n_frames]:
            shutil.copy(os.path.join(seq, name), os.path.join(d, "seq"))
        argv = ["none", yaml, os.path.join(d, "seq"), "--image_ext", ".pgm",
                "--out_dir", os.path.join(d, "out"), "--device", "cuda",
                "--plot_matches", os.path.join(d, "plots")]
        if extra:
            argv += extra + [os.path.join(d, "trace")]
        _, wall, n, gates, _ = run_cli(argv, d, f"irotavg_{tag}")
        with open(os.path.join(d, "out", "rotavg_poses_ids.txt")) as fh:
            ids = [int(v) for v in fh.read().split()]
        pngs = sorted(os.listdir(os.path.join(d, "plots")))
        shapes = {read_png(os.path.join(d, "plots", p)).shape for p in pngs}
        runs[tag] = dict(d=d, wall=wall, launches=n, by_gate=gates, ids=ids,
                         pngs=pngs, shapes=shapes, frames=n_frames)
    with open(os.path.join(res3, "rotavg_poses_ids.txt")) as fh:
        ids3 = [int(v) for v in fh.read().split()]
    path, size, n_events, kernels = _trace_kernels(
        os.path.join(runs["trace"]["d"], "trace"))
    named = sorted(k for k in kernels if KERNEL_SYMBOL in k)
    for tag, r in runs.items():
        first3 = [v for v in ids3 if v <= r["frames"]]
        flags = "--plot_matches" + (" --trace_dir" if tag == "trace" else "")
        print(f"[surfaces] CLI {flags} on {r['frames']} frames: "
              f"{len(r['ids'])} keyframes, phase 3's first keyframes "
              f"{r['ids'] == first3}; {len(r['pngs'])} "
              f"PNGs, decoded shapes {sorted(r['shapes'])}; launches "
              f"{r['launches']}, by gate {json.dumps(r['by_gate'])}; "
              f"{r['wall']:.1f} s  ({card})")
        want = [f"matches_{i:06d}.png" for i in range(1, len(r["ids"]))]
        if r["ids"] != first3:
            raise SmokeError(f"--plot_matches keyframes {r['ids']} differ "
                             f"from phase 3's {first3}")
        if r["pngs"] != want or r["shapes"] != {(KITTI_H, 2 * KITTI_W, 3)}:
            raise SmokeError(f"--plot_matches wrote {r['pngs']} with shapes "
                             f"{r['shapes']}")
        if r["launches"] <= 0:
            raise SmokeError(f"the {tag} CLI run never launched the kernel")
    print(f"[surfaces] trace {os.path.basename(path)}: {size} bytes, "
          f"{n_events} events, {len(kernels)} distinct CUDA kernels, "
          f"{KERNEL_SYMBOL} among them {bool(named)}  ({card})")
    if not named:
        raise SmokeError(f"the trace names no {KERNEL_SYMBOL} kernel")
    shutil.rmtree(sub)
    print(f"[surfaces] phase 10 in {time.perf_counter() - t_phase:.1f} s  "
          f"({card})")
    cli = {g: sum(r["by_gate"][g] for r in runs.values())
           for g in match.GATES}
    total = {g: by_gate[g] + cli[g] for g in match.GATES}
    return (launches + sum(r["launches"] for r in runs.values()),
            {"calls": by_gate, "cli": cli, "total": total})


def geo_deg_R(Ra, Rb):
    """Angle (deg) between two rotation matrices."""
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64))
         - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out"),
                    help="scratch directory for the sequence and outputs")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable: {e}",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "irotavg_tpu_torch")):
        print("chip_smoke: FAIL: irotavg_tpu_torch/ not found beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    t_start = time.perf_counter()
    frames = []              # rendered sequences, removed at the end
    try:
        card = phase_device()
        phase_build(card)
        kern = phase_kernels(card)
        seg = phase_segment_kernel(card)
        fused = phase_laplacian_kernels(card)
        l1k = phase_l1ra_kernels(card)
        ransack = phase_ransac_kernels(card) + phase_ransac_tail(card)
        refine = phase_refine_graphs(card)
        main_launches, main_by_gate, phase3 = phase_main_path(card, args.out)
        frames.append(phase3[0])
        vocab = vocab_file(args.out)
        prefetch = phase_prefetch(card, phase3[0], vocab)
        loop, seq, yaml, R_gt, rmse_b = phase_loop_closure(
            card, os.path.join(args.out, "loop"), vocab)
        frames.append(seq)
        phase_extraction_parity(card, seq)
        offline_launches, offline_by_gate = phase_offline(
            card, os.path.join(args.out, "loop"), seq, yaml, vocab, R_gt,
            rmse_b)
        phase_vocab_training(card, seq)
        shutil.rmtree(frames.pop())
        phase_solver(card, os.path.join(args.out, "solver"))
        phase_distributed(card, os.path.join(args.out, "dist"))
        resume_launches, resume_by_gate = phase_resume(card, args.out,
                                                       *phase3)
        surf_launches, surf_by_gate = phase_surfaces(
            card, args.out, phase3[0], phase3[2], vocab, phase3[3][1])
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        for seq in frames:   # the frames are regenerated from the seed
            shutil.rmtree(seq)
    kern["launches"] = (main_launches + sum(n for n, _ in loop.values())
                        + offline_launches + resume_launches + surf_launches)
    kern["launches_by_gate"] = {
        "phase3": main_by_gate, "phase4_loop_closure": loop["A"][1],
        "phase4_no_loop_closure": loop["B"][1],
        "phase6_resume": resume_by_gate, "phase7_offline": offline_by_gate,
        "phase10_surfaces": surf_by_gate}
    kern["prefetch_extraction_ms"] = prefetch
    kern["refine_graphs"] = refine
    print(f"[smoke] every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    # the composed-route solve of phase 5b is a comparison, not a path
    paths = {p: c for p, c in SOLVER_LAUNCHES.items()
             if p != "phase5b_runcomposed"}
    for entry in [seg] + fused:
        entry["launches"] = sum(c[entry["name"]] for c in paths.values())
        entry["launches_by_path"] = {p: c[entry["name"]]
                                     for p, c in paths.items()}
    for entry in ransack:
        by_path = {p: c[entry["name"]] for p, c in RANSAC_LAUNCHES.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    print(json.dumps({"kernels": [kern, seg] + fused + [l1k] + ransack}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

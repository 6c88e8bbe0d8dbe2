"""The incremental rotation-averaging SLAM CLI on PyTorch (port of
``irotavg_tpu/app/irotavg.py``, the reference ``irotavg`` binary,
src/IRotAvg.cpp:132-398).

    python -m irotavg_tpu_torch.app.irotavg VOCAB CONFIG SEQUENCE_PATH
        [--image_ext .png] [--timestamp_offset 0] [--gt FILE]
        [--max_frames N] [--out_dir DIR] [--no_loop_closure]
        [--checkpoint] [--resume SNAPSHOT] [--prefetch B]
        [--plot_matches DIR] [--trace_dir DIR] [--device cuda|cpu]

``VOCAB`` is a DBoW2 text vocabulary (ORB-SLAM's ``ORBvoc.txt`` format),
or ``none`` to run without place recognition.  ``--device`` is ``cuda``
by default; without a card the CLI exits 2 unless given ``--device cpu``.
``--prefetch B`` (default 8) extracts the frames ``B`` at a time in one
batched pyramid (``frontend/prefetch.py``); 0 or 1 extracts one frame at
a time.  Without lens distortion the frames are bit-identical either
way, so is every engine decision.  With distortion the batched path
undistorts the keypoints on the device in f32 and the per-frame path on
the host in f64, as the JAX package does; the two agree to 1e-3 px, so a
decision at a threshold may differ (tests/test_torch_prefetch.py holds
the keyframes of the two widths equal on one distorted sequence).

Per frame: Frame creation (extract + undistort + BoW) ->
ViewGraph.process_frame (skip if not a keyframe) -> loop closure
(candidates -> consistency -> BoW match + essential RANSAC + refine ->
connect, min 150 inliers) -> optional GT ``fix_pose`` every 20 ids ->
rot_avg(10), or a whole-graph solve after a new loop connection or a GT
correction -> per-frame timing line -> every 5 ids the poses, the ids
and (``--checkpoint``) a restartable ``checkpoint.npz`` snapshot in
``--out_dir``.  Outputs ``rotavg_poses.txt`` and ``rotavg_poses_ids.txt``
as the reference writes them.  ``--resume SNAPSHOT`` restores the engine
from a snapshot (either package's; ``engine/checkpoint.py``) and goes on
from its source-frame cursor.  The summary adds a ``loop_closure`` stage,
the part of ``frame_processing`` spent in the loop-closure block.

``--plot_matches DIR`` writes ``matches_{id:06d}.png`` (the two frames
side by side with their match lines, ``utils/viz.py``; PNG encoded with
``zlib``) for each keyframe connected to the keyframe before it.  The
plot needs each frame's pixels, which batched extraction does not keep,
so with this flag the frames are extracted one at a time with
``keep_image=True`` and ``--prefetch`` is not used — the JAX package's
rule; the frames and decisions are those of ``--prefetch 1``.
``--trace_dir DIR`` runs the frame loop inside ``torch.profiler`` (CPU
activity, and CUDA activity on the card) and writes one TensorBoard /
Chrome trace file, ``*.pt.trace.json``, under ``DIR``; it holds the
program's spans (``utils/timing.py:span``) as ranges: each stage of the
timing line (``frame_creation``, ``frame_processing``, ``loop_closure``,
``rotavg``) with ``engine.process_frame``, ``placerec.loop_closure``,
``engine.rot_avg`` and the geometry and solver spans inside them.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="irotavg",
        description="Incremental rotation averaging over an image sequence",
    )
    p.add_argument("orb_vocabulary",
                   help="ORB vocabulary (text format), or 'none'")
    p.add_argument("config", help="ORB-SLAM-compatible YAML settings")
    p.add_argument("sequence_path", help="path to images")
    p.add_argument("--image_ext", default=".png")
    p.add_argument("--timestamp_offset", type=int, default=0)
    p.add_argument("--gt", default=None,
                   help="ground-truth orientations (9 numbers per line)")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--out_dir", default=".")
    p.add_argument("--no_loop_closure", action="store_true")
    p.add_argument("--prefetch", type=int, default=8, metavar="B",
                   help="batched extraction width (frames per batch); 0/1 "
                        "extracts per frame like the reference.  Engine "
                        "decisions are identical either way without lens "
                        "distortion; with it keypoints agree to 1e-3 px")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--checkpoint", action="store_true",
                   help="write a restartable engine snapshot "
                        "(checkpoint.npz in --out_dir) at each save point")
    p.add_argument("--resume", default=None, metavar="SNAPSHOT",
                   help="resume from a checkpoint.npz snapshot")
    p.add_argument("--trace_dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the frame loop "
                        "(CPU, and CUDA on the card) under DIR")
    p.add_argument("--plot_matches", default=None, metavar="DIR",
                   help="write a PNG of each consecutive keyframe pair's "
                        "matches into DIR (extracts one frame at a time, "
                        "without --prefetch)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from irotavg_tpu_torch import so3
    from irotavg_tpu_torch.config import PipelineConfig, load_settings
    from irotavg_tpu_torch.device import pick_device
    from irotavg_tpu_torch.engine.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from irotavg_tpu_torch.engine.viewgraph import (
        FrameConnectionError, ViewGraph,
    )
    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.frame import Frame
    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.frontend.prefetch import FramePrefetcher
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
    from irotavg_tpu_torch.utils.sequence import SequenceLoader, load_gray
    from irotavg_tpu_torch.utils.timing import StageTimer, device_trace

    try:
        device = pick_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    cfg = PipelineConfig()
    cam_cfg, orb_cfg = load_settings(args.config)

    vocab = None
    if args.orb_vocabulary.lower() not in ("none", "-", ""):
        print("loading vocabulary...")
        vocab = Vocabulary.load_text(args.orb_vocabulary, device=device)

    gt_rots = None
    if args.gt is not None:
        data = np.loadtxt(args.gt)
        if data.ndim == 1:
            data = data[None]
        if data.shape[1] != 9:
            print(f"bad GT file: expected 9 columns, got {data.shape[1]}",
                  file=sys.stderr)
            return 1
        gt_rots = data.reshape(-1, 3, 3)

    extractor = ORBExtractor(
        n_features=orb_cfg.n_features, scale_factor=orb_cfg.scale_factor,
        n_levels=orb_cfg.n_levels, ini_th_fast=orb_cfg.ini_th_fast,
        min_th_fast=orb_cfg.min_th_fast, device=device)
    loader = SequenceLoader(args.sequence_path, args.image_ext,
                            args.timestamp_offset)
    if len(loader) == 0:
        print(f"no {args.image_ext} images in {args.sequence_path}",
              file=sys.stderr)
        return 1

    print(f"K:\n[{cam_cfg.fx} 0 {cam_cfg.cx}; 0 {cam_cfg.fy} {cam_cfg.cy}; "
          f"0 0 1]")
    print(f"dist coefs: [{cam_cfg.k1} {cam_cfg.k2} {cam_cfg.p1} "
          f"{cam_cfg.p2}]")
    print(f"device: {device}")

    detect_loop_closure = cfg.loop.enabled and not args.no_loop_closure \
        and vocab is not None

    timer = StageTimer()
    os.makedirs(args.out_dir, exist_ok=True)
    poses_path = os.path.join(args.out_dir, "rotavg_poses.txt")
    ids_path = os.path.join(args.out_dir, "rotavg_poses_ids.txt")
    ckpt_path = os.path.join(args.out_dir, "checkpoint.npz")
    im0 = load_gray(loader[0][1])
    camera = Camera(
        fx=cam_cfg.fx, fy=cam_cfg.fy, cx=cam_cfg.cx, cy=cam_cfg.cy,
        k1=cam_cfg.k1, k2=cam_cfg.k2, p1=cam_cfg.p1, p2=cam_cfg.p2,
        width=im0.shape[1], height=im0.shape[0])

    frame_id = 0
    skip_until = 0          # 1-based count of the last frame already seen
    selected_frames: list[int] = []
    if args.resume is not None:
        vg, extra = load_checkpoint(args.resume, camera, device=device)
        skip_until = int(extra["count"])
        frame_id = int(extra["frame_id"])
        selected_frames = [int(v) for v in extra["selected_frames"]]
        print(f"resumed at source frame {skip_until} "
              f"({vg.num_views} keyframes)")
    else:
        vg = ViewGraph(camera, min_matches=cfg.vg_min_matches, device=device,
                       loop_cfg=cfg.loop)
    todo = [(count + 1, impath) for count, (_ts, impath) in enumerate(loader)
            if count >= skip_until and count % cfg.sampling_step == 0]
    count = skip_until      # the resume cursor written into checkpoints
    pf = None
    keep_image = args.plot_matches is not None
    # the plots need the raw pixels, which batched extraction does not keep
    if args.prefetch > 1 and not keep_image:
        # over the frames left after the resume cursor
        pf = FramePrefetcher([(lambda p=p: load_gray(p)) for _, p in todo],
                             extractor, camera, batch=args.prefetch,
                             vocab=vocab)

    def checkpoint(count1, next_id):
        if args.checkpoint:
            save_checkpoint(vg, ckpt_path, extra={
                "count": count1, "frame_id": next_id,
                "selected_frames": selected_frames})

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with device_trace(args.trace_dir, device):
        for k, (count1, impath) in enumerate(todo):
            if args.max_frames is not None and frame_id >= args.max_frames:
                break
            count = count1
            with timer.stage("frame_creation"):
                if pf is not None:
                    frame = pf.frame(k)
                    frame.id = frame_id
                else:
                    frame = Frame(frame_id, load_gray(impath), extractor,
                                  camera, vocab=vocab, keep_image=keep_image)
                sync()
            with timer.stage("frame_processing"):
                try:
                    selected = vg.process_frame(frame,
                                                win_size=cfg.vg_win_size)
                except FrameConnectionError as e:
                    # the reference std::exits here (src/ViewGraph.cpp:1083)
                    print(f"Not enough matches: {e}", file=sys.stderr)
                    return -1
                sync()
                if not selected:
                    print(f"skipping frame - local rad = {vg.local_rad}\n")
                    continue
                selected_frames.append(count1)
                view_id = vg.num_views - 1
                if keep_image and view_id > 0:
                    _plot(vg, view_id, args.plot_matches,
                          f"matches_{frame_id:06d}.png")

                loop_new_connections = False
                if detect_loop_closure:
                    with timer.stage("loop_closure"):
                        loop_new_connections = _loop_closure(
                            vg, view_id, cfg.loop.min_matches)
                        sync()

            with timer.stage("rotavg"):
                add_correction = (gt_rots is not None
                                  and frame_id % cfg.gt_fix_every == 0)
                if add_correction:
                    gi = frame_id * cfg.sampling_step
                    if gi < len(gt_rots):
                        q = so3.rotmat_to_quat(torch.from_numpy(gt_rots[gi]))
                        vg.fix_pose(view_id, q.numpy())
                        print(f"Fixing pose for view id {frame_id}")
                vg.rot_avg(cfg.global_win_size
                           if loop_new_connections or add_correction
                           else cfg.rotavg_win_size)
                sync()

            print(timer.frame_line(frame_id))
            if frame_id % cfg.save_every == 0:
                vg.save_poses(poses_path)
                _save_ids(ids_path, selected_frames)
                checkpoint(count1, frame_id + 1)
            frame_id += 1

    vg.save_poses(poses_path)
    _save_ids(ids_path, selected_frames)
    checkpoint(count, frame_id)
    for name, s in timer.summary().items():
        print(f"{name}: total {s['total_s']:.3f}s over {s['count']} "
              f"frames (mean {s['mean_s'] * 1e3:.1f} ms)")
    return 0


def _loop_closure(vg, view_id: int, min_matches: int) -> bool:
    """The loop-closure block (src/IRotAvg.cpp:295-353): candidates ->
    consistency -> verify and connect each -> add the view to the
    database.  True when a new loop connection was made."""
    from irotavg_tpu_torch.utils.timing import span

    with span("placerec.loop_closure", view=view_id) as sp:
        candidates = vg.detect_loop_candidates(view_id)
        consistent = (vg.check_loop_consistency(candidates) if candidates
                      else [])
        if consistent:
            print(" * * * loop closure detected * * *\n")
        connected = 0
        for cand in consistent:
            if vg.close_loop(view_id, cand, min_matches=min_matches):
                print(f"   new connection: ( {cand}, {view_id} )")
                connected += 1
        vg.add_to_database(view_id)
        sp.set(candidates=len(candidates), consistent=len(consistent),
               connected=connected)
    return connected > 0


def _plot(vg, view_id: int, out_dir: str, name: str) -> None:
    """The matches of keyframe ``view_id`` with the keyframe before it,
    as a PNG in ``out_dir``, when the two are connected."""
    from irotavg_tpu_torch.utils.viz import plot_matches

    os.makedirs(out_dir, exist_ok=True)
    conn = vg.connections.get((view_id - 1, view_id))
    if conn is not None and vg.frames[view_id - 1].image is not None:
        plot_matches(vg.frames[view_id - 1], vg.frames[view_id], conn.pairs,
                     os.path.join(out_dir, name))


def _save_ids(path: str, selected: list[int]) -> None:
    """`saveSelectedFramesIds` (src/IRotAvg.cpp:111-128): the 1-based
    running count at selection time, one per line."""
    with open(path, "w") as fh:
        for v in selected:
            fh.write(f"{v}\n")


if __name__ == "__main__":
    sys.exit(main())

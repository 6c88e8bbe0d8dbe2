"""Offline batched rotation-averaging CLI on PyTorch (port of
``irotavg_tpu/app/irotavg_batch.py``): the throughput counterpart of
``irotavg``, with the same inputs and outputs and batched execution
(``pipeline/offline.py``).

    python -m irotavg_tpu_torch.app.irotavg_batch VOCAB CONFIG SEQUENCE_PATH
        [--image_ext .png] [--timestamp_offset 0] [--max_frames N]
        [--out_dir DIR] [--batch 8] [--chunk 8] [--win_size 4]
        [--no_loop_closure] [--device cuda|cpu]

Accepts the reference's file formats (ORB-SLAM YAML, DBoW2 text
vocabulary or ``none``) and writes ``rotavg_poses.txt`` (zero
translations) and ``rotavg_poses_ids.txt`` (1-based source frames) as the
reference writes them (src/ViewGraph.cpp:1206-1231,
src/IRotAvg.cpp:111-128); prints the stage seconds and frames/s.
``--device`` is ``cuda`` by default; without a card the CLI exits 2
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="irotavg_batch",
        description="Batched offline rotation averaging over an image "
                    "sequence",
    )
    p.add_argument("orb_vocabulary",
                   help="ORB vocabulary (text format), or 'none'")
    p.add_argument("config", help="ORB-SLAM-compatible YAML settings")
    p.add_argument("sequence_path", help="path to images")
    p.add_argument("--image_ext", default=".png")
    p.add_argument("--timestamp_offset", type=int, default=0)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--out_dir", default=".")
    p.add_argument("--batch", type=int, default=8,
                   help="frames per batched extraction")
    p.add_argument("--chunk", type=int, default=8,
                   help="pairs per batched two-view estimation")
    p.add_argument("--win_size", type=int, default=4)
    p.add_argument("--no_loop_closure", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from irotavg_tpu_torch.config import PipelineConfig, load_settings
    from irotavg_tpu_torch.device import pick_device
    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.pipeline import run_offline
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
    from irotavg_tpu_torch.utils.sequence import SequenceLoader, load_gray

    try:
        device = pick_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    cfg = PipelineConfig()
    cam_cfg, orb_cfg = load_settings(args.config)

    vocab = None
    if (args.orb_vocabulary.lower() not in ("none", "-", "")
            and not args.no_loop_closure):
        print("loading vocabulary...")
        vocab = Vocabulary.load_text(args.orb_vocabulary, device=device)

    loader = SequenceLoader(args.sequence_path, args.image_ext,
                            args.timestamp_offset)
    paths = [p for _, p in loader]
    if args.max_frames is not None:
        paths = paths[: args.max_frames]
    if not paths:
        print(f"no {args.image_ext} images in {args.sequence_path}",
              file=sys.stderr)
        return 1

    im0 = load_gray(paths[0])
    camera = Camera(
        fx=cam_cfg.fx, fy=cam_cfg.fy, cx=cam_cfg.cx, cy=cam_cfg.cy,
        k1=cam_cfg.k1, k2=cam_cfg.k2, p1=cam_cfg.p1, p2=cam_cfg.p2,
        width=im0.shape[1], height=im0.shape[0])
    extractor = ORBExtractor(
        n_features=orb_cfg.n_features, scale_factor=orb_cfg.scale_factor,
        n_levels=orb_cfg.n_levels, ini_th_fast=orb_cfg.ini_th_fast,
        min_th_fast=orb_cfg.min_th_fast, device=device)
    print(f"device: {device}")

    images = [(lambda p=p: load_gray(p)) for p in paths]
    res = run_offline(
        images, camera, extractor, vocab=vocab, cfg=cfg,
        batch=args.batch, chunk=args.chunk, win_size=args.win_size,
        progress=lambda msg: print(f"  {msg}", end="\r"))
    print()

    os.makedirs(args.out_dir, exist_ok=True)
    poses_path = os.path.join(args.out_dir, "rotavg_poses.txt")
    ids_path = os.path.join(args.out_dir, "rotavg_poses_ids.txt")
    with open(poses_path, "w") as fh:
        for i, q in enumerate(res.Q):
            xq, yq, zq, wq = q
            vals = (wq, xq, yq, zq, 0.0, 0.0, 0.0)
            fh.write(str(i) + "\t"
                     + "\t".join(f"{v:.17e}" for v in vals) + "\n")
    with open(ids_path, "w") as fh:
        for i in res.keyframes:
            fh.write(f"{i + 1}\n")

    n_frames = len(paths)
    total = res.stats["total_s"]
    print(f"keyframes: {len(res.keyframes)}/{n_frames}, edges "
          f"{len(res.edges)} ({res.loop_edges} loop)")
    for k in ("extract_s", "flow_s", "pairs_s", "loop_s", "solve_s"):
        if k in res.stats:
            print(f"{k[:-2]}: {res.stats[k]:.3f}s")
    print(f"total: {total:.3f}s  ({n_frames / total:.2f} frames/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

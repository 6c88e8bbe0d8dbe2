#!/usr/bin/env python3
"""Seed spread of the port's offline pipeline on ``chip_smoke.py``'s
phase-4 frames (the 241-frame two-lap orbit, 1241x376, 2000 ORB
features, the repo's k=10, L=5 vocabulary) on one CUDA card.

    python3 tools/offline_seeds.py [--seeds 0 1 2 3 4] [--out DIR]

Renders the frames once (numpy), then runs ``pipeline.run_offline`` with
the ``irotavg_batch`` CLI's settings once per seed (the seed of the
RANSAC draws) and prints, per seed, the rotation RMSE against GT
(``chip_smoke.rotation_rmse_deg``), the loop edges and the stage
seconds, then the median and range of the RMSEs.  The card's name and
power limit lead the output.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_outputs(res, out):
    """``rotavg_poses.txt`` / ``rotavg_poses_ids.txt`` as the CLI writes
    them; returns their paths."""
    os.makedirs(out, exist_ok=True)
    poses = os.path.join(out, "rotavg_poses.txt")
    ids = os.path.join(out, "rotavg_poses_ids.txt")
    with open(poses, "w") as fh:
        for i, (x, y, z, w) in enumerate(res.Q):
            fh.write(str(i) + "\t" + "\t".join(
                f"{v:.17e}" for v in (w, x, y, z, 0.0, 0.0, 0.0)) + "\n")
    with open(ids, "w") as fh:
        fh.writelines(f"{k + 1}\n" for k in res.keyframes)
    return poses, ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out",
                                                  "offline_seeds"))
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE]

    import torch

    import chip_smoke as cs
    from irotavg_tpu_torch.config import PipelineConfig
    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.pipeline import run_offline
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
    from irotavg_tpu_torch.utils.sequence import load_gray

    if not torch.cuda.is_available():
        print("offline_seeds: no CUDA card", file=sys.stderr)
        return 1
    card = cs._card(torch)
    print(card)
    dev = torch.device("cuda", torch.cuda.current_device())
    seq, _gt, _yaml, R_gt = cs.write_sequence(
        args.out, cs.LOOP_FRAMES, laps=2.0, spiral=cs.LOOP_SPIRAL)
    try:
        vocab = Vocabulary.load_text(cs.vocab_file(args.out), device=dev)
        fx, fy, cx, cy = cs.KITTI_K
        cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy, width=cs.KITTI_W,
                     height=cs.KITTI_H)
        ext = ORBExtractor(n_features=2000, n_levels=8, device=dev)
        images = [(lambda p=os.path.join(seq, n): load_gray(p))
                  for n in sorted(os.listdir(seq))]
        rmses = []
        for seed in args.seeds:
            res = run_offline(images, cam, ext, vocab=vocab,
                              cfg=PipelineConfig(), seed=seed)
            rmse, n_key = cs.rotation_rmse_deg(
                *write_outputs(res, os.path.join(args.out, f"s{seed}")),
                R_gt)
            rmses.append(rmse)
            st = res.stats
            print(f"seed {seed}: rotation RMSE {rmse:.4f} deg, keyframes "
                  f"{n_key}, edges {len(res.edges)} ({res.loop_edges} loop),"
                  f" pairs {st['pairs_s']:.1f} s, loop {st['loop_s']:.1f} "
                  f"s, total {st['total_s']:.1f} s  ({card})", flush=True)
    finally:
        shutil.rmtree(seq)
    print(f"RMSE over seeds {args.seeds}: median "
          f"{statistics.median(rmses):.4f}, min {min(rmses):.4f}, max "
          f"{max(rmses):.4f} deg  ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

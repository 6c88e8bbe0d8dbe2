#!/usr/bin/env python3
"""The JAX package's offline pipeline (the reference) on ``chip_smoke.py``'s
phase-4 frames, on the CPU: the source of ``chip_smoke.py``'s
``JAX_OFFLINE_RMSE_DEG``.  Not part of the port: it imports the JAX
package and no torch.

    JAX_PLATFORMS=cpu python3 tools/jax_offline_reference.py \\
        [--seeds 0] [--no_loop_closure] [--out DIR]

Renders the 241-frame two-lap orbit (1241x376, 2000 ORB features) with
``chip_smoke.write_sequence``, decompresses the repo's k=10, L=5
vocabulary, and runs ``irotavg_tpu.pipeline.run_offline`` with the JAX
``irotavg_batch`` CLI's settings (default ``PipelineConfig``, batch 8,
chunk 8, window 4; seed 0 is the CLI's run) once per seed; prints the
rotation RMSE against GT (``chip_smoke.rotation_rmse_deg``), the
keyframes, the edges, the loop edges and their keyframe spans.  About 9
minutes a seed with loop closure on 8 CPU cores; ~2 GB of memory.
"""

from __future__ import annotations

import argparse
import collections
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--no_loop_closure", action="store_true")
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out",
                                                  "jax_offline"))
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [HERE]

    import jax

    jax.config.update("jax_platforms", "cpu")

    import chip_smoke as cs
    from irotavg_tpu.config import PipelineConfig
    from irotavg_tpu.frontend import Camera, ORBExtractor
    from irotavg_tpu.pipeline import run_offline
    from irotavg_tpu.placerec.vocabulary import Vocabulary
    from irotavg_tpu.utils import load_gray

    sys.path.insert(0, os.path.join(HERE, "tools"))
    from offline_seeds import write_outputs

    seq, _gt, _yaml, R_gt = cs.write_sequence(
        args.out, cs.LOOP_FRAMES, laps=2.0, spiral=cs.LOOP_SPIRAL)
    try:
        vocab = None if args.no_loop_closure else Vocabulary.load_text(
            cs.vocab_file(args.out))
        fx, fy, cx, cy = cs.KITTI_K
        cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy, width=cs.KITTI_W,
                     height=cs.KITTI_H)
        ext = ORBExtractor(n_features=2000, n_levels=8)
        images = [(lambda p=os.path.join(seq, n): load_gray(p))
                  for n in sorted(os.listdir(seq))]
        for seed in args.seeds:
            res = run_offline(images, cam, ext, vocab=vocab,
                              cfg=PipelineConfig(), seed=seed)
            rmse, n_key = cs.rotation_rmse_deg(
                *write_outputs(res, os.path.join(args.out, f"s{seed}")),
                R_gt)
            e = res.edges[res.loop_mask]
            spans = dict(sorted(collections.Counter(
                (e[:, 1] - e[:, 0]).tolist()).items()))
            print(f"seed {seed}: rotation RMSE {rmse!r} deg, keyframes "
                  f"{n_key}, edges {len(res.edges)} ({res.loop_edges} loop,"
                  f" spans {spans}), total {res.stats['total_s']:.1f} s "
                  f"(CPU)", flush=True)
    finally:
        shutil.rmtree(seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The JAX package's incremental ``irotavg`` CLI (the reference) on
``chip_smoke.py``'s phase-4 frames, on the CPU: runs A (loop closure on)
and B (``--no_loop_closure``), as phase 4 runs the port's CLI.  Not part
of the port: it runs the JAX package and no torch.

    JAX_PLATFORMS=cpu python3 tools/jax_incremental_reference.py \\
        [--runs A B] [--out DIR]

Renders the 241-frame two-lap orbit (1241x376) with
``chip_smoke.write_sequence``, decompresses the repo's k=10, L=5
vocabulary, and runs ``irotavg_tpu.app.irotavg.main`` with phase 4's
arguments on the CPU (without x64, as the CLI runs); prints per run the
rotation RMSE against GT (``chip_smoke.rotation_rmse_deg``), the
keyframes, the loop edges (the CLI's "new connection" lines) and the
wall, beside the port's values recorded on the CPU
(``chip_smoke.LOOP_PHASE4``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", default=["A", "B"],
                    choices=["A", "B"])
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out",
                                                  "jax_incremental"))
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [HERE]

    import jax

    jax.config.update("jax_platforms", "cpu")

    import chip_smoke as cs
    from irotavg_tpu.app import irotavg

    seq, gt, yaml, R_gt = cs.write_sequence(
        args.out, cs.LOOP_FRAMES, laps=2.0, spiral=cs.LOOP_SPIRAL)
    vocab = cs.vocab_file(args.out)
    try:
        for name in args.runs:
            res = os.path.join(args.out, f"res_{name}")
            extra = ["--no_loop_closure"] if name == "B" else []
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = irotavg.main([vocab, yaml, seq, "--image_ext", ".pgm",
                                   "--out_dir", res] + extra)
            wall = time.perf_counter() - t0
            if rc:
                print(log.getvalue()[-4000:], file=sys.stderr)
                return rc
            loops = log.getvalue().count("new connection:")
            rmse, n_key = cs.rotation_rmse_deg(
                os.path.join(res, "rotavg_poses.txt"),
                os.path.join(res, "rotavg_poses_ids.txt"), R_gt)
            port = cs.LOOP_PHASE4[name]
            print(f"run {name}: rotation RMSE {rmse!r} deg, keyframes "
                  f"{n_key}, loop edges {loops}, {wall:.1f} s (CPU); the "
                  f"port on the CPU: {port['rmse']!r} deg, keyframes "
                  f"{port['keyframes']}, loop edges {port['loop_edges']}",
                  flush=True)
    finally:
        shutil.rmtree(seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())

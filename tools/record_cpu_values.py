#!/usr/bin/env python3
"""The values ``chip_smoke.py`` holds the card to, from the port on the CPU.

    python3 tools/record_cpu_values.py --run phase3|phase4A|phase4B|phase7
        [--threads N] [--out DIR] [--json FILE]

Renders the same sequence as ``chip_smoke.py``'s phase (from its seed),
runs the same CLI call with ``--device cpu`` and prints one JSON line of
what the phase compares:

* ``phase3``: the ``irotavg`` CLI on the first 150 frames of the one-lap
  sequence, ``VOCAB=none``, GT pins, per-frame extraction
  (``--prefetch 1``): keyframes, matcher calls by gate, rotation RMSE,
  connections (``PER_FRAME_PHASE3``);
* ``phase4A`` / ``phase4B``: the CLI on the two-lap orbit with the repo's
  vocabulary, with and without loop closure: keyframes, matcher calls by
  gate, RMSE, connections, the loop edges (``LOOP_PHASE4``);
* ``phase7``: the ``irotavg_batch`` CLI on the same frames: keyframes,
  edges, loop candidates, the loop edges, RMSE (``PORT_OFFLINE``).

On the CPU the matcher launches no kernel, so its calls are counted here,
one for each call of ``best2_plain`` (on the card each call is one
launch).  Each run takes minutes of CPU; run them in separate processes.
No card is needed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

import chip_smoke as cs  # noqa: E402


def _counting_matcher():
    """Counts calls of the matcher's plain version by gate."""
    from irotavg_tpu_torch.ops import match

    counts = dict.fromkeys(match.GATES, 0)
    plain = match.best2_plain

    def counted(*args, **kw):
        gate = args[4] if len(args) > 4 else kw["gate"]
        counts[gate] += 1
        return plain(*args, **kw)

    match.best2_plain = counted
    return counts


def _run(main_fn, argv, log_path):
    with open(log_path, "w", buffering=1) as fh, \
            contextlib.redirect_stdout(fh):
        rc = main_fn(argv)
    with open(log_path) as fh:
        log = fh.read()
    if rc != 0:
        raise SystemExit(f"{argv} returned {rc}:\n{log[-2000:]}")
    return log


def _loop_edges(log):
    return sorted([int(v) for v in line.split("(")[1].split(")")[0]
                   .split(",")]
                  for line in log.splitlines()
                  if line.strip().startswith("new connection:"))


def record(run: str, out: str) -> dict:
    from irotavg_tpu_torch.app import irotavg, irotavg_batch

    counts = _counting_matcher()
    os.makedirs(out, exist_ok=True)
    res = os.path.join(out, f"out_{run}")
    if run == "phase3":
        seq, gt, yaml, R_gt = cs.write_sequence(
            out, cs.MAIN_LAP_FRAMES, first=cs.MAIN_FRAMES)
        argv = ["none", yaml, seq, "--image_ext", ".pgm", "--gt", gt,
                "--out_dir", res, "--max_frames", str(cs.MAIN_FRAMES),
                "--prefetch", "1", "--device", "cpu"]
        main_fn = irotavg.main
    else:
        seq, _, yaml, R_gt = cs.write_sequence(
            out, cs.LOOP_FRAMES, laps=2.0, spiral=cs.LOOP_SPIRAL)
        vocab = cs.vocab_file(out)
        argv = [vocab, yaml, seq, "--image_ext", ".pgm", "--out_dir", res,
                "--device", "cpu"]
        if run == "phase4B":
            argv.append("--no_loop_closure")
        main_fn = irotavg_batch.main if run == "phase7" else irotavg.main
    graphs, results = [], []
    if run == "phase7":
        from irotavg_tpu_torch import pipeline

        run_offline = pipeline.run_offline

        def recording(*a, **kw):
            results.append(run_offline(*a, **kw))
            return results[-1]

        pipeline.run_offline = recording
    else:
        from irotavg_tpu_torch.engine.viewgraph import ViewGraph

        process_frame = ViewGraph.process_frame

        def recording(self, *a, **kw):
            graphs[:] = [self]
            return process_frame(self, *a, **kw)

        ViewGraph.process_frame = recording
    t0 = time.perf_counter()
    log = _run(main_fn, argv, os.path.join(out, f"{run}.log"))
    wall = time.perf_counter() - t0
    rmse, n_key = cs.rotation_rmse_deg(
        os.path.join(res, "rotavg_poses.txt"),
        os.path.join(res, "rotavg_poses_ids.txt"), R_gt)
    rec = {"run": run, "keyframes": n_key, "rmse": rmse,
           "by_gate": counts, "seconds": wall}
    if run == "phase7":
        r = results[0]
        edges = [list(map(int, e)) for e in r.edges[r.loop_mask]]
        rec.update(edges=len(r.edges),
                   loop_candidates=int(r.stats.get("loop_candidate_pairs",
                                                   0)))
    else:
        edges = _loop_edges(log)
        rec.update(connections=len(graphs[0].connections))
    rec.update(loop_edges=len(edges), loop_edge_digest=cs.edge_digest(edges),
               loop_edge_list=edges)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True,
                    choices=("phase3", "phase4A", "phase4B", "phase7"))
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads (0: torch's default)")
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out",
                                                  "cpu_record"))
    ap.add_argument("--json", help="also write the JSON line here")
    args = ap.parse_args(argv)
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    rec = record(args.run, os.path.join(args.out, args.run))
    line = json.dumps(rec)
    print(line)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings for the limits of the comparison: one cell on many seeds in
one process, as the program, as the control (``--control``: the solver in
f32) or with a fault planted (``--fault NAME``).  Prints one JSON line a
seed (the numbers compared, the end-to-end metrics, ``correct`` against
the current limits) and appends it to ``--out`` when given.

    python3 portbench/readings.py --workload NAME --seeds 1,2,3 \
        --seconds S [--control] [--fault NAME] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    import run as run_mod

    run_mod.cache_env(ROOT)
    from pbkit import runner, spec
    import torch

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    shared: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = runner.run_cell(cell, seed, args.seconds, False, device,
                              control=args.control, fault=args.fault,
                              shared=shared)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": args.control, "fault": args.fault,
                           "correct": out["correct"],
                           "attempted": out["attempted"],
                           "failed": out["failed"],
                           "metrics": {k: v["value"] for k, v in
                                       out["metrics"].items()},
                           "compared": {k: v["value"] for k, v in
                                        out["compared"].items()}})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

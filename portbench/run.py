"""The benchmark of irotavg_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` and prints its result as the last
line of standard output (one JSON object); the numbers compared with the
reference, each beside its limit, are the last lines of standard error.
Exits 2 without a CUDA card (it never falls back to the CPU), and 3 if
JAX or the JAX package was loaded.  ``--control`` (the solver in f32) and
``--fault NAME`` (the timed path broken underneath) serve the checks of
the comparison itself; the benchmark's own runs never pass them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cache_env(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    cache_env(ROOT)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    from pbkit import runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, control=args.control, fault=args.fault,
                          t_start=T_START)
    bad = runner.forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}, which the benchmark "
              f"must not load", file=sys.stderr)
        return 3
    print(runner.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

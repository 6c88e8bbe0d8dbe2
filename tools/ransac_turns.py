#!/usr/bin/env python3
"""One RANSAC call's device work, and phase 3 in turns, for checkouts of
the port.

    python3 tools/ransac_turns.py --profile TREE [TREE ...] \\
        --turns TREE [TREE ...] [--frames 150] [--out DIR]

``TREE`` is the root of a checkout holding ``irotavg_tpu_torch/`` (this
repo, or an unpacked ``git archive`` of another commit); each is run in a
process of its own, with the tree first on ``sys.path``.

``--profile``: per tree, 20 calls of ``ransac_essential`` and
``recover_pose`` at phase 3's shape (``chip_smoke.ransac_parity_inputs``:
2000 slots, 120 / 250 / 500 valid; 512 + 192 samples) after 3 warm-up
calls, under ``torch.profiler``; prints per call the CUDA kernels, the
host-to-device copies, the stream / device synchronisations and the
``aten::_local_scalar_dense`` reads (a host read of a device scalar), and
the host ms per call.  A tree whose ``ransac_essential`` takes a
``generator`` (before the port drew JAX's keys) gets a
``torch.Generator`` on the card.

``--turns``: renders phase 3's sequence once (``chip_smoke.py``'s
``write_sequence``, the first ``--frames`` frames of its lap), then runs
the ``irotavg`` CLI of each tree on it in the order given (name a tree
twice to run it twice: parent, change, change, parent), printing each
run's wall, frames/s and the CLI's per-stage means; a 3-frame run of
each tree first builds its kernels outside the turns.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PROFILE = r"""
import inspect, json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from chip_smoke import KITTI_K, ransac_parity_inputs
from irotavg_tpu_torch.geometry import essential as te
dev = torch.device("cuda")
th = torch.tensor(np.float32(1.0 / KITTI_K[0]), device=dev)
keyed = "key" in inspect.signature(te.ransac_essential).parameters
if keyed:
    from irotavg_tpu_torch import prng
else:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
inputs = [[torch.from_numpy(a).to(dev) for a in ransac_parity_inputs(1000 + i)]
          for i in range(23)]

def call(i):
    p1, p2, valid = inputs[i]
    draw = prng.key(i) if keyed else gen
    E, inl, _ = te.ransac_essential(p1, p2, valid, draw, th_norm=th,
                                    n_samples=512)
    return te.recover_pose(E, p1, p2, inl)

for i in range(3):
    call(i)
torch.cuda.synchronize()
n = 20
t0 = time.perf_counter()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for i in range(3, 3 + n):
        call(i)
    torch.cuda.synchronize()
host_ms = (time.perf_counter() - t0) * 1e3 / n
counts = dict(kernels=0, h2d=0, syncs=0, scalar_reads=0)
for e in prof.events():
    name = e.name
    dt = str(getattr(e, "device_type", ""))
    if dt.endswith("CUDA"):
        if "Memcpy HtoD" in name:
            counts["h2d"] += 1
        elif "Memcpy" not in name and "Memset" not in name:
            counts["kernels"] += 1
    elif name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize"):
        counts["syncs"] += 1
    elif name == "aten::_local_scalar_dense":
        counts["scalar_reads"] += 1
per_call = {k: v / n for k, v in counts.items()}
print(json.dumps(dict(tree=sys.argv[1], keyed=keyed, calls=n,
                      host_ms=host_ms, per_call=per_call)))
"""


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def profile_tree(tree):
    tree = os.path.abspath(tree)
    r = subprocess.run([sys.executable, "-c", PROFILE, tree, HERE],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"profile of {tree} failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def turn(tree, seq, gt, yaml, frames, out):
    tree = os.path.abspath(tree)
    res = os.path.join(out, f"res_{time.monotonic_ns()}")
    argv = [sys.executable, "-m", "irotavg_tpu_torch.app.irotavg", "none",
            yaml, seq, "--image_ext", ".pgm", "--gt", gt, "--out_dir", res,
            "--max_frames", str(frames), "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=tree)
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                       text=True, timeout=1200)
    wall = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"CLI of {tree} failed:\n{r.stderr[-4000:]}")
    stages = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
              if " frames (mean " in ln]
    return dict(tree=tree, wall_s=wall, frames_per_s=frames / wall,
                stages=stages)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", nargs="*", default=[])
    ap.add_argument("--turns", nargs="*", default=[])
    ap.add_argument("--frames", type=int, default=None)
    # the rendered frames (about 70 MB) stay on the machine that runs this
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out",
                                                  "ransac_turns"))
    args = ap.parse_args()
    print(f"card: {card()}", flush=True)
    for tree in args.profile:
        print("profile " + json.dumps(profile_tree(tree)), flush=True)
    if args.turns:
        import chip_smoke as cs

        frames = args.frames or cs.MAIN_FRAMES
        os.makedirs(args.out, exist_ok=True)
        seq, gt, yaml, _ = cs.write_sequence(args.out, cs.MAIN_LAP_FRAMES,
                                             first=frames)
        # build each tree's kernels (at its first use) outside the turns
        for tree in dict.fromkeys(args.turns):
            turn(tree, seq, gt, yaml, 3, args.out)
        for tree in args.turns:
            print("turn " + json.dumps(turn(tree, seq, gt, yaml, frames,
                                            args.out)), flush=True)


if __name__ == "__main__":
    main()

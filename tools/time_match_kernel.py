#!/usr/bin/env python3
"""Time the CUDA matcher of one copy of ``irotavg_tpu_torch`` on one card.

    python3 tools/time_match_kernel.py [DIR]

``DIR`` holds the package to time (default: this checkout), e.g. a parent
commit unpacked with ``git archive`` into a git-ignored directory.  Each
of ``chip_smoke.py``'s 15 main-shape cases (same inputs, same seed) is
timed with ``chip_smoke.py``'s method: the median of 7 windows of 50
back-to-back launches between one CUDA event pair, per launch.  A copy
whose wrapper has ``best2_launcher`` is timed through it (outputs
allocated once); an older one through ``best2`` itself, which is fair
while its kernel takes far longer than the wrapper's host work.  Compare
two copies only inside one call on one card, in turns (a, b, b, a).
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    where = os.path.abspath(argv[0] if argv else HERE)
    sys.path.insert(0, where)
    import torch

    if not torch.cuda.is_available():
        print("time_match_kernel: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from irotavg_tpu_torch.ops import match

    if not match.__file__.startswith(where):
        print(f"time_match_kernel: imported {match.__file__}, not the copy "
              f"in {where}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    card = cs._card(torch)
    for B, n1, n2 in cs.MATCH_SHAPES:
        for gate in match.GATES:
            args = cs._match_inputs(torch, B, n1, n2, gate, gen, dev)
            if hasattr(match, "best2_launcher"):
                fn = match.best2_launcher(*args, gate)[0]
            else:
                def fn(args=args, gate=gate):
                    match.best2(*args, gate)
            ms = cs._time_ms(torch, fn)
            print(f"[{os.path.relpath(where, HERE)}] match_best2 B={B} "
                  f"{n1}x{n2} {gate:>15}: {ms:.4f} ms  ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

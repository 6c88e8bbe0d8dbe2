#!/usr/bin/env python3
"""Replays every RANSAC call of ``chip_smoke.py``'s phase 3 on the CPU.

    python3 tools/ransac_replay.py [--out DIR] [--dump N]

Runs phase 3 (the port's ``irotavg`` CLI on 150 rendered KITTI-sized
frames) on the card with ``geometry/fused.py``'s RANSAC wrapped: each batch
of lanes runs on the card, then again on the CPU with the same inputs and
the same keys, and each lane's inlier masks are compared.  Prints the
number of RANSAC calls (lanes) and of calls whose masks differ; the first
``--dump`` differing calls are saved as ``DIR/mismatch_<call>.npz`` (``p1,
p2, valid, key, th``) with a line each naming the first stage that differs
(the minimal-sample hypotheses, the homography support, the Sampson
scores, the re-rank, the winner) and whether the winner's minimal sample
drew a correspondence twice.  Needs a card; about five minutes on one
H100.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def stages(p1, p2, valid, key, th_norm):
    """The intermediate results of one lane of
    ``essential.ransac_pose_lanes`` (with ``fused.py``'s sample counts), on
    the device of the inputs, moved to the CPU."""
    import torch

    from irotavg_tpu_torch.geometry import essential as te
    from irotavg_tpu_torch.geometry import fused
    from irotavg_tpu_torch.ops import draw, ransac

    f64 = torch.float64
    p1, p2, valid = p1.to(f64)[None], p2.to(f64)[None], valid[None]
    th2 = torch.as_tensor(th_norm, device=p1.device).to(f64) ** 2
    E, sup_h = te.candidate_pool(p1, p2, valid, th2, keys=[key],
                                 n_samples=fused.N_SAMPLES,
                                 h_samples=fused.H_SAMPLES)
    inl, scores = ransac.ransac_vote(E, p1, p2, valid, th2, "sampson")
    top, che = ransac.cheirality_rerank(E, inl, scores, p1, p2,
                                        te.RERANK_K)
    best, _, _ = ransac.essential_refit(top, che, inl, p1, p2)
    idx, _ = draw.draw_positions_plain(valid.cpu(), [key],
                                       ((fused.N_SAMPLES, 8),
                                        (fused.H_SAMPLES, 4)))
    out = {"E_min": E[0, :fused.N_SAMPLES], "sup_h": sup_h[0],
           "scores": scores[0], "top": top[0].long(), "che": che[0],
           "best": best[0].long()}
    return {k: v.cpu() for k, v in out.items()}, idx[0]


def first_difference(card, cpu):
    import torch

    for key in ("E_min", "sup_h", "scores", "top", "che", "best"):
        a, b = card[key], cpu[key]
        if key == "E_min":
            sgn = torch.sign((a * b).sum((-2, -1), keepdim=True))
            if float((sgn * a - b).abs().max()) > 1e-9:
                return key
        elif not torch.equal(a, b):
            return key
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out"))
    ap.add_argument("--dump", type=int, default=6)
    args = ap.parse_args(argv)
    import torch

    from irotavg_tpu_torch.geometry import fused

    os.makedirs(args.out, exist_ok=True)
    card_name = cs.phase_device()
    run = fused.ransac_pose_lanes
    tally = {"calls": 0, "differ": 0}

    def replayed(p1, p2, valid, th_norm, *, keys, **kw):
        out = run(p1, p2, valid, th_norm, keys=keys, **kw)
        inl = out[1]
        host = [t.cpu() for t in (p1, p2, valid)]
        th = torch.as_tensor(th_norm).cpu()
        inl_cpu = run(*host, th, keys=keys, **kw)[1]
        for k, key in enumerate(keys):
            tally["calls"] += 1
            if torch.equal(inl[k].cpu(), inl_cpu[k]):
                continue
            tally["differ"] += 1
            if tally["differ"] > args.dump:
                continue
            lane = [t[k] for t in (p1, p2, valid)]
            card, idx = stages(*lane, key, th_norm)
            cpu, _ = stages(*(t.cpu() for t in lane), key, th)
            winners = [int(card["best"]), int(cpu["best"])]
            twice = [w < len(idx) and len(set(idx[w].tolist())) < 8
                     for w in winners]
            print("[replay] " + json.dumps({
                "call": tally["calls"], "valid": int(host[2][k].sum()),
                "first_difference": first_difference(card, cpu),
                "winners_card_cpu": winners,
                "winner_drew_a_correspondence_twice": twice}),
                file=sys.stderr, flush=True)
            np.savez(os.path.join(args.out,
                                  f"mismatch_{tally['calls']}.npz"),
                     p1=host[0][k].numpy(), p2=host[1][k].numpy(),
                     valid=host[2][k].numpy(), key=np.array(key),
                     th=th.numpy())
        return out

    fused.ransac_pose_lanes = replayed
    cs.hold_to_cpu = lambda *a, **k: None       # report, do not hold
    try:
        cs.phase_main_path(card_name, args.out)
    finally:
        fused.ransac_pose_lanes = run
    print(f"[replay] phase 3: {tally['calls']} RANSAC calls on the card, "
          f"{tally['differ']} with another inlier mask than the same call "
          f"on the CPU  ({card_name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Replays every RANSAC call of ``chip_smoke.py``'s phase 3 on the CPU.

    python3 tools/ransac_replay.py [--out DIR] [--dump N]

Runs phase 3 (the port's ``irotavg`` CLI on 150 rendered KITTI-sized
frames) on the card with ``geometry/fused.py``'s RANSAC wrapped: each call
runs on the card, then again on the CPU with the same inputs and the same
drawn positions, and the two inlier masks are compared.  Prints the number
of calls and of calls whose masks differ; the first ``--dump`` differing
calls are saved as ``DIR/mismatch_<call>.npz`` (``p1, p2, valid, idx,
idx_h, th``) with a line each naming the first stage that differs (the
minimal-sample hypotheses, the homography support, the Sampson scores, the
re-rank, the winner) and whether the winner's minimal sample drew a
correspondence twice.  Needs a card; about five minutes on one H100.
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


def stages(p1, p2, valid, idx, idx_h, th_norm):
    """The intermediate results of ``essential.ransac_drawn``, on the
    device of the inputs, moved to the CPU."""
    import torch

    from irotavg_tpu_torch.geometry import essential as te

    f64 = torch.float64
    p1, p2 = p1.to(f64), p2.to(f64)
    th2 = torch.as_tensor(th_norm, device=p1.device).to(f64) ** 2
    E_min = te._project_essential(te._eight_point_samples(p1, p2, idx))
    Hc = te._homography_samples(p1, p2, idx_h)
    sup_h = te._transfer_support(Hc, p1, p2, valid[None, :], 4.0 * th2)
    H_best = Hc[torch.argmax(sup_h)]
    hinl = te._transfer_inliers(H_best, p1, p2, valid, 4.0 * th2)
    H_ref = te._homography_ls(p1, p2, hinl.to(f64))
    sup_ref = te._transfer_support(H_ref, p1, p2, valid, 4.0 * th2)
    Rh, th_ = te._decompose_homography(
        torch.where(sup_ref >= sup_h.max(), H_ref, H_best))
    E = torch.cat([E_min, te._project_essential(te._skew(th_) @ Rh)])
    inl = (te.sampson_distance(E, p1, p2) < th2) & valid[None]
    scores = inl.sum(1)
    top = torch.sort(scores, descending=True, stable=True)[1][:te.RERANK_K]
    che = te._cheirality_counts(E[top], p1, p2, inl[top])
    out = {"E_min": E_min, "sup_h": sup_h, "scores": scores, "top": top,
           "che": che, "best": top[torch.argmax(che)]}
    return {k: v.cpu() for k, v in out.items()}


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
    run = fused.ransac_drawn
    tally = {"calls": 0, "differ": 0}

    def replayed(p1, p2, valid, idx, idx_h, *, th_norm, **kw):
        E, inl, n = run(p1, p2, valid, idx, idx_h, th_norm=th_norm, **kw)
        host = [t.cpu() for t in (p1, p2, valid, idx, idx_h)]
        th = torch.as_tensor(th_norm).cpu()
        _, inl_cpu, _ = run(*host, th_norm=th, **kw)
        tally["calls"] += 1
        if not torch.equal(inl.cpu(), inl_cpu):
            tally["differ"] += 1
            if tally["differ"] <= args.dump:
                card = stages(p1, p2, valid, idx, idx_h, th_norm)
                cpu = stages(*host, th)
                winners = [int(card["best"]), int(cpu["best"])]
                twice = [w < len(host[3]) and len(set(host[3][w].tolist())) < 8
                         for w in winners]
                print("[replay] " + json.dumps({
                    "call": tally["calls"], "valid": int(host[2].sum()),
                    "first_difference": first_difference(card, cpu),
                    "winners_card_cpu": winners,
                    "winner_drew_a_correspondence_twice": twice}),
                    file=sys.stderr, flush=True)
                np.savez(os.path.join(args.out,
                                      f"mismatch_{tally['calls']}.npz"),
                         p1=host[0].numpy(), p2=host[1].numpy(),
                         valid=host[2].numpy(), idx=host[3].numpy(),
                         idx_h=host[4].numpy(), th=th.numpy())
        return E, inl, n

    fused.ransac_drawn = replayed
    cs.hold_to_cpu = lambda *a, **k: None       # report, do not hold
    try:
        cs.phase_main_path(card_name, args.out)
    finally:
        fused.ransac_drawn = run
    print(f"[replay] phase 3: {tally['calls']} RANSAC calls on the card, "
          f"{tally['differ']} with another inlier mask than the same call "
          f"on the CPU  ({card_name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

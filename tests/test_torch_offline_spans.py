"""The offline pipeline's plan, its global solve and its program spans on
the CPU, against the benchmark's plain reference (``portbench/reference``,
which imports nothing of the port).

``run_offline`` on a seeded sequence keeps the keyframes and window pairs
that ``reference/offline.py:plan`` derives from the job's own consecutive
flows, and searches each pair at the plan's radius; ``solve_global``
equals ``reference/rotavg.py``'s spanning-tree start, L1-RA and IRLS.
Under a CPU ``torch.profiler`` session the job records its seven
``offline.*`` spans, nested as the stages run, with attributes equal to
what the stages did; without one it records none."""

import gzip
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from irotavg_tpu_torch.config import PipelineConfig
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.geometry import fused
from irotavg_tpu_torch.pipeline import offline
from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
from irotavg_tpu_torch.utils import timing
from seqgen import make_sequence
from synth import make_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "portbench") not in sys.path:
    sys.path.append(os.path.join(ROOT, "portbench"))
from reference import offline as ref, rotavg  # noqa: E402

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

GATE_PX, WIN, BATCH, CHUNK = 5.0, 4, 4, 8
VOCAB = os.path.join(ROOT, "tests", "data", "product_vocab_k10_L5_v1.txt.gz")
STAGES = ("offline.extract", "offline.flow", "offline.pairs", "offline.loop",
          "offline.solve")
PARENTS = {**{s: {"offline.job"} for s in STAGES},
           "offline.pair_chunk": {"offline.pairs", "offline.loop"}}


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_bytes(gzip.decompress(open(VOCAB, "rb").read()))
    return Vocabulary.load_text(str(path), device="cpu")


def _job(n_frames, vocab, traced):
    """One job on a seeded sequence with the pair estimates' arguments
    and refine batches recorded; returns (result, spans, calls, refines).
    The loop stage is handed one candidate, the last keyframe against the
    first, so that its verification runs."""
    frames, K, _ = make_sequence(n_frames=n_frames, seed=1, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
                 height=480)
    ext = ORBExtractor(n_features=1200, n_levels=8, device="cpu")
    calls, refines = [], []
    mp = pytest.MonkeyPatch()
    pair_est, refine = offline.fused_pair_estimate_gather, fused.fused_refine

    def recording(*a, **kw):
        out = pair_est(*a, **kw)
        calls.append((a[6].numpy(), a[7].numpy(), a[8].numpy()))
        return out

    def counted_refine(f1, *a, **kw):
        # the lanes that refine; the others ride along frozen
        refines.append(f1[0].shape[0] - sum(kw.get("frozen") or ()))
        return refine(f1, *a, **kw)

    mp.setattr(offline, "fused_pair_estimate_gather", recording)
    mp.setattr(fused, "fused_refine", counted_refine)
    mp.setattr(offline, "_loop_candidates",
               lambda vocab, desc, valid, kf, *a: [(0, len(kf) - 1)])
    timing.clear_spans()
    try:
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                res = offline.run_offline(
                    frames, cam, ext, vocab=vocab,
                    cfg=PipelineConfig(), batch=BATCH, chunk=CHUNK,
                    min_matches=60, win_size=WIN)
        else:
            res = offline.run_offline(frames, cam, ext, vocab=vocab,
                                      cfg=PipelineConfig(), batch=BATCH,
                                      chunk=CHUNK, min_matches=60,
                                      win_size=WIN)
    finally:
        mp.undo()
    spans = timing.recorded_spans()
    timing.clear_spans()
    return res, spans, calls, refines


@pytest.fixture(scope="module")
def runs(vocab):
    """A traced 12-frame job and an untraced 6-frame one."""
    return {"traced": _job(12, vocab, True), "untraced": _job(6, vocab,
                                                              False)}


@pytest.mark.parametrize("which", ["traced", "untraced"])
def test_keyframes_and_window_pairs_follow_the_plan(runs, which):
    res, _, calls, _ = runs[which]
    kf, pairs, radii = ref.plan(res.flows, GATE_PX, WIN)
    assert len(res.flows) == (12 if which == "traced" else 6) - 1
    assert res.keyframes == kf
    assert res.stats["pairs_total"] == len(pairs)
    assert res.stats["pairs_connected"] == len(pairs)
    # the first pass of stage 3 searched every planned pair at its radius
    first = calls[:math.ceil(len(pairs) / CHUNK)]
    ia, ib, rad = (np.concatenate(x) for x in zip(*first))
    np.testing.assert_array_equal(ia, np.asarray(kf)[pairs[:, 0]])
    np.testing.assert_array_equal(ib, np.asarray(kf)[pairs[:, 1]])
    np.testing.assert_array_equal(rad, radii)
    window = res.edges[~res.loop_mask]
    assert sorted(map(tuple, window.tolist())) == sorted(
        map(tuple, pairs.tolist()))


def test_untraced_job_records_no_span(runs):
    _, spans, calls, _ = runs["untraced"]
    assert spans == [] and calls


def test_offline_spans_nest(runs):
    res, spans, _, _ = runs["traced"]
    names = [n for n, *_ in spans]
    assert set(STAGES) | {"offline.job", "offline.pair_chunk"} <= set(names)
    assert names.count("offline.job") == 1
    assert all(e is not None and e >= s for _, s, e, _, _ in spans)
    for name, s, e, parent, _ in spans:
        if not name.startswith("offline.") or name == "offline.job":
            continue
        pname, ps, pe = spans[parent][:3]
        assert pname in PARENTS[name], (name, pname)
        assert ps <= s and e <= pe
    # the solver's own spans inside the global solve
    solve = names.index("offline.solve")
    kids = {spans[k][0] for k in range(len(spans)) if spans[k][3] == solve}
    assert kids == {"solver.init_mst", "solver.l1ra", "solver.irls"}


def test_offline_span_attributes(runs):
    res, spans, calls, refines = runs["traced"]
    by = {}
    for i, (name, _, _, parent, attrs) in enumerate(spans):
        by.setdefault(name, []).append((i, parent, attrs))
    (_, _, job), = by["offline.job"]
    assert job == {"frames": 12, "keyframes": len(res.keyframes)}
    assert by["offline.extract"][0][2] == {"frames": 12,
                                           "batches": math.ceil(12 / BATCH)}
    assert by["offline.flow"][0][2] == {"pairs": 11}
    (pi, _, pairs), = by["offline.pairs"]
    chunks = [(p, a) for _, p, a in by["offline.pair_chunk"]]
    assert len(chunks) == len(calls)
    assert [a["lanes"] for _, a in chunks] == [len(c[0]) for c in calls]
    in_pairs = [a for p, a in chunks if p == pi]
    total = res.stats["pairs_total"]
    assert pairs == {"pairs": total, "chunks": len(in_pairs),
                     "retried": sum(a["lanes"] for a in in_pairs) - total,
                     "connected": res.stats["pairs_connected"]}
    # one refine call a chunk that refined, on the lanes it counted
    assert [a["refined"] for _, a in chunks if a["refined"]] == refines
    (_, _, loop), = by["offline.loop"]
    assert loop["candidates"] == res.stats["loop_candidate_pairs"] == 1
    assert loop["loop_edges"] == res.loop_edges <= loop["verified"] <= 1
    (_, _, solve), = by["offline.solve"]
    assert solve == {"n": len(res.keyframes), "m": len(res.edges)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_global_equals_the_reference(seed):
    """Stage 5 on a seeded random graph (30 views, 120 edges, 10%
    outliers) against the benchmark's plain solver from the same edges."""
    p = make_problem(n=30, extra_edges=91, noise_deg=2.0, outlier_frac=0.1,
                     seed=seed)
    edges = np.asarray(p["edges"], np.int64)
    order = np.lexsort((edges[:, 0], edges[:, 1]))
    edges, QQ = edges[order], np.asarray(p["QQ"], np.float64)[order]
    assert len(edges) == 120
    cfg = PipelineConfig()
    Q, _ = offline.solve_global(edges, QQ, 30, cfg, torch.device("cpu"))
    Q_ref = ref.resolve(edges, QQ, 30, {
        "sigma_deg": cfg.solver.sigma_deg, "l1_iters": cfg.solver.l1_iters,
        "irls_iters": cfg.solver.irls_iters,
        "change_th": cfg.solver.change_th})
    assert rotavg.geodesic_deg(Q, Q_ref).max() < 1e-9

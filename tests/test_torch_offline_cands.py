"""The offline pipeline's loop candidates: the port's ``_loop_candidates``
(the keyframes' BoW in batched descents, the inverted-file cascade and
the consecutive-group consistency) against the JAX ``run_offline``'s loop
stage, on the same JAX-extracted features, keyframes, window edges and
match counts.  The candidate pairs must be equal, in order.

Run as a script, the file is the diagnosis behind that test: the offline
pipeline of both packages on ``chip_smoke.py``'s phase-4 frames, stage by
stage, to show where their loop edges and their rotation errors part.

    PYTHONPATH=. python3 tests/test_torch_offline_cands.py [--seed 0] \\
        [--runs jax port_jaxfeat port] [--device cpu|cuda] \\
        [--save-features] [--features NPZ] [--diff-features NPZ] \\
        [--saved NAME=NPZ ...] [--first N] [--out DIR]

It renders the 241-frame two-lap orbit (1241x376, 2000 ORB features),
decompresses the repo's k=10, L=5 vocabulary and runs ``run_offline``
with the ``irotavg_batch`` CLI's settings:

* ``jax``: the JAX package (its own extraction);
* ``port_jaxfeat``: the port on the CPU fed the JAX run's extracted
  features (``interop.features_from_arrays``), so only the stages after
  extraction differ;
* ``port``: the port with its own extraction on ``--device`` (the CPU by
  default; ``cuda`` imports no JAX, so it runs where JAX is missing);
  ``--save-features`` keeps its features in ``DIR/feats.npz``;
* ``port_feat``: the port on the CPU fed the features of ``--features``
  (a ``feats.npz`` from an earlier call, e.g. the card's).

``--saved`` adds runs saved by an earlier call (``DIR/<run>.npz``) to the
comparison; ``--diff-features`` holds a saved ``feats.npz`` against the
port's extraction on the CPU, frame by frame.  For each run it prints the
loop candidates, the loop pairs past the success flag and the
``loop.min_matches`` gate, and each edge's rotation error against GT
(measured and solved), split into window edges by span and loop edges;
then, for each two runs, the candidates and passing pairs on one side
only, and each run's graph re-solved on the CPU without the loop edges
the other lacks.  10 to 20 minutes a CPU run on 8 cores; about 2 minutes
a card run.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
import types

import numpy as np
import pytest
import torch

from irotavg_tpu_torch.config import LoopClosureConfig, PipelineConfig
from irotavg_tpu_torch.interop import (
    features_from_arrays, vocabulary_from_arrays,
)
from irotavg_tpu_torch.pipeline import offline as toffline
from irotavg_tpu_torch.pipeline.offline import (
    LOOP_SEED, RETRY_SEED, _loop_candidates,
)

torch.set_num_threads(1)

SEED = 0
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what run_offline reads of the extracted features
FEATURE_KEYS = ("desc", "valid", "octave", "angle", "x0", "y0")


def _kind(key, seed):
    """The stage of a pair estimate from its chunk key: window pairs are
    keyed ``seed + lo``, retries ``seed + RETRY_SEED + lo``, loop pairs
    ``seed + LOOP_SEED + lo``."""
    d = (int(key) - seed) & 0xFFFFFFFF
    return "loop" if d >= LOOP_SEED else "retry" if d >= RETRY_SEED \
        else "window"


def loop_pairs(recs, seed, keyframes):
    """The loop stage's pairs as keyframe indices, in call order, each
    once (a chunk is padded by repeating its last pair): ``{pair: (final
    match count, success)}``."""
    index = {f: k for k, f in enumerate(keyframes)}
    loop = {}
    for ia, ib, key, n, s in recs:
        if _kind(key, seed) == "loop":
            for p in range(len(n)):
                loop.setdefault((index[int(ia[p])], index[int(ib[p])]),
                                (int(n[p]), bool(s[p])))
    return loop


def run_jax(images, camera, extractor, vocab, cfg, seed, **kw):
    """The JAX ``run_offline`` with every pair estimate and extracted batch
    recorded: (result, ``[(ia, ib, key, final match counts, success)]``,
    the extracted features stacked per frame)."""
    import jax

    from irotavg_tpu.geometry import fused as jfused
    from irotavg_tpu.pipeline import offline as joffline

    calls, feats = [], []
    pair_est, ext_batched = jfused.fused_pair_estimate_gather, \
        joffline._ext_batched

    def rec_pairs(*a, **kw):
        out = pair_est(*a, **kw)
        calls.append((np.asarray(a[6]), np.asarray(a[7]), int(a[13]), out))
        return out

    def rec_ext(params):
        fn = ext_batched(params)

        def wrapped(imgs):
            out = fn(imgs)
            feats.append(out)
            return out
        return wrapped

    jfused.fused_pair_estimate_gather = rec_pairs
    joffline._ext_batched = rec_ext
    try:
        res = joffline.run_offline(images, camera, extractor, vocab=vocab,
                                   cfg=cfg, seed=seed, **kw)
    finally:
        jfused.fused_pair_estimate_gather = pair_est
        joffline._ext_batched = ext_batched
    recs = []
    for ia, ib, key, out in calls:
        _, _, _, _, m12, success = jax.device_get(out)
        recs.append((ia, ib, key, (np.asarray(m12) >= 0).sum(axis=1),
                     np.asarray(success)))
    stacked = {k: np.concatenate([np.asarray(f[k]) for f in feats])[
        :len(images)] for k in feats[0]}
    return res, recs, stacked


def test_loop_candidates_equal_jax():
    from irotavg_tpu.config import LoopClosureConfig as JLoopCfg
    from irotavg_tpu.config import PipelineConfig as JPipelineCfg
    from irotavg_tpu.frontend import Camera as JaxCamera
    from irotavg_tpu.frontend import ORBExtractor as JaxORB
    from irotavg_tpu.placerec import train_vocabulary
    from seqgen import make_sequence

    frames, K, _ = make_sequence(n_frames=14, seed=4, step=0.3,
                                 yaw_deg_per_frame=-1.2, loop=True)
    jext = JaxORB(n_features=1000, n_levels=8)
    sample = []
    for im in frames[::4]:
        o = {k: np.asarray(v) for k, v in jext(im).items()}
        sample.append(o["desc"][o["valid"]][:300])
    jv = train_vocabulary(sample, k=8, L=3, seed=0)
    h, w = frames[0].shape
    res, recs, stacked = run_jax(
        frames, JaxCamera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                          width=w, height=h),
        JaxORB(n_features=1000, n_levels=8), jv,
        JPipelineCfg(loop=JLoopCfg(covisibility_consistency_th=1,
                                   min_matches=60)),
        SEED, batch=4, chunk=8, min_matches=60, win_size=4)
    want = list(loop_pairs(recs, SEED, res.keyframes))
    assert len(want) >= 2, "no loop candidates on the out-and-back sequence"

    t = features_from_arrays([{k: v[i] for k, v in stacked.items()}
                              for i in range(len(frames))], device="cpu")
    vocab = vocabulary_from_arrays(jv.k, jv.L, jv.children, jv.node_desc,
                                   jv.weight, jv.word_id, jv.is_leaf,
                                   jv.scoring, jv.weighting, device="cpu")
    # the window edges in the order the stage saw them (keyframe b
    # ascending, then a descending), with their final match counts
    win = ~res.loop_mask
    edges, n_matches = res.edges[win], res.n_matches[win]
    order = np.lexsort((-edges[:, 0], edges[:, 1]))
    cfg = PipelineConfig(loop=LoopClosureConfig(
        covisibility_consistency_th=1, min_matches=60))
    got = _loop_candidates(vocab, t["desc"], t["valid"],
                           np.asarray(res.keyframes), edges[order].astype(
                               np.int64), n_matches[order], cfg)
    assert got == want
    assert res.stats["loop_candidate_pairs"] == len(want)


def _revisits(n_places, laps, n_desc, seed):
    """Descriptors of ``n_places * laps`` keyframes that revisit
    ``n_places`` places lap after lap (each place's (n_desc, 8) int32
    words with a few bits flipped a visit), all valid, and window edges
    ``(i - d, i)`` for d = 1, 2, 3 with match counts falling with d (ties
    included)."""
    rng = np.random.default_rng(seed)
    places = rng.integers(0, 2**32, (n_places, n_desc, 8), dtype=np.uint64)
    K = n_places * laps
    desc = places[np.arange(K) % n_places]
    flips = rng.integers(0, 32, (K, n_desc, 8), dtype=np.uint64)
    desc = desc ^ np.where(rng.random((K, n_desc, 8)) < 0.1, 1 << flips, 0)
    desc = torch.from_numpy(desc.astype(np.uint32).view(np.int32))
    edges = np.array([(i - d, i) for i in range(1, K) for d in (1, 2, 3)
                      if i - d >= 0], np.int64)
    n_matches = np.array([400 - 50 * (b - a) + (b % 2) for a, b in edges])
    return desc, torch.ones(desc.shape[:2], dtype=torch.bool), edges, \
        n_matches


@pytest.mark.parametrize("consistency_th", [1, 7])
def test_loop_candidates_equal_engine(consistency_th):
    """Given the same keyframe BoW and the same adjacency, the engine's
    loop methods, asked keyframe by keyframe in order (candidates,
    consistency, then the database insert), give the (candidate, query)
    pairs of the offline pipeline's ``_loop_candidates``."""
    from irotavg_tpu_torch.engine.viewgraph import ViewGraph
    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.placerec.vocabulary import make_random_vocabulary

    vocab = make_random_vocabulary(k=10, L=3, seed=1, device="cpu")
    desc, valid, edges, n_matches = _revisits(10, 3, 200, seed=2)
    kf = np.arange(len(desc))
    cfg = LoopClosureConfig(covisibility_consistency_th=consistency_th)
    want = _loop_candidates(vocab, desc, valid, kf, edges, n_matches,
                            PipelineConfig(loop=cfg))

    vg = ViewGraph(Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                          width=640, height=480), device="cpu",
                   loop_cfg=cfg)
    vg.frames = [types.SimpleNamespace(bow=vocab.transform(desc[k],
                                                           valid[k])[0])
                 for k in kf]
    for (a, b), nm in zip(edges, n_matches):  # the whole graph, as offline
        vg.adjacency.setdefault(int(a), {})[int(b)] = int(nm)
        vg.adjacency.setdefault(int(b), {})[int(a)] = int(nm)
    got = []
    for k in kf:
        cands = vg.detect_loop_candidates(int(k))
        got += [(c, int(k)) for c in vg.check_loop_consistency(cands)]
        vg.add_to_database(int(k))
    assert got == want
    assert len(want) >= 2, "no consistent loop candidates on the revisits"


# -- the diagnosis (run as a script) ------------------------------------------


class _FixedFeatures:
    """An extractor stand-in that hands out precomputed (B, N, ...)
    features batch by batch, in order."""

    def __init__(self, feats, device):
        self.feats, self.device, self._at = feats, device, 0

    def extract_batch(self, images):
        lo, self._at = self._at, self._at + len(images)
        return {k: v[lo:self._at] for k, v in self.feats.items()}


def run_port(images, cam_args, vocab_path, seed, feats=None,
             device="cpu", save_features=None):
    """The port's ``run_offline`` with every pair estimate recorded, on its
    own extraction or fed ``feats``: (result, records as
    :func:`run_jax`'s)."""
    from irotavg_tpu_torch.frontend.camera import Camera
    from irotavg_tpu_torch.frontend.orb import ORBExtractor
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary

    calls = []
    pair_est = toffline.fused_pair_estimate_gather

    def rec_pairs(*a, **kw):
        out = pair_est(*a, **kw)
        calls.append((a[6].cpu().numpy(), a[7].cpu().numpy(), int(a[13]),
                      (out[4] >= 0).sum(dim=1).cpu().numpy(),
                      np.asarray(out[5], bool)))
        return out

    if feats is None:
        ext = ORBExtractor(n_features=2000, n_levels=8, device=device)
    else:
        per_frame = [{k: v[i] for k, v in feats.items()}
                     for i in range(len(images))]
        ext = _FixedFeatures(features_from_arrays(per_frame, device="cpu"),
                             torch.device("cpu"))
    if save_features:
        batches, extract = [], ext.extract_batch

        def recording(imgs):
            out = extract(imgs)
            batches.append({k: v.cpu().numpy() for k, v in out.items()
                            if k in FEATURE_KEYS})
            return out
        ext.extract_batch = recording
    toffline.fused_pair_estimate_gather = rec_pairs
    try:
        res = toffline.run_offline(
            images, Camera(**cam_args), ext,
            vocab=Vocabulary.load_text(vocab_path, device=ext.device),
            cfg=PipelineConfig(), seed=seed)
    finally:
        toffline.fused_pair_estimate_gather = pair_est
    if save_features:
        np.savez_compressed(save_features, **{
            k: np.concatenate([b[k] for b in batches]) for k in FEATURE_KEYS})
    return res, calls


def _angle_deg(Ra, Rb):
    """Angle (deg) of Ra Rb^T for stacks of rotation matrices."""
    c = (np.einsum("nij,nij->n", Ra, Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def edge_errors(res, R_gt):
    """Per edge: the measured and the solved relative rotation's error
    (deg) against GT (``R_j ~ R_ij R_i``, world->camera rotations)."""
    from scipy.spatial.transform import Rotation as Rsc

    kf = np.asarray(res.keyframes)
    a, b = res.edges[:, 0], res.edges[:, 1]
    rel_gt = R_gt[kf[b]] @ np.swapaxes(R_gt[kf[a]], 1, 2)
    meas = Rsc.from_quat(res.QQ).as_matrix()
    R = Rsc.from_quat(res.Q).as_matrix()
    solved = R[b] @ np.swapaxes(R[a], 1, 2)
    return _angle_deg(meas, rel_gt), _angle_deg(solved, rel_gt)


def summarise(name, res, recs, seed, R_gt, cfg_min):
    """Prints the run's loop stage and error split; returns its loop
    records, the pairs that pass, and the per-edge errors."""
    loop = loop_pairs(recs, seed, res.keyframes)
    passed = {p for p, (n, s) in loop.items() if s and n >= cfg_min}
    meas, solved = edge_errors(res, R_gt)
    span = res.edges[:, 1] - res.edges[:, 0]
    print(f"== {name}: keyframes {len(res.keyframes)}, edges {len(res.edges)}"
          f" ({res.loop_edges} loop), loop candidates "
          f"{res.stats.get('loop_candidate_pairs')}, recorded loop pairs "
          f"{len(loop)}, passing {len(passed)}; solve "
          f"{res.stats['irls_iters']} IRLS iterations")
    for label, sel in [(f"window span {s}", (~res.loop_mask) & (span == s))
                       for s in range(1, 5)] + [
            ("loop", res.loop_mask), ("all", np.ones(len(span), bool))]:
        if sel.any():
            print(f"   {label:14s} n {int(sel.sum()):4d}  measured error "
                  f"mean {meas[sel].mean():.4f} rms "
                  f"{np.sqrt((meas[sel] ** 2).mean()):.4f} max "
                  f"{meas[sel].max():.4f} deg; solved mean "
                  f"{solved[sel].mean():.4f} rms "
                  f"{np.sqrt((solved[sel] ** 2).mean()):.4f} max "
                  f"{solved[sel].max():.4f} deg")
    return loop, passed, meas, solved


def diff_features(images, path):
    """Per frame, a saved extraction against the port's on the CPU: the
    keypoints (x0, y0, octave, valid) that are equal, the descriptors of
    equal keypoints that are bit-equal, and the largest angle difference;
    prints the totals and the frames that differ."""
    from irotavg_tpu_torch.frontend.orb import ORBExtractor

    ext = ORBExtractor(n_features=2000, n_levels=8, device="cpu")
    z = np.load(path)
    tot = dict(kp=0, kp_eq=0, desc_eq=0, angle=0.0)
    for i, im in enumerate(images):
        out = {k: v.numpy() for k, v in ext(im).items()}
        v = z["valid"][i] & out["valid"]
        kp = v & (z["x0"][i] == out["x0"]) & (z["y0"][i] == out["y0"]) & (
            z["octave"][i] == out["octave"])
        deq = kp & (z["desc"][i] == out["desc"]).all(axis=1)
        da = float(np.abs(z["angle"][i] - out["angle"])[kp].max(initial=0))
        n = int(z["valid"][i].sum())
        tot["kp"] += n
        tot["kp_eq"] += int(kp.sum())
        tot["desc_eq"] += int(deq.sum())
        tot["angle"] = max(tot["angle"], da)
        if kp.sum() != n or deq.sum() != kp.sum() or (
                z["valid"][i] != out["valid"]).any():
            print(f"   frame {i}: {n} keypoints saved, {int(kp.sum())} equal "
                  f"on the CPU, {int(deq.sum())} with equal descriptors, "
                  f"angle max |d| {da:.3e} rad")
    print(f"== features of {path} against the CPU extraction: "
          f"{tot['kp_eq']} of {tot['kp']} keypoints equal, "
          f"{tot['desc_eq']} of them with bit-equal descriptors, angle max "
          f"|d| {tot['angle']:.3e} rad", flush=True)


def resolve_rmse(run, drop, out):
    """``run``'s graph without the edges ``drop`` through the pipeline's
    global solve (``pipeline.offline.solve_global``, f64 on the CPU):
    (rotation RMSE against GT in deg, keyframes)."""
    import chip_smoke as cs
    from offline_seeds import write_outputs

    keep = np.array([(int(a), int(b)) not in drop for a, b in run["edges"]])
    K = len(run["keyframes"])
    Q, _ = toffline.solve_global(run["edges"][keep], run["QQ"][keep], K,
                                 PipelineConfig(), "cpu")
    res = types.SimpleNamespace(Q=Q, keyframes=run["keyframes"])
    return cs.rotation_rmse_deg(*write_outputs(res, os.path.join(
        out, "resolved")), run["R_gt"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", nargs="*", default=["jax", "port_jaxfeat",
                                                  "port"])
    ap.add_argument("--device", default="cpu",
                    help="device of the port's own-extraction run")
    ap.add_argument("--save-features", action="store_true",
                    help="keep the port run's features in DIR/feats.npz")
    ap.add_argument("--features", default=None,
                    help="a feats.npz for the port_feat run")
    ap.add_argument("--diff-features", default=None, metavar="NPZ",
                    help="compare saved features with the CPU extraction")
    ap.add_argument("--saved", nargs="*", default=[], metavar="NAME=NPZ",
                    help="runs saved by an earlier call, compared too")
    ap.add_argument("--first", type=int, default=None,
                    help="render only the first N frames (a quick check)")
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out",
                                                  "offline_compare"))
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # the module's single thread is for the test under pytest-xdist
    torch.set_num_threads(os.cpu_count() or 1)
    sys.path[:0] = [HERE, os.path.join(HERE, "tools")]

    import chip_smoke as cs
    from offline_seeds import write_outputs

    from irotavg_tpu_torch.utils.sequence import load_gray

    cfg_min = PipelineConfig().loop.min_matches
    runs, jax_feats = {}, None
    if args.runs or args.diff_features:
        seq, _gt, _yaml, R_gt = cs.write_sequence(
            args.out, cs.LOOP_FRAMES, laps=2.0, spiral=cs.LOOP_SPIRAL,
            first=args.first)
        vocab = cs.vocab_file(args.out)
        fx, fy, cx, cy = cs.KITTI_K
        cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=cs.KITTI_W,
                   height=cs.KITTI_H)
        images = [load_gray(os.path.join(seq, n))
                  for n in sorted(os.listdir(seq))]
        shutil.rmtree(seq)
    if args.diff_features:
        diff_features(images, args.diff_features)
    for name in args.runs:
        t0 = time.perf_counter()
        if name == "jax":
            from irotavg_tpu.config import PipelineConfig as JPipelineCfg
            from irotavg_tpu.frontend import Camera as JaxCamera
            from irotavg_tpu.frontend import ORBExtractor as JaxORB
            from irotavg_tpu.placerec.vocabulary import Vocabulary as JVocab

            res, recs, jax_feats = run_jax(
                images, JaxCamera(**cam), JaxORB(n_features=2000,
                                                 n_levels=8),
                JVocab.load_text(vocab), JPipelineCfg(), args.seed)
        elif name == "port_jaxfeat":
            if jax_feats is None:
                raise SystemExit("port_jaxfeat needs the jax run first")
            res, recs = run_port(images, cam, vocab, args.seed, jax_feats)
        elif name == "port_feat":
            with np.load(args.features) as z:
                res, recs = run_port(images, cam, vocab, args.seed,
                                     {k: z[k] for k in FEATURE_KEYS})
        else:
            res, recs = run_port(
                images, cam, vocab, args.seed, device=args.device,
                save_features=(os.path.join(args.out, "feats.npz")
                               if args.save_features else None))
        rmse, _ = cs.rotation_rmse_deg(
            *write_outputs(res, os.path.join(args.out, name)), R_gt)
        where = args.device if name == "port" else "cpu"
        print(f"{name}: rotation RMSE {rmse!r} deg, "
              f"{time.perf_counter() - t0:.1f} s ({where})", flush=True)
        loop, passed, meas, solved = summarise(name, res, recs, args.seed,
                                               R_gt, cfg_min)
        runs[name] = dict(keyframes=list(res.keyframes), loop=loop,
                          passed=passed, edges=res.edges, QQ=res.QQ,
                          R_gt=R_gt)
        lk = sorted(loop)
        np.savez(os.path.join(args.out, f"{name}.npz"), Q=res.Q,
                 keyframes=res.keyframes, edges=res.edges, QQ=res.QQ,
                 n_matches=res.n_matches, loop_mask=res.loop_mask,
                 meas_err=meas, solved_err=solved, rmse=rmse, R_gt=R_gt,
                 loop_pairs=np.array(lk, np.int64).reshape(-1, 2),
                 loop_counts=np.array([loop[p][0] for p in lk], np.int64),
                 loop_success=np.array([loop[p][1] for p in lk], bool))
        sys.stdout.flush()
    for item in args.saved:
        name, path = item.split("=", 1)
        z = np.load(path)
        loop = {tuple(map(int, p)): (int(n), bool(ok)) for p, n, ok in zip(
            z["loop_pairs"], z["loop_counts"], z["loop_success"])}
        runs[name] = dict(keyframes=z["keyframes"].tolist(), loop=loop,
                          passed={p for p, (n, ok) in loop.items()
                                  if ok and n >= cfg_min},
                          edges=z["edges"], QQ=z["QQ"], R_gt=z["R_gt"])
        print(f"== {name} (saved): rotation RMSE {float(z['rmse'])!r} deg, "
              f"loop edges {int(z['loop_mask'].sum())}, recorded loop pairs "
              f"{len(loop)}")
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            ra, rb = runs[a], runs[b]
            la, pa, lb, pb = ra["loop"], ra["passed"], rb["loop"], \
                rb["passed"]
            print(f"== {a} vs {b}: keyframes equal "
                  f"{ra['keyframes'] == rb['keyframes']}; candidates only in "
                  f"{a}: {sorted(set(la) - set(lb))}, only in {b}: "
                  f"{sorted(set(lb) - set(la))}")
            for p in sorted(pa ^ pb):
                print(f"   pair {p} passes in {a if p in pa else b} only: "
                      f"{a} {la.get(p)}, {b} {lb.get(p)} (count, success; "
                      f"gate {cfg_min})")
            for name, extra in ((a, pa - pb), (b, pb - pa)):
                if extra:
                    full, _ = resolve_rmse(runs[name], set(), args.out)
                    cut, _ = resolve_rmse(runs[name], extra, args.out)
                    print(f"   {name}'s graph re-solved on the CPU: RMSE "
                          f"{full!r} deg; without its {len(extra)} loop "
                          f"edges missing in the other run: {cut!r} deg")
    return 0


if __name__ == "__main__":
    sys.exit(main())

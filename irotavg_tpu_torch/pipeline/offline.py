"""Offline batched rotation-averaging pipeline.

Port of ``irotavg_tpu/pipeline/offline.py``.  The same program as the
incremental engine (ORB features, local matching, essential RANSAC and
refine, keyframe thinning, window edges, optional BoW loop closure,
robust rotation averaging), organised for throughput:

  1. **extract**: frames in batches through the batched pyramid
     (``ORBExtractor.extract_batch``); keypoints undistorted on the host
     in f64 when the camera has distortion;
  2. **flow / keyframe thinning**: the mean feature displacement of each
     consecutive pair (`fused_flow`, ``chunk`` pairs a launch); the
     reference's keyframe gate (reject when motion < 5 px,
     src/ViewGraph.cpp:1071) becomes greedy thinning over accumulated
     flow;
  3. **pair estimation**: every (i, i-k) window pair of the keyframes in
     chunks of ``chunk`` pairs (`fused_pair_estimate`: match -> RANSAC ->
     refine per pair, the matching of a chunk one launch with a column
     frame per lane); failed pairs are retried once at twice the radius;
  4. **loop closure** (vocabulary given): the keyframes' BoW in batched
     descents, the incremental engine's loop detector
     (``placerec/loop.py``) asked keyframe by keyframe, loop pairs
     verified in one batch;
  5. **solve**: one spanning-tree init + L1-RA + IRLS over the whole
     graph, in f64.

Divergences from the incremental path (the reference's, kept): window
edges are matched directly (A against B) rather than through pivot
chaining (src/ViewGraph.cpp:786-825), and the keyframe gate uses the
accumulated consecutive flow as the motion estimate.  Random draws are
the reference's: a chunk of pairs starting at ``lo`` draws from the key
``prng.key((seed + lo) & 0xFFFFFFFF)``, pair ``p`` of it from that key's
``split(...)[p]``.  The reference pads a chunk's tail with repeated lanes;
a lane's key does not depend on the chunk's width, so the port does not
pad, and draws what the reference's real lanes draw.

Under a profiler session a job runs inside the program span
``offline.job`` (``frames``, ``keyframes``), its stages inside
``offline.extract`` (``frames``, ``batches``), ``offline.flow``
(``pairs``), ``offline.pairs`` (stage 3 with its retry pass: ``pairs``,
``chunks``, ``retried``, ``connected``), ``offline.loop``
(``candidates``, the pairs the two-view estimate ``verified``,
``loop_edges``) and ``offline.solve`` (``n``, ``m``), and every chunk of
pair estimates inside ``offline.pair_chunk`` (``lanes``, ``refined``:
the lanes that reached the refine); ``utils/timing.py``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.config import PipelineConfig
from irotavg_tpu_torch.geometry.fused import (
    fused_flow_gather, fused_pair_estimate_gather,
)
from irotavg_tpu_torch.placerec.loop import LoopDetector
from irotavg_tpu_torch.solver import RotationGraph, init_mst, irls, l1ra
from irotavg_tpu_torch.solver.irls import Cost, IRLSConfig
from irotavg_tpu_torch.solver.l1ra import L1RAConfig
from irotavg_tpu_torch.utils.timing import span

FLOW_RADIUS = 90.0          # px, the flow stage's local search window
LOOP_RADIUS = 512.0         # px, the loop pairs' search window
BOW_CHUNK = 16              # keyframes per batched vocabulary descent
RETRY_SEED = 7919           # seed offsets of the retry and loop passes
LOOP_SEED = 104729


@dataclasses.dataclass
class OfflineResult:
    Q: np.ndarray              # (K, 4) absolute rotations [x y z w]
    keyframes: list[int]       # source frame index per solved rotation
    edges: np.ndarray          # (M, 2) indices into keyframes
    QQ: np.ndarray             # (M, 4) relative rotations per edge
    n_matches: np.ndarray      # (M,) inlier matches per edge
    loop_edges: int            # how many edges came from loop closure
    loop_mask: np.ndarray      # (M,) bool, True where the edge is a loop edge
    stats: dict                # stage timing / solve stats
    flows: np.ndarray          # (B-1,) mean displacement, frame i -> i+1


def _chunks(n, size):
    for lo in range(0, n, size):
        yield lo, min(lo + size, n)


def _load(image) -> np.ndarray:
    return np.asarray(image() if callable(image) else image, np.uint8)


def _sync(dev) -> None:
    """Finish the device's queued work (stage timing)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_offline(images, camera, extractor, *, vocab=None,
                cfg: PipelineConfig | None = None, batch: int = 8,
                chunk: int = 8, min_matches: int | None = None,
                win_size: int | None = None, seed: int = 0,
                keyframe_gate_px: float = 5.0, refine_iters: int = 10,
                progress=None) -> OfflineResult:
    """Run the full batched pipeline over a sequence of grayscale images.

    ``images`` is a sequence of arrays or callables returning arrays
    (lazy loading).  Everything runs on ``extractor.device``.  Returns
    rotations for the selected keyframes; as in the reference,
    translations are never estimated.
    """
    with span("offline.job", frames=len(images)) as job_sp:
        cfg = cfg or PipelineConfig()
        if min_matches is None:
            min_matches = cfg.vg_min_matches
        win_size = cfg.vg_win_size if win_size is None else win_size
        dev = extractor.device
        stats: dict = {}
        t_start = time.perf_counter()

        # -- stage 1: batched extraction --------------------------------------
        B = len(images)
        n_batches = -(-B // batch)
        feats: dict = {}
        with span("offline.extract", frames=B, batches=n_batches):
            for lo, hi in _chunks(B, batch):
                out = extractor.extract_batch(
                    np.stack([_load(images[i]) for i in range(lo, hi)]))
                for k_, v in out.items():
                    feats.setdefault(k_, []).append(v)
                if progress:
                    progress(f"extracted {hi}/{B}")
            feats = {k_: torch.cat(v) for k_, v in feats.items()}
            desc, valid = feats["desc"], feats["valid"]
            octave = feats["octave"]
            angle = feats["angle"].to(torch.float32)
            if camera.has_distortion:
                xh, yh = feats["x0"].cpu().numpy(), feats["y0"].cpu().numpy()
                xu, yu = camera.undistort_points(xh.ravel(), yh.ravel())
                x = torch.as_tensor(xu.reshape(xh.shape), dtype=torch.float32,
                                    device=dev)
                y = torch.as_tensor(yu.reshape(yh.shape), dtype=torch.float32,
                                    device=dev)
            else:
                x = feats["x0"].to(torch.float32)
                y = feats["y0"].to(torch.float32)
            _sync(dev)
        stats["extract_s"] = time.perf_counter() - t_start

        # -- stage 2: consecutive flow + keyframe thinning --------------------
        t0 = time.perf_counter()
        with span("offline.flow", pairs=B - 1):
            flow_out = []
            for lo, hi in _chunks(B - 1, chunk):
                ia = torch.arange(lo, hi, device=dev)
                flow_out.append(fused_flow_gather(desc, valid, octave, x, y,
                                                  ia, ia + 1, FLOW_RADIUS))
            flows = torch.cat([f for f, _ in flow_out]).cpu().numpy() \
                if flow_out else np.zeros(0, np.float32)
            # greedy thinning on accumulated flow (keyframe gate parity: 5 px)
            keyframes = [0]
            acc = 0.0
            acc_since = []  # accumulated flow between consecutive keyframes
            for i in range(1, B):
                acc += float(flows[i - 1])
                if acc >= keyframe_gate_px:
                    keyframes.append(i)
                    acc_since.append(acc)
                    acc = 0.0
        K = len(keyframes)
        stats["flow_s"] = time.perf_counter() - t0
        if K < 2:
            raise ValueError(
                "fewer than two keyframes survive the motion gate")

        # -- stage 3: window pair estimation ----------------------------------
        t0 = time.perf_counter()
        pairs = []              # (a, b) indices into `keyframes`, a < b
        radii = []
        cum = np.concatenate([[0.0], np.cumsum(acc_since)])  # flow up to kf k
        for bkf in range(1, K):
            for w in range(1, win_size + 1):
                akf = bkf - w
                if akf < 0:
                    break
                span_px = cum[bkf] - cum[akf]
                pairs.append((akf, bkf))
                radii.append(np.clip(1.25 * span_px + 30.0, 45.0, 512.0))
        pairs = np.asarray(pairs, np.int64)
        radii = np.asarray(radii, np.float32)
        kf = np.asarray(keyframes)

        f32 = torch.float32
        K_inv = torch.as_tensor(np.linalg.inv(camera.K), dtype=f32, device=dev)
        sigma2 = torch.as_tensor((1.2 ** np.arange(8)) ** 2, dtype=f32,
                                 device=dev)
        camv = torch.tensor([camera.fx, camera.fy, camera.cx, camera.cy],
                            dtype=f32, device=dev)
        th_norm = torch.tensor(1.0 / camera.fx, dtype=f32, device=dev)

        def estimate_pairs(pair_arr, rad_arr, key0):
            """Chunked `fused_pair_estimate` over (P, 2) keyframe-index pairs:
            (R (P, 3, 3), final match counts (P,), success (P,)), each chunk
            inside an ``offline.pair_chunk`` span."""
            P = len(pair_arr)
            Rs = np.zeros((P, 3, 3), np.float32)
            ns = np.zeros(P, np.int64)
            succ = np.zeros(P, bool)
            for lo, hi in _chunks(P, chunk):
                with span("offline.pair_chunk", lanes=hi - lo) as sp:
                    ia = torch.as_tensor(kf[pair_arr[lo:hi, 0]], device=dev)
                    ib = torch.as_tensor(kf[pair_arr[lo:hi, 1]], device=dev)
                    counts: dict = {}
                    _, R, _, _, m12, success = fused_pair_estimate_gather(
                        desc, valid, octave, x, y, angle, ia, ib,
                        torch.as_tensor(rad_arr[lo:hi], device=dev), K_inv,
                        sigma2, camv, th_norm, (key0 + lo) & 0xFFFFFFFF,
                        min_matches, refine_iters, counts=counts)
                    Rs[lo:hi] = R.cpu().numpy()
                    ns[lo:hi] = (m12 >= 0).sum(dim=1).cpu().numpy()
                    succ[lo:hi] = success
                    sp.set(refined=counts["refined"])
                if progress:
                    progress(f"pairs {hi}/{P}")
            return Rs, ns, succ

        with span("offline.pairs", pairs=len(pairs)) as sp:
            Rs, ns, succ = estimate_pairs(pairs, radii, seed)
            # failed pairs get one retry at a doubled search radius (the
            # incremental engine's radius-escalation analogue, :884-899)
            retry = ~succ
            n_retry = int(retry.sum())
            if n_retry:
                Rs2, ns2, succ2 = estimate_pairs(
                    pairs[retry], np.clip(radii[retry] * 2.0, None, 512.0),
                    seed + RETRY_SEED)
                ridx = np.where(retry)[0][succ2]
                Rs[ridx] = Rs2[succ2]
                ns[ridx] = ns2[succ2]
                succ[ridx] = True
            n_chunks = -(-len(pairs) // chunk) + -(-n_retry // chunk)
            n_connected = int(succ.sum())
            sp.set(chunks=n_chunks, retried=n_retry, connected=n_connected)
        edges = pairs[succ]
        QQ = _to_quat(Rs[succ])
        n_matches = ns[succ]
        stats["pairs_s"] = time.perf_counter() - t0
        stats["pairs_total"] = len(pairs)
        stats["pairs_connected"] = n_connected

        # keep only the connected component containing keyframe 0 — a batch
        # tool is more useful degrading gracefully than aborting (the
        # reference exits on an unconnectable frame, src/ViewGraph.cpp:1083)
        parent = list(range(K))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for a, b in edges:
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[ra] = rb
        root0 = find(0)
        in_comp = np.array([find(i) == root0 for i in range(K)])
        if not in_comp.all():
            stats["dropped_keyframes"] = int((~in_comp).sum())
            remap = -np.ones(K, np.int64)
            remap[in_comp] = np.arange(int(in_comp.sum()))
            keep_edge = in_comp[edges[:, 0]] & in_comp[edges[:, 1]]
            edges = remap[edges[keep_edge]]
            QQ = QQ[keep_edge]
            n_matches = n_matches[keep_edge]
            keyframes = [k_ for k_, ok in zip(keyframes, in_comp) if ok]
            K = len(keyframes)
            kf = np.asarray(keyframes)  # loop-closure stages index through kf

        # -- stage 4: loop closure (optional) ---------------------------------
        loop_edges = 0
        loop_mask = np.zeros(len(edges), bool)
        if vocab is not None:
            t0 = time.perf_counter()
            with span("offline.loop") as sp:
                cand_pairs = _loop_candidates(vocab, desc, valid, kf, edges,
                                              n_matches, cfg)
                n_verified = 0
                if cand_pairs:
                    cp = np.asarray(cand_pairs, np.int64)
                    rad = np.full(len(cp), LOOP_RADIUS, np.float32)
                    Rs2, ns2, succ2 = estimate_pairs(cp, rad, seed + LOOP_SEED)
                    n_verified = int(succ2.sum())
                    ok = succ2 & (ns2 >= cfg.loop.min_matches)
                    if ok.any():
                        edges = np.concatenate([edges, cp[ok]])
                        QQ = np.concatenate([QQ, _to_quat(Rs2[ok])])
                        n_matches = np.concatenate([n_matches, ns2[ok]])
                        loop_edges = int(ok.sum())
                        loop_mask = np.concatenate(
                            [loop_mask, np.ones(loop_edges, bool)])
                sp.set(candidates=len(cand_pairs), verified=n_verified,
                       loop_edges=loop_edges)
            stats["loop_s"] = time.perf_counter() - t0
            stats["loop_candidate_pairs"] = len(cand_pairs)

        # -- stage 5: global robust solve (f64) -------------------------------
        t0 = time.perf_counter()
        order = np.lexsort((edges[:, 0], edges[:, 1]))
        edges, QQ, n_matches = edges[order], QQ[order], n_matches[order]
        loop_mask = loop_mask[order]
        with span("offline.solve", n=K, m=len(edges)):
            Qf, iters = solve_global(edges, QQ, K, cfg, dev)
        stats["solve_s"] = time.perf_counter() - t0
        stats["irls_iters"] = int(iters)
        stats["total_s"] = time.perf_counter() - t_start
        job_sp.set(keyframes=K)

    return OfflineResult(
        Q=Qf, keyframes=list(map(int, keyframes)), edges=edges, QQ=QQ,
        n_matches=n_matches, loop_edges=loop_edges, loop_mask=loop_mask,
        stats=stats, flows=flows)


def solve_global(edges, QQ, K, cfg: PipelineConfig, device):
    """Stage 5: spanning-tree init, L1-RA, then IRLS (dense, f64) over
    ``K`` keyframes, keyframe 0 fixed.  Returns (Q (K, 4) [x y z w],
    IRLS iterations)."""
    Q0 = np.zeros((K, 4))
    Q0[0] = [0, 0, 0, 1]
    Q0 = init_mst(Q0, QQ, edges, 1)
    g = RotationGraph.create(edges, QQ, Q0, f=1, dtype=torch.float64,
                             device=device)
    sol = cfg.solver
    g = dataclasses.replace(
        g, Q=l1ra(g, L1RAConfig(max_iters=sol.l1_iters,
                                change_th=sol.change_th))[0])
    Qf, _, iters, _ = irls(g, IRLSConfig(
        cost=Cost.parse(sol.cost), sigma=math.radians(sol.sigma_deg),
        max_iters=sol.irls_iters, change_th=sol.change_th, backend="dense"))
    return so3.qnormalize(Qf).cpu().numpy(), iters


def _to_quat(R: np.ndarray) -> np.ndarray:
    """(M, 3, 3) rotation matrices -> (M, 4) f64 quaternions [x y z w]."""
    return so3.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float64)
                              ).numpy().reshape(-1, 4)


def _loop_candidates(vocab, desc, valid, kf, edges, n_matches, cfg):
    """(candidate, query) keyframe pairs that pass the loop detector's
    candidates and consistency (src/ViewGraph.cpp:906-1033), the
    keyframes taken in order as the incremental engine takes them, over
    the whole graph of window edges."""
    K = len(kf)
    bows = []
    for lo, hi in _chunks(K, BOW_CHUNK):      # one descent + one fetch each
        idx = torch.as_tensor(kf[lo:hi], device=desc.device)
        bows.extend(b for b, _ in vocab.transform_batch(desc[idx],
                                                        valid[idx]))

    adjacency: dict[int, dict[int, int]] = {}
    for (a, b), nm in zip(edges, n_matches):
        adjacency.setdefault(int(a), {})[int(b)] = int(nm)
        adjacency.setdefault(int(b), {})[int(a)] = int(nm)

    det = LoopDetector(cfg.loop.covisibility_consistency_th)
    cand_pairs = []
    for k_i in range(K):
        cands = det.candidates(k_i, bows[k_i], adjacency, bows.__getitem__)
        cand_pairs.extend((cand, k_i)
                          for cand in det.consistent(cands, adjacency))
        det.add(k_i, bows[k_i])
    return cand_pairs

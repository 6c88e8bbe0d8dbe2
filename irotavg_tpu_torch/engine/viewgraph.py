"""The SLAM view-graph engine: frame ingestion, connection, loop closure,
rotation averaging.

Port of ``irotavg_tpu/engine/viewgraph.py`` (orchestration of
``ViewGraph``, src/ViewGraph.cpp):

* ``process_frame`` runs the adaptive initial pose against the previous
  keyframe with the 5 px keyframe gate, the epipolar refinement, a hard
  failure when the frame cannot be connected with ``min_matches``, then
  the pivot-chained connections back through the view window (stopping
  at the first failure).  When the current, previous and every window
  frame carry vocabulary node ids, the re-matching uses the ``epipolar``
  gate (same node required).
* loop closure: min-BoW-score floor over the connected views
  (:906-944), the database cascade (``ViewDatabase``), consecutive-group
  consistency (:948-1033, threshold 7), and ``close_loop``'s BoW match +
  RANSAC + refine.
* ``rot_avg`` delegates to the incremental windowed solver.

Under a profiler session ``process_frame`` runs inside a program span
``engine.process_frame`` (attribute ``view``: the view id the frame
takes if kept; ``utils/timing.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from irotavg_tpu_torch import so3
from irotavg_tpu_torch.engine.incremental import IncrementalRotAvg
from irotavg_tpu_torch.geometry.fused import (
    fused_bow_pair_estimate, fused_process_frame,
)
from irotavg_tpu_torch.geometry.twoview import RelativePose
from irotavg_tpu_torch.matching.matchers import matches_to_pairs
from irotavg_tpu_torch.placerec.bow import bow_score
from irotavg_tpu_torch.placerec.database import ViewDatabase
from irotavg_tpu_torch.utils.timing import span


class FrameConnectionError(RuntimeError):
    """Raised where the reference exits: a frame could not be connected."""


@dataclasses.dataclass
class Connection:
    pairs: np.ndarray        # (M, 2) feature indices (i-side, j-side), i < j
    pose: RelativePose       # x_j ~ R x_i + t


def _rel(R, t, E, n, n_pairs) -> RelativePose:
    return RelativePose(R=np.asarray(R, np.float64),
                        t=np.asarray(t, np.float64),
                        E=np.asarray(E, np.float64), n_cheirality=int(n),
                        inlier_mask=np.ones(n_pairs, bool))


class ViewGraph:
    """Incremental monocular rotation-averaging SLAM engine.  Feature work
    runs on the frames' device; the solver on ``device`` (defaults to the
    same)."""

    COVISIBILITY_CONSISTENCY_TH = 7  # src/ViewGraph.hpp:99

    def __init__(self, camera, *, min_matches: int = 100, device=None):
        self.camera = camera
        self.min_matches = min_matches
        self.frames: list = []
        self.connections: dict[tuple[int, int], Connection] = {}
        self.adjacency: dict[int, dict[int, int]] = {}
        self.ra = IncrementalRotAvg(device=device)
        self.local_rad = 45.0             # src/ViewGraph.hpp:134
        self.db = ViewDatabase()
        self._consistent_groups: list[tuple[set, int]] = []
        self._consts_dev = None

    def _consts(self, device) -> dict:
        """Per-camera constants on ``device``, made once."""
        if self._consts_dev is None or self._consts_dev["cam"].device != \
                device:
            cam = self.camera
            f32 = torch.float32
            self._consts_dev = {
                "cam": torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy],
                                    dtype=f32, device=device),
                "th_norm": torch.tensor(1.0 / cam.fx, dtype=f32,
                                        device=device),
                "K_inv": torch.tensor(np.linalg.inv(cam.K), dtype=f32,
                                      device=device),
                "sigma2": torch.tensor((1.2 ** np.arange(8)) ** 2,
                                       dtype=f32, device=device),
            }
        return self._consts_dev

    # -- graph bookkeeping ---------------------------------------------------

    @property
    def num_views(self) -> int:
        return len(self.frames)

    def connect(self, i: int, j: int, pairs: np.ndarray,
                rel: RelativePose) -> None:
        if i > j:
            raise ValueError("connect expects i < j")
        self.connections[(i, j)] = Connection(pairs=pairs, pose=rel)
        self.adjacency.setdefault(i, {})[j] = len(pairs)
        self.adjacency.setdefault(j, {})[i] = len(pairs)
        self.ra.add_edge(i, j, rel.q)

    def is_connected(self, i: int, j: int) -> bool:
        return (min(i, j), max(i, j)) in self.connections

    def best_covisibility(self, i: int, n: int) -> list[int]:
        """Top-n neighbours by match count (View::getBestCovisibilityViews)."""
        nb = self.adjacency.get(i, {})
        return [v for v, _ in sorted(nb.items(), key=lambda x: -x[1])[:n]]

    # -- frame ingestion -----------------------------------------------------

    @staticmethod
    def _tensors(f, has_nodes: bool):
        """Frame tensors ``(desc, nodes, valid, angle, x, y, octave)``;
        ``nodes`` are the frame's vocabulary node ids with ``has_nodes``,
        else zeros."""
        nodes = f.dev("feat_nodes") if has_nodes else torch.zeros(
            f.capacity, dtype=torch.int32, device=f.device)
        return (f.dev("desc"), nodes, f.dev("valid"), f.dev("angle"),
                f.dev("xu"), f.dev("yu"), f.dev("octave"))

    def process_frame(self, frame, win_size: int = 4) -> bool:
        """Ingest a frame; returns False when rejected (not a keyframe).
        Raises :class:`FrameConnectionError` where the reference exits."""
        with span("engine.process_frame", view=self.num_views):
            return self._process_frame(frame, win_size)

    def _process_frame(self, frame, win_size: int) -> bool:
        if self.num_views == 0:
            self.frames.append(frame)
            self.ra.add_view()
            return True

        curr_idx = self.num_views
        prev_idx = curr_idx - 1
        prev = self.frames[prev_idx]
        n = frame.capacity
        if prev.capacity != n:
            raise ValueError("mixed frame capacities")
        dev = frame.device
        c = self._consts(dev)

        # window candidates, padded to K = win_size - 1 (padded slots
        # repeat candidate 0 and are inactive)
        cand_ids = [v1 for v1 in range(prev_idx - 1, -1, -1)
                    if (curr_idx - v1) <= win_size]
        k_pad = max(win_size - 1, 1)
        m12_w2p = np.full((k_pad, n), -1, np.int64)
        active = [False] * k_pad
        fr = []
        for ki in range(k_pad):
            v1 = cand_ids[ki] if ki < len(cand_ids) else (
                cand_ids[0] if cand_ids else prev_idx)
            if self.frames[v1].capacity != n:
                raise ValueError(f"mixed frame capacities: window candidate "
                                 f"{v1} has {self.frames[v1].capacity}, "
                                 f"current frame has {n}")
            fr.append(self.frames[v1])
            if ki >= len(cand_ids):
                continue
            key = (min(v1, prev_idx), max(v1, prev_idx))
            conn = self.connections.get(key)
            if conn is None:
                continue
            p = conn.pairs if key[0] == v1 else conn.pairs[:, ::-1]
            m12_w2p[ki, p[:, 0]] = p[:, 1]
            active[ki] = len(p) > 0
        # node ids only when every frame involved has them
        # (irotavg_tpu/engine/viewgraph.py:161-166)
        has_nodes = all(f.feat_nodes is not None for f in [frame, prev] + fr)
        local_rad, rel_valid, refined, window = fused_process_frame(
            self._tensors(frame, has_nodes), self._tensors(prev, has_nodes),
            tuple(self._tensors(f, has_nodes) for f in fr),
            torch.as_tensor(m12_w2p, device=dev), active, self.local_rad,
            c["K_inv"], c["sigma2"], c["cam"], c["th_norm"], self.num_views,
            self.min_matches, 2 * self.min_matches, 0.9, has_nodes)
        self.local_rad = float(local_rad)
        if self.local_rad < 5.0:
            return False                       # keyframe gate (:1071-1074)

        E_r, R_r, t_r, n_r, m12_pc = (a.cpu().numpy() for a in refined)
        E_w, R_w, t_w, n_w, m12_w = (a.cpu().numpy() for a in window[:5])
        succ_w = window[5]

        self.frames.append(frame)
        self.ra.add_view()
        pairs = matches_to_pairs(m12_pc)
        if not rel_valid or len(pairs) < self.min_matches:
            raise FrameConnectionError(
                f"failed to connect frame {curr_idx}: insufficient matches "
                f"{len(pairs)}")
        rel = _rel(R_r, t_r, E_r, n_r, len(pairs))
        self.connect(prev_idx, curr_idx, pairs, rel)
        # warm-start the new rotation: R_curr = R_rel @ R_prev
        self.ra.Q[curr_idx] = so3.qmul(
            torch.from_numpy(rel.q), torch.from_numpy(self.ra.Q[prev_idx])
        ).numpy()

        # window walk: stop at the first failure (src/ViewGraph.cpp:1109-1136)
        for ki, v1 in enumerate(cand_ids):
            if not succ_w[ki]:
                break
            pairs_w = matches_to_pairs(m12_w[ki])
            self.connect(v1, curr_idx, pairs_w,
                         _rel(R_w[ki], t_w[ki], E_w[ki], n_w[ki],
                              len(pairs_w)))
        return True

    # -- loop closure --------------------------------------------------------

    def detect_loop_candidates(self, view_id: int) -> list[int]:
        """Min-score floor over connected views, then the database cascade
        (src/ViewGraph.cpp:906-944)."""
        frame = self.frames[view_id]
        if frame.bow is None:
            return []
        min_score = 1.0
        for nb in self.adjacency.get(view_id, {}):
            nb_bow = self.frames[nb].bow
            if nb_bow is not None:
                min_score = min(min_score, bow_score(frame.bow, nb_bow))
        return self.db.detect_loop_candidates(
            query_id=view_id, bow=frame.bow,
            connected=set(self.adjacency.get(view_id, {})),
            min_score=min_score, covisibility_fn=self.best_covisibility,
            score_fn=bow_score)

    def check_loop_consistency(self, candidates: list[int]) -> list[int]:
        """Consecutive-keyframe group consistency (:948-1033)."""
        consistent: list[int] = []
        new_groups: list[tuple[set, int]] = []
        prev_flag = [False] * len(self._consistent_groups)
        for cand in candidates:
            group = set(self.adjacency.get(cand, {})) | {cand}
            some = False
            enough = False
            for g, (pg, cnt) in enumerate(self._consistent_groups):
                if group & pg:
                    some = True
                    cur = cnt + 1
                    if not prev_flag[g]:
                        new_groups.append((group, cur))
                        prev_flag[g] = True
                    if cur >= self.COVISIBILITY_CONSISTENCY_TH and not enough:
                        consistent.append(cand)
                        enough = True
            if not some:
                new_groups.append((group, 0))
        self._consistent_groups = new_groups
        return consistent

    def close_loop(self, view_id: int, cand_id: int, *,
                   min_matches: int = 150) -> bool:
        """BoW match + relative pose + refine, then connect ``(cand_id,
        view_id)`` (the app's loop-closure block, src/IRotAvg.cpp:309-347).
        Reads back only the success flag, then the accepted edge."""
        f2 = self.frames[view_id]
        f1 = self.frames[cand_id]
        dev = f2.device
        c = self._consts(dev)
        has_nodes = f1.feat_nodes is not None and f2.feat_nodes is not None
        E, R, t, n_che, m12, success = fused_bow_pair_estimate(
            self._tensors(f1, has_nodes), self._tensors(f2, has_nodes),
            c["K_inv"], c["sigma2"], c["cam"], c["th_norm"],
            (view_id * 31 + cand_id) & 0xFFFFFFFF, 0.9, min_matches,
            has_nodes)
        if not success:
            return False
        pairs = matches_to_pairs(m12.cpu().numpy())
        self.connect(cand_id, view_id, pairs,
                     _rel(R.cpu(), t.cpu(), E.cpu(), n_che, len(pairs)))
        return True

    def add_to_database(self, view_id: int) -> None:
        bow = self.frames[view_id].bow
        if bow is not None:
            self.db.add(view_id, bow)

    # -- solver bridge / persistence ----------------------------------------

    def rot_avg(self, win_size: int, **kw):
        """Windowed solve; lazy by default (the write-back happens at the
        next ``ra.Q`` access)."""
        kw.setdefault("lazy", True)
        return self.ra.rot_avg(win_size, **kw)

    def fix_pose(self, idx: int, q=None) -> None:
        self.ra.fix_pose(idx, q)

    def save_poses(self, path: str) -> None:
        self.ra.save_poses(path)

    def save_view_graph(self, path: str) -> None:
        """Every connection's relative pose as YAML —
        `ViewGraph::saveViewGraph` (src/ViewGraph.cpp:1148-1171), in the
        JAX package's layout: one ``i``/``j``/``R``/``t`` record per edge
        (i < j, sorted) in a YAML sequence under ``edges`` (the
        reference's repeated top-level keys are not parseable YAML), the
        numbers as ``{:.17e}``."""
        lines = ["%YAML:1.0", "---", "edges:"]
        for (i, j), conn in sorted(self.connections.items()):
            R = np.asarray(conn.pose.R, np.float64).reshape(3, 3)
            t = np.asarray(conn.pose.t, np.float64).reshape(3)
            rdata = ", ".join(f"{v:.17e}" for v in R.ravel())
            tdata = ", ".join(f"{v:.17e}" for v in t)
            lines += [
                f"  - {{ i: {self.frames[i].id}, j: {self.frames[j].id},",
                f"      R: [ {rdata} ],",
                f"      t: [ {tdata} ] }}",
            ]
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")

    def save_pose_ids(self, path: str) -> None:
        """1-based frame ids of the keyframes, one per line
        (src/IRotAvg.cpp:111-128)."""
        with open(path, "w") as fh:
            for f in self.frames:
                fh.write(f"{f.id + 1}\n")

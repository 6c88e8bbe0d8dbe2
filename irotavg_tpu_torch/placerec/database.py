"""Inverted-file view database + loop-candidate cascade.

Port of ``irotavg_tpu/placerec/database.py`` (src/ViewDatabase.{hpp,cpp}):
postings lists per word id (`add`/`erase`, :32-62) and the cascade of
`detect_loop_candidates` (:96-214):

  1. collect views sharing words with the query, excluding views already
     connected to it (`findViewsSharingWords`, :65-92);
  2. keep views with shared-word count > SHARED_WORDS_FRAC (0.8) * max;
  3. BoW score filter >= min_score;
  4. accumulate scores over each candidate's COVISIBILITY_TOP_N (10) best
     covisible views that also pass the shared-word bar, track the best
     view of each group;
  5. retain groups with accumulated score > GROUP_SCORE_FRAC (0.75) *
     best, deduplicated.

Documented divergence (kept from the JAX package): the reference stores
per-view scores in a ``std::map<View*, int>`` (ViewDatabase.cpp:123),
truncating every BoW score in [0, 1) to 0, which silently disables the
covisibility accumulation.  Scores stay floats here.

The stock L1 scorer runs as one batched numpy merge-join per query
(:func:`l1_scores`), in place of the JAX package's native C++ kernel and
with its summation order, so the scores are bit-for-bit the same.
"""

from __future__ import annotations

import collections

import numpy as np

from irotavg_tpu_torch.placerec.bow import bow_score as _default_l1_score

# the cascade's constants, steps 2, 4 and 5 above (ViewDatabase.cpp:111-119,
# :151-213)
SHARED_WORDS_FRAC = 0.8
COVISIBILITY_TOP_N = 10
GROUP_SCORE_FRAC = 0.75


def _to_arrays(bow: dict):
    """Sparse BoW dict -> (ids, weights) sorted by word id."""
    ids = np.fromiter(bow.keys(), np.int64, len(bow))
    ws = np.fromiter(bow.values(), np.float64, len(bow))
    order = np.argsort(ids)
    return ids[order], ws[order]


def l1_scores(q_ids, q_w, cands) -> np.ndarray:
    """L1 similarity ``0.5 * sum(|v| + |w| - |v - w|)`` over the common
    words of one query and each candidate ``(ids, weights)`` (all sorted
    by id).  Each candidate's terms are summed left to right in ascending
    word order, the order of the reference's sequential merge-join."""
    out = np.zeros(len(cands), np.float64)
    if not cands or len(q_ids) == 0:
        return out
    lens = np.array([len(c[0]) for c in cands], np.int64)
    c_ids = np.concatenate([c[0] for c in cands])
    c_w = np.concatenate([c[1] for c in cands])
    owner = np.repeat(np.arange(len(cands)), lens)
    pos = np.minimum(np.searchsorted(q_ids, c_ids), len(q_ids) - 1)
    hit = q_ids[pos] == c_ids
    v, w, owner = q_w[pos[hit]], c_w[hit], owner[hit]
    terms = np.abs(v) + np.abs(w) - np.abs(v - w)
    if len(terms) == 0:
        return out
    n_hit = np.bincount(owner, minlength=len(cands))
    col = np.arange(len(terms)) - np.repeat(np.cumsum(n_hit) - n_hit, n_hit)
    padded = np.zeros((len(cands), int(n_hit.max())), np.float64)
    padded[owner, col] = terms
    # cumsum is a sequential sum; trailing zeros leave it unchanged
    return 0.5 * np.cumsum(padded, axis=1)[:, -1]


class ViewDatabase:
    """Host-side inverted file.  Stored BoW vectors are also kept as
    sorted (ids, weights) arrays for the batched L1 scorer."""

    def __init__(self):
        self.inverted: dict[int, list[int]] = collections.defaultdict(list)
        self.bows: dict[int, dict] = {}
        self._arrs: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def add(self, view_id: int, bow: dict) -> None:
        self.bows[view_id] = bow
        self._arrs[view_id] = _to_arrays(bow)
        for w in bow:
            self.inverted[w].append(view_id)

    def erase(self, view_id: int) -> None:
        bow = self.bows.pop(view_id, None)
        self._arrs.pop(view_id, None)
        if bow is None:
            return
        for w in bow:
            try:
                self.inverted[w].remove(view_id)
            except ValueError:
                pass

    def _score_many(self, bow: dict, vids: list[int], score_fn) -> list[float]:
        """Batched scores for the stock L1 scorer; one ``score_fn`` call
        per candidate for any other scorer."""
        if score_fn is _default_l1_score:
            q_ids, q_w = _to_arrays(bow)
            out = l1_scores(q_ids, q_w, [self._arrs[v] for v in vids])
            return [float(s) for s in out]
        return [score_fn(bow, self.bows[v]) for v in vids]

    def find_views_sharing_words(self, bow: dict, exclude: set[int]):
        """view_id -> number of shared words, excluding `exclude`."""
        counts: dict[int, int] = collections.defaultdict(int)
        for w in bow:
            for vid in self.inverted.get(w, ()):
                counts[vid] += 1
        return {v: c for v, c in counts.items() if v not in exclude}

    def detect_loop_candidates(self, query_id: int, bow: dict,
                               connected: set[int], min_score: float,
                               covisibility_fn, score_fn) -> list[int]:
        """The reference's shared-word / min_score / group-score cascade.

        covisibility_fn(view_id, n) -> up to n best covisible view ids;
        score_fn(bow1, bow2) -> similarity.
        """
        exclude = set(connected) | {query_id}
        shared = self.find_views_sharing_words(bow, exclude)
        if not shared:
            return []

        max_common = max(shared.values())
        min_common = max_common * SHARED_WORDS_FRAC

        passing = [vid for vid, c in shared.items() if c > min_common]
        batch = self._score_many(bow, passing, score_fn)
        scores: dict[int, float] = dict(zip(passing, batch))
        score_and_view = [(s, vid) for vid, s in zip(passing, batch)
                          if s >= min_score]
        if not score_and_view:
            return []

        acc_pairs = []
        best_acc = min_score
        for s, vid in score_and_view:
            acc = s
            best_score, best_view = s, vid
            for co in covisibility_fn(vid, COVISIBILITY_TOP_N):
                if shared.get(co, 0) > min_common:
                    co_s = scores.get(co, 0.0)
                    acc += co_s
                    if co_s > best_score:
                        best_score, best_view = co_s, co
            acc_pairs.append((acc, best_view))
            best_acc = max(best_acc, acc)

        retain = GROUP_SCORE_FRAC * best_acc
        out, seen = [], set()
        for acc, vid in acc_pairs:
            if acc > retain and vid not in seen:
                seen.add(vid)
                out.append(vid)
        return out

"""Loop closure's decisions (src/ViewGraph.cpp:906-1033), for the
incremental engine (``engine/viewgraph.py``) and the offline pipeline
(``pipeline/offline.py``) alike:

* ``candidates``: the min-BoW-score floor over the query's connected
  views, then the inverted-file cascade (``ViewDatabase``) with the
  neighbours ranked by match count;
* ``consistent``: the consecutive-group rule, which carries the groups
  from one query to the next;
* ``add``: the view's insertion into the database.

A query reads the view graph as an adjacency map ``{view: {neighbour:
matches}}`` and the views' BoW vectors; the detector owns the database and
the groups.
"""

from __future__ import annotations

import functools

from irotavg_tpu_torch.placerec.bow import bow_score
from irotavg_tpu_torch.placerec.database import ViewDatabase


def best_covisibility(adjacency: dict, i: int, n: int) -> list[int]:
    """Top-n neighbours of ``i`` by match count, ties in the map's order
    (View::getBestCovisibilityViews)."""
    nb = adjacency.get(i, {})
    return [v for v, _ in sorted(nb.items(), key=lambda x: -x[1])[:n]]


class LoopDetector:
    """The database, the consistency groups and their threshold
    (``LoopClosureConfig.covisibility_consistency_th``)."""

    def __init__(self, consistency_th: int):
        self.consistency_th = consistency_th
        self.db = ViewDatabase()
        self.groups: list[tuple[set, int]] = []

    def candidates(self, view_id: int, bow, adjacency: dict,
                   bow_of) -> list[int]:
        """Loop candidates of ``view_id`` (BoW ``bow``; none without one):
        the floor is the lowest score against a connected view with a BoW
        (``bow_of(v)``, None without one), then the cascade
        (:906-944)."""
        if bow is None:
            return []
        connected = adjacency.get(view_id, {})
        min_score = 1.0
        for nb in connected:
            nb_bow = bow_of(nb)
            if nb_bow is not None:
                min_score = min(min_score, bow_score(bow, nb_bow))
        return self.db.detect_loop_candidates(
            query_id=view_id, bow=bow, connected=set(connected),
            min_score=min_score,
            covisibility_fn=functools.partial(best_covisibility, adjacency),
            score_fn=bow_score)

    def consistent(self, candidates: list[int], adjacency: dict) -> list[int]:
        """The candidates whose group (the candidate and its neighbours)
        meets a group of the previous query that has been met
        ``consistency_th`` times in a row (:948-1033); the groups met
        become the next query's."""
        consistent: list[int] = []
        new_groups: list[tuple[set, int]] = []
        prev_flag = [False] * len(self.groups)
        for cand in candidates:
            group = set(adjacency.get(cand, {})) | {cand}
            some = enough = False
            for g, (pg, cnt) in enumerate(self.groups):
                if group & pg:
                    some = True
                    cur = cnt + 1
                    if not prev_flag[g]:
                        new_groups.append((group, cur))
                        prev_flag[g] = True
                    if cur >= self.consistency_th and not enough:
                        consistent.append(cand)
                        enough = True
            if not some:
                new_groups.append((group, 0))
        self.groups = new_groups
        return consistent

    def add(self, view_id: int, bow) -> None:
        """Insert the view into the database (a view without a BoW is
        left out)."""
        if bow is not None:
            self.db.add(view_id, bow)

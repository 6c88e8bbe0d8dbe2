# Copied from irotavg_tpu/engine/checkpoint.py (numpy only; deduplicate once irotavg_tpu imports lazily);
# load_checkpoint builds the port's ViewGraph, Frame, Connection and RelativePose;
# the database and the groups are those of the graph's LoopDetector.
"""First-class restartable checkpoints for the SLAM engine.

The reference only ever *writes* state — `rotavg_poses.txt` every 5
keyframes (src/IRotAvg.cpp:385-389) and a never-called view-graph YAML
serializer (src/ViewGraph.cpp:1148-1171); nothing can be loaded back.
Here the full engine state round-trips through one ``.npz`` snapshot:
rotations, fixed mask, edge list, per-frame feature bundles, match sets,
relative poses, the place-recognition database, loop-consistency groups,
and the adaptive search radius — so a run can resume exactly where it
stopped (same keyframe decisions, same solves).

Variable-length structures (BoW vectors, match lists, consistency groups)
are stored CSR-style: one concatenated array + one offsets array.
"""

from __future__ import annotations

import numpy as np

FORMAT_VERSION = 1

_FRAME_FIELDS = ("x", "y", "xu", "yu", "octave", "angle", "response",
                 "size", "desc", "valid", "cell")


def _csr(seqs, dtype, width=None):
    """Concatenate a list of arrays; return (data, offsets)."""
    offsets = np.zeros(len(seqs) + 1, np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    shape = (int(offsets[-1]),) if width is None else (int(offsets[-1]), width)
    data = np.zeros(shape, dtype)
    for i, s in enumerate(seqs):
        data[offsets[i]:offsets[i + 1]] = s
    return data, offsets


def _uncsr(data, offsets):
    return [data[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def save_checkpoint(vg, path: str, extra: dict | None = None) -> None:
    """Snapshot a :class:`~irotavg_tpu_torch.engine.viewgraph.ViewGraph`.

    ``extra`` holds caller-owned arrays (e.g. the app's sequence cursor);
    they round-trip through :func:`load_checkpoint`'s second return value.
    """
    out: dict[str, np.ndarray] = {
        "version": np.int64(FORMAT_VERSION),
        "min_matches": np.int64(vg.min_matches),
        "local_rad": np.float64(vg.local_rad),
        # solver state
        "Q": vg.ra.Q,
        "fixed": vg.ra.fixed,
        "edges": vg.ra.edges,
        "QQ": vg.ra.QQ,
    }

    # frames (equal capacity -> stacked)
    if vg.frames:
        caps = {len(f.valid) for f in vg.frames}
        if len(caps) != 1:
            raise ValueError(f"mixed frame capacities {caps}")
        out["frame_ids"] = np.array([f.id for f in vg.frames], np.int64)
        for name in _FRAME_FIELDS:
            out["frame_" + name] = np.stack(
                [np.asarray(getattr(f, name)) for f in vg.frames]
            )
        # descriptor words as the reference stores them (uint32)
        out["frame_desc"] = out["frame_desc"].view(np.uint32)
        has_bow = np.array([f.bow is not None for f in vg.frames])
        out["frame_has_bow"] = has_bow
        bows = [
            (np.fromiter(f.bow.keys(), np.int64, len(f.bow)),
             np.fromiter(f.bow.values(), np.float64, len(f.bow)))
            if f.bow is not None else (np.zeros(0, np.int64),
                                       np.zeros(0, np.float64))
            for f in vg.frames
        ]
        out["bow_ids"], out["bow_offsets"] = _csr(
            [b[0] for b in bows], np.int64)
        out["bow_w"], _ = _csr([b[1] for b in bows], np.float64)
        has_fn = np.array([f.feat_nodes is not None for f in vg.frames])
        out["frame_has_feat_nodes"] = has_fn
        cap = next(iter(caps))
        out["feat_nodes"] = np.stack([
            np.asarray(f.feat_nodes) if f.feat_nodes is not None
            else np.full(cap, -1, np.int64)
            for f in vg.frames
        ])

    # connections
    keys = sorted(vg.connections)
    conns = [vg.connections[k] for k in keys]
    out["conn_ij"] = np.array(keys, np.int64).reshape(-1, 2)
    out["conn_pairs"], out["conn_offsets"] = _csr(
        [c.pairs for c in conns], np.int64, width=2)
    out["conn_R"] = np.stack([c.pose.R for c in conns]) if conns \
        else np.zeros((0, 3, 3))
    out["conn_t"] = np.stack([c.pose.t for c in conns]) if conns \
        else np.zeros((0, 3))
    out["conn_E"] = np.stack([
        c.pose.E if c.pose.E is not None else np.zeros((3, 3))
        for c in conns
    ]) if conns else np.zeros((0, 3, 3))
    out["conn_nche"] = np.array([c.pose.n_cheirality for c in conns],
                                np.int64)

    # the loop detector: its database's views and its consistency groups
    out["db_ids"] = np.array(sorted(vg.loop.db.bows), np.int64)
    groups = vg.loop.groups
    out["group_members"], out["group_offsets"] = _csr(
        [np.fromiter(g, np.int64, len(g)) for g, _ in groups], np.int64)
    out["group_counts"] = np.array([c for _, c in groups], np.int64)

    for k, v in (extra or {}).items():
        out["extra_" + k] = np.asarray(v)
    np.savez_compressed(path, **out)


def load_checkpoint(path: str, camera, device=None):
    """Restore a ViewGraph; returns ``(view_graph, extra_dict)``.

    Camera/config objects are not serialised — pass the same ones the run
    was started with.  Frames and the solver go on ``device`` (the card
    unless ``device="cpu"``)."""
    from irotavg_tpu_torch.engine.viewgraph import Connection, ViewGraph
    from irotavg_tpu_torch.frontend.frame import Frame
    from irotavg_tpu_torch.geometry.twoview import RelativePose

    z = np.load(path)
    version = int(z["version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {version}")

    vg = ViewGraph(camera, min_matches=int(z["min_matches"]), device=device)
    vg.local_rad = float(z["local_rad"])

    # frames
    if "frame_ids" in z:
        bow_ids = _uncsr(z["bow_ids"], z["bow_offsets"])
        bow_w = _uncsr(z["bow_w"], z["bow_offsets"])
        for i, fid in enumerate(z["frame_ids"]):
            arrays = {name: z["frame_" + name][i] for name in _FRAME_FIELDS}
            bow = None
            if z["frame_has_bow"][i]:
                bow = dict(zip(bow_ids[i].tolist(), bow_w[i].tolist()))
            fn = z["feat_nodes"][i] if z["frame_has_feat_nodes"][i] else None
            vg.frames.append(Frame.restore(int(fid), camera, arrays,
                                           bow=bow, feat_nodes=fn,
                                           device=device))

    # solver state (rebuilt directly; connect() below must not re-add)
    ra = vg.ra
    ra.Q = np.array(z["Q"], ra.dtype)
    ra.fixed = np.array(z["fixed"], bool)
    ra.edges = np.array(z["edges"], np.int32)
    ra.QQ = np.array(z["QQ"], ra.dtype)
    ra._edges_by_max = [[] for _ in range(len(ra.Q))]
    for eid, (_, j) in enumerate(ra.edges):
        ra._edges_by_max[int(j)].append(eid)

    # connections + adjacency
    pairs_list = _uncsr(z["conn_pairs"], z["conn_offsets"])
    for k, (i, j) in enumerate(z["conn_ij"]):
        i, j = int(i), int(j)
        pairs = np.array(pairs_list[k], np.int64)
        rel = RelativePose(
            R=np.array(z["conn_R"][k]),
            t=np.array(z["conn_t"][k]),
            E=np.array(z["conn_E"][k]),
            n_cheirality=int(z["conn_nche"][k]),
            inlier_mask=np.ones(len(pairs), bool),
        )
        vg.connections[(i, j)] = Connection(pairs=pairs, pose=rel)
        vg.adjacency.setdefault(i, {})[j] = len(pairs)
        vg.adjacency.setdefault(j, {})[i] = len(pairs)

    # the loop detector: database + consistency groups
    for vid in z["db_ids"]:
        vg.loop.add(int(vid), vg.frames[int(vid)].bow)
    members = _uncsr(z["group_members"], z["group_offsets"])
    vg.loop.groups = [
        (set(m.tolist()), int(c))
        for m, c in zip(members, z["group_counts"])
    ]
    extra = {k[len("extra_"):]: z[k] for k in z.files
             if k.startswith("extra_")}
    return vg, extra

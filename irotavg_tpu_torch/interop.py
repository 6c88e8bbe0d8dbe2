"""Carry state from the JAX package into the port (numpy in, tensors out).

The parity tests use these to put identical features and solver state
into both packages.  Nothing here imports JAX: inputs are the host
(numpy) arrays of a reference ``Frame`` or ``IncrementalRotAvg``.
"""

from __future__ import annotations

import ast
import os

import numpy as np


FRAME_FIELDS = ("x", "y", "xu", "yu", "octave", "angle", "response", "size",
                "desc", "valid")


def frame_from_arrays(d: dict, camera, device=None, bow=None,
                      feat_nodes=None):
    """A port ``Frame`` from a reference Frame's host arrays (the fields
    ``x y xu yu octave angle response size desc valid``; ``desc`` as
    (N, 8) uint32 words, carried as int32 bit patterns), with a copy of
    the reference's ``bow`` dict and ``feat_nodes`` when given."""
    from irotavg_tpu_torch.frontend.frame import Frame

    return Frame.restore(0, camera, {k: d[k] for k in FRAME_FIELDS},
                         bow=None if feat_nodes is None else dict(bow or {}),
                         feat_nodes=feat_nodes, device=device)


def features_from_arrays(outs: list, device=None) -> dict:
    """Stacked ``(B, N, ...)`` tensors from a list of reference extractor
    outputs (dicts of host arrays: ``desc`` as (N, 8) uint32 words, carried
    as int32 bit patterns; ``x0, y0, x, y, angle, response, size`` f32;
    ``octave`` int32; ``valid`` bool) — the layout of the port's
    ``extract_batch``."""
    import torch

    from irotavg_tpu_torch.device import pick_device

    dev = pick_device(device)
    out = {}
    for k in outs[0]:
        a = np.stack([np.asarray(o[k]) for o in outs])
        if k == "desc":
            a = np.ascontiguousarray(a.astype(np.uint32)).view(np.int32)
        elif k == "octave":
            a = a.astype(np.int32)
        elif a.dtype != bool:
            a = a.astype(np.float32)
        out[k] = torch.as_tensor(a, device=dev)
    return out


def vocabulary_from_arrays(k, L, children, node_desc, weight, word_id,
                           is_leaf, scoring="L1", weighting="TF_IDF",
                           device=None):
    """A port ``Vocabulary`` from a reference Vocabulary's host arrays
    (``node_desc`` as (n_nodes, 8) uint32 words)."""
    from irotavg_tpu_torch.placerec.vocabulary import Vocabulary

    return Vocabulary(k, L, np.array(children), np.array(node_desc),
                      np.array(weight), np.array(word_id),
                      np.array(is_leaf), scoring=scoring,
                      weighting=weighting, device=device)


def incremental_from_arrays(Q, fixed, edges, QQ, device=None):
    """A port ``IncrementalRotAvg`` holding the reference solver state
    (absolute rotations ``Q``, pins ``fixed``, ``edges`` (m, 2) with
    i < j, relative rotations ``QQ``)."""
    from irotavg_tpu_torch.engine.incremental import IncrementalRotAvg

    ra = IncrementalRotAvg(device=device)
    ra.Q = np.array(Q, np.float64).reshape(-1, 4)
    ra.fixed = np.array(fixed, bool).reshape(-1)
    ra._edges_by_max = [[] for _ in range(ra.num_views)]
    for i, j in np.asarray(edges, np.int64).reshape(-1, 2):
        ra.add_edge(int(i), int(j), np.zeros(4))
    ra.QQ = np.array(QQ, np.float64).reshape(-1, 4)
    return ra


def orb_pattern_matches_reference(path: str | None = None) -> bool:
    """True when the copied ORB pattern equals the reference's table
    (read from ``irotavg_tpu/ops/orb_pattern.py`` as source, so that no
    JAX import happens)."""
    from irotavg_tpu_torch.ops.orb_pattern import ORB_PATTERN

    if path is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(repo, "irotavg_tpu", "ops", "orb_pattern.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "ORB_PATTERN"):
            table = np.array(ast.literal_eval(node.value.args[0]))
            return table.shape == ORB_PATTERN.shape and bool(
                np.array_equal(table, ORB_PATTERN))
    return False

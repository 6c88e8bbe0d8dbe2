"""The loop-closure slice end to end: test_loop_e2e.py's 14-frame
out-and-back sequence through the port's ViewGraph and the JAX ViewGraph
(consistency threshold 1: the JAX class's ``COVISIBILITY_CONSISTENCY_TH``,
the port's ``LoopClosureConfig.covisibility_consistency_th``), per
keyframe: process_frame -> loop candidates -> consistency -> close_loop
(+ a whole-graph solve) -> add_to_database -> rot_avg(10).

Two vocabularies, one test file each (each file compiles the JAX
programs once): here a k=8, L=3 one trained by the JAX package on the
sequence and carried across (with ``levelsup=4`` every node id is the
root, so the ``node``/``epipolar`` gates see one node);
test_torch_loop_e2e_fixture.py runs the same checks with the repo's
k=10, L=5 fixture, whose level-1 node ids really split the matches.

Both ViewGraphs get the same features (the port's frames are built from
the JAX frames' host arrays; each package computes its own BoW) and draw
the same RANSAC samples (the JAX side runs without x64, as its CLI
does).  Their solves round differently (f64 against f32), which can tip
a near-tied RANSAC decision, so: the same keyframes, loop edges and
connections, at least half of the connections carrying exactly the
reference's pairs, rotations within 0.1 deg of the reference's after
gauge alignment, and the reference test's bounds against ground truth
(test_loop_e2e.py:55-79).
"""

import gzip
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from irotavg_tpu import so3 as jso3
from irotavg_tpu.engine.viewgraph import ViewGraph as JaxViewGraph
from irotavg_tpu.frontend import Camera as JaxCamera
from irotavg_tpu.frontend import Frame as JaxFrame
from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu.placerec import train_vocabulary
from irotavg_tpu.placerec.vocabulary import Vocabulary as JaxVocabulary
from irotavg_tpu_torch.config import LoopClosureConfig
from irotavg_tpu_torch.engine.viewgraph import ViewGraph
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.interop import (
    FRAME_FIELDS, frame_from_arrays, vocabulary_from_arrays,
)
from irotavg_tpu_torch.ops import match
from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
from seqgen import make_sequence
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

# the consistency threshold of the short synthetic sequence
CONSISTENCY_TH = 1
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "product_vocab_k10_L5_v1.txt.gz")


def _sequence():
    frames, K, R_gt = make_sequence(n_frames=14, seed=4, step=0.3,
                                    yaw_deg_per_frame=-1.2, loop=True)
    kw = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
              height=480)
    jcam = JaxCamera(**kw)
    ext = JaxORB(n_features=1000, n_levels=8)
    jframes = [JaxFrame(i, im, ext, jcam) for i, im in enumerate(frames)]
    return jcam, Camera(**kw), jframes, R_gt


def _vocabs(which, jframes, tmp_dir):
    if which == "k8L3":
        # test_loop_e2e.py's vocabulary: trained on the sequence itself
        sample = [f.desc[f.valid][:300] for f in jframes[::4]]
        jv = train_vocabulary(sample, k=8, L=3, seed=0)
        return jv, vocabulary_from_arrays(
            jv.k, jv.L, jv.children, jv.node_desc, jv.weight, jv.word_id,
            jv.is_leaf, jv.scoring, jv.weighting, device="cpu")
    path = tmp_dir / "vocab.txt"
    with gzip.open(FIXTURE, "rb") as src, open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return (JaxVocabulary.load_text(str(path)),
            Vocabulary.load_text(str(path), device="cpu"))


def _run(vg, frames):
    """test_loop_e2e.py's loop, for either package's ViewGraph."""
    loops, kept = [], []
    for i, f in enumerate(frames):
        if not vg.process_frame(f, win_size=4):
            continue
        kept.append(i)
        view_id = vg.num_views - 1
        cands = vg.detect_loop_candidates(view_id)
        for cand in vg.check_loop_consistency(cands):
            if vg.close_loop(view_id, cand, min_matches=60):
                loops.append((cand, view_id))
                vg.rot_avg(5_000_000)      # whole-graph solve
        vg.add_to_database(view_id)
        vg.rot_avg(10)
    return loops, kept


def run_both(which, tmp_dir):
    """Both ViewGraphs through the sequence with vocabulary ``which``
    (``"k8L3"`` or ``"fixture"``); records the matcher gates the port's
    run reached."""
    jcam, cam, jframes, R_gt = _sequence()
    jvoc, tvoc = _vocabs(which, jframes, tmp_dir)
    for f in jframes:
        f.compute_bow(jvoc)
    jvg = JaxViewGraph(jcam, min_matches=60)
    jvg.COVISIBILITY_CONSISTENCY_TH = CONSISTENCY_TH
    with jax.enable_x64(False):              # as the JAX CLI runs
        jloops, jkept = _run(jvg, jframes)
    tframes = []
    for jf in jframes:
        f = frame_from_arrays({k: getattr(jf, k) for k in FRAME_FIELDS},
                              cam, device="cpu")
        f.id = jf.id
        f.compute_bow(tvoc)
        tframes.append(f)
    vg = ViewGraph(cam, min_matches=60, device="cpu",
                   loop_cfg=LoopClosureConfig(
                       covisibility_consistency_th=CONSISTENCY_TH))
    calls = []
    orig = match.best2_plain

    def spy(d1, d2, rowf, colf, gate):       # the gates the slice reaches
        calls.append(gate)
        return orig(d1, d2, rowf, colf, gate)

    match.best2_plain = spy
    try:
        loops, kept = _run(vg, tframes)
    finally:
        match.best2_plain = orig
    return {"which": which, "jax": (jvg, jloops, jkept),
            "port": (vg, loops, kept), "R_gt": R_gt, "gates": set(calls),
            "nodes": np.concatenate([f.feat_nodes for f in tframes])}


def _gauge_err_deg(q_est, q_ref):
    qa = jso3.qmul(q_est, np.tile(jso3.qinv_flipw(q_est[0]), (len(q_est), 1)))
    qb = jso3.qmul(q_ref, np.tile(jso3.qinv_flipw(q_ref[0]), (len(q_ref), 1)))
    return np.degrees(np.asarray(jso3.qgeodesic(jso3.qnormalize(qa), qb)))


def check_same_keyframes_and_loop_edges(both):
    jvg, jloops, jkept = both["jax"]
    vg, loops, kept = both["port"]
    assert kept == jkept
    assert loops == jloops
    assert sorted(vg.connections) == sorted(jvg.connections)


def check_loop_edges_span_beyond_window(both):
    """test_loop_e2e.py's bounds: >= 10 views and a loop edge spanning
    more than the window, each with >= 60 matches."""
    vg, loops, _ = both["port"]
    assert vg.num_views >= 10
    assert loops and max(j - i for i, j in loops) > 4
    for i, j in loops:
        assert vg.is_connected(i, j) and vg.adjacency[j][i] >= 60


def check_rotations_match_reference_and_ground_truth(both):
    jvg, _, jkept = both["jax"]
    vg, _, kept = both["port"]
    q_port = np.asarray(vg.ra.Q)
    assert _gauge_err_deg(q_port, np.asarray(jvg.ra.Q)).max() < 0.1
    q_gt = np.stack([np.asarray(jso3.rotmat_to_quat(both["R_gt"][i]))
                     for i in kept])
    err = _gauge_err_deg(q_port, q_gt)
    assert err.mean() < 1.5, f"mean rotation error {err.mean():.2f} deg"


def check_connections_carry_reference_pairs(both):
    """31 of 53 (k8L3) and 34 of 51 (fixture) on a CPU."""
    jvg, _, _ = both["jax"]
    vg, _, _ = both["port"]
    same = [np.array_equal(np.asarray(vg.connections[k].pairs),
                           np.asarray(jvg.connections[k].pairs))
            for k in vg.connections]
    assert sum(same) >= len(same) / 2, (sum(same), len(same))


def check_slice_reaches_the_node_and_epipolar_gates(both):
    """With node ids on every frame the slice matches under ``node``
    (loop verification) and ``epipolar`` (every re-match), never under
    ``epipolar_nonode``; only the fixture's nodes split the features."""
    assert {"node", "epipolar", "local"} <= both["gates"]
    assert "epipolar_nonode" not in both["gates"]
    real = both["nodes"][both["nodes"] >= 0]
    if both["which"] == "fixture":
        assert len(np.unique(real)) > 5
    else:
        assert set(np.unique(real).tolist()) == {0}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both("k8L3", tmp_path_factory.mktemp("vocab"))


def test_same_keyframes_and_loop_edges(both):
    check_same_keyframes_and_loop_edges(both)


def test_loop_edges_span_beyond_window(both):
    check_loop_edges_span_beyond_window(both)


def test_rotations_match_reference_and_ground_truth(both):
    check_rotations_match_reference_and_ground_truth(both)


def test_connections_carry_reference_pairs(both):
    check_connections_carry_reference_pairs(both)


def test_slice_reaches_the_node_and_epipolar_gates(both):
    check_slice_reaches_the_node_and_epipolar_gates(both)

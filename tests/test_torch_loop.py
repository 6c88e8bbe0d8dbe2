"""Loop closure in the port against the JAX package: the epipolar re-match
under the ``epipolar`` gate once frames carry vocabulary node ids, the
node ids ``process_frame`` hands to the per-frame loops, and the BoW
verification ``fused_bow_pair_estimate`` on the out-and-back sequence of
test_loop_e2e.py (the whole loop-closure slice is in
test_torch_loop_e2e.py).

Both packages get the same features: the port's frames are built from
the JAX frames' host arrays; their BoW vectors and node ids come from
each package's own vocabulary transform.  Tolerances: exact for matches,
0.05 deg for rotations (the same RANSAC draws, the JAX side without x64;
the two packages' solves round differently: f64 against f32).
"""

import gzip
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from irotavg_tpu.engine.viewgraph import ViewGraph as JaxViewGraph
from irotavg_tpu.frontend import Camera as JaxCamera
from irotavg_tpu.frontend import Frame as JaxFrame
from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu.geometry.fused import \
    fused_bow_pair_estimate as jax_bow_pair
from irotavg_tpu.matching import matchers as jm
from irotavg_tpu.placerec.vocabulary import Vocabulary as JaxVocabulary
from irotavg_tpu_torch import prng
from irotavg_tpu_torch.engine import viewgraph as tvg
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.geometry import fused
from irotavg_tpu_torch.interop import FRAME_FIELDS, frame_from_arrays
from irotavg_tpu_torch.matching import matchers as tm
from irotavg_tpu_torch.placerec.vocabulary import Vocabulary
from seqgen import make_sequence
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "product_vocab_k10_L5_v1.txt.gz")
MIN_MATCHES = 60


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """JAX frames with the fixture vocabulary's BoW, and port frames from
    the same features with the port's BoW."""
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    with gzip.open(FIXTURE, "rb") as src, open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    jvoc = JaxVocabulary.load_text(str(path))
    tvoc = Vocabulary.load_text(str(path), device="cpu")
    frames, K, R_gt = make_sequence(n_frames=14, seed=4, step=0.3,
                                    yaw_deg_per_frame=-1.2, loop=True)
    kw = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
              height=480)
    jcam, cam = JaxCamera(**kw), Camera(**kw)
    ext = JaxORB(n_features=1000, n_levels=8)
    jframes = [JaxFrame(i, im, ext, jcam, vocab=jvoc)
               for i, im in enumerate(frames)]
    tframes = [port_frame(f, cam, tvoc) for f in jframes]
    return jcam, jframes, cam, tframes, R_gt


def port_frame(jf, cam, vocab=None):
    """The port Frame with the JAX frame's features (and its own BoW)."""
    f = frame_from_arrays({k: getattr(jf, k) for k in FRAME_FIELDS}, cam,
                          device="cpu")
    f.id = jf.id
    if vocab is not None:
        f.compute_bow(vocab)
    return f


def test_frame_from_arrays_carries_reference_bow(scene):
    """``frame_from_arrays`` carries the reference's BoW and node ids
    across; they equal the port's own transform of the same features."""
    _, jframes, cam, tframes, _ = scene
    jf, own = jframes[5], tframes[5]
    f = frame_from_arrays({k: getattr(jf, k) for k in FRAME_FIELDS}, cam,
                          device="cpu", bow=jf.bow, feat_nodes=jf.feat_nodes)
    assert f.bow == jf.bow and f.bow is not jf.bow
    assert f.bow.keys() == own.bow.keys()
    np.testing.assert_array_equal(f.feat_nodes, np.asarray(jf.feat_nodes))
    np.testing.assert_array_equal(f.feat_nodes, own.feat_nodes)
    assert f.dev("feat_nodes").dtype == torch.int32
    np.testing.assert_array_equal(f.dev("feat_nodes").numpy(), f.feat_nodes)


def _consts(jcam):
    return JaxViewGraph(jcam)._consts()


class _Spy:
    """Wraps a function, recording the arguments and result of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


def _jax_rematch(jf1, jf2, F, has_nodes, c):
    """The reference's epipolar re-match of frame 1 rows against frame 2
    under the fundamental matrix ``F``."""
    nodes = (lambda f: f.dev("feat_nodes")) if has_nodes else \
        (lambda f: jnp.zeros(f.capacity, jnp.int32))
    return np.asarray(jm._match_epipolar_core(
        jf1.pm1, nodes(jf1), jf1.dev("valid"), jf1.dev("angle"),
        jf1.dev("xu"), jf1.dev("yu"), jf1.dev("octave"),
        jf2.pm1.T, nodes(jf2), jf2.dev("valid"), jf2.dev("angle"),
        jf2.dev("xu"), jf2.dev("yu"), jnp.asarray(F, jnp.float32),
        c["sigma2"], has_nodes=has_nodes))


@pytest.mark.parametrize("has_nodes", [True, False])
def test_refine_rematches_like_reference(scene, monkeypatch, has_nodes):
    """``fused_refine`` re-matches exactly like the JAX
    ``_match_epipolar_core`` on the same F: under the ``epipolar`` gate
    with node ids, under ``epipolar_nonode`` (zeros) without."""
    jcam, jframes, cam, tframes, _ = scene
    jf1, jf2, f1, f2 = jframes[0], jframes[2], tframes[0], tframes[2]
    c = _consts(jcam)
    E0, R0, t0, n0, m12_0, ok = jax_bow_pair(
        jf1.pm1, jf1.dev("feat_nodes"), jf1.dev("valid"), jf1.dev("angle"),
        jf1.dev("xu"), jf1.dev("yu"), jf1.dev("octave"),
        jf2.pm1.T, jf2.dev("feat_nodes"), jf2.dev("valid"),
        jf2.dev("angle"), jf2.dev("xu"), jf2.dev("yu"),
        c["K_inv"], c["sigma2"], c["camv"], c["th_norm"], np.uint32(7),
        np.float32(0.9), np.int32(MIN_MATCHES), has_nodes=True)
    assert bool(ok)
    spy = _Spy(tm._match_epipolar_core)
    monkeypatch.setattr(fused, "_match_epipolar_core", spy)
    t1 = tvg.ViewGraph._tensors(f1, has_nodes)
    t2 = tvg.ViewGraph._tensors(f2, has_nodes)
    tc = tvg.ViewGraph(cam, device="cpu")._consts(torch.device("cpu"))
    m12 = torch.from_numpy(np.asarray(m12_0, np.int64))
    fused.fused_refine(
        tuple(a[None] for a in t1), t2[:6],
        torch.from_numpy(np.array(E0))[None],
        torch.from_numpy(np.array(R0))[None],
        torch.from_numpy(np.array(t0))[None],
        (m12 >= 0).sum()[None], m12[None], tc["K_inv"], tc["sigma2"],
        tc["cam"], tc["th_norm"], [prng.key(0)],
        int(np.ceil(0.75 * MIN_MATCHES)), has_nodes=has_nodes)
    assert spy.calls
    for args, kwargs, out in spy.calls:
        assert kwargs["has_nodes"] is has_nodes
        F = args[13][0].numpy()
        ref = _jax_rematch(jf1, jf2, F, has_nodes, c)
        np.testing.assert_array_equal(out[0].numpy(), ref)
    # the gate matters on these frames: node ids change the re-match
    F = spy.calls[0][0][13][0].numpy()
    assert not np.array_equal(_jax_rematch(jf1, jf2, F, True, c),
                              _jax_rematch(jf1, jf2, F, False, c))


def _drive(vg, frames):
    for f in frames:
        vg.process_frame(f, win_size=4)


@pytest.mark.parametrize("with_nodes", [True, False])
def test_process_frame_passes_node_ids(scene, monkeypatch, with_nodes):
    """Every frame's ``feat_nodes`` reaches the per-frame loops, with
    ``has_nodes``, when the current, previous and all window frames carry
    them; otherwise zeros and ``epipolar_nonode``."""
    _, jframes, cam, tframes, _ = scene
    frames = tframes[:4] if with_nodes else \
        tframes[:3] + [port_frame(jframes[3], cam)]
    spy = _Spy(tvg.fused_process_frame)
    monkeypatch.setattr(tvg, "fused_process_frame", spy)
    vg = tvg.ViewGraph(cam, min_matches=MIN_MATCHES, device="cpu")
    _drive(vg, frames)
    assert len(spy.calls) == 3
    args, _, _ = spy.calls[-1]
    fc, fp, cands, has_nodes = args[0], args[1], args[2], args[-1]
    fw = tuple(torch.stack(a) for a in zip(*cands))
    assert has_nodes is with_nodes
    prev = [f for f in vg.frames if f is not frames[3]][-1]
    if with_nodes:
        assert torch.equal(fc[1], frames[3].dev("feat_nodes"))
        assert torch.equal(fp[1], prev.dev("feat_nodes"))
        assert (fw[1] != 0).any() and fw[1].shape == (3, fc[1].shape[0])
    else:
        assert not fc[1].any() and not fp[1].any() and not fw[1].any()


@pytest.mark.parametrize("pair", [(0, 13), (2, 11), (1, 6), (0, 7)])
def test_bow_pair_estimate_matches_reference(scene, pair):
    """The BoW match under the ``node`` gate is exactly the reference's;
    ``success`` is the same, and R is within 0.05 deg."""
    jcam, jframes, cam, tframes, _ = scene
    i, j = pair
    jf1, jf2, f1, f2 = jframes[i], jframes[j], tframes[i], tframes[j]
    c = _consts(jcam)
    ref_m12 = np.asarray(jm._match_by_bow_core(
        jf1.pm1, jf1.dev("feat_nodes"), jf1.dev("valid"), jf1.dev("angle"),
        jf2.pm1.T, jf2.dev("feat_nodes"), jf2.dev("valid"),
        jf2.dev("angle"), np.float32(0.9), has_nodes=True))
    t1, t2 = tvg.ViewGraph._tensors(f1, True), tvg.ViewGraph._tensors(f2, True)
    m12 = tm._match_by_bow_core(t1[0], t1[1], t1[2], t1[3], t2[0], t2[1],
                                t2[2], t2[3], 0.9, has_nodes=True)
    np.testing.assert_array_equal(m12.numpy(), ref_m12)
    assert (ref_m12 >= 0).sum() > 4

    with jax.enable_x64(False):              # the same draws as the port
        _, Rj, _, _, _, okj = jax_bow_pair(
            jf1.pm1, jf1.dev("feat_nodes"), jf1.dev("valid"),
            jf1.dev("angle"), jf1.dev("xu"), jf1.dev("yu"),
            jf1.dev("octave"), jf2.pm1.T, jf2.dev("feat_nodes"),
            jf2.dev("valid"), jf2.dev("angle"), jf2.dev("xu"),
            jf2.dev("yu"), c["K_inv"], c["sigma2"], c["camv"],
            c["th_norm"], np.uint32((j * 31 + i) & 0xFFFFFFFF),
            np.float32(0.9), np.int32(MIN_MATCHES), has_nodes=True)
    tc = tvg.ViewGraph(cam, device="cpu")._consts(torch.device("cpu"))
    _, R, _, _, m12f, ok = fused.fused_bow_pair_estimate(
        t1, t2, tc["K_inv"], tc["sigma2"], tc["cam"], tc["th_norm"],
        j * 31 + i, 0.9, MIN_MATCHES, True)
    assert ok == bool(okj)
    if ok:
        assert (m12f >= 0).sum() >= MIN_MATCHES
        ang = np.degrees(np.linalg.norm(Rsc.from_matrix(
            np.asarray(Rj, np.float64).T @ R.double().numpy()).as_rotvec()))
        assert ang < 0.05


def test_close_loop_connects_candidate_to_view(scene):
    """``close_loop`` verifies the revisit and connects ``(cand, view)``
    with the verified pairs; a pair without overlap is refused."""
    _, _, cam, tframes, _ = scene
    vg = tvg.ViewGraph(cam, min_matches=MIN_MATCHES, device="cpu")
    for f in tframes:
        vg.frames.append(f)
        vg.ra.add_view()
    assert vg.close_loop(13, 0, min_matches=MIN_MATCHES)
    assert vg.is_connected(0, 13) and vg.is_connected(13, 0)
    assert vg.adjacency[13][0] >= MIN_MATCHES
    pairs = vg.connections[(0, 13)].pairs
    assert pairs.shape[1] == 2 and len(np.unique(pairs[:, 1])) == len(pairs)
    assert not vg.close_loop(13, 0, min_matches=10_000)

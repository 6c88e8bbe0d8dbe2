"""The port's Frame-level matchers and dense Hamming distance against the
JAX package, on the same frames.

Two consecutive seqgen frames are extracted once by the JAX ORB extractor;
both packages get Frames restored from those host arrays (the port's on
the CPU, where ``best2`` runs its plain version; the JAX matcher runs its
dense CPU route).  Node ids, where used, are the low two bits of each
descriptor's first word, the same array in both packages, so that the
``node`` / ``epipolar`` gates keep most true matches and still cut.

Tolerance: none.  Assignments and Hamming distances are integers and must
be equal.
"""

import numpy as np
import pytest
import torch

from irotavg_tpu.frontend import Camera as JCamera
from irotavg_tpu.frontend import Frame as JFrame
from irotavg_tpu.frontend import ORBExtractor as JORB
from irotavg_tpu.geometry import find_relative_pose as j_find_pose
from irotavg_tpu.matching import matchers as jm
from irotavg_tpu.ops import hamming as jh
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.matching import matchers as tm
from irotavg_tpu_torch.ops import hamming as th
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

_KEYS = ("x", "y", "xu", "yu", "octave", "angle", "response", "size",
         "desc", "valid")


@pytest.fixture(scope="module")
def features():
    frames, K, _ = make_sequence(n_frames=2, seed=3, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    kw = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=640,
              height=480)
    jcam = JCamera(**kw)
    ext = JORB(n_features=800, n_levels=8)
    arrays = []
    for i, im in enumerate(frames):
        f = JFrame(i, im, ext, jcam)
        arrays.append({k: np.array(getattr(f, k)) for k in _KEYS})
    return arrays, jcam, Camera(**kw)


def _frames(features, nodes):
    """(JAX frame pair, port frame pair) from the same arrays."""
    arrays, jcam, cam = features
    out_j, out_t = [], []
    for i, a in enumerate(arrays):
        fn = (a["desc"][:, 0] & 3).astype(np.int32) if nodes else None
        out_j.append(JFrame.restore(i, jcam, dict(a), feat_nodes=fn))
        out_t.append(Frame.restore(i, cam, dict(a), feat_nodes=fn,
                                   device="cpu"))
    return out_j, out_t


def _assert_same(got, ref, min_matches):
    ref = np.asarray(ref)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref.astype(got.dtype))
    assert (ref >= 0).sum() >= min_matches


@pytest.mark.parametrize("guess", ["motion-free", "shifted"])
def test_match_locally_equals_jax(features, guess):
    (j1, j2), (t1, t2) = _frames(features, nodes=False)
    kw = {}
    if guess == "shifted":
        kw["guess_xy"] = (t2.xu + 3.0, t2.yu - 2.0)
    ref = jm.match_locally(j2, j1, radius=40.0, **kw)
    got = tm.match_locally(t2, t1, radius=40.0, **kw)
    _assert_same(got, ref, 100)


@pytest.mark.parametrize("has_nodes", [False, True])
def test_match_by_bow_equals_jax(features, has_nodes):
    """Without node ids on either frame the search is global (gate
    ``none``), with them it is per node (gate ``node``)."""
    (j1, j2), (t1, t2) = _frames(features, nodes=has_nodes)
    ref = jm.match_by_bow(j1, j2)
    got = tm.match_by_bow(t1, t2)
    _assert_same(got, ref, 50)


def test_match_by_bow_one_frame_without_nodes_searches_globally(features):
    (j1, _), (t1, _) = _frames(features, nodes=False)
    (_, j2), (_, t2) = _frames(features, nodes=True)
    _assert_same(tm.match_by_bow(t1, t2), jm.match_by_bow(j1, j2), 50)
    _assert_same(tm.match_by_bow(t1, t2),
                 tm.match_by_bow(*_frames(features, nodes=False)[1]), 50)


@pytest.mark.parametrize("has_nodes", [False, True])
def test_match_epipolar_equals_jax(features, has_nodes):
    """The epipolar gate of F = K^-T E K^-1 from the JAX pose of the two
    frames' local matches, the same F in both packages."""
    (j1, j2), (t1, t2) = _frames(features, nodes=has_nodes)
    jcam = features[1]
    pairs = jm.matches_to_pairs(jm.match_locally(j1, j2, radius=40.0))
    rel = j_find_pose(j1, j2, pairs, jcam)
    assert rel is not None
    K_inv = np.linalg.inv(jcam.K)
    F = K_inv.T @ rel.E @ K_inv
    ref = jm.match_epipolar(j1, j2, F)
    got = tm.match_epipolar(t1, t2, F)
    _assert_same(got, ref, 100)


def test_hamming_matrix_equals_jax(features):
    a, b = features[0]
    d1 = a["desc"][a["valid"]][:300]
    d2 = b["desc"][b["valid"]][:250]
    ref = np.asarray(jh.hamming_matrix(d1, d2))
    got = th.hamming_matrix(torch.from_numpy(d1.view(np.int32)),
                            torch.from_numpy(d2.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (300, 250)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the matcher's distances are these: the best column's distance
    assert got.min(dim=1).values.min() >= 0 and got.max() <= 256


def test_popcount32_equals_jax():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x55555555,
                  0xAAAAAAAA], np.uint32)])
    ref = np.asarray(jh.popcount32(words)).astype(np.int64)
    got = th.popcount32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        ref, [bin(int(w)).count("1") for w in words])

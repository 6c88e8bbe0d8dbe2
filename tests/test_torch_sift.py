"""The port's SIFT front end and ``match_sift`` against the JAX package,
and the behaviour tests of ``tests/test_sift.py`` on the port.

Parity runs on a 640x480 seqgen frame at 600 features and 3 octaves.
Tolerances: at least 99% of the JAX package's valid keypoints are found
at the same (octave, x0, y0); descriptors agree within 1e-3 (L-inf) on at
least 98% of the common keypoints (the blur, the exponentials and the
norms round differently from XLA's, in the last bits); orientations
within 1e-3 rad on the same share.  ``match_sift`` fed the JAX package's
own descriptors gives the JAX assignment exactly.
"""

import numpy as np
import pytest
import torch

from irotavg_tpu.frontend.sift import SIFTExtractor as JSIFT
from irotavg_tpu.frontend.sift import _octave_budgets as j_budgets
from irotavg_tpu.matching.matchers import match_sift as j_match_sift
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.frontend.sift import SIFTExtractor, _octave_budgets
from irotavg_tpu_torch.matching.matchers import match_sift, matches_to_pairs
from irotavg_tpu_torch.ops.image import pad_reflect101
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

KEYPOINT_SHARE = 0.99
DESC_TOL = 1e-3
DESC_SHARE = 0.98


@pytest.fixture(scope="module")
def pair():
    frames, K, _ = make_sequence(n_frames=2, seed=5, step=0.25,
                                 yaw_deg_per_frame=-0.8)
    ext = SIFTExtractor(n_features=600, n_octaves=3, device="cpu")
    return [ext(f) for f in frames], frames


@pytest.fixture(scope="module")
def jax_pair(pair):
    jext = JSIFT(n_features=600, n_octaves=3)
    return [{k: np.asarray(v) for k, v in jext(f).items()} for f in pair[1]]


def _np(o):
    return {k: v.numpy() for k, v in o.items()}


def _keyed(o):
    v = o["valid"]
    return {(int(a), float(x), float(y)): i
            for i, (a, x, y) in enumerate(zip(o["octave"], o["x0"], o["y0"]))
            if v[i]}


def test_keypoints_and_descriptors_match_jax(pair, jax_pair):
    for got, ref in zip(pair[0], jax_pair):
        got = _np(got)
        assert set(got) == set(ref)
        for k in ref:
            # the port computes in f32 (JAX under the tests' x64 setting
            # returns its angles and descriptors in f64)
            assert got[k].shape == ref[k].shape, k
            assert got[k].dtype == (np.float32 if ref[k].dtype.kind == "f"
                                    else ref[k].dtype), k
        kj, kt = _keyed(ref), _keyed(got)
        common = sorted(set(kj) & set(kt))
        assert len(kj) > 100
        assert len(common) >= KEYPOINT_SHARE * len(kj)
        ij = np.array([kj[c] for c in common])
        it = np.array([kt[c] for c in common])
        err = np.abs(got["desc"][it] - ref["desc"][ij]).max(axis=1)
        assert (err <= DESC_TOL).mean() >= DESC_SHARE
        da = np.abs(got["angle"][it] - ref["angle"][ij])
        assert (da <= 1e-3).mean() >= DESC_SHARE
        np.testing.assert_allclose(got["size"][it], ref["size"][ij],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["response"][it],
                                   ref["response"][ij], rtol=1e-4,
                                   atol=1e-7)


def _frame(o, i=0):
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                 height=480)
    return Frame.from_extracted(i, o, cam)


def test_match_sift_on_jax_descriptors_equals_jax(jax_pair):
    class F:
        pass

    fs = []
    for o in jax_pair:
        f = F()
        f.desc, f.valid = o["desc"], o["valid"]
        fs.append(f)
    ref = np.asarray(j_match_sift(fs[0], fs[1]))
    got = match_sift(*[_frame({k: torch.from_numpy(np.array(v))
                               for k, v in o.items()}, i)
                       for i, o in enumerate(jax_pair)])
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, ref)
    assert (ref >= 0).sum() > 40


def test_extractor_shapes_and_mask(pair):
    o = _np(pair[0][0])
    n = o["x0"].shape[0]
    assert n == SIFTExtractor(n_features=600, n_octaves=3,
                              device="cpu").capacity
    assert o["desc"].shape == (n, 128) and o["desc"].dtype == np.float32
    v = o["valid"]
    assert v.sum() > 100
    nrm = np.linalg.norm(o["desc"][v], axis=1)
    np.testing.assert_allclose(nrm, 1.0, atol=1e-3)
    for n, o in ((600, 3), (2000, 4), (300, 1), (40, 4)):
        assert _octave_budgets(n, o) == j_budgets(n, o)


def test_keypoints_inside_image(pair):
    o = _np(pair[0][0])
    h, w = pair[1][0].shape
    v = o["valid"]
    assert (o["x0"][v] < w).all() and (o["y0"][v] < h).all()
    assert (o["response"][v] > 0).all()


def test_match_sift_finds_consistent_motion(pair):
    f1, f2 = (_frame(o, i) for i, o in enumerate(pair[0]))
    pairs = matches_to_pairs(match_sift(f1, f2))
    assert len(pairs) > 40
    dx = f2.x[pairs[:, 1]] - f1.x[pairs[:, 0]]
    dy = f2.y[pairs[:, 1]] - f1.y[pairs[:, 0]]
    mx, my = np.median(dx), np.median(dy)
    inl = (np.abs(dx - mx) < 8) & (np.abs(dy - my) < 8)
    assert inl.mean() > 0.6
    assert abs(mx) > 1.0


def test_descriptor_rotation_covariance():
    """The same structure rotated 90 deg matches itself."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(7)
    im = rng.integers(0, 255, (160, 160), np.uint8)
    im = ndi.gaussian_filter(im.astype(np.float32), 2.0)
    im = (255 * (im - im.min()) / (np.ptp(im) + 1e-9)).astype(np.uint8)
    im90 = np.rot90(im).copy()
    ext = SIFTExtractor(n_features=200, n_octaves=2, device="cpu")
    o1, o2 = ext(im), ext(im90)
    pairs = matches_to_pairs(match_sift(_frame(o1), _frame(o2)))
    assert len(pairs) >= 10
    x1, y1 = o1["x0"].numpy()[pairs[:, 0]], o1["y0"].numpy()[pairs[:, 0]]
    x2, y2 = o2["x0"].numpy()[pairs[:, 1]], o2["y0"].numpy()[pairs[:, 1]]
    err = np.hypot(y1 - x2, im.shape[1] - 1 - x1 - y2)
    assert np.median(err) < 3.0


def test_frame_accepts_sift_extractor():
    """Frame takes the extractor's descriptor type: (N, 128) f32 rows,
    with ``n_valid`` and ``cell``; a vocabulary of ORB words is refused."""
    frames, K, _ = make_sequence(n_frames=1, seed=3)
    cam = Camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                 width=640, height=480)
    ext = SIFTExtractor(n_features=300, n_octaves=3, device="cpu")
    f = Frame(0, frames[0], ext, cam, keep_image=True)
    assert f.desc.shape[1] == 128 and f.desc.dtype == np.float32
    assert f.dev("desc").dtype == torch.float32
    assert f.n_valid > 50
    assert f.cell.shape == (len(f.valid), 2)
    assert f.image is frames[0] or np.array_equal(f.image, frames[0])
    with pytest.raises(ValueError, match="float"):
        f.compute_bow(object())
    assert Frame(0, frames[0], ext, cam).image is None


def test_pad_reflect101_refuses_a_pad_past_the_axis():
    img = torch.arange(12.0).reshape(3, 4)
    out = pad_reflect101(img, 2)
    np.testing.assert_array_equal(
        out.numpy(), np.pad(img.numpy(), 2, mode="reflect"))
    with pytest.raises(ValueError, match="REFLECT_101"):
        pad_reflect101(img, 3)

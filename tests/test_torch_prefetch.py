"""The port's batched look-ahead extraction (``frontend/prefetch.py``)
against its per-frame extraction and against the JAX ``FramePrefetcher``
on the images of tests/test_prefetch.py (96x128, 60 features, 3 levels),
and the CLI's ``--prefetch`` widths against each other.

Tolerances: against the port's per-frame frames, descriptors, validity
and every keypoint array exactly equal, ``xu`` and ``angle`` within 1e-5
(the reference test's bounds); against the JAX package, those of
test_torch_frontend.py (keypoints exact, >= 99% of descriptors
bit-identical, the rest at most 8 bits apart).
"""

import numpy as np
import pytest
import torch

from irotavg_tpu.frontend import Camera as JaxCamera
from irotavg_tpu.frontend import FramePrefetcher as JaxPrefetcher
from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu.frontend.prefetch import _undistort_xla
from irotavg_tpu.frontend.prefetch import \
    sample_descriptors as jax_sample_descriptors
from irotavg_tpu_torch.app import irotavg as port_cli
from irotavg_tpu_torch.frontend.camera import Camera
from irotavg_tpu_torch.frontend.frame import Frame
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.frontend.prefetch import (
    FramePrefetcher, _undistort, sample_descriptors,
)
from irotavg_tpu_torch.interop import vocabulary_from_arrays
from irotavg_tpu_torch.utils.sequence import write_pgm
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

H, W = 96, 128
EXACT = ("x", "y", "octave", "response", "size", "desc", "valid")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (H * 2, W * 2), np.uint8)
    imgs = [np.ascontiguousarray(base[dy:dy + H, dx:dx + W])
            for dy, dx in [(0, 0), (3, 5), (7, 2), (11, 9), (15, 4),
                           (20, 13), (24, 6)]]
    cam = Camera(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, width=W, height=H)
    ext = ORBExtractor(n_features=60, n_levels=3, device="cpu")
    return imgs, cam, ext


@pytest.mark.parametrize("i", [0, 3, 6])   # first batch, middle, padded tail
def test_prefetcher_matches_direct_extraction(setup, i):
    imgs, cam, ext = setup
    pf = FramePrefetcher(imgs, ext, cam, batch=4)
    got = pf.frame(i)
    want = Frame(i, imgs[i], ext, cam)
    assert got.id == i
    assert want.valid.sum() > 20
    for k in EXACT:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_allclose(got.xu, want.xu, atol=1e-5)
    np.testing.assert_allclose(got.angle, want.angle, atol=1e-5)


def test_extract_batch_is_per_image_extract(setup):
    """Every output of the batched pyramid equals the per-image one bit
    for bit, angles included."""
    imgs, _, ext = setup
    batch = ext.extract_batch(imgs)
    for b, im in enumerate(imgs):
        one = ext(im)
        for k, v in one.items():
            assert torch.equal(batch[k][b], v), (b, k)


@pytest.mark.parametrize("op", ["blur", "resize", "fast", "nms",
                                "fallback"])
def test_image_ops_take_a_batch_axis_bit_equal(setup, op):
    """Each image op on a (B, H, W) stack equals the op image by image."""
    from irotavg_tpu_torch.ops import fast, image

    imgs = torch.from_numpy(np.stack(setup[0][:3]).astype(np.float32))
    fn = {"blur": image.gaussian_blur7,
          "resize": lambda x: image.resize_bilinear(x, 80, 107),
          "fast": fast.fast_score_map,
          "nms": lambda x: fast.nms3(fast.fast_score_map(x)),
          "fallback": lambda x: fast.cell_fallback_mask(
              fast.fast_score_map(x), 20.0, 7.0)}[op]
    batch = fn(imgs)
    for b in range(len(imgs)):
        assert torch.equal(batch[b], fn(imgs[b]))


def test_prefetcher_matches_jax_prefetcher(setup):
    imgs, cam, ext = setup
    jcam = JaxCamera(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, width=W,
                     height=H)
    jpf = JaxPrefetcher(imgs, JaxORB(n_features=60, n_levels=3), jcam,
                        batch=4)
    pf = FramePrefetcher(imgs, ext, cam, batch=4)
    same = total = 0
    for i in range(len(imgs)):
        got, want = pf.frame(i), jpf.frame(i)
        for k in ("x", "y", "octave", "valid"):
            np.testing.assert_array_equal(getattr(got, k),
                                          np.asarray(getattr(want, k)),
                                          err_msg=f"frame {i} {k}")
        v = np.asarray(want.valid)
        a = np.asarray(want.desc)[v].astype(np.uint32)
        b = got.desc[v].view(np.uint32)
        bits = np.unpackbits((a ^ b).view(np.uint8), axis=1).sum(axis=1)
        assert bits.max() <= 8
        same += int((bits == 0).sum())
        total += len(bits)
    assert total > 150 and same >= 0.99 * total, (same, total)


def test_undistort_matches_jax_and_host():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 640, 300).astype(np.float32)
    y = rng.uniform(0, 480, 300).astype(np.float32)
    cam = Camera(fx=500.0, fy=510.0, cx=320.0, cy=240.0, k1=-0.28,
                 k2=0.07, p1=1e-3, p2=-5e-4, width=640, height=480)
    dist = (cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2)
    xu, yu = _undistort(torch.from_numpy(x), torch.from_numpy(y), dist)
    jx, jy = _undistort_xla(x, y, dist)
    np.testing.assert_allclose(xu.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(yu.numpy(), np.asarray(jy), atol=1e-5)
    hx, hy = cam.undistort_points(x, y)       # the host's f64 scheme
    np.testing.assert_allclose(xu.numpy(), hx, atol=1e-3)
    np.testing.assert_allclose(yu.numpy(), hy, atol=1e-3)


def test_distorted_camera_prefetch_undistorts_on_the_device(setup):
    imgs, _, ext = setup
    cam = Camera(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, k1=-0.2, k2=0.05,
                 width=W, height=H)
    got = FramePrefetcher(imgs, ext, cam, batch=4).frame(5)
    want = Frame(5, imgs[5], ext, cam)               # host f64
    np.testing.assert_array_equal(got.x, want.x)
    assert not np.allclose(got.xu, got.x)
    np.testing.assert_allclose(got.xu, want.xu, atol=1e-3)
    np.testing.assert_allclose(got.yu, want.yu, atol=1e-3)


def test_transform_batch_bow_equals_per_frame(setup):
    """One batched descent per batch gives each frame the BoW vector and
    node ids of the per-frame transform (a vocabulary trained by the JAX
    package and carried over)."""
    from irotavg_tpu.placerec import train_vocabulary

    imgs, cam, ext = setup
    jvoc = train_vocabulary(
        jax_sample_descriptors(imgs, JaxORB(n_features=60, n_levels=3),
                               batch=4, cap=200), k=4, L=2, seed=0)
    vocab = vocabulary_from_arrays(
        jvoc.k, jvoc.L, jvoc.children, jvoc.node_desc, jvoc.weight,
        jvoc.word_id, jvoc.is_leaf, jvoc.scoring, jvoc.weighting,
        device="cpu")
    pf = FramePrefetcher(imgs, ext, cam, batch=4, vocab=vocab)
    for i in (2, 5):
        f = pf.frame(i)
        want = Frame(i, imgs[i], ext, cam, vocab=vocab)
        assert f.bow and f.bow == want.bow
        np.testing.assert_array_equal(f.feat_nodes, want.feat_nodes)
        np.testing.assert_array_equal(f.dev("feat_nodes").numpy(),
                                      want.feat_nodes)


def test_sample_descriptors_matches_jax(setup):
    imgs, _, ext = setup
    got = sample_descriptors(imgs, ext, batch=4, cap=40, stride=2)
    want = jax_sample_descriptors(imgs, JaxORB(n_features=60, n_levels=3),
                                  batch=4, cap=40, stride=2)
    assert len(got) == len(want) == 4
    same = total = 0
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and g.shape == w.shape
        assert 0 < len(g) <= 40
        same += int((g == w).all(axis=1).sum())
        total += len(g)
    assert same >= 0.99 * total


def test_prefetcher_iteration_covers_sequence(setup):
    imgs, cam, ext = setup
    pf = FramePrefetcher(imgs, ext, cam, batch=4)
    assert len(pf) == len(imgs)
    assert [f.id for f in pf] == list(range(len(imgs)))
    assert not pf._cache                # every frame handed out once


def test_cli_prefetch_widths_agree(tmp_path):
    """``--prefetch 4`` and ``--prefetch 1`` write the same files."""
    frames, K, _ = make_sequence(n_frames=6, seed=1, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, im in enumerate(frames):
        write_pgm(str(seq / f"{i:06d}.pgm"), im)
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
        f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        "ORBextractor.nFeatures: 800\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    outs = {}
    for b in (4, 1):
        out = tmp_path / f"out{b}"
        assert port_cli.main(["none", str(yaml), str(seq), "--image_ext",
                              ".pgm", "--out_dir", str(out), "--prefetch",
                              str(b), "--device", "cpu"]) == 0
        outs[b] = [(out / n).read_text() for n in
                   ("rotavg_poses.txt", "rotavg_poses_ids.txt")]
    assert len(outs[4][1].split()) >= 4
    assert outs[4] == outs[1]


def _write_seq(tmp_path, frames, K, k1=0.0, k2=0.0):
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, im in enumerate(frames):
        write_pgm(str(seq / f"{i:06d}.pgm"), im)
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {K[0, 0]}\nCamera.fy: {K[1, 1]}\n"
        f"Camera.cx: {K[0, 2]}\nCamera.cy: {K[1, 2]}\n"
        f"Camera.k1: {k1}\nCamera.k2: {k2}\nCamera.p1: 0.0\n"
        "Camera.p2: 0.0\n"
        "ORBextractor.nFeatures: 800\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
        "ORBextractor.minThFAST: 7\n")
    return seq, yaml


K1, K2 = -0.12, 0.02      # barrel distortion of a wide-angle lens


def test_lens_distortion_paths_match_jax_and_cli_widths(tmp_path):
    """k1 != 0.  The batched path undistorts on the device in f32 and the
    per-frame path on the host in f64, in the port as in the JAX package
    (``irotavg_tpu/frontend/prefetch.py:27``, ``frontend/frame.py``).
    Each of the port's paths matches the JAX package's same path on the
    same frames within 1e-3 px.  The CLI at ``--prefetch 8`` and
    ``--prefetch 1`` then makes the same keyframe decisions on this
    sequence; the poses are not compared (the two undistortions differ
    by up to 1e-3 px, so the solves may differ in the last digits)."""
    frames, K, _ = make_sequence(n_frames=6, seed=1, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    h, w = frames[0].shape
    kw = dict(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], k1=K1, k2=K2,
              width=w, height=h)
    cam, jcam = Camera(**kw), JaxCamera(**kw)
    ext = ORBExtractor(n_features=800, n_levels=8, device="cpu")
    jext = JaxORB(n_features=800, n_levels=8)
    pf = FramePrefetcher(frames, ext, cam, batch=8)
    jpf = JaxPrefetcher(frames, jext, jcam, batch=8)
    for i in (0, 3, 5):
        batched, jbatched = pf.frame(i), jpf.frame(i)
        one, jone = Frame(i, frames[i], ext, cam), _jax_frame(i, frames[i],
                                                              jext, jcam)
        for got, want, path in ((batched, jbatched, "batched"),
                                (one, jone, "per-frame")):
            np.testing.assert_array_equal(got.x, np.asarray(want.x))
            assert not np.allclose(got.xu, got.x), path
            for k in ("xu", "yu"):
                np.testing.assert_allclose(getattr(got, k),
                                           np.asarray(getattr(want, k)),
                                           atol=1e-3, err_msg=f"{path} {k}")

    seq, yaml = _write_seq(tmp_path, frames, K, k1=K1, k2=K2)
    ids = {}
    for b in (8, 1):
        out = tmp_path / f"out{b}"
        assert port_cli.main(["none", str(yaml), str(seq), "--image_ext",
                              ".pgm", "--out_dir", str(out), "--prefetch",
                              str(b), "--device", "cpu"]) == 0
        ids[b] = (out / "rotavg_poses_ids.txt").read_text()
    assert len(ids[8].split()) >= 4
    assert ids[8] == ids[1]


def _jax_frame(i, image, extractor, camera):
    from irotavg_tpu.frontend import Frame as JaxFrame

    return JaxFrame(i, image, extractor, camera)

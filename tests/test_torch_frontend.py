"""The port's ORB front end against the JAX reference on one 640x480
``seqgen`` frame with 1000 features.

Tolerances: x, y, octave and valid exactly equal; responses and angles
exactly / within 1e-4 rad on level 0, and within 1e-5 (relative) / 5e-4
rad on the resampled levels, because XLA on the CPU contracts the
resize's ``a*b + c*d`` into a fused multiply-add (checked in
``test_resize_rounding_differs_only_by_contraction``) while the port
rounds each product, so upper-level pixels differ in the last ulp;
descriptors at least 99% bit-identical, the rest at most 8 bits apart
(the blurred level can round across .5 differently).  Measured on this
frame: 987 of the 988 valid descriptors (99.90%) are bit-identical and
the other differs in one bit; the largest angle difference is 1.3e-4
rad, on a resampled level.
"""

import jax
import numpy as np
import pytest
import torch

from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu.ops.fast import fast_score_map as jfast, nms3 as jnms3
from irotavg_tpu.ops.image import gaussian_blur7 as jblur
from irotavg_tpu.ops.image import resize_bilinear as jresize
from irotavg_tpu_torch import interop
from irotavg_tpu_torch.frontend.orb import ORBExtractor
from irotavg_tpu_torch.ops.fast import fast_score_map, nms3
from irotavg_tpu_torch.ops.image import gaussian_blur7, resize_bilinear
from seqgen import make_sequence

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image():
    frames, _, _ = make_sequence(n_frames=1, seed=1, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    return frames[0]


@pytest.fixture(scope="module")
def extracted(image):
    ref = {k: np.asarray(v) for k, v in
           JaxORB(n_features=1000, n_levels=8)(image).items()}
    got = {k: v.numpy() for k, v in
           ORBExtractor(n_features=1000, n_levels=8, device="cpu")(
               image).items()}
    return ref, got


def test_fast_scores_and_nms_equal(image):
    img = np.float32(image)
    ref = np.asarray(jfast(img))
    got = fast_score_map(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(nms3(torch.tensor(ref)).numpy(),
                                  np.asarray(jnms3(ref)))


def test_blur_and_resize_close(image):
    img = np.float32(image)
    np.testing.assert_allclose(
        gaussian_blur7(torch.from_numpy(img)).numpy(),
        np.asarray(jblur(img)), atol=2e-4)
    np.testing.assert_allclose(
        resize_bilinear(torch.from_numpy(img), 400, 533).numpy(),
        np.asarray(jresize(img, 400, 533)), atol=2e-4)


def test_resize_rounding_differs_only_by_contraction(image):
    """The reference's resize equals the port's blend with its first
    product fused (computed in f64, rounded once)."""
    img = np.float32(image)
    r0, r1 = img[:-1], img[1:]
    wy = np.float32(0.3)
    ref = np.asarray(jax.jit(lambda a, b: a * (1.0 - wy) + b * wy)(r0, r1))
    fused = (r0.astype(np.float64) * np.float64(np.float32(1.0) - wy)
             + (r1 * wy).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(ref, fused)


def test_keypoints_equal(extracted):
    ref, got = extracted
    for k in ("x", "y", "x0", "y0", "octave", "valid", "size"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["valid"].sum() > 500
    lv0 = ref["octave"] == 0
    np.testing.assert_array_equal(got["response"][lv0], ref["response"][lv0])
    v = ref["valid"]
    np.testing.assert_allclose(got["response"][v], ref["response"][v],
                               rtol=1e-5)


def test_angles_close(extracted):
    ref, got = extracted
    v = ref["valid"]
    d = np.abs(got["angle"] - ref["angle"])
    d = np.minimum(d, 2 * np.pi - d)
    assert d[v & (ref["octave"] == 0)].max() < 1e-4
    assert d[v].max() < 5e-4


def test_ic_angles_on_identical_patches(image):
    from irotavg_tpu.ops.orient import ic_angles as jangles
    from irotavg_tpu_torch.ops.orient import ic_angles

    rng = np.random.default_rng(0)
    img = np.float32(image)
    ys = rng.integers(15, 480 - 16, 200)
    xs = rng.integers(15, 640 - 16, 200)
    patches = np.stack([img[y - 15:y + 16, x - 15:x + 16]
                        for y, x in zip(ys, xs)])
    np.testing.assert_allclose(ic_angles(torch.from_numpy(patches)).numpy(),
                               np.asarray(jangles(patches)), atol=1e-5)


def test_descriptors_nearly_bit_identical(extracted):
    ref, got = extracted
    v = ref["valid"]
    a = ref["desc"][v].astype(np.uint32)
    b = got["desc"][v].view(np.uint32)
    bits = np.unpackbits((a ^ b).view(np.uint8), axis=1).sum(axis=1)
    same = np.mean(bits == 0)
    assert same >= 0.99, f"only {same:.4f} of descriptors bit-identical"
    assert bits.max() <= 8


def test_frame_from_reference_arrays(extracted):
    """interop.frame_from_arrays carries a reference frame's host arrays
    into a port Frame unchanged."""
    from irotavg_tpu_torch.frontend.camera import Camera

    ref, _ = extracted
    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                 height=480)
    d = {"x": ref["x0"], "y": ref["y0"], "xu": ref["x0"], "yu": ref["y0"],
         "octave": ref["octave"], "angle": ref["angle"],
         "response": ref["response"], "size": ref["size"],
         "desc": ref["desc"], "valid": ref["valid"]}
    f = interop.frame_from_arrays(d, cam, "cpu")
    assert f.capacity == len(ref["valid"])
    assert np.array_equal(f.desc.view(np.uint32), ref["desc"])
    assert f.dev("desc").dtype == torch.int32
    np.testing.assert_array_equal(f.xu, ref["x0"])


def test_orb_pattern_copy_is_identical():
    assert interop.orb_pattern_matches_reference()

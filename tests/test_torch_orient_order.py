"""ORB orientation and steering that round the same whatever order a
device adds in (``ops/orient.py:ic_angles``, ``ops/brief.py:
steered_brief``), on the CPU.

A GPU sums the 961 moment products in another order than the CPU, so the
port computes the moments, ``atan2`` and the steering in f64 and rounds to
f32 once.  The CPU stand-ins for order independence:

* the same patches in three memory layouts (a contiguous copy, a
  transposed then re-transposed view, a shuffled batch order) give
  bit-identical angles and descriptors;
* the angles equal, bit for bit, an independent numpy f64 computation
  (pairwise sums in numpy's order) rounded to f32, and the descriptors
  numpy's f64 steering of those angles;
* on identical integer (level-0) patches, the angles stay within 1e-5
  rad of the JAX package's f32 ones; on resized patches, within 1e-5 rad
  plus the move its f32 sums' rounding explains.

Patches are bilinear-resized (non-integer) pixels, like the pyramid's
upper levels, where f32 sums round.
"""

import numpy as np
import pytest
import torch

from irotavg_tpu.ops.orient import ic_angles as jax_ic_angles
from irotavg_tpu_torch.ops.brief import PATCH_R, PATCH_W, steered_brief
from irotavg_tpu_torch.ops.image import resize_bilinear
from irotavg_tpu_torch.ops.orb_pattern import ORB_PATTERN
from irotavg_tpu_torch.ops.orient import HALF_PATCH, ic_angles, orb_disc_mask

torch.set_num_threads(1)

K = 1500


@pytest.fixture(scope="module")
def patches():
    """(K, 31, 31) orientation patches and (K, 41, 41) blurred-level
    patches cut from a smoothed random image resized by 1/1.2."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (300, 400)).astype(np.float32)
    img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
           + np.roll(img, (1, 1), (0, 1))) / 4
    lvl = resize_bilinear(torch.from_numpy(img), 250, 333).numpy()
    ys = rng.integers(PATCH_R, 250 - PATCH_R, K)
    xs = rng.integers(PATCH_R, 333 - PATCH_R, K)
    ip = np.stack([lvl[y - 15:y + 16, x - 15:x + 16] for y, x in zip(ys, xs)])
    bp = np.round(np.stack([lvl[y - PATCH_R:y + PATCH_R + 1,
                                x - PATCH_R:x + PATCH_R + 1]
                            for y, x in zip(ys, xs)]))
    return np.ascontiguousarray(ip), np.ascontiguousarray(bp)


def _layouts(a):
    """The same (K, h, w) values: contiguous, a transposed-back view, and
    a shuffled batch with its inverse permutation."""
    t = torch.from_numpy(a)
    back = t.transpose(1, 2).contiguous().transpose(1, 2)
    assert not back.is_contiguous()
    perm = np.random.default_rng(1).permutation(len(a))
    return t.clone(), back, t[perm].contiguous(), np.argsort(perm)


def test_upper_level_patches_are_not_integers(patches):
    ip, _ = patches
    assert np.mean(ip != np.round(ip)) > 0.5


def test_angles_bit_identical_across_layouts(patches):
    ip, _ = patches
    flat, back, shuffled, inv = _layouts(ip)
    a = ic_angles(flat)
    assert a.dtype == torch.float32
    assert torch.equal(a, ic_angles(back))
    assert torch.equal(a, ic_angles(shuffled)[inv])
    # one call over the batch equals calls over its halves
    assert torch.equal(a, torch.cat([ic_angles(flat[:K // 3]),
                                     ic_angles(flat[K // 3:])]))


def test_angles_equal_numpy_f64(patches):
    ip, _ = patches
    mask = orb_disc_mask().astype(np.float64)
    uu = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float64)
    p = ip.astype(np.float64)
    m10 = (p * (mask * uu[None, :])).sum(axis=(1, 2))
    m01 = (p * (mask * uu[:, None])).sum(axis=(1, 2))
    ang = np.arctan2(m01, m10)
    ref = np.where(ang < 0, ang + 2 * np.pi, ang).astype(np.float32)
    np.testing.assert_array_equal(ic_angles(torch.from_numpy(ip)).numpy(),
                                  ref)


def _circ(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def test_angles_close_to_jax_on_integer_patches(patches):
    """Level-0 patches hold integer pixels: both packages' moment sums are
    exact, and the angles agree within 1e-5 rad."""
    ip, _ = patches
    ip = np.round(ip)
    got = ic_angles(torch.from_numpy(ip)).numpy()
    assert _circ(got, jax_ic_angles(ip)).max() < 1e-5


def test_angles_close_to_jax_on_resized_patches(patches):
    """On resized patches the JAX package's f32 sums round: its angles
    stay within 1e-5 rad plus what a sum's rounding (log2(961) f32 ulps of
    the absolute moment sum) moves an angle by."""
    ip, _ = patches
    got = ic_angles(torch.from_numpy(ip)).numpy()
    mask = orb_disc_mask().astype(np.float64)
    uu = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float64)
    p = ip.astype(np.float64)
    m10 = (p * (mask * uu[None, :])).sum(axis=(1, 2))
    m01 = (p * (mask * uu[:, None])).sum(axis=(1, 2))
    s_abs = np.abs(p * (mask * uu[None, :])).sum(axis=(1, 2))
    err = 10 * np.finfo(np.float32).eps * s_abs / np.hypot(m10, m01)
    d = _circ(got, jax_ic_angles(ip))
    assert np.all(d < 1e-5 + 2 * err)
    assert np.median(d) < 1e-5


def test_descriptors_bit_identical_across_layouts(patches):
    ip, bp = patches
    angles = ic_angles(torch.from_numpy(ip))
    flat, back, shuffled, inv = _layouts(bp.astype(np.float32))
    d = steered_brief(flat, angles)
    assert torch.equal(d, steered_brief(back, angles))
    perm = np.argsort(inv)
    assert torch.equal(d, steered_brief(shuffled, angles[perm])[inv])


def test_descriptors_equal_numpy_f64_steering(patches):
    ip, bp = patches
    angles = ic_angles(torch.from_numpy(ip))
    got = steered_brief(torch.from_numpy(bp.astype(np.float32)),
                        angles).numpy().view(np.uint32)
    a = np.cos(angles.numpy().astype(np.float64))[:, None]
    b = np.sin(angles.numpy().astype(np.float64))[:, None]
    pts = ORB_PATTERN.reshape(512, 2).astype(np.float64)
    xo = np.round(pts[None, :, 0] * a - pts[None, :, 1] * b).astype(int)
    yo = np.round(pts[None, :, 0] * b + pts[None, :, 1] * a).astype(int)
    flat = bp.reshape(K, PATCH_W * PATCH_W)
    vals = np.take_along_axis(flat, (yo + PATCH_R) * PATCH_W + xo + PATCH_R,
                              axis=1)
    bits = (vals[:, 0::2] < vals[:, 1::2]).reshape(K, 8, 32)
    ref = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=2).astype(np.uint32)
    np.testing.assert_array_equal(got, ref)

"""The port's essential RANSAC and pose recovery against the JAX reference.

Both packages get the same f32 correspondences and the same key; the port
draws the reference's own samples from it (``prng.py``, ``ops/draw.py``:
``jax.random.randint`` in int32 mapped through the cumulative valid
count, essential.py:620-641).  The JAX side runs under
``jax.enable_x64(False)``, as the JAX CLIs do: under the tests' x64
setting ``randint`` draws int64 and other numbers.  One test also injects
the x64 draws into the port's ``ransac_drawn``.

Tolerances: E equal up to sign within 1e-4 (singular vectors have an
arbitrary sign and the decompositions differ); inlier masks equal except
for points whose Sampson residual lies within 1e-5 (relative) of the
threshold; R within 1e-4 rad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from irotavg_tpu.geometry import essential as je
from irotavg_tpu_torch import prng
from irotavg_tpu_torch.geometry import essential as te
from irotavg_tpu_torch.ops import ransac
from test_planar import _scene
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

FOCAL = 500.0
TH = np.float32(1.0 / FOCAL)


def _views(n=300, rot_deg=8.0, noise_px=0.5, outlier_frac=0.0, seed=0):
    """Normalised correspondences of random 3-D points (the scene of
    test_geometry.py:_synth_views) with optional outliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-4, -3, 4], [4, 3, 12], (n, 3))
    R = Rsc.from_rotvec(np.deg2rad(rot_deg) * np.array([0.3, 0.9, 0.1]))
    t = np.array([0.5, -0.1, 0.2])
    t /= np.linalg.norm(t)
    X2 = X @ R.as_matrix().T + t
    p1 = X[:, :2] / X[:, 2:3] + rng.normal(0, noise_px / FOCAL, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:3] + rng.normal(0, noise_px / FOCAL, (n, 2))
    k = int(outlier_frac * n)
    out = rng.choice(n, k, replace=False)
    p2[out] = rng.uniform([-0.6, -0.5], [0.6, 0.5], (k, 2))
    return p1, p2, R.as_matrix()


def _jax_draws(valid, key, n_samples, h_samples):
    """The reference's sample positions for ``key`` (essential.py:620-641)."""
    cs = jnp.cumsum(jnp.asarray(valid).astype(jnp.int32))
    nv = jnp.maximum(cs[-1], 1)
    ranks = jax.random.randint(key, (n_samples, 8), 0, nv)
    idx = jnp.sum(cs[None, None, :] <= ranks[..., None], axis=-1)
    ranks_h = jax.random.randint(jax.random.fold_in(key, 1), (h_samples, 4),
                                 0, nv)
    idx_h = jnp.sum(cs[None, None, :] <= ranks_h[..., None], axis=-1)
    return (torch.tensor(np.asarray(idx), dtype=torch.int64),
            torch.tensor(np.asarray(idx_h), dtype=torch.int64))


def _jax_ransac(p1, p2, valid, seed, n_samples, h_samples):
    Ej, inlj, _ = je.ransac_essential(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
        jax.random.key(seed), th_norm=jnp.float32(TH), n_samples=n_samples,
        h_samples=h_samples)
    return np.asarray(Ej), np.asarray(inlj)


def _both(p1, p2, valid, seed, n_samples=512, h_samples=192):
    """The JAX function in int32 (no x64) and the port drawing from the
    same key."""
    p1 = p1.astype(np.float32)
    p2 = p2.astype(np.float32)
    with jax.enable_x64(False):
        ref = _jax_ransac(p1, p2, valid, seed, n_samples, h_samples)
    Et, inlt, nt = te.ransac_essential(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
        prng.key(seed), th_norm=torch.tensor(TH), n_samples=n_samples,
        h_samples=h_samples)
    assert int(nt) == int(inlt.sum())
    return ref, (Et.numpy(), inlt.numpy())


def _check_E_and_mask(ref, got, p1, p2, valid):
    Ej, inlj = ref
    Et, inlt = got
    sgn = np.sign(np.sum(Ej * Et))
    np.testing.assert_allclose(sgn * Et, Ej, atol=1e-4)
    d = np.asarray(je.sampson_distance(jnp.asarray(Ej),
                                       jnp.asarray(p1, jnp.float32),
                                       jnp.asarray(p2, jnp.float32)))
    th2 = float(TH) ** 2
    far = np.abs(d - th2) > 1e-5 * th2
    assert far.sum() > 0.9 * len(far)
    np.testing.assert_array_equal(inlt[far], inlj[far])


# A minimal sample that draws one point twice has a rank-7 design whose
# null vector is arbitrary in both packages; with 1000 points such samples
# are rare and never win, so the hypothesis pools agree.
SCENES = {
    "clean": lambda: _views(seed=0),
    "outliers": lambda: _views(n=1000, outlier_frac=0.3, seed=1),
    "planar": lambda: _scene(0.7, n=1000, seed=1)[:2] + (None,),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_ransac_essential_with_injected_draws(scene):
    """``ransac_drawn`` on the reference's x64 draws (``_jax_draws``)
    against the JAX function under the tests' x64 setting."""
    p1, p2, _ = SCENES[scene]()
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)
    valid = np.ones(len(p1), bool)
    valid[::17] = False                  # exercise the masked draw
    ref = _jax_ransac(p1, p2, valid, 3, 512, 192)
    idx, idx_h = _jax_draws(valid, jax.random.key(3), 512, 192)
    Et, inlt, _ = te.ransac_drawn(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
        idx, idx_h, th_norm=torch.tensor(TH))
    _check_E_and_mask(ref, (Et.numpy(), inlt.numpy()), p1, p2, valid)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("seed", [3, 8])
def test_ransac_essential_draws_from_the_reference_key(scene, seed):
    """The port draws for itself from ``prng.key(seed)`` and lands on the
    JAX function's E and inliers (int32 draws, no x64)."""
    p1, p2, _ = SCENES[scene]()
    valid = np.ones(len(p1), bool)
    valid[::17] = False                  # exercise the masked draw
    ref, got = _both(p1, p2, valid, seed=seed)
    _check_E_and_mask(ref, got, p1, p2, valid)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_recover_pose_matches_reference(scene):
    p1, p2, R_gt = SCENES[scene]()
    p1 = p1.astype(np.float32)
    p2 = p2.astype(np.float32)
    valid = np.ones(len(p1), bool)
    (Ej, inlj), _ = _both(p1, p2, valid, seed=5)
    Rj, tj, nj, mj = je.recover_pose(jnp.asarray(Ej), jnp.asarray(p1),
                                     jnp.asarray(p2), jnp.asarray(inlj))
    Rt, tt, nt, mt = te.recover_pose(torch.from_numpy(Ej),
                                     torch.from_numpy(p1),
                                     torch.from_numpy(p2),
                                     torch.from_numpy(inlj))
    ang = np.linalg.norm(Rsc.from_matrix(
        np.asarray(Rj, np.float64).T @ Rt.double().numpy()).as_rotvec())
    assert ang < 1e-4
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    if R_gt is not None:
        err = np.linalg.norm(Rsc.from_matrix(
            R_gt.T @ Rt.double().numpy()).as_rotvec())
        assert np.degrees(err) < 1.0


def test_cheirality_counts_match_reference():
    p1, p2, _ = _views(outlier_frac=0.2, seed=4)
    p1 = p1.astype(np.float32)
    p2 = p2.astype(np.float32)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(p1), (64, 8))
    E = je._project_essential(je._eight_point_samples(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(idx)))
    inl = np.asarray(je.sampson_distance(E, jnp.asarray(p1),
                                         jnp.asarray(p2)) < TH * TH)
    ref = np.asarray(je._cheirality_counts(E, jnp.asarray(p1),
                                           jnp.asarray(p2),
                                           jnp.asarray(inl)))
    got = ransac._cheirality_counts(
        torch.from_numpy(np.asarray(E, np.float64))[None],
        torch.from_numpy(inl)[None], torch.from_numpy(p1).double()[None],
        torch.from_numpy(p2).double()[None])[0].numpy()
    # E near-degenerate samples may flip a borderline depth sign
    assert np.mean(got == ref) > 0.95
    assert np.max(np.abs(got - ref)) <= 2


def test_homography_decomposition_contains_motion():
    p1, p2, R_gt, t_gt = _scene(1.0, seed=6, noise_px=0.0)
    p1 = torch.from_numpy(p1.astype(np.float32)).double()[None]
    p2 = torch.from_numpy(p2.astype(np.float32)).double()[None]
    # the least-squares homography over every correspondence: the refit of
    # a single "sample" whose transfer inliers are all of them
    every = torch.ones((1, 1, p1.shape[1]), dtype=torch.bool)
    H, _ = ransac.homography_refit_plain(
        torch.eye(3, dtype=torch.float64)[None, None], every,
        torch.ones((1, 1), dtype=torch.int32), p1, p2)
    Rs, ts = ransac._decompose(H[:, 0])
    errs = [np.linalg.norm(Rsc.from_matrix(
        R_gt.T @ R.numpy()).as_rotvec()) for R in Rs[0]]
    assert np.degrees(min(errs)) < 0.05

"""The plain versions of the port's two RANSAC kernels (``ops/ransac.py``:
the minimal-sample hypotheses and the inlier vote) against the JAX
package, against the ``torch.linalg`` route they replace, and on
rank-deficient samples; and the kernel build's hash of included headers.

The kernels themselves run only on the card, where ``chip_smoke.py``
holds each bit for bit to these plain versions.

Tolerances:
* against the JAX package in f64 (the tests' x64 setting; its Householder
  QR without pivoting and its 3x3 Jacobi eigensolver): E and H equal up
  to sign within 1e-10 on samples of 8 (4) distinct correspondences;
* against the JAX package in f32 (the precision it runs in): within 1e-3
  on every such sample and 1e-5 in the median (its null vector loses
  about f32 epsilon times the design's condition number);
* against ``torch.linalg.svd`` in f64 (the port's route before the
  kernels): within 1e-10 on every sample, those that drew a
  correspondence twice included (both project ``NULL_PICK`` onto the
  null space);
* the votes: masks equal except for points whose residual lies within
  1e-9 (relative) of the threshold (the JAX package forms the residual
  with matrix products, which round otherwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irotavg_tpu.geometry import essential as je
from irotavg_tpu_torch import prng
from irotavg_tpu_torch.kernels import build
from irotavg_tpu_torch.ops import ransac
from irotavg_tpu_torch.ops.draw import draw_positions_plain
from jax_programs import release_jax_programs  # noqa: F401

torch.set_num_threads(1)

F64 = torch.float64
FOCAL = 718.856
TH2 = (1.0 / FOCAL) ** 2


def _points(n, seed, outliers=0.2):
    """Normalised correspondences of a 3-D scene after a 1 deg, 0.3 m
    step (0.5 px noise, a share of outliers), f32 rounded to f64."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-8, -3, 5], [8, 3, 40], (n, 3))
    ax = rng.normal(size=3)
    k = ax / np.linalg.norm(ax)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    a = np.radians(1.0)
    R = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    X2 = X @ R.T + np.array([0.02, 0.01, -0.3])
    p1 = X[:, :2] / X[:, 2:] + rng.normal(0, 0.5 / FOCAL, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 0.5 / FOCAL, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform([-0.8, -0.25], [0.8, 0.25], (int(bad.sum()), 2))
    valid = rng.random(n) < 0.8
    return (p1.astype(np.float32).astype(np.float64),
            p2.astype(np.float32).astype(np.float64), valid)


def _lane(n, seed, S, H):
    p1, p2, valid = _points(n, seed)
    t = [torch.from_numpy(a)[None] for a in (p1, p2, valid)]
    idx, idx_h = draw_positions_plain(t[2], [prng.key(seed)],
                                      ((S, 8), (H, 4)))
    return t, (idx, idx_h)


def _distinct(idx):
    return np.array([len(set(r)) == r.size for r in idx.numpy()])


def _up_to_sign(a, b):
    """Per sample, max |s a - b| with the sign s that fits best."""
    s = np.sign(np.sum(a * b, axis=(-2, -1), keepdims=True))
    s[s == 0] = 1.0
    return np.abs(s * a - b).max(axis=(-2, -1))


@pytest.mark.parametrize("seed", [0, 1])
def test_hypotheses_match_the_jax_package_in_f64(seed):
    (p1, p2, valid), (idx, idx_h) = _lane(300, seed, 64, 32)
    E, H = ransac.ransac_hypotheses_plain(p1, p2, valid, n_samples=64,
                                          h_samples=32,
                                          positions=(idx, idx_h))
    jp1, jp2 = jnp.asarray(p1[0].numpy()), jnp.asarray(p2[0].numpy())
    Ej = np.asarray(je._project_essential(je._eight_point_samples(
        jp1, jp2, jnp.asarray(idx[0].numpy()))))
    Hj = np.asarray(je._homography_samples(jp1, jp2,
                                           jnp.asarray(idx_h[0].numpy())))
    full, full_h = _distinct(idx[0]), _distinct(idx_h[0])
    assert full.sum() > 50 and full_h.sum() > 25
    assert _up_to_sign(E[0].numpy(), Ej)[full].max() < 1e-10
    assert _up_to_sign(H[0].numpy(), Hj)[full_h].max() < 1e-10


def test_hypotheses_match_the_jax_package_in_f32():
    (p1, p2, valid), (idx, idx_h) = _lane(300, 2, 128, 64)
    E, H = ransac.ransac_hypotheses_plain(p1, p2, valid, n_samples=128,
                                          h_samples=64,
                                          positions=(idx, idx_h))
    jp1 = jnp.asarray(p1[0].numpy(), jnp.float32)
    jp2 = jnp.asarray(p2[0].numpy(), jnp.float32)
    Ej = np.asarray(je._project_essential(je._eight_point_samples(
        jp1, jp2, jnp.asarray(idx[0].numpy()))), np.float64)
    Hj = np.asarray(je._homography_samples(
        jp1, jp2, jnp.asarray(idx_h[0].numpy())), np.float64)
    for got, ref, ok in ((E[0].numpy(), Ej, _distinct(idx[0])),
                         (H[0].numpy(), Hj, _distinct(idx_h[0]))):
        err = _up_to_sign(got, ref)[ok]
        assert err.max() < 1e-3 and np.median(err) < 1e-5


def _linalg_route(p1, p2, idx, essential):
    """The port's minimal-sample solve before the kernels: Hartley
    normalisation by means, the design's null direction from
    ``torch.linalg.svd`` (``NULL_PICK`` projected onto the right singular
    vectors of the ninth singular value and of those below ``RANK_TOL``
    of the largest), the transforms undone by matrix products, unit
    norm, and for E the projection by a 3x3 SVD."""
    def norm_pts(q):
        c = q.mean(dim=-2, keepdim=True)
        var = ((q - c) ** 2).sum(dim=-1).mean(dim=-1)
        s = torch.sqrt(2.0 / torch.clamp(var, min=1e-12))[..., None, None]
        return (q - c) * s, c[..., 0, :], s[..., 0, 0]

    def T(c, s, inv=False):
        z, o = torch.zeros_like(s), torch.ones_like(s)
        if inv:
            return torch.stack([torch.stack([1 / s, z, c[..., 0]], -1),
                                torch.stack([z, 1 / s, c[..., 1]], -1),
                                torch.stack([z, z, o], -1)], -2)
        return torch.stack([torch.stack([s, z, -s * c[..., 0]], -1),
                            torch.stack([z, s, -s * c[..., 1]], -1),
                            torch.stack([z, z, o], -1)], -2)

    q1n, c1, s1 = norm_pts(p1[idx])
    q2n, c2, s2 = norm_pts(p2[idx])
    A = ransac._designs(q1n, q2n, essential)
    _, s, Vh = torch.linalg.svd(A, full_matrices=True)
    null = torch.cat([s < ransac.RANK_TOL * s[..., :1],
                      torch.ones_like(s[..., :1], dtype=torch.bool)], -1)
    r = torch.tensor(ransac.NULL_PICK, dtype=F64)
    e = (((Vh @ r) * null)[..., None, :] @ Vh)[..., 0, :]
    e = (e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)).reshape(
        -1, 3, 3)
    if essential:
        M = T(c2, s2).transpose(-2, -1) @ e @ T(c1, s1)
    else:
        M = T(c2, s2, inv=True) @ e @ T(c1, s1)
    M = M / torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True))
    if not essential:
        return M
    U, _, Vh = torch.linalg.svd(M)
    return U[..., :, :2] @ Vh[..., :2, :]


@pytest.mark.parametrize("seed", [3, 4])
def test_hypotheses_match_the_linalg_route(seed):
    """At the engine's shape (2000 slots, 512 + 192 samples), samples that
    drew a correspondence twice included."""
    (p1, p2, valid), (idx, idx_h) = _lane(2000, seed, 512, 192)
    idx[0, :40, 1] = idx[0, :40, 0]              # force rank-7 designs
    idx_h[0, :20, 1] = idx_h[0, :20, 0]          # and rank-6 ones
    E, H = ransac.ransac_hypotheses_plain(p1, p2, valid, n_samples=512,
                                          h_samples=192,
                                          positions=(idx, idx_h))
    Eo = _linalg_route(p1[0], p2[0], idx[0], True)
    Ho = _linalg_route(p1[0], p2[0], idx_h[0], False)
    assert _up_to_sign(E[0].numpy(), Eo.numpy()).max() < 1e-10
    assert np.abs(H[0].numpy() - Ho.numpy()).max() < 1e-10


def _rank_deficient(seed, dup):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(8, 9))
    for i, j in dup:
        A[j] = A[i]
    return A


@pytest.mark.parametrize("dup", [((0, 1),), ((0, 1), (2, 5))])
def test_null_direction_projects_null_pick(dup):
    """A design with repeated rows (rank 7, rank 6): the null direction is
    NULL_PICK projected onto the null space, whatever orthogonal change of
    the rows' basis it is given in."""
    A = _rank_deficient(7, dup)
    _, s, Vt = np.linalg.svd(A)
    N = Vt[8 - len(dup):]                        # the null space's basis
    r = np.array(ransac.NULL_PICK)
    want = N.T @ (N @ r)
    want /= np.linalg.norm(want)
    rng = np.random.default_rng(11)
    Qs = [np.eye(8)] + [np.linalg.qr(rng.normal(size=(8, 8)))[0]
                        for _ in range(4)]
    got = ransac._null_directions(
        torch.tensor(np.stack([Q @ A for Q in Qs])), None).numpy()
    assert np.abs(got - want).max() < 1e-10


def test_keys_and_lanes():
    """Drawing from keys equals sampling their positions, and a batch of
    lanes equals each lane alone, bit for bit."""
    lanes = [_points(500, 20 + i) for i in range(3)]
    p1, p2, valid = (torch.from_numpy(np.stack(a)) for a in zip(*lanes))
    keys = prng.split(prng.key(5), 3)
    E, H = ransac.ransac_hypotheses_plain(p1, p2, valid, keys, 96, 48)
    idx, idx_h = draw_positions_plain(valid, keys, ((96, 8), (48, 4)))
    Ep, Hp = ransac.ransac_hypotheses_plain(p1, p2, valid, n_samples=96,
                                            h_samples=48,
                                            positions=(idx, idx_h))
    assert torch.equal(E, Ep) and torch.equal(H, Hp)
    for k in range(3):
        Ek, Hk = ransac.ransac_hypotheses_plain(
            p1[k:k + 1], p2[k:k + 1], valid[k:k + 1], keys[k:k + 1], 96, 48)
        assert torch.equal(Ek[0], E[k]) and torch.equal(Hk[0], H[k])


@pytest.mark.parametrize("mode", ["sampson", "transfer"])
def test_vote_matches_the_jax_package(mode):
    (p1, p2, valid), (idx, idx_h) = _lane(1500, 8, 96, 48)
    E, H = ransac.ransac_hypotheses_plain(p1, p2, valid, n_samples=96,
                                          h_samples=48,
                                          positions=(idx, idx_h))
    th2 = torch.tensor(TH2 if mode == "sampson" else 4.0 * TH2, dtype=F64)
    models = E if mode == "sampson" else H
    mask, counts = ransac.ransac_vote_plain(models, p1, p2, valid, th2,
                                            mode)
    assert torch.equal(counts, mask.sum(dim=-1, dtype=torch.int32))
    jm = jnp.asarray(models[0].numpy())
    jp1, jp2 = jnp.asarray(p1[0].numpy()), jnp.asarray(p2[0].numpy())
    if mode == "sampson":
        d = np.asarray(je.sampson_distance(jm, jp1, jp2))
        ref = (d < float(th2)) & valid[0].numpy()
    else:
        ref = np.asarray(je._transfer_inliers(jm, jp1, jp2,
                                              jnp.asarray(valid[0].numpy()),
                                              float(th2)))
        y = np.einsum("cij,nj->cni", models[0].numpy(),
                      np.c_[p1[0].numpy(), np.ones(1500)])
        d = np.sum((y[..., :2] / y[..., 2:] - p2[0].numpy()) ** 2, axis=-1)
    far = np.abs(d - float(th2)) > 1e-9 * float(th2)
    assert far.mean() > 0.99
    assert ref.sum() > 1000
    np.testing.assert_array_equal(mask[0].numpy()[far], ref[far])


def test_vote_edges():
    """No valid correspondence gives zero counts; a homography whose
    transfer has ``|z| <= 1e-8`` counts no point, however close its
    transfer lands."""
    (p1, p2, valid), (idx, idx_h) = _lane(300, 9, 16, 8)
    E, H = ransac.ransac_hypotheses_plain(p1, p2, valid, n_samples=16,
                                          h_samples=8,
                                          positions=(idx, idx_h))
    th2 = torch.tensor(TH2, dtype=F64)
    none = torch.zeros_like(valid)
    for models, mode in ((E, "sampson"), (H, "transfer")):
        mask, counts = ransac.ransac_vote_plain(models, p1, p2, none, th2,
                                                mode)
        assert not mask.any() and not counts.any()
    # H = 1e-9 I maps every point onto itself, but through |z| <= 1e-8
    Hz = (1e-9 * torch.eye(3, dtype=F64))[None, None]
    mask, counts = ransac.ransac_vote_plain(Hz, p2, p2, valid, th2,
                                            "transfer")
    assert int(counts) == 0
    mask, counts = ransac.ransac_vote_plain(Hz * 100.0, p2, p2, valid, th2,
                                            "transfer")
    assert int(counts) == int(valid.sum())


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors run the plain versions; any other device launches the
    kernel or raises (no fallback)."""
    (p1, p2, valid), (idx, idx_h) = _lane(300, 10, 16, 8)
    keys = [prng.key(10)]
    E, H = ransac.ransac_hypotheses(p1, p2, valid, keys, 16, 8)
    Ep, Hp = ransac.ransac_hypotheses_plain(p1, p2, valid, keys, 16, 8)
    assert torch.equal(E, Ep) and torch.equal(H, Hp)
    th2 = torch.tensor(TH2, dtype=F64)
    m, c = ransac.ransac_vote(E, p1, p2, valid, th2, "sampson")
    mp, cp = ransac.ransac_vote_plain(E, p1, p2, valid, th2, "sampson")
    assert torch.equal(m, mp) and torch.equal(c, cp)
    meta = [t.to("meta") for t in (p1, p2, valid)]
    with pytest.raises(ValueError, match="no kernel"):
        ransac.ransac_hypotheses(*meta, keys, 16, 8)
    with pytest.raises(ValueError, match="no kernel"):
        ransac.ransac_vote(E.to("meta"), *meta, th2.to("meta"), "sampson")
    with pytest.raises(ValueError):
        ransac.ransac_vote(E, p1, p2, valid, th2, "affine")


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """The built library's name hashes the source and every ``csrc/``
    header it includes, followed into the headers' own includes, so an
    edited header is rebuilt; a source that includes none keeps its
    name."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("#pragma once\nint g;\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    a0, b0 = build.library_path("a"), build.library_path("b")
    (tmp_path / "g.cuh").write_text("#pragma once\nint g2;\n")
    a1, b1 = build.library_path("a"), build.library_path("b")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n\n')
    a2 = build.library_path("a")
    assert len({a0, a1, a2}) == 3 and b0 == b1
    assert a0.endswith(".so") and "liba_" in a0


def test_kernel_sources_hash_their_shared_header():
    """The hypotheses kernel includes ``csrc/threefry.cuh``, whose bytes
    enter its library name."""
    with open(f"{build.CSRC}/threefry.cuh", "rb") as fh:
        header = fh.read()
    src = build._source_bytes(f"{build.CSRC}/ransac_hyp.cu", set())
    assert header in src

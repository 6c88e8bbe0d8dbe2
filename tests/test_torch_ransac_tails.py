"""RANSAC's tail for every lane at once: the plain versions of the tail
kernels (``ops/ransac.py``: ``homography_refit``, ``homography_pool``,
``cheirality_rerank``, ``essential_refit``, ``ransac_finish``) and the
batched route of ``geometry/essential.py`` against the lane-by-lane code
they replaced (``tests/ransac_lane_oracle.py``, ``torch.linalg`` solves),
lanes batched against lanes alone, the top-48 order under score ties,
degenerate lanes, and the JAX package.

The kernels themselves run only on the card, where ``chip_smoke.py``
holds each to these plain versions.

Tolerances:
* against the lane-by-lane code, with the same draws: every decision
  exactly (the best homography sample, the keep choice, the pool's
  Sampson scores, the top-48 order, the cheirality counts, the pick, the
  refit's check, the inlier and pose masks, ``n_che``); the rescued H,
  the pool, the refit and the final E, R and t within 1e-10, E up to
  sign, in f64; with f32 points the f32 outputs within 2 units in the
  last place;
* lanes batched against one-lane calls: bit for bit;
* against the JAX package: ``test_torch_geometry.py``'s (E up to sign
  within 1e-4, masks equal away from the threshold).
"""

import jax
import numpy as np
import pytest
import torch

from irotavg_tpu_torch import prng
from irotavg_tpu_torch.geometry import essential as te
from irotavg_tpu_torch.geometry import fused
from irotavg_tpu_torch.ops import ransac
import ransac_lane_oracle as oracle
from jax_programs import release_jax_programs  # noqa: F401
from test_planar import _scene
from test_torch_geometry import TH as GEO_TH
from test_torch_geometry import SCENES, _check_E_and_mask, _jax_ransac

torch.set_num_threads(1)

F64 = torch.float64
FOCAL = 718.856
TH = np.float32(1.0 / FOCAL)


def _points(n, seed, outliers=0.2, share=0.8):
    """Normalised correspondences of a 3-D scene after a 1 deg, 0.3 m
    step (0.5 px noise, a share of outliers and of valid slots), f32."""
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
    valid = rng.random(n) < share
    return p1.astype(np.float32), p2.astype(np.float32), valid


def _planar(n, seed):
    """A scene with 70% of its points on one plane (the homography
    rescue's case), f32, every slot valid."""
    p1, p2, _, _ = _scene(0.7, n=n, seed=seed)
    return p1.astype(np.float32), p2.astype(np.float32), np.ones(n, bool)


def _valid_count(v, count, seed):
    """``v`` with only ``count`` of its slots valid."""
    out = np.zeros_like(v)
    out[np.random.default_rng(seed).choice(len(v), count, replace=False)] = 1
    return out


def _stack(lanes):
    return tuple(torch.from_numpy(np.stack([ln[i] for ln in lanes]))
                 for i in range(3))


CASES = {
    "one_lane": lambda: [_points(2000, 0)],
    "three_lanes": lambda: [_points(2000, 1), _points(2000, 2, share=0.3),
                            _points(2000, 3, outliers=0.5, share=0.1)],
    "planar": lambda: [_planar(1000, 1), _planar(1000, 4)],
}


def _oracle_steps(p1, p2, valid, keys, th2):
    """Every intermediate of the lane-by-lane route (f64 points)."""
    L = p1.shape[0]
    lanes = torch.arange(L)
    E_cand, Hc = ransac.ransac_hypotheses(p1, p2, valid, keys, 512, 192)
    hmask, sup_h = ransac.ransac_vote(Hc, p1, p2, valid, 4.0 * th2,
                                      "transfer")
    hbest = torch.argmax(sup_h, dim=1)
    H_ref = torch.stack([oracle._homography_ls(
        p1[k], p2[k], hmask[k, hbest[k]].to(F64)) for k in range(L)])
    _, sup_ref = ransac.ransac_vote(H_ref[:, None], p1, p2, valid,
                                    4.0 * th2, "transfer")
    keep = sup_ref[:, 0] >= sup_h[lanes, hbest]
    H_use = torch.where(keep[:, None, None], H_ref, Hc[lanes, hbest])
    E_h = []
    for k in range(L):
        Rh, th_ = oracle._decompose_homography(H_use[k])
        E_h.append(oracle._project_essential(oracle._skew(th_) @ Rh))
    pool = torch.cat([E_cand, torch.stack(E_h)], dim=1)
    inl, scores = ransac.ransac_vote(pool, p1, p2, valid, th2, "sampson")
    top = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :48]
    che = torch.stack([oracle._cheirality_counts(
        pool[k, top[k]], p1[k], p2[k], inl[k, top[k]]) for k in range(L)])
    best = top[lanes, torch.argmax(che, dim=1)]
    E_ref = torch.stack([oracle._project_essential(oracle._eight_point(
        p1[k], p2[k], inl[k, best[k]].to(F64))) for k in range(L)])
    inl_ref, _ = ransac.ransac_vote(E_ref[:, None], p1, p2, valid, th2,
                                    "sampson")
    che_ref = torch.stack([oracle._cheirality_counts(
        E_ref[k], p1[k], p2[k], inl_ref[k, 0]) for k in range(L)])
    better = che_ref >= che.amax(dim=1)
    E = torch.where(better[:, None, None], E_ref, pool[lanes, best])
    mask = torch.where(better[:, None], inl_ref[:, 0], inl[lanes, best])
    pose = [oracle.recover_pose(E[k], p1[k], p2[k], mask[k])
            for k in range(L)]
    return {"hbest": hbest, "H_ref": H_ref, "keep": keep, "pool": pool,
            "scores": scores, "top": top, "che": che, "best": best,
            "E_ref": E_ref, "better": better, "E": E, "mask": mask,
            "R": torch.stack([p[0] for p in pose]),
            "t": torch.stack([p[1] for p in pose]),
            "n_che": torch.stack([p[2] for p in pose]),
            "pose_mask": torch.stack([p[3] for p in pose])}


def _tail_steps(p1, p2, valid, keys, th2):
    """The same intermediates from the plain versions of the tail."""
    L = p1.shape[0]
    lanes = torch.arange(L)
    E_cand, Hc = ransac.ransac_hypotheses(p1, p2, valid, keys, 512, 192)
    hmask, sup_h = ransac.ransac_vote(Hc, p1, p2, valid, 4.0 * th2,
                                      "transfer")
    H_ref, hbest = ransac.homography_refit(Hc, hmask, sup_h, p1, p2)
    _, sup_ref = ransac.ransac_vote(H_ref, p1, p2, valid, 4.0 * th2,
                                    "transfer")
    keep = sup_ref[:, 0] >= sup_h[lanes, hbest.long()]
    pool = ransac.homography_pool(E_cand, None, Hc, hbest, sup_h, H_ref,
                                  sup_ref)
    inl, scores = ransac.ransac_vote(pool, p1, p2, valid, th2, "sampson")
    top, che = ransac.cheirality_rerank(pool, inl, scores, p1, p2, 48)
    best, che_max, E_ref = ransac.essential_refit(top, che, inl, p1, p2)
    inl_ref, _ = ransac.ransac_vote(E_ref, p1, p2, valid, th2, "sampson")
    che_ref = ransac._cheirality_counts(E_ref, inl_ref, p1, p2)[:, 0]
    E, mask, R, t, n_che, pose_mask = ransac.ransac_finish(
        E_ref, inl_ref, p1, p2, False, (pool, inl, best, che_max))
    return {"hbest": hbest, "H_ref": H_ref[:, 0], "keep": keep,
            "pool": pool, "scores": scores, "top": top, "che": che,
            "best": best, "E_ref": E_ref[:, 0], "better": che_ref >= che_max,
            "E": E, "mask": mask, "R": R, "t": t, "n_che": n_che,
            "pose_mask": pose_mask}


def _up_to_sign(a, b):
    """max |s a - b| per matrix (last two axes), s the sign that fits."""
    s = torch.sign((a * b).sum(dim=(-2, -1), keepdim=True))
    s[s == 0] = 1.0
    return float((s * a - b).abs().max())


def _lanes(case):
    p1, p2, valid = _stack(CASES[case]())
    keys = [prng.key(17 + k) for k in range(p1.shape[0])]
    return p1, p2, valid, keys


@pytest.mark.parametrize("case", sorted(CASES))
def test_tail_steps_match_the_lane_loops(case):
    """Each plain version, fed the same inputs, decides as the lane-by-
    lane code did; its matrices lie within 1e-10."""
    p1, p2, valid, keys = _lanes(case)
    p1, p2 = p1.to(F64), p2.to(F64)
    th2 = torch.tensor(float(TH), dtype=F64) ** 2
    ref = _oracle_steps(p1, p2, valid, keys, th2)
    got = _tail_steps(p1, p2, valid, keys, th2)
    for name in ("hbest", "keep", "scores", "top", "che", "best", "better",
                 "mask", "n_che", "pose_mask"):
        assert torch.equal(got[name].long(), ref[name].long()), name
    for name in ("H_ref", "pool", "E_ref", "E"):
        assert _up_to_sign(got[name], ref[name]) < 1e-10, name
    for name in ("R", "t"):
        assert float((got[name] - ref[name]).abs().max()) < 1e-10, name
    if case == "planar":   # the rescue's motions are in play
        assert bool(ref["keep"].any())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ransac_pose_lanes_matches_the_lane_loops(dtype):
    """The whole call (``ransac_pose_lanes``) against the lane-by-lane
    ``ransac_lanes`` and ``recover_pose`` it replaced."""
    p1, p2, valid, keys = _lanes("three_lanes")
    dt = getattr(torch, dtype)
    p1, p2 = p1.to(dt), p2.to(dt)
    th = torch.tensor(TH)
    E, mask, R, t, n_che, pose_mask = te.ransac_pose_lanes(
        p1, p2, valid, th, keys=keys, n_samples=512, h_samples=192)
    Eo, masko = oracle.ransac_lanes(p1, p2, valid, th, keys=keys,
                                    n_samples=512, h_samples=192)
    tol = 1e-10 if dtype == "float64" else 2.4e-7
    assert E.dtype == R.dtype == t.dtype == dt
    assert torch.equal(mask, masko)
    assert _up_to_sign(E.double(), Eo.double()) <= tol
    for k in range(p1.shape[0]):
        Ro, to, no, pmo = oracle.recover_pose(Eo[k], p1[k], p2[k], masko[k])
        assert int(n_che[k]) == int(no) and torch.equal(pose_mask[k], pmo)
        assert float((R[k].double() - Ro.double()).abs().max()) <= tol
        assert float((t[k].double() - to.double()).abs().max()) <= tol


def _edge_lanes(L):
    """``L`` lanes of f32 correspondences: normal ones, and from the
    fourth lane on one with no valid slot, one with 3 and one with 7."""
    lanes = [_points(2000, 30 + k, share=(0.8, 0.4, 0.2)[k % 3])
             for k in range(L)]
    for k, count in zip(range(3, L), (0, 3, 7)):
        p1, p2, v = lanes[k]
        lanes[k] = (p1, p2, _valid_count(v, count, k))
    return _stack(lanes)


@pytest.mark.parametrize("L", [1, 2, 3, 8])
def test_lanes_batched_equal_lanes_alone(L):
    """``fused._ransac_lanes`` over L lanes gives, bit for bit, what L
    one-lane calls (``ransac_essential`` and ``recover_pose``, the
    ``find_relative_pose`` route) give, degenerate lanes included."""
    p1, p2, valid = _edge_lanes(L)
    keys = prng.split(prng.key(L), L)
    th = torch.tensor(TH)
    out = fused._ransac_lanes(p1, p2, valid, keys, th)
    for k in range(L):
        E, inl, n_inl = te.ransac_essential(p1[k], p2[k], valid[k], keys[k],
                                            th_norm=th, n_samples=512)
        alone = (E,) + te.recover_pose(E, p1[k], p2[k], inl)
        for got, ref in zip(out, alone):
            assert got[k].dtype == ref.dtype
            assert torch.equal(got[k], ref)


def test_degenerate_lanes_decide_as_the_lane_loops():
    """Lanes with 0, 3 and 7 valid correspondences beside normal ones:
    the masks and counts of the lane-by-lane code, nothing but invalid
    slots chosen, and nothing at all for the empty lane."""
    p1, p2, valid = _edge_lanes(6)
    keys = prng.split(prng.key(6), 6)
    th = torch.tensor(TH)
    E, mask, R, t, n_che, pose_mask = te.ransac_pose_lanes(
        p1, p2, valid, th, keys=keys, n_samples=512, h_samples=192)
    Eo, masko = oracle.ransac_lanes(p1, p2, valid, th, keys=keys,
                                    n_samples=512, h_samples=192)
    assert torch.equal(mask, masko)
    assert not bool((mask & ~valid).any())
    assert not bool(mask[3].any()) and int(n_che[3]) == 0
    assert not bool(pose_mask[3].any())
    for k in range(6):
        no, pmo = oracle.recover_pose(Eo[k], p1[k], p2[k], masko[k])[2:]
        assert int(n_che[k]) == int(no) and torch.equal(pose_mask[k], pmo)
    assert all(bool(torch.isfinite(a).all()) for a in (E, R, t))


def _rank_order(scores):
    """Each slot's model by counting: the models above a model, ties
    broken by the lower index (the kernel's rule)."""
    C = len(scores)
    order = [None] * C
    for i, s in enumerate(scores):
        rank = sum(1 for j, o in enumerate(scores)
                   if o > s or (o == s and j < i))
        order[rank] = i
    return order


@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_takes_the_stable_order_under_ties(seed):
    """Scores with many ties: the top 48 are ``torch.sort``'s stable
    descending order (lower index first, as ``jax.lax.top_k``), the
    kernel's counting rule gives the same, and the pick is the first of
    the largest cheirality counts."""
    rng = np.random.default_rng(seed)
    p1, p2, valid = (t.to(F64) if t.is_floating_point() else t
                     for t in _stack([_points(400, 40 + seed)]))
    C = 130
    models = ransac.ransac_hypotheses(p1, p2, valid, [prng.key(seed)], C,
                                      0)[0]
    inl, _ = ransac.ransac_vote(models, p1, p2, valid,
                                torch.tensor(float(TH) ** 2, dtype=F64),
                                "sampson")
    scores = torch.from_numpy(rng.integers(0, 4, (1, C)).astype(np.int32))
    top, che = ransac.cheirality_rerank(models, inl, scores, p1, p2, 48)
    assert top[0].tolist() == _rank_order(scores[0].tolist())[:48]
    jtop = jax.lax.top_k(np.asarray(scores[0]), 48)[1]
    assert top[0].tolist() == np.asarray(jtop).tolist()
    tied = torch.full_like(che, 7)
    tied[0, 5] = tied[0, 9] = 9
    best, che_max, _ = ransac.essential_refit(top, tied, inl, p1, p2)
    assert int(best[0]) == int(top[0, 5]) and int(che_max[0]) == 9


@pytest.mark.parametrize("seed", [3, 8])
def test_lanes_match_the_jax_package(seed):
    """Every lane of one batched call against the JAX package's
    ``ransac_essential`` drawing from the same key (int32 draws), on
    ``test_torch_geometry.py``'s scenes."""
    lanes = []
    for name in sorted(SCENES):
        q1, q2, _ = SCENES[name]()
        v = np.ones(len(q1), bool)
        v[::17] = False
        lanes.append((q1.astype(np.float32), q2.astype(np.float32), v))
    n = max(len(v) for _, _, v in lanes)
    # invalid slots at the end change no draw
    p1, p2, valid = _stack([tuple(np.concatenate(
        [a, np.zeros((n - len(a),) + a.shape[1:], a.dtype)]) for a in ln)
        for ln in lanes])
    E, mask = te.ransac_pose_lanes(
        p1, p2, valid, torch.tensor(GEO_TH),
        keys=[prng.key(seed)] * len(lanes), n_samples=512,
        h_samples=192)[:2]
    for k, (q1, q2, v) in enumerate(lanes):
        with jax.enable_x64(False):
            ref = _jax_ransac(q1, q2, v, seed, 512, 192)
        m = len(v)
        assert not bool(mask[k, m:].any())
        _check_E_and_mask(ref, (E[k].numpy(), mask[k, :m].numpy()), q1, q2,
                          v)


def _gram(seed, rank):
    """A 9x9 8-point Gram matrix of ``rank`` (8: a scene's inliers; 7:
    seven correspondences), f64."""
    p1, p2, _ = _points(300 if rank == 8 else 7, seed, outliers=0.0)
    p1, p2 = torch.from_numpy(p1).to(F64), torch.from_numpy(p2).to(F64)
    w = torch.ones(p1.shape[0], dtype=F64)
    return (w @ oracle._design_sq(p1, p2)).reshape(9, 9)


@pytest.mark.parametrize("rank", [8, 7])
def test_gram_null_matches_eigh(rank):
    """The Jacobi null direction of the Hartley-conditioned Gram matrix
    (``NULL_PICK`` projected onto the null space, so the same whatever its
    basis) against ``torch.linalg.eigh``'s, and the whole conditioned
    solve against the lane-by-lane one."""
    G = torch.stack([_gram(s, rank) for s in range(4)])
    T1 = oracle._hartley_T(G[:, 8, 8], G[:, 8, 6], G[:, 8, 7], G[:, 6, 6],
                           G[:, 7, 7])
    T2 = oracle._hartley_T(G[:, 8, 8], G[:, 2, 8], G[:, 5, 8], G[:, 2, 2],
                           G[:, 5, 5])
    M = oracle._kron3(T2, T1)
    Gn = M @ G @ M.transpose(1, 2)
    Gn = (Gn + Gn.transpose(1, 2)) / 2
    got = ransac._gram_null(Gn)
    ref = oracle._gram_null(Gn)
    # a direction in the null space moves by about eps over the gap to the
    # first eigenvalue outside it (relative to the largest)
    # (rank 8: below 1e-10)
    w = torch.linalg.eigvalsh(Gn)
    tol = 1e-10 if rank == 8 else 1e-14 * w[:, -1] / w[:, 9 - rank]
    assert bool(((got - ref).abs().amax(dim=1) < tol).all())
    got = ransac._solve_gram(G)
    ref = oracle._solve_gram(G)
    s = torch.sign((got * ref).sum(dim=(1, 2), keepdim=True))
    assert bool(((s * got - ref).abs().amax(dim=(1, 2)) < tol).all())


def test_svd3_matches_linalg():
    """The 3x3 SVD of the tail (one-sided Jacobi) against
    ``torch.linalg.svd`` with the lane-by-lane code's sign rules."""
    M = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 3, 3)))
    U, d, V = ransac._svd3(M)
    Uo, do, Vo = oracle._svd3x3(M)
    assert float((d - do).abs().max()) < 1e-12
    assert float((U - Uo).abs().max()) < 1e-10
    assert float((V - Vo).abs().max()) < 1e-10


def test_tail_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors run the plain versions; any other device launches the
    kernel or raises (no fallback)."""
    p1, p2, valid, keys = _lanes("one_lane")
    p1, p2 = p1.to(F64), p2.to(F64)
    th2 = torch.tensor(float(TH) ** 2, dtype=F64)
    E_cand, Hc = ransac.ransac_hypotheses(p1, p2, valid, keys, 64, 32)
    hmask, sup_h = ransac.ransac_vote(Hc, p1, p2, valid, th2, "transfer")
    H_ref, hbest = ransac.homography_refit(Hc, hmask, sup_h, p1, p2)
    _, sup_ref = ransac.ransac_vote(H_ref, p1, p2, valid, th2, "transfer")
    pool = ransac.homography_pool(E_cand, None, Hc, hbest, sup_h, H_ref,
                                  sup_ref)
    inl, scores = ransac.ransac_vote(pool, p1, p2, valid, th2, "sampson")
    top, che = ransac.cheirality_rerank(pool, inl, scores, p1, p2, 48)
    best, che_max, E_ref = ransac.essential_refit(top, che, inl, p1, p2)
    calls = {
        "homography_refit": (Hc, hmask, sup_h, p1, p2),
        "homography_pool": (E_cand, None, Hc, hbest, sup_h, H_ref, sup_ref),
        "cheirality_rerank": (pool, inl, scores, p1, p2, 48),
        "essential_refit": (top, che, inl, p1, p2),
        "ransac_finish": (E_ref, inl[:, :1], p1, p2, True,
                          (pool, inl, best, che_max)),
    }

    def meta(a):
        if isinstance(a, torch.Tensor):
            return a.to("meta")
        return tuple(meta(x) for x in a) if isinstance(a, tuple) else a

    ransac.reset_launch_counts()
    for name, args in calls.items():
        got = getattr(ransac, name)(*args)
        ref = getattr(ransac, f"{name}_plain")(*args)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(g, r)
        with pytest.raises(ValueError, match="no kernel"):
            getattr(ransac, name)(*meta(args))
    assert ransac.tail_launches() == 0

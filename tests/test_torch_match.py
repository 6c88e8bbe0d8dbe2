"""The port's best-2 matcher and matcher cores against the JAX reference.

Inputs are the 200x300 fixture of ``test_match_pallas.py`` (planted
near-duplicates, all five gates).  Distances and indices are integers, so
every comparison is exact.
"""

import numpy as np
import pytest
import torch

from irotavg_tpu.matching import matchers as jm
from irotavg_tpu.ops.match_pallas import (
    GATES, best2_reference, fused_best2, unpack_pm1,
)
from irotavg_tpu_torch.matching import matchers as tm
from irotavg_tpu_torch.ops import match as tmatch
from test_match_pallas import _features

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    # the fixture of test_match_pallas.py:16-33, rebuilt from its seed
    rng = np.random.default_rng(7)
    n1, n2 = 200, 300
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    d2[10] = d1[0]
    d2[11] = d1[0] ^ np.uint32(1)
    meta = {
        "valid1": rng.random(n1) > 0.1,
        "valid2": rng.random(n2) > 0.1,
        "node1": rng.integers(0, 12, n1),
        "node2": rng.integers(0, 12, n2),
        "x1": rng.uniform(0, 640, n1), "y1": rng.uniform(0, 480, n1),
        "x2": rng.uniform(0, 640, n2), "y2": rng.uniform(0, 480, n2),
        "oct1": rng.integers(0, 8, n1), "oct2": rng.integers(0, 8, n2),
    }
    return d1, d2, meta


def _words(d):
    """uint32 descriptor words -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


def _port_inputs(gate, d1, d2, m):
    _, _, rowf, colft = _features(gate, d1, d2, m)
    return (_words(d1), _words(d2), torch.from_numpy(np.asarray(rowf)),
            torch.from_numpy(np.asarray(colft).T.copy()))


def _assert_same(got, ref, gate):
    for name, g, r in zip(("d1", "d2", "idx"), got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=f"{name} [{gate}]")


@pytest.mark.parametrize("gate", GATES)
def test_best2_plain_matches_reference(problem, gate):
    d1, d2, m = problem
    ref = best2_reference(*_features(gate, d1, d2, m), gate)
    got = tmatch.best2(*_port_inputs(gate, d1, d2, m), gate)
    _assert_same([g.numpy() for g in got], ref, gate)


@pytest.mark.parametrize("gate", GATES)
def test_best2_plain_matches_pallas_interpret(problem, gate, monkeypatch):
    d1, d2, m = problem
    monkeypatch.setenv("IROTAVG_PALLAS", "interpret")
    ref = [np.asarray(r) for r in
           fused_best2(*_features(gate, d1, d2, m), gate)]
    got = [g.numpy() for g in
           tmatch.best2_plain(*_port_inputs(gate, d1, d2, m), gate)]
    # d1 / d2 exact everywhere; idx wherever the row has a match (the
    # Pallas kernel leaves padded-tile argmins unspecified otherwise)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    has = ref[0] < tmatch.BIG
    np.testing.assert_array_equal(got[2][has], ref[2][has])


@pytest.mark.parametrize("gate", GATES)
def test_best2_batched(problem, gate):
    """B = 3 stacked problems give the per-problem answers."""
    d1, d2, m = problem
    rng = np.random.default_rng(11)
    probs = []
    for b in range(3):
        perm1 = rng.permutation(len(d1))
        perm2 = rng.permutation(len(d2))
        mb = {k: (v[perm1] if k.endswith("1") else v[perm2])
              for k, v in m.items()}
        probs.append((d1[perm1], d2[perm2], mb))
    ins = [_port_inputs(gate, *p) for p in probs]
    stacked = [torch.stack([x[i] for x in ins]) for i in range(4)]
    got = tmatch.best2(*stacked, gate)
    for b, p in enumerate(probs):
        ref = best2_reference(*_features(gate, *p), gate)
        _assert_same([g[b].numpy() for g in got], ref, f"{gate} b={b}")


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
@pytest.mark.parametrize("gate", ["none", "epipolar"])
def test_best2_plain_lanes_without_valid_rows(problem, gate, shared):
    """A batch entry with no valid row, which the plain version does not
    compute, gets what the whole product gives it (``BIG``, ``BIG``, -1),
    and the other entries their own answers; a batch of such entries
    only gives them alone."""
    d1, d2, m = problem
    desc1, desc2, rowf, colf = _port_inputs(gate, d1, d2, m)
    dead = rowf.clone()
    dead[:, 0] = 0.0
    rows = (torch.stack([desc1] * 3), torch.stack([rowf, dead, rowf]))
    cols = (desc2, colf) if shared else (torch.stack([desc2] * 3),
                                         torch.stack([colf] * 3))
    got = tmatch.best2_plain(rows[0], cols[0], rows[1], cols[1], gate)
    for b, r in enumerate((rowf, dead, rowf)):
        want = tmatch.best2_plain(desc1, desc2, r, colf, gate)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g[b], w), b
    assert bool((got[2][1] == -1).all())
    none = tmatch.best2_plain(rows[0][1:2], cols[0][1:2] if not shared
                              else cols[0], rows[1][1:2],
                              cols[1][1:2] if not shared else cols[1], gate)
    for g, w in zip(none, got):
        assert torch.equal(g[0], w[1])


def test_word_packing_roundtrip(problem):
    """int32 bit patterns unpack to the reference's ±1 rows."""
    d1, _, _ = problem
    w = _words(d1)
    assert np.array_equal(w.numpy().view(np.uint32), d1)
    np.testing.assert_array_equal(tmatch.unpack_pm1(w).numpy(),
                                  np.asarray(unpack_pm1(d1), np.float32))


def test_best2_rejects_unknown_gate(problem):
    d1, d2, m = problem
    with pytest.raises(ValueError):
        tmatch.best2(*_port_inputs("none", d1, d2, m), "bogus")


def _jax_frames(d1, d2, m):
    b1 = unpack_pm1(d1)
    b2t = unpack_pm1(d2).T
    return b1, b2t


@pytest.fixture(scope="module")
def planted(problem):
    """The fixture with 80 rows planted as noisy, displaced copies in
    frame 2, so the matcher cores accept real matches."""
    d1, d2, m = problem
    rng = np.random.default_rng(9)
    d2, m = d2.copy(), {k: v.copy() for k, v in m.items()}
    for i in range(80):
        j = 100 + 2 * i
        flips = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
        d2[j] = d1[i] ^ (flips[0] & flips[1] & flips[2] & flips[3])
        m["x2"][j] = m["x1"][i] + rng.uniform(-30, 30)
        m["y2"][j] = m["y1"][i] + rng.uniform(-30, 30)
        m["oct2"][j] = m["oct1"][i]
        m["node2"][j] = m["node1"][i]
        m["valid1"][i] = m["valid2"][j] = True
    return d1, d2, m


def _angles(n1, n2, seed):
    """Random orientations; planted pairs rotate consistently."""
    rng = np.random.default_rng(seed)
    ang1 = rng.uniform(0, 2 * np.pi, n1).astype(np.float32)
    ang2 = rng.uniform(0, 2 * np.pi, n2).astype(np.float32)
    for i in range(80):
        ang2[100 + 2 * i] = (ang1[i] + 0.05) % (2 * np.pi)
    return ang1, ang2


def test_local_core_matches_reference(planted):
    d1, d2, m = planted
    b1, b2t = _jax_frames(d1, d2, m)
    f32 = np.float32
    ref = jm._match_locally_core(
        b1, m["valid1"], m["oct1"], m["x1"].astype(f32), m["y1"].astype(f32),
        b2t, m["valid2"], m["oct2"], m["x2"].astype(f32),
        m["y2"].astype(f32), f32(80.0), f32(0.9))
    t = torch.from_numpy
    got = tm._match_locally_core(
        _words(d1), t(m["valid1"]), t(m["oct1"]), t(m["x1"].astype(f32)),
        t(m["y1"].astype(f32)), _words(d2), t(m["valid2"]), t(m["oct2"]),
        t(m["x2"].astype(f32)), t(m["y2"].astype(f32)), 80.0, 0.9)
    assert (np.asarray(ref) >= 0).sum() >= 10
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("has_nodes", [True, False])
def test_epipolar_core_matches_reference(planted, has_nodes):
    d1, d2, m = planted
    b1, b2t = _jax_frames(d1, d2, m)
    f32 = np.float32
    ang1, ang2 = _angles(len(d1), len(d2), 3)
    # pure x-translation: epipolar lines are the rows y = y2
    F = np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], f32)
    sigma2 = ((1.2 ** np.arange(8)) ** 2 * 40).astype(f32)
    n1 = m["node1"].astype(np.int32)
    n2 = m["node2"].astype(np.int32)
    ref = jm._match_epipolar_core(
        b1, n1, m["valid1"], ang1, m["x1"].astype(f32), m["y1"].astype(f32),
        m["oct1"], b2t, n2, m["valid2"], ang2, m["x2"].astype(f32),
        m["y2"].astype(f32), F, sigma2, has_nodes=has_nodes)
    t = torch.from_numpy
    got = tm._match_epipolar_core(
        _words(d1), t(n1), t(m["valid1"]), t(ang1), t(m["x1"].astype(f32)),
        t(m["y1"].astype(f32)), t(m["oct1"]), _words(d2), t(n2),
        t(m["valid2"]), t(ang2), t(m["x2"].astype(f32)),
        t(m["y2"].astype(f32)), t(F), t(sigma2), has_nodes=has_nodes)
    assert (np.asarray(ref) >= 0).sum() >= 10
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("has_nodes", [True, False])
def test_bow_core_matches_reference(planted, has_nodes):
    d1, d2, m = planted
    b1, b2t = _jax_frames(d1, d2, m)
    ang1, ang2 = _angles(len(d1), len(d2), 4)
    n1 = m["node1"].astype(np.int32)
    n2 = m["node2"].astype(np.int32)
    ref = jm._match_by_bow_core(b1, n1, m["valid1"], ang1, b2t, n2,
                                m["valid2"], ang2, np.float32(0.9),
                                has_nodes=has_nodes)
    t = torch.from_numpy
    got = tm._match_by_bow_core(_words(d1), t(n1), t(m["valid1"]), t(ang1),
                                _words(d2), t(n2), t(m["valid2"]), t(ang2),
                                0.9, has_nodes=has_nodes)
    assert (np.asarray(ref) >= 0).sum() >= 10
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("gate", GATES)
def test_best_two_shared_column_frame_equals_expanded(problem, gate):
    """A 2-D ``desc2`` / ``colf`` beside batched rows (the refine's shared
    current frame) gives what the expanded, copied frame gives."""
    d1, d2, m = problem
    rng = np.random.default_rng(13)
    perms = [rng.permutation(len(d1)) for _ in range(3)]
    w1, w2, rowf, colf = _port_inputs(gate, d1, d2, m)
    desc1 = torch.stack([w1[p] for p in perms])
    rowfb = torch.stack([rowf[p] for p in perms])
    shared = tm._best_two(desc1, w2, rowfb, colf, gate)
    expanded = tm._best_two(desc1, w2.expand(3, *w2.shape).contiguous(),
                            rowfb, colf.expand(3, *colf.shape).contiguous(),
                            gate)
    for s, e in zip(shared, expanded):
        assert s.shape == e.shape == (3, len(d1))
        assert torch.equal(s, e)


def test_best2_work_and_bound_by_hand():
    """B=3, N1=N2=2000: 2*256 int8 operations a pair and every input
    read once, every output written once."""
    ops, nbytes = tmatch.best2_work(3, 2000, 2000)
    assert ops == 2 * 256 * 3 * 2000 * 2000 == 6_144_000_000
    # desc1, rowf, desc2, colf: 3*2000 rows of 32 B each; d1, d2, idx
    assert nbytes == 4 * 3 * 2000 * 32 + 3 * 3 * 2000 * 4 == 840_000
    ms, by = tmatch.bound_ms(3, 2000, 2000)
    assert by == "operations"
    assert ms == pytest.approx(6.144e9 / 1979e12 * 1e3)      # 3.10 us
    assert ms == pytest.approx(0.0031046, rel=1e-4)
    # a tiny problem is bound by its bytes
    ms, by = tmatch.bound_ms(1, 8, 8)
    assert by == "bytes"
    assert ms == pytest.approx((8 * 64 + 8 * 64 + 8 * 12) / 3.35e12 * 1e3)

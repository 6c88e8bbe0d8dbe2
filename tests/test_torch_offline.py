"""The offline pipeline's two-view units against the JAX package, fed the
same JAX-extracted features (``interop.features_from_arrays``) of a
``seqgen`` sequence (640x480, 1000 features).

Tolerances: flow counts exact and mean displacements within 1e-5 px;
local matching with per-lane radii and per-lane column frames exactly
equal; pair estimation by outcome (the port's RANSAC draws come from
torch's generator, the reference's from JAX's keys): the same success
flags, rotations within 0.5 deg, final match counts within 10%.  The
refine with one column frame per lane equals the shared-frame refine.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from irotavg_tpu.frontend import ORBExtractor as JaxORB
from irotavg_tpu.geometry import fused as jfused
from irotavg_tpu.matching.matchers import \
    _match_locally_core as jax_local_core
from irotavg_tpu.ops.match_pallas import unpack_pm1
from irotavg_tpu_torch import prng
from irotavg_tpu_torch.geometry import fused
from irotavg_tpu_torch.interop import features_from_arrays
from irotavg_tpu_torch.matching.matchers import _match_locally_core
from irotavg_tpu_torch.utils import timing
from seqgen import make_sequence
from jax_programs import release_jax_programs  # noqa: F401

# xdist runs several workers on the same cores; torch's default
# intra-op pool per worker oversubscribes them many times over
torch.set_num_threads(1)

N_FRAMES = 10
MIN_MATCHES = 60
# (a, b) frame pairs of the test and their radii: consecutive, window
# and wide pairs, and a pair too far apart to succeed at its radius
PAIRS = np.array([[0, 1], [0, 2], [1, 3], [2, 5], [3, 7], [4, 5], [0, 9],
                  [6, 8]])
RADII = np.array([45.0, 60.0, 70.0, 110.0, 160.0, 45.0, 20.0, 90.0],
                 np.float32)


@pytest.fixture(scope="module")
def feats():
    frames, K, _ = make_sequence(n_frames=N_FRAMES, seed=1, step=0.3,
                                 yaw_deg_per_frame=-1.0)
    jext = JaxORB(n_features=1000, n_levels=8)
    outs = [{k: np.asarray(v) for k, v in jext(im).items()} for im in frames]
    jax_stack = {k: jnp.asarray(np.stack([o[k] for o in outs]))
                 for k in outs[0]}
    return outs, jax_stack, features_from_arrays(outs, device="cpu"), K


def _consts(K):
    f32 = np.float32
    return (np.linalg.inv(K).astype(f32),
            ((1.2 ** np.arange(8)) ** 2).astype(f32),
            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], f32),
            f32(1.0 / K[0, 0]))


def test_features_from_arrays_layout(feats):
    outs, _, t, _ = feats
    assert t["desc"].dtype == torch.int32 and t["desc"].shape == (
        N_FRAMES, outs[0]["desc"].shape[0], 8)
    assert np.array_equal(t["desc"][3].numpy().view(np.uint32),
                          outs[3]["desc"].astype(np.uint32))
    assert t["valid"].dtype == torch.bool
    assert t["octave"].dtype == torch.int32
    np.testing.assert_array_equal(t["x0"][2].numpy(), outs[2]["x0"])


def test_fused_flow_matches_jax(feats):
    _, j, t, _ = feats
    ia = np.arange(N_FRAMES - 1)
    fl_j, ct_j = jfused.fused_flow_gather(
        j["desc"], j["valid"], j["octave"], j["x0"], j["y0"], ia, ia + 1,
        np.float32(90.0))
    ti = torch.from_numpy(ia)
    fl, ct = fused.fused_flow_gather(t["desc"], t["valid"], t["octave"],
                                     t["x0"], t["y0"], ti, ti + 1, 90.0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(ct_j))
    assert (ct.numpy() > 100).all()
    np.testing.assert_allclose(fl.numpy(), np.asarray(fl_j), atol=1e-5)


def test_local_matching_per_lane_radius_and_columns(feats):
    """One batched call, each lane with its own radius and column frame,
    equals the reference's core lane by lane."""
    outs, _, t, _ = feats
    ia, ib = PAIRS[:, 0], PAIRS[:, 1]
    got = _match_locally_core(
        t["desc"][ia], t["valid"][ia], t["octave"][ia], t["x0"][ia],
        t["y0"][ia], t["desc"][ib], t["valid"][ib], t["octave"][ib],
        t["x0"][ib], t["y0"][ib], torch.from_numpy(RADII), 0.9)
    for p, (a, b) in enumerate(PAIRS):
        A, Bf = outs[a], outs[b]
        want = jax_local_core(
            unpack_pm1(A["desc"]), A["valid"], A["octave"], A["x0"],
            A["y0"], unpack_pm1(Bf["desc"]).T, Bf["valid"], Bf["octave"],
            Bf["x0"], Bf["y0"], float(RADII[p]), 0.9)
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want),
                                      err_msg=f"pair {p}")
    assert (got >= 0).sum() > 500


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return math.degrees(math.acos(np.clip(c, -1.0, 1.0)))


def test_fused_pair_estimate_matches_jax_outcomes(feats):
    _, j, t, K = feats
    K_inv, sigma2, cam, th_norm = _consts(K)
    ia, ib = PAIRS[:, 0].astype(np.int32), PAIRS[:, 1].astype(np.int32)
    with jax.enable_x64(False):
        E_j, R_j, _, _, m_j, s_j = jfused.fused_pair_estimate_gather(
            j["desc"], j["valid"], j["octave"], j["x0"], j["y0"],
            j["angle"], ia, ib, RADII, K_inv, sigma2, cam, th_norm,
            np.uint32(0), np.int32(MIN_MATCHES))
    E, R, _, n, m12, success = fused.fused_pair_estimate_gather(
        t["desc"], t["valid"], t["octave"], t["x0"], t["y0"], t["angle"],
        torch.from_numpy(ia).long(), torch.from_numpy(ib).long(),
        torch.from_numpy(RADII), torch.from_numpy(K_inv),
        torch.from_numpy(sigma2), torch.from_numpy(cam),
        torch.tensor(th_norm), 0, MIN_MATCHES)
    s_j = np.asarray(s_j)
    assert success == s_j.tolist()
    assert 4 <= sum(success) < len(PAIRS)
    R_j = np.asarray(R_j)
    n_j = (np.asarray(m_j) >= 0).sum(axis=1)
    n_t = (m12 >= 0).sum(dim=1).numpy()
    for p in np.flatnonzero(s_j):
        assert _rot_deg(R[p].double().numpy(), R_j[p].astype(np.float64)) \
            < 0.5, f"pair {p}"
        assert abs(int(n_t[p]) - int(n_j[p])) <= 0.1 * n_j[p], (p, n_t, n_j)


def _refine_inputs(t, K, lanes):
    """Initial models and assignments for the pairs ``lanes`` (local
    match + RANSAC), as the pair estimate hands them to the refine."""
    return _pair_inputs(t, K, PAIRS[lanes, 0], PAIRS[lanes, 1],
                        RADII[lanes])


def _pair_inputs(t, K, ia, ib, radii):
    """:func:`_refine_inputs` of the pairs ``(ia[p], ib[p])`` searched at
    ``radii``."""
    K_inv, sigma2, cam, th_norm = (torch.from_numpy(np.asarray(c))
                                   for c in _consts(K))
    m12 = _match_locally_core(
        t["desc"][ia], t["valid"][ia], t["octave"][ia], t["x0"][ia],
        t["y0"][ia], t["desc"][ib], t["valid"][ib], t["octave"][ib],
        t["x0"][ib], t["y0"][ib], torch.from_numpy(radii), 0.9)
    E, R, tt, n, mask = fused._ransac_lanes(
        *fused._assignment_coords(m12, t["x0"][ia], t["y0"][ia],
                                  t["x0"][ib], t["y0"][ib], cam),
        prng.split(prng.key(3), len(ia)), th_norm)
    m12 = torch.where(mask, m12, torch.full_like(m12, -1))

    def frame(i, rows):
        z = torch.zeros_like(t["valid"][i], dtype=torch.int32)
        f = (t["desc"][i], z, t["valid"][i], t["angle"][i], t["x0"][i],
             t["y0"][i])
        return f + (t["octave"][i],) if rows else f

    consts = (K_inv, sigma2, cam, th_norm)
    return ia, ib, (E, R, tt, (m12 >= 0).sum(dim=1), m12), consts, frame


def test_refine_per_lane_columns_equal_lane_by_lane(feats):
    """``fused_refine`` with one column frame per lane (one batched
    match per iteration) equals shared-frame calls lane by lane, through
    every iteration: each lane draws from its own key."""
    _, _, t, K = feats
    lanes = [0, 1, 3]
    ia, ib, init, consts, frame = _refine_inputs(t, K, lanes)
    floor = math.ceil(0.75 * MIN_MATCHES)
    keys = prng.split(prng.key(11), len(lanes))
    got = fused.fused_refine(
        frame(ia, True), frame(ib, False), *init, *consts, keys, floor)
    for k in range(len(lanes)):
        one = fused.fused_refine(
            tuple(a[None] for a in frame(ia[k], True)), frame(ib[k], False),
            *(v[k:k + 1] for v in init), *consts, [keys[k]], floor)
        for g, w in zip(got[:5], one[:5]):
            assert torch.equal(g[k], w[0])
    assert got[5] >= 1 and (got[4] >= 0).sum() > 100


def test_refine_shared_frame_equals_broadcast_frame(feats):
    """The shared-frame callers' path (a 2-D column frame, batch stride 0
    in the kernel) gives what a per-lane copy of that frame gives."""
    _, _, t, K = feats
    _, _, init, consts, frame = _refine_inputs(t, K, [5])    # pair (4, 5)
    # two lanes holding the same pair: rows of frame 4, columns of frame 5
    init = tuple(v.repeat((2,) + (1,) * (v.dim() - 1)) for v in init)
    rows = frame(torch.tensor([4, 4]), True)
    cols = frame(5, False)
    floor = math.ceil(0.75 * MIN_MATCHES)
    keys = prng.split(prng.key(5))
    shared = fused.fused_refine(rows, cols, *init, *consts, keys, floor)
    lane_cols = tuple(c[None].expand((2,) + c.shape).contiguous()
                      for c in cols)
    per_lane = fused.fused_refine(rows, lane_cols, *init, *consts, keys,
                                  floor)
    for a, b in zip(shared[:5], per_lane[:5]):
        assert torch.equal(a, b)
    assert shared[5] == per_lane[5] >= 1


# rows of these frames against frame 5's columns, the shared-frame lanes
SHARED_ROWS = np.array([4, 6, 3, 7, 2, 8, 1, 0])


def _key_chains(monkeypatch):
    """Record every ``prng.split``: key -> the key it hands on."""
    chain, split = {}, prng.split

    def recording(k, n=2):
        out = split(k, n)
        chain[tuple(k)] = tuple(out[0])
        return out

    monkeypatch.setattr(prng, "split", recording)
    return chain


def _splits(chain, key):
    """How many times ``key`` and its successors were split."""
    n, k = 0, tuple(key)
    while k in chain:
        n, k = n + 1, chain[k]
    return n


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_refine_lanes_equal_lanes_alone(feats, monkeypatch, B, shared):
    """Every lane of a batched refine equals that lane run alone, in
    every output and in its iterations (the splits of its key), with one
    column frame per lane or one shared.  The last lane of a batch is a
    padding lane, frozen from the start: it returns its inputs, splits no
    key and changes no other lane.  Under a CPU profiler the call records
    one ``geometry.refine`` span whose ``lanes``, re-match shape,
    ``iters``, ``replays`` and ``captures`` (none on the CPU) are what
    ran; without one, nothing."""
    _, _, t, K = feats
    if shared:
        ia, ib = SHARED_ROWS[:B], np.full(B, 5)
        radii = (40.0 + 25.0 * np.abs(ia - 5)).astype(np.float32)
    else:
        ia, ib, radii = PAIRS[:B, 0], PAIRS[:B, 1], RADII[:B]
    _, _, init, consts, frame = _pair_inputs(t, K, ia, ib, radii)
    rows = frame(torch.from_numpy(ia), True)
    cols = frame(5 if shared else torch.from_numpy(ib), False)
    floor = math.ceil(0.75 * MIN_MATCHES)
    keys = prng.split(prng.key(11), B)
    frozen = [B > 1 and b == B - 1 for b in range(B)]
    chain = _key_chains(monkeypatch)
    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = fused.fused_refine(rows, cols, *init, *consts, keys, floor,
                                 frozen=frozen)
    spans = [s for s in timing.recorded_spans() if s[0] == "geometry.refine"]
    timing.clear_spans()
    assert [s[4] for s in spans] == [
        {"lanes": B - sum(frozen), "width": B, "rows": rows[4].shape[1],
         "cols": cols[4].shape[-1], "shared": int(shared),
         "gate": "epipolar_nonode", "iters": got[5], "replays": 0,
         "captures": 0}]
    iters = [_splits(chain, k) for k in keys]
    assert got[5] == max(iters) >= 1
    for b in range(B):
        chain.clear()
        one = fused.fused_refine(
            tuple(a[b:b + 1] for a in rows),
            cols if shared else tuple(a[b:b + 1] for a in cols),
            *(v[b:b + 1] for v in init), *consts, [keys[b]], floor,
            frozen=frozen[b:b + 1])
        for g, w in zip(got[:5], one[:5]):
            assert torch.equal(g[b], w[0]), b
        assert one[5] == iters[b] == _splits(chain, keys[b]), b
    assert timing.recorded_spans() == []
    if frozen[-1]:
        assert iters[-1] == 0
        want = (init[0].float(), init[1].float(), init[2].float(), init[3],
                init[4])
        for g, w in zip(got[:5], want):
            assert torch.equal(g[-1], w[-1])
    assert (got[4][:B - sum(frozen)] >= 0).sum() > 100 * (B - sum(frozen))


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
def test_refine_padding_lanes_change_nothing(feats, monkeypatch, shared):
    """The loop at a wider batch than its lanes (lane 0 repeated and
    frozen, as ``fused_refine`` pads its lanes on a CUDA device) gives
    every lane's outputs and iterations unpadded, and a padding lane
    splits no key."""
    _, _, t, K = feats
    B = 3
    if shared:
        ia, ib = SHARED_ROWS[:B], np.full(B, 5)
        radii = (40.0 + 25.0 * np.abs(ia - 5)).astype(np.float32)
    else:
        ia, ib, radii = PAIRS[:B, 0], PAIRS[:B, 1], RADII[:B]
    _, _, init, consts, frame = _pair_inputs(t, K, ia, ib, radii)
    rows = frame(torch.from_numpy(ia), True)
    cols = frame(5 if shared else torch.from_numpy(ib), False)
    keys = prng.split(prng.key(11), B)
    frozen = [False, True, False]

    def run(width):
        out, replays, captures = fused._refine(
            rows, cols, *init, *consts, keys, math.ceil(0.75 * MIN_MATCHES),
            False, fused.MAX_ITERS, fused.N_SAMPLES, frozen, False, width)
        assert replays == captures == 0
        return out

    splits, split = [], prng.split
    monkeypatch.setattr(prng, "split",
                        lambda k, n=2: splits.append(k) or split(k, n))
    want = run(B)
    n_want = len(splits)
    got = run(8)
    for g, w in zip(got, want):
        assert g == w if isinstance(g, int) else torch.equal(g, w)
    assert got[0].shape[0] == B and got[5] >= 1
    # the five padding lanes split no key
    assert len(splits) == 2 * n_want


def _signature(B, per_lane=False, n1=6, n2=5, xdtype=torch.float32):
    """Zero row and column frames of ``B`` lanes, ``n1`` / ``n2`` slots,
    coordinates of ``xdtype``."""
    def frame(shape):
        z = torch.zeros
        return (z(shape + (8,), dtype=torch.int32),
                z(shape, dtype=torch.int32), z(shape, dtype=torch.bool),
                z(shape), z(shape, dtype=xdtype), z(shape, dtype=xdtype),
                z(shape, dtype=torch.int32))
    return frame((B, n1)), frame((B, n2) if per_lane else (n2,))[:6]


def test_refine_loops_kept_by_signature_least_recently_used_out(
        monkeypatch):
    """The module keeps one refine loop a signature (lanes, row and column
    slots, a shared or per-lane column frame, gate, octave levels, the
    dtypes) and hands it back; past ``REFINE_GRAPHS`` signatures the
    least recently used goes."""
    monkeypatch.setattr(fused, "_refine_loops", type(fused._refine_loops)())
    consts = (torch.eye(3), torch.ones(8), torch.ones(4))

    def loop(B, *a, has_nodes=True, **kw):
        return fused._captured_loop(*_signature(B, *a, **kw), *consts,
                                    has_nodes)

    first = loop(1)
    assert loop(1) is first and first.graphs is None
    others = [loop(1, True), loop(1, has_nodes=False), loop(1, n1=7),
              loop(1, n2=4), loop(1, xdtype=torch.float64)]
    assert all(o is not first for o in others)
    assert len({id(o) for o in others}) == len(others)
    full = fused.REFINE_GRAPHS - len(others)        # B = 2 .. full: full
    for B in range(2, full + 1):
        loop(B)
    assert len(fused._refine_loops) == fused.REFINE_GRAPHS
    assert loop(1) is first                  # used again: the newest
    loop(full + 1)                           # one more: the oldest goes
    assert len(fused._refine_loops) == fused.REFINE_GRAPHS
    assert loop(1) is first
    assert loop(1, True) is not others[0]

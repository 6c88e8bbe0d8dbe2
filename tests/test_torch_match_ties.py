"""The matcher's adversarial cases (``chip_smoke.adversarial_match_cases``,
the cases phase 2 holds the CUDA kernel to on the card) on the CPU.

* ``best2_plain`` against the JAX ``best2_reference`` and the Pallas
  kernel in interpret mode, lane by lane.
* A numpy replay of the kernel's reduction order: per-lane partial top-2
  over the columns each lane of each block sees, merged in a shuffled
  order with the kernel's key encoding and merge rule.  It must equal
  ``best2_plain``; this is where ties across column chunks and tiles are
  decided.
* The cases cover what they claim, with the split and tile sizes of
  ``ops/match.py``.

Distances and indices are integers and the gate is the same f32
arithmetic, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from chip_smoke import adversarial_match_cases, column_boundaries
from irotavg_tpu.ops.match_pallas import (
    best2_reference, fused_best2, unpack_pm1,
)
from irotavg_tpu_torch.ops import match as tmatch
from irotavg_tpu_torch.ops.match import (
    COL_SPLIT, COL_TILE, GATES, MAX_COLS, ROWS_PER_BLOCK,
)

torch.set_num_threads(1)

IDX_BITS = 22
NO_DIST = 511
NO_KEY = (NO_DIST << IDX_BITS) | MAX_COLS


@pytest.fixture(scope="module")
def cases():
    return adversarial_match_cases(seed=0)


def _torch_args(case):
    t = [torch.from_numpy(np.ascontiguousarray(case[k]))
         for k in ("desc1", "desc2", "rowf", "colf")]
    t[0], t[1] = t[0].view(torch.int32), t[1].view(torch.int32)
    return t


def _lanes(case):
    """Per-lane numpy (desc1, desc2, rowf, colf)."""
    for b in range(case["desc1"].shape[0]):
        yield (case["desc1"][b],
               case["desc2"] if case["desc2"].ndim == 2 else case["desc2"][b],
               case["rowf"][b],
               case["colf"] if case["colf"].ndim == 2 else case["colf"][b])


def _jax_args(d1, d2, rowf, colf):
    return unpack_pm1(d1), unpack_pm1(d2).T, rowf, np.ascontiguousarray(
        colf.T)


@pytest.mark.parametrize("gate", GATES)
def test_plain_matches_reference_on_adversarial_cases(cases, gate):
    for case in (c for c in cases if c["gate"] == gate):
        got = [g.numpy() for g in tmatch.best2(*_torch_args(case), gate)]
        for b, lane in enumerate(_lanes(case)):
            ref = best2_reference(*_jax_args(*lane), gate)
            for name, g, r in zip(("d1", "d2", "idx"), got, ref):
                np.testing.assert_array_equal(
                    g[b], np.asarray(r), err_msg=f"{name} {case['name']} b={b}")


@pytest.mark.parametrize("gate", GATES)
def test_plain_matches_pallas_interpret_on_adversarial_cases(
        cases, gate, monkeypatch):
    monkeypatch.setenv("IROTAVG_PALLAS", "interpret")
    for case in (c for c in cases if c["gate"] == gate):
        got = [g.numpy() for g in tmatch.best2_plain(*_torch_args(case),
                                                     gate)]
        for b, lane in enumerate(_lanes(case)):
            ref = [np.asarray(r) for r in fused_best2(*_jax_args(*lane),
                                                      gate)]
            what = f"{case['name']} b={b}"
            np.testing.assert_array_equal(got[0][b], ref[0], err_msg=what)
            np.testing.assert_array_equal(got[1][b], ref[1], err_msg=what)
            # idx wherever the row has a match (the Pallas kernel leaves
            # padded-tile argmins unspecified otherwise)
            has = ref[0] < tmatch.BIG
            np.testing.assert_array_equal(got[2][b][has], ref[2][has],
                                          err_msg=what)


def _hamming(d1, d2):
    """(n1, n2) int64 Hamming distances of uint32 word rows."""
    x = d1[:, None, :] ^ d2[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)


def _merge(k1, k2, k1b, k2b):
    """The kernel's merge of top-2 keys, key = (d1 << 22) | idx."""
    return (np.minimum(k1, k1b),
            np.minimum(np.minimum(k2, k2b), np.maximum(k1, k1b)))


def _kernel_order(D, passed, rng):
    """best-2 through the kernel's partials: block chunk r, lane quad t
    sees the columns ``c`` of its chunk with ``(c - start) % 8`` in
    {2t, 2t+1}; the partials are merged in a shuffled order."""
    n1, n2 = D.shape
    cols = np.arange(n2)
    # the kernel's key: ((256 << 21) + column) - (dot << 21), dot = 256 - 2h
    keys = np.where(passed, ((256 << 21) + cols) - ((256 - 2 * D) << 21),
                    NO_KEY)
    assert np.array_equal(keys[passed], ((D << IDX_BITS) | cols)[passed])
    chunk = -(-n2 // COL_SPLIT)
    parts = []
    for r in range(COL_SPLIT):
        lo, hi = min(n2, r * chunk), min(n2, (r + 1) * chunk)
        for t in range(4):
            k1 = np.full(n1, NO_KEY, np.int64)
            k2 = np.full(n1, NO_KEY, np.int64)
            for c in range(lo, hi):
                if (c - lo) % 8 // 2 == t:
                    k1, k2 = _merge(k1, k2, keys[:, c], NO_KEY)
            parts.append((k1, k2))
    k1 = np.full(n1, NO_KEY, np.int64)
    k2 = np.full(n1, NO_KEY, np.int64)
    for i in rng.permutation(len(parts)):
        k1, k2 = _merge(k1, k2, *parts[i])
    d1, d2 = k1 >> IDX_BITS, k2 >> IDX_BITS
    none = d1 >= NO_DIST
    return (np.where(none, tmatch.BIG, d1).astype(np.float32),
            np.where(d2 >= NO_DIST, tmatch.BIG, d2).astype(np.float32),
            np.where(none, -1, k1 & MAX_COLS).astype(np.int32))


def test_kernel_reduction_order_matches_plain(cases):
    rng = np.random.default_rng(5)
    for case in cases:
        gate = case["gate"]
        got = [g.numpy() for g in tmatch.best2_plain(*_torch_args(case),
                                                     gate)]
        for b, (d1, d2, rowf, colf) in enumerate(_lanes(case)):
            passed = tmatch.gate_mask(gate, torch.from_numpy(rowf),
                                      torch.from_numpy(colf)).numpy()
            emu = _kernel_order(_hamming(d1, d2), passed, rng)
            for name, g, e in zip(("d1", "d2", "idx"), got, emu):
                np.testing.assert_array_equal(
                    g[b], e, err_msg=f"{name} {case['name']} {gate} b={b}")


def test_adversarial_cases_cover_their_claims(cases):
    st = COL_SPLIT * COL_TILE
    shapes = {(c["desc1"].shape[0], c["desc1"].shape[1], c["desc2"].shape[-2],
               c["desc2"].ndim, c["colf"].ndim) for c in cases}
    assert {n2 for _, _, n2, _, _ in shapes} >= {st - 1, st + 1}
    assert min(n1 for _, n1, _, _, _ in shapes) < ROWS_PER_BLOCK
    assert (3, ROWS_PER_BLOCK + 6, st + 1, 2, 2) in shapes   # both shared
    assert (3, ROWS_PER_BLOCK + 6, st + 1, 2, 3) in shapes   # words shared
    for gate in GATES:
        n_pass = []
        for case in (c for c in cases if c["gate"] == gate):
            d1, d2, rowf, colf = next(_lanes(case))
            passed = tmatch.gate_mask(gate, torch.from_numpy(rowf),
                                      torch.from_numpy(colf)).numpy()
            n_pass.append(passed.sum(1))
            if case["name"] == "one valid column":
                continue
            # exact duplicates of one row on both sides of every boundary
            bounds = column_boundaries(d2.shape[0], COL_SPLIT, COL_TILE)
            assert bounds
            D = _hamming(d1, d2)
            for c in bounds:
                both = (D[:, c - 1] == 0) & (D[:, c] == 0) & \
                    passed[:, c - 1] & passed[:, c]
                assert both.any(), f"{case['name']} {gate} boundary {c}"
        n_pass = np.concatenate(n_pass)
        assert (n_pass == 0).any() and (n_pass == 1).any(), gate


def test_nibble_expansion_formula():
    """The kernel's ±1 expansion of a nibble (pm1_nibble): a multiply
    spreads bit j to bit 8j, then one multiply-subtract gives byte j =
    +1 (bit set) or -1 (bit clear)."""
    v = np.arange(16, dtype=np.uint64)
    spread = (v * 0x00204081) & 0x01010101
    word = (0xFFFFFFFF - spread * 0xFE).astype(np.uint32)
    got = word.view(np.int8).reshape(16, 4)           # little-endian bytes
    want = np.where((v[:, None] >> np.arange(4, dtype=np.uint64)) & 1, 1, -1)
    np.testing.assert_array_equal(got, want)

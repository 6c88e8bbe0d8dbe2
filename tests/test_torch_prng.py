"""The port's threefry key tree (``prng.py``) and RANSAC's draw
(``ops/draw.py``) against ``jax.random``, bit for bit.

The JAX side runs under ``jax.enable_x64(False)``, as the JAX CLIs do:
under x64 ``randint`` draws int64 and other numbers (checked below), so
the port reproduces the int32 draws.  The plain draw is held to the
reference's positions (``test_torch_geometry._jax_draws``, clamped to
``N - 1`` as the reference's gather reads them) for single calls and for
lanes, each lane with its own key and valid row.  Every comparison is
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irotavg_tpu_torch import prng, so3
from irotavg_tpu_torch.ops import draw
from test_torch_geometry import _jax_draws
from jax_programs import release_jax_programs  # noqa: F401

SEEDS = [0, 5, 123_456_789, 2**32 - 1]


def _kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def test_threefry_partitionable_is_pinned():
    """The port implements the partitionable variant only; a JAX whose
    default changes must fail here, not drift."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    with jax.enable_x64(False):
        k = jax.random.key(jnp.uint32(seed))
        assert _kd(k) == prng.key(seed)
        for n in (2, 3, 8):
            assert [_kd(s) for s in jax.random.split(k, n)] == \
                prng.split(prng.key(seed), n)
        for data in (0, 1, 7, 2**31 + 3):
            assert _kd(jax.random.fold_in(k, data)) == \
                prng.fold_in(prng.key(seed), data)
        # split(k, n)[i] is fold_in(k, i), whatever n
        assert prng.split(prng.key(seed), 5)[3] == \
            prng.fold_in(prng.key(seed), 3)


# spans: nv = 0 and 1 (maxval clamps to one value), N-sized, and spans
# above 2**16, where the multiplier (2**16 % span)**2 wraps
SPANS = [0, 1, 7, 2000, 70_000, 100_003, 2**31 - 99, 2**31 - 1]


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("shape", [(4,), (64, 8), (3, 5, 2)])
def test_randint_int32(span, shape):
    for seed in SEEDS[:3]:
        with jax.enable_x64(False):
            ref = np.asarray(jax.random.randint(jax.random.key(seed), shape,
                                                0, span))
        got = prng.randint(prng.key(seed), shape, 0, span)
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), ref)


def test_randint_wraps_and_shifts():
    """Above a span of 2**16 the multiplier ``(2**16 % span)**2`` wraps to
    0 in uint32, as JAX's does (without the wrap the draws differ); and a
    non-zero minval."""
    k = prng.key(11)
    span = 2**31 - 99
    k1, k2 = prng.split(k)
    hi = prng.random_bits(k1, (4096,))
    lo = prng.random_bits(k2, (4096,))
    unwrapped = ((hi % span) * (65536**2 % span) + lo % span) % span
    with jax.enable_x64(False):
        ref = np.asarray(jax.random.randint(jax.random.key(11), (4096,), 0,
                                            span))
        ref_shift = np.asarray(jax.random.randint(jax.random.key(11), (50,),
                                                  -40, 17))
    got = prng.randint(k, (4096,), 0, span)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (unwrapped != got).any()
    np.testing.assert_array_equal(prng.randint(k, (50,), -40, 17).numpy(),
                                  ref_shift)


def test_x64_draws_other_numbers():
    """Why the JAX side of every parity test runs without x64."""
    with jax.enable_x64(False):
        i32 = np.asarray(jax.random.randint(jax.random.key(5), (4,), 0, 1000))
    with jax.enable_x64(True):
        i64 = np.asarray(jax.random.randint(jax.random.key(5), (4,), 0, 1000))
    assert i32.tolist() == [961, 648, 303, 936]
    assert i64.tolist() == [167, 852, 506, 541]
    assert prng.randint(prng.key(5), (4,), 0, 1000).tolist() == i32.tolist()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_and_random_quat(seed, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.enable_x64(dtype == "float64"):
        k = jax.random.key(jnp.uint32(seed))
        ref = np.asarray(jax.random.uniform(k, (7, 3), dtype=jdt))
        scalar = np.asarray(jax.random.uniform(k, (), dtype=jdt))
    got = prng.uniform(prng.key(seed), (7, 3), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(prng.uniform(prng.key(seed), (), tdt)
                                  .numpy(), scalar)
    # random_quat is Shoemake's map of the same numbers
    from irotavg_tpu import so3 as jso3

    with jax.enable_x64(dtype == "float64"):
        qj = np.asarray(jso3.random_quat(k, (5,), jdt))
    qt = so3.random_quat(prng.key(seed), (5,), tdt, device="cpu")
    tol = 1e-6 if dtype == "float32" else 1e-14
    np.testing.assert_allclose(qt.numpy(), qj, rtol=0, atol=tol)
    with pytest.raises(TypeError):
        prng.uniform(prng.key(seed), (2,), torch.float16)


def _valid(kind, n, rng):
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "one":
        v = np.zeros(n, bool)
        v[rng.integers(n)] = True
        return v
    if kind == "all":
        return np.ones(n, bool)
    return rng.random(n) < 0.6


def _reference(valid, seed, n_samples, h_samples):
    with jax.enable_x64(False):
        idx, idx_h = _jax_draws(valid, jax.random.key(seed), n_samples,
                                h_samples)
    n = len(valid)
    return idx.clamp(max=n - 1), idx_h.clamp(max=n - 1)


@pytest.mark.parametrize("kind", ["none", "one", "all", "some"])
@pytest.mark.parametrize("n, n_samples, h_samples",
                         [(2000, 512, 192), (2000, 1024, 192), (77, 64, 0)])
def test_draw_positions_plain_single(kind, n, n_samples, h_samples):
    rng = np.random.default_rng(n + n_samples)
    valid = _valid(kind, n, rng)
    for seed in (3, 2**32 - 5):
        idx, idx_h = draw.draw_positions_plain(
            torch.from_numpy(valid)[None], [prng.key(seed)],
            ((n_samples, 8), (h_samples, 4)))
        ref, ref_h = _reference(valid, seed, n_samples, h_samples)
        assert idx.shape == (1, n_samples, 8) and idx.dtype == torch.int64
        assert idx_h.shape == (1, h_samples, 4)
        assert torch.equal(idx[0], ref) and torch.equal(idx_h[0], ref_h)
        if kind != "none":
            assert valid[idx.numpy()].all()


def test_draw_positions_plain_lanes():
    """Lanes, each with its own key and valid row, equal the reference's
    single calls; a lane's draws do not depend on the other lanes."""
    rng = np.random.default_rng(0)
    n = 500
    kinds = ["some", "none", "all", "one", "some", "some", "some", "some"]
    valid = np.stack([_valid(k, n, rng) for k in kinds])
    keys = prng.split(prng.key(77), len(kinds))
    shapes = ((512, 8), (192, 4))
    idx, idx_h = draw.draw_positions_plain(torch.from_numpy(valid), keys,
                                           shapes)
    with jax.enable_x64(False):
        jkeys = jax.random.split(jax.random.key(77), len(kinds))
    for lane in range(len(kinds)):
        with jax.enable_x64(False):
            ref = _jax_draws(valid[lane], jkeys[lane], 512, 192)
        assert torch.equal(idx[lane], ref[0].clamp(max=n - 1))
        assert torch.equal(idx_h[lane], ref[1].clamp(max=n - 1))
    sub = draw.draw_positions_plain(torch.from_numpy(valid[2:5]), keys[2:5],
                                    shapes)
    assert torch.equal(sub[0], idx[2:5]) and torch.equal(sub[1], idx_h[2:5])


def test_draw_dispatch_and_bound():
    """The plain draw refuses malformed input: ``valid`` not (lanes, N)
    bool, a key count other than the lanes', no position to draw from,
    other than two shapes."""
    valid = torch.ones((2, 10), dtype=torch.bool)
    keys = prng.split(prng.key(1))
    shapes = ((3, 8), (2, 4))
    with pytest.raises(ValueError, match="lanes, N"):
        draw.draw_positions_plain(valid[0], keys[:1], shapes)
    with pytest.raises(TypeError, match="bool"):
        draw.draw_positions_plain(valid.to(torch.uint8), keys, shapes)
    with pytest.raises(ValueError, match="keys"):
        draw.draw_positions_plain(valid, keys[:1], shapes)
    with pytest.raises(ValueError, match="no positions"):
        draw.draw_positions_plain(valid[:, :0], keys, shapes)
    with pytest.raises(ValueError, match="two shapes"):
        draw.draw_positions_plain(valid, keys, shapes[:1])
    idx, idx_h = draw.draw_positions_plain(valid, keys, shapes)
    assert idx.shape == (2, 3, 8) and idx_h.shape == (2, 2, 4)


def test_port_draws_from_no_torch_generator():
    """Every random number of the port comes from the key tree: no module
    makes a ``torch.Generator`` or draws from torch's own streams."""
    import os
    import re

    import irotavg_tpu_torch

    root = os.path.dirname(irotavg_tpu_torch.__file__)
    pattern = re.compile(r"torch\.(Generator|rand|randn|randint|randperm|"
                         r"multinomial|bernoulli)\(|manual_seed\(")
    hits = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    hits += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                             if pattern.search(line)]
    assert hits == []

"""JAX's threefry key tree, for the port's random draws.

The JAX package draws every RANSAC sample from ``jax.random`` keys
(``jax.random.key(seed)``, ``split``, ``fold_in``, ``randint``); here the
same keys are derived on the host, so the port draws the numbers the JAX
package draws, on the card and on the CPU alike.  Only the partitionable
threefry variant is implemented (``jax_threefry_partitionable``, JAX's
default): ``split(key, n)[i] == fold_in(key, i)``, and the bits of a
draw over a shape are ``b1 ^ b2`` of ``threefry2x32(key, (hi, lo))`` of
each element's flat index.

A key is a pair of uint32 values held as Python ints.  Deriving keys
costs no launch and no read from the device.  :func:`threefry2x32` also
takes int64 tensors of uint32 values as its counters, which is how the
plain draws (:func:`random_bits`, ``ops/draw.py``) evaluate it.

The JAX package's CLIs run without x64, so :func:`randint` is JAX's
int32 ``randint`` (under x64 JAX draws int64 and other numbers).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's ``_threefry2x32_lowering``):
    the hash of the counter pair ``(x0, x1)`` under ``key``.  ``x0`` and
    ``x1`` are ints or int64 tensors of uint32 values; returns the pair
    ``(y0, y1)`` of the same kind."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int):
    """``jax.random.key(uint32(seed))``: the key ``(0, seed)``."""
    return (0, int(seed) & M32)


def fold_in(k, data: int):
    """``jax.random.fold_in(k, data)``."""
    return threefry2x32(k, 0, int(data) & M32)


def split(k, n: int = 2):
    """``jax.random.split(k, n)`` as a list of ``n`` keys."""
    return [fold_in(k, i) for i in range(n)]


def _counters(shape, device):
    """The (hi, lo) words of each element's flat index (JAX's
    ``iota_2x32_shape``), int64 tensors of ``shape``."""
    flat = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                        device=device).reshape(shape)
    return flat >> 32, flat & M32


def random_bits(k, shape, device=None, width=32):
    """JAX's random bits of ``k`` over ``shape`` as an int64 tensor: the
    32-bit ``b1 ^ b2``, or for ``width=64`` the top 52 bits of
    ``b1 << 32 | b2`` (all that a float64 draw reads; a uint64 does not
    fit an int64)."""
    b1, b2 = threefry2x32(k, *_counters(shape, device))
    if width == 32:
        return b1 ^ b2
    return (b1 << 20) | (b2 >> 12)


def randint_span(hi, lo, span):
    """JAX's int32 ``randint`` offset in ``[0, span)`` from its higher and
    lower 32 random bits, in uint32 arithmetic: ``((hi % span) * mult +
    lo % span) % span`` with ``mult = (2**16 % span)**2 % span``, where
    the arithmetic wraps at 2**32 as JAX's does (above a span of 2**16
    the square is 2**32, so ``mult`` is 0).  ``span`` (>= 1) is an int or
    a tensor that broadcasts against ``hi``."""
    mult = (((65536 % span) * (65536 % span)) & M32) % span
    return (((hi % span) * mult + lo % span) & M32) % span


def randint(k, shape, minval: int, maxval: int, device=None):
    """``jax.random.randint(k, shape, minval, maxval, dtype=int32)`` as an
    int64 tensor."""
    k1, k2 = split(k)
    span = (maxval - minval) & M32 if maxval > minval else 1
    off = randint_span(random_bits(k1, shape, device),
                       random_bits(k2, shape, device), span)
    return ((minval + off + 2**31) & M32) - 2**31


def uniform(k, shape=(), dtype=torch.float32, device=None):
    """``jax.random.uniform(k, shape, dtype)`` on [0, 1): the mantissa
    bits of a float in [1, 2), less one."""
    if dtype == torch.float32:
        bits = (random_bits(k, shape, device) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = random_bits(k, shape, device, width=64) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform draws float32 or float64, not {dtype}")

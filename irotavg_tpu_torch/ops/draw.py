"""RANSAC's sample draws from JAX's threefry keys, in plain PyTorch.

The JAX package's ``ransac_essential`` (``irotavg_tpu/geometry/
essential.py:620-641``) draws ranks uniform over the valid
correspondences with ``jax.random.randint`` (int32, the CLIs run without
x64) and maps each rank to a position through the cumulative valid
count: ``(S, 8)`` ranks from its key for the 8-point samples, ``(H, 4)``
from ``fold_in(key, 1)`` for the homography samples.
:func:`draw_positions_plain` computes exactly those positions for a
leading axis of lanes, one key and one ``valid`` row each:

* ``nv = max(cumsum(valid)[-1], 1)``; ``ranks = randint(k, shape, 0,
  nv)``, where ``randint`` splits ``k`` into ``k1, k2`` and maps the
  bits of ``k1`` (higher) and ``k2`` (lower) with ``prng.randint_span``;
* ``position = searchsorted(cumsum(valid), rank, right=True)``, clamped
  to ``N - 1`` as the reference's clamped gather reads it (with no valid
  entry every position is ``N - 1``).

On the card the hypotheses kernel draws for itself (``csrc/ransac_hyp.cu``
through ``csrc/threefry.cuh``), in integer arithmetic equal to this
function's bit for bit; ``ops/ransac.py``'s plain version draws with this
function.
"""

from __future__ import annotations

import math

import torch

from irotavg_tpu_torch import prng

# integer operations of one threefry2x32: two key adds, then five groups
# of four rounds (add, rotate, xor) each followed by three adds
THREEFRY_OPS = 2 + 5 * (4 * 3 + 3)
# randint's mapping of one draw: two xors, three remainders, a product,
# a sum and a last remainder
MAP_OPS = 8


def lane_keys(key):
    """The ``(k1, k2)`` keys of a lane's two draws: ``split(key)`` for the
    first shape, ``split(fold_in(key, 1))`` for the second (the
    reference's homography draw)."""
    return [prng.split(key), prng.split(prng.fold_in(key, 1))]


def _check_shapes(valid, keys, shapes):
    if valid.dim() != 2:
        raise ValueError(f"valid must be (lanes, N), got "
                         f"{tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if len(keys) != valid.shape[0]:
        raise ValueError(f"{len(keys)} keys for {valid.shape[0]} lanes")
    if valid.shape[1] == 0:
        raise ValueError("valid has no positions to draw from")
    if len(shapes) != 2:
        raise ValueError(f"draw_positions_plain takes two shapes, got "
                         f"{shapes}")


def draw_positions_plain(valid, keys, shapes):
    """Plain version: ``valid (L, N)`` bool, ``keys`` L host keys,
    ``shapes`` the two draw shapes -> the two int64 position tensors
    ``(L, *shapes[0])`` and ``(L, *shapes[1])``, in int64 arithmetic
    masked to 32 bits."""
    _check_shapes(valid, keys, shapes)
    dev = valid.device
    N = valid.shape[1]
    cs = torch.cumsum(valid.to(torch.int64), dim=1)
    span = cs[:, -1:].clamp(min=1)
    sizes = [math.prod(s) for s in shapes]
    # per draw, the (k1, k2) keys of its lane and shape, as (L, n) words
    words = torch.tensor([[[*k1, *k2] for k1, k2 in lane_keys(key)]
                          for key in keys], dtype=torch.int64, device=dev)
    words = torch.repeat_interleave(
        words, torch.tensor(sizes, device=dev), dim=1)       # (L, n, 4)
    idx = torch.cat([torch.arange(n, dtype=torch.int64, device=dev)
                     for n in sizes])
    k1, k2 = (words[..., 0], words[..., 1]), (words[..., 2], words[..., 3])
    hi = torch.bitwise_xor(*prng.threefry2x32(k1, 0, idx))
    lo = torch.bitwise_xor(*prng.threefry2x32(k2, 0, idx))
    ranks = prng.randint_span(hi, lo, span)
    pos = torch.searchsorted(cs, ranks.contiguous(), right=True)
    pos = pos.clamp(max=N - 1)
    L = pos.shape[0]
    return (pos[:, :sizes[0]].reshape((L,) + tuple(shapes[0])),
            pos[:, sizes[0]:].reshape((L,) + tuple(shapes[1])))

"""RANSAC's sample draws from JAX's threefry keys: the CUDA kernel's
wrapper and its plain PyTorch version.

The JAX package's ``ransac_essential`` (``irotavg_tpu/geometry/
essential.py:620-641``) draws ranks uniform over the valid
correspondences with ``jax.random.randint`` (int32, the CLIs run without
x64) and maps each rank to a position through the cumulative valid
count: ``(S, 8)`` ranks from its key for the 8-point samples, ``(H, 4)``
from ``fold_in(key, 1)`` for the homography samples.
:func:`draw_positions` computes exactly those positions for a leading
axis of lanes, one key and one ``valid`` row each:

* ``nv = max(cumsum(valid)[-1], 1)``; ``ranks = randint(k, shape, 0,
  nv)``, where ``randint`` splits ``k`` into ``k1, k2`` and maps the
  bits of ``k1`` (higher) and ``k2`` (lower) with ``prng.randint_span``;
* ``position = searchsorted(cumsum(valid), rank, right=True)``, clamped
  to ``N - 1`` as the reference's clamped gather reads it (with no valid
  entry every position is ``N - 1``).

The arithmetic is integer only, so ``csrc/threefry_draw.cu`` equals
:func:`draw_positions_plain` bit for bit.  The keys are derived on the
host (``prng.py``) and reach the kernel by value, so a draw needs no copy
to the card and no read back.

:func:`draw_positions` dispatches on the device of ``valid`` only: CPU
tensors run :func:`draw_positions_plain`, CUDA tensors launch the kernel
(one launch for every ``MAX_LANES`` lanes) or raise.  Each launch adds one
to ``draw_positions.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from irotavg_tpu_torch import prng
from irotavg_tpu_torch.ops.segment import H100_HBM_BYTES_PER_S

# lanes one launch takes (their keys travel in the kernel's arguments) and
# the longest valid row (its cumulative count lives in shared memory);
# both must equal the .cu's kMaxLanes and kMaxN
MAX_LANES = 64
MAX_N = 57344
# 32-bit integer operations per second of one NVIDIA H100 SXM: 132 SMs
# of 64 INT32 lanes (the Hopper architecture white paper) at the 1.98 GHz
# at which the data sheet's 67 TFLOP/s f32 (128 FMA lanes) is quoted
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
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
        raise ValueError(f"draw_positions takes two shapes, got {shapes}")


def _split_out(out, shapes):
    L, n_e = out.shape[0], math.prod(shapes[0])
    return (out[:, :n_e].reshape((L,) + tuple(shapes[0])),
            out[:, n_e:].reshape((L,) + tuple(shapes[1])))


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
    return _split_out(pos.clamp(max=N - 1), shapes)


def draw_work(lanes: int, n: int, draws: int):
    """(operations, bytes) of drawing ``draws`` positions in each of
    ``lanes`` lanes over ``n`` valid flags: the scan's ``n`` adds, per
    draw two threefry2x32 evaluations, randint's mapping and a binary
    search of ``ceil(log2(n + 1))`` steps; ``valid`` read once and the
    int64 positions written once."""
    steps = math.ceil(math.log2(n + 1))
    ops = lanes * (n + draws * (2 * THREEFRY_OPS + MAP_OPS + steps))
    return ops, lanes * (n + 8 * draws)


def bound_ms(lanes: int, n: int, draws: int):
    """(ms, "operations" or "bytes"): the least time one H100 could take
    for :func:`draw_work`, its integer operations at the card's int32
    rate or its bytes at the HBM rate, whichever is longer."""
    ops, nbytes = draw_work(lanes, n, draws)
    t_ops = ops / H100_INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class _Keys(ctypes.Structure):
    """The kernel's ``DrawKeys``: per lane the words ``k1, k2`` of the
    first shape's keys, then those of the second shape's."""
    _fields_ = [("k", ctypes.c_uint32 * (MAX_LANES * 8))]


@functools.lru_cache(maxsize=None)
def _lib():
    from irotavg_tpu_torch.kernels.build import load

    lib = load("threefry_draw")
    limits = (ctypes.c_int * 2)()
    lib.threefry_draw_limits(limits)
    if tuple(limits) != (MAX_LANES, MAX_N):
        raise RuntimeError(f"threefry_draw limits {tuple(limits)} differ "
                           f"from ops/draw.py's {(MAX_LANES, MAX_N)}")
    fn = lib.threefry_draw
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _Keys,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def draw_launcher(valid, keys, shapes):
    """Check CUDA inputs once and allocate the output: returns ``(launch,
    (pos_a, pos_b))``, where each ``launch()`` runs the kernel into those
    tensors, one launch for every ``MAX_LANES`` lanes, each counted.
    :func:`draw_positions` is one such call; ``chip_smoke.py`` times
    back-to-back calls with it."""
    _check_shapes(valid, keys, shapes)
    dev = valid.device
    if dev.type != "cuda":
        raise ValueError(f"threefry_draw has no kernel for device {dev}")
    L, N = valid.shape
    if N > MAX_N:
        raise ValueError(f"threefry_draw takes at most {MAX_N} positions, "
                         f"got {N}")
    valid = valid.contiguous()
    n_a, n_b = (math.prod(s) for s in shapes)
    total = n_a + n_b
    out = torch.empty((L, total), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = []
    for g in range(0, L, MAX_LANES):
        lanes = min(MAX_LANES, L - g)
        words = _Keys()
        for i, key in enumerate(keys[g:g + lanes]):
            (a1, a2), (b1, b2) = lane_keys(key)
            words.k[8 * i:8 * i + 8] = [*a1, *a2, *b1, *b2]
        calls.append((valid[g].data_ptr(), out[g].data_ptr(), lanes, N,
                      n_a, n_b, words, stream))
    fn = _lib()

    def launch():
        if total == 0:
            return
        for args in calls:
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"threefry_draw launch failed: CUDA "
                                   f"error {err}")
            draw_positions.launches += 1

    launch.tensors = (valid, out)   # what ``calls`` points at
    return launch, _split_out(out, shapes)


def draw_positions(valid, keys, shapes):
    """Sample positions of ``L`` lanes: ``valid (L, N)`` bool, ``keys`` a
    list of L host keys (``prng.key``), ``shapes`` the two draw shapes
    (the reference's ``(S, 8)`` and ``(H, 4)``).  Returns int64 tensors
    ``(L, *shapes[0])`` and ``(L, *shapes[1])``.  CPU tensors run
    :func:`draw_positions_plain`; CUDA tensors launch ``threefry_draw``;
    any other device raises."""
    if valid.device.type == "cpu":
        return draw_positions_plain(valid, keys, shapes)
    launch, out = draw_launcher(valid, keys, shapes)
    launch()
    return out


def reset_launch_counts() -> None:
    """Zero the kernel launch counter of :func:`draw_positions`."""
    draw_positions.launches = 0


# kernel launches made by draw_positions and draw_launcher (read and reset
# by chip_smoke.py)
reset_launch_counts()

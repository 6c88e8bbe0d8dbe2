"""Hamming distance between 256-bit descriptors (XOR + popcount).

Port of ``irotavg_tpu/ops/hamming.py``: the dense (K1, K2) FORB distance
(third_party/DBoW2/DBoW2/FORB.cpp:81-101; descriptorDistance,
src/ViewGraph.cpp:106-122).  Plain PyTorch, as the reference's is a plain
XLA program; the matchers do not use it (their best-2 reduction is the
CUDA kernel of ``ops/match.py``).  Descriptors are the port's ``(N, 8)``
int32 tensors holding the uint32 word bit patterns.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def popcount32(x):
    """Per-lane popcount of 32-bit words (the SWAR bit-twiddle), as int32.

    ``x`` holds uint32 bit patterns in any integer dtype (int32 words are
    read as unsigned); the arithmetic runs in int64, so no lane
    overflows."""
    x = x.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _M32) >> 24).to(torch.int32)


def hamming_matrix(d1, d2):
    """(K1, K2) int32 Hamming distances for (K1, 8), (K2, 8) words."""
    x = torch.bitwise_xor(d1[:, None, :], d2[None, :, :])   # (K1, K2, 8)
    return popcount32(x).sum(dim=-1, dtype=torch.int32)

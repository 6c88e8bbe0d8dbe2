// JAX's threefry draws of RANSAC's sample positions, as device code of
// csrc/ransac_hyp.cu.
//
// A lane's draw d, with valid flags v (n bytes) scanned into cs, and the
// keys (k1, k2) of d's shape (i = d's index in its shape):
//
//   span    = max(cs[n-1], 1)
//   hi, lo  = b0 ^ b1 of threefry2x32(k1, (0, i)) and of (k2, (0, i))
//   rank    = ((hi % span) * mult + lo % span) % span in uint32, with
//             mult = (2^16 % span)^2 % span       (jax.random.randint)
//   pos     = min(#{j : cs[j] <= rank}, n - 1)
//
// which is what irotavg_tpu/geometry/essential.py:620-641 computes with
// jax.random.randint (int32) and its compare-reduce over cs, and what
// irotavg_tpu_torch/ops/draw.py:draw_positions_plain computes.  Integer
// arithmetic only.

#pragma once

#include <stdint.h>

constexpr int kDrawMaxLanes = 64;

// The keys of a launch, passed by value (2 KB of kernel arguments): per
// lane k1 and k2 of the first shape, then of the second.  At file scope,
// so that exported C functions taking it keep external linkage.
struct DrawKeys {
  uint32_t k[kDrawMaxLanes * 8];
};

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// JAX's _threefry2x32_lowering: 20 rounds; returns y0 ^ y1
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

// Inclusive scan of the n flags v into cs (shared memory), by all
// kThreads threads of the block: a contiguous chunk per thread, the
// chunks' counts scanned across the block.  Ends with __syncthreads().
template <int kThreads>
__device__ void scan_flags(const uint8_t* __restrict__ v, int n, int* cs) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * per, n);
  const int hi = min(lo + per, n);
  int c = 0;
  for (int j = lo; j < hi; ++j) c += v[j] != 0;
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if ((tid & 31) >= o) x += y;
  }
  if ((tid & 31) == 31) warp_sum[tid >> 5] = x;
  __syncthreads();
  if (tid < 32) {
    int w = tid < kWarps ? warp_sum[tid] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (tid >= o) w += y;
    }
    if (tid < kWarps) warp_sum[tid] = w;
  }
  __syncthreads();
  int run = x - c + ((tid >> 5) ? warp_sum[(tid >> 5) - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    run += v[j] != 0;
    cs[j] = run;
  }
  __syncthreads();
}

// randint's multiplier for a span (see the top of this file)
__device__ __forceinline__ uint32_t draw_mult(uint32_t span) {
  const uint32_t m = 65536u % span;
  return (m * m) % span;
}

// The position of draw i of a shape with keys k = {k1[0], k1[1], k2[0],
// k2[1]}, over the scanned flags cs (n of them).
__device__ __forceinline__ int draw_position(const int* cs, int n,
                                             uint32_t span, uint32_t mult,
                                             const uint32_t* k, uint32_t i) {
  const uint32_t hbits = threefry_bits(k[0], k[1], 0u, i);
  const uint32_t lbits = threefry_bits(k[2], k[3], 0u, i);
  const uint32_t rank = ((hbits % span) * mult + lbits % span) % span;
  // the first j with cs[j] > rank (cs is non-decreasing)
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if ((uint32_t)cs[mid] <= rank) a = mid + 1; else b = mid;
  }
  return min(a, n - 1);
}

}  // namespace

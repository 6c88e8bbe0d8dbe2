// RANSAC's sample positions from JAX's threefry keys.
//
// For each lane (blockIdx.y) with its valid flags v (n bytes) and four
// keys, and each draw d of its n_a + n_b draws:
//
//   cs      = inclusive cumulative count of v         (shared memory)
//   span    = max(cs[n-1], 1)
//   (k1,k2) = the keys of d's shape (the first n_a draws read the first
//             pair, the rest the second); i = d's index in its shape
//   hi, lo  = b0 ^ b1 of threefry2x32(k1, (0, i)) and of (k2, (0, i))
//   rank    = ((hi % span) * mult + lo % span) % span in uint32, with
//             mult = (2^16 % span)^2 % span       (jax.random.randint)
//   out[d]  = min(#{j : cs[j] <= rank}, n - 1)
//
// which is what irotavg_tpu/geometry/essential.py:620-641 computes with
// jax.random.randint (int32) and its compare-reduce over cs.  The JAX
// package has no Pallas kernel here: this replaces the XLA program of
// that draw, and today's eight torch launches a draw.  The keys are
// derived on the host (irotavg_tpu_torch/prng.py) and passed by value.
//
// Bound: the integer operations of two threefry evaluations (about 80
// each) per draw, far above the bytes (n flags in, 8 bytes out a draw);
// at RANSAC's sizes (a few thousand draws) a launch is latency-bound
// either way.  Design: every block of a lane scans the lane's flags into
// shared memory itself (n <= kMaxN; a few thousand bytes, re-read from
// L2), so blocks need no second pass; then one thread per draw runs the
// hash, the mapping and a binary search of cs (csrc/threefry.cuh, shared
// with csrc/ransac_hyp.cu).  Integer arithmetic only: the result equals
// ops/draw.py:draw_positions_plain bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

constexpr int kMaxLanes = kDrawMaxLanes;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 57344;          // 224 KB of int32 cs
constexpr int kMaxBlocksPerLane = 64;

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const uint8_t* __restrict__ valid,
                     int64_t* __restrict__ out, int n, int n_a, int n_b,
                     DrawKeys keys) {
  extern __shared__ int cs[];
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  scan_flags<kThreads>(valid + (int64_t)lane * n, n, cs);

  const uint32_t span = (uint32_t)max(cs[n - 1], 1);
  const uint32_t mult = draw_mult(span);
  const int total = n_a + n_b;
  const uint32_t* kl = keys.k + lane * 8;
  int64_t* o = out + (int64_t)lane * total;
  for (int d = blockIdx.x * kThreads + tid; d < total;
       d += gridDim.x * kThreads) {
    const bool second = d >= n_a;
    const uint32_t i = (uint32_t)(second ? d - n_a : d);
    const uint32_t* k = kl + (second ? 4 : 0);
    o[d] = (int64_t)draw_position(cs, n, span, mult, k, i);
  }
}

}  // namespace

// The limits that ops/draw.py checks at load: {kMaxLanes, kMaxN}.
extern "C" void threefry_draw_limits(int* out) {
  out[0] = kMaxLanes;
  out[1] = kMaxN;
}

// valid: (lanes, n) uint8 row-major; out: (lanes, n_a + n_b) int64.
// Returns a cudaError_t (0 on success).
extern "C" int threefry_draw(const void* valid, void* out, int lanes, int n,
                             int n_a, int n_b, DrawKeys keys, void* stream) {
  if (lanes <= 0 || n_a + n_b <= 0) return (int)cudaSuccess;
  if (lanes > kMaxLanes || n <= 0 || n > kMaxN || n_a < 0 || n_b < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        threefry_draw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int total = n_a + n_b;
  int blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerLane) blocks = kMaxBlocksPerLane;
  threefry_draw_kernel<<<dim3(blocks, lanes), kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (int64_t*)out, n, n_a, n_b, keys);
  return (int)cudaGetLastError();
}

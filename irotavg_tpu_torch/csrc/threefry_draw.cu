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
// hash, the mapping and a binary search of cs.  Integer arithmetic only:
// the result equals ops/draw.py:draw_positions_plain bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxLanes = 64;

// The keys of a launch, passed by value (2 KB of kernel arguments): per
// lane k1 and k2 of the first shape, then of the second.  At file scope,
// so that the exported C function taking it keeps external linkage.
struct DrawKeys {
  uint32_t k[kMaxLanes * 8];
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 57344;          // 224 KB of int32 cs
constexpr int kMaxBlocksPerLane = 64;

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

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const uint8_t* __restrict__ valid,
                     int64_t* __restrict__ out, int n, int n_a, int n_b,
                     DrawKeys keys) {
  extern __shared__ int cs[];
  __shared__ int warp_sum[kWarps];
  const int lane = blockIdx.y;
  const uint8_t* v = valid + (int64_t)lane * n;
  const int tid = threadIdx.x;

  // inclusive scan of the flags: a contiguous chunk per thread, the
  // chunks' counts scanned across the block
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

  const uint32_t span = (uint32_t)max(cs[n - 1], 1);
  const uint32_t m = 65536u % span;
  const uint32_t mult = (m * m) % span;
  const int total = n_a + n_b;
  const uint32_t* kl = keys.k + lane * 8;
  int64_t* o = out + (int64_t)lane * total;
  for (int d = blockIdx.x * kThreads + tid; d < total;
       d += gridDim.x * kThreads) {
    const bool second = d >= n_a;
    const uint32_t i = (uint32_t)(second ? d - n_a : d);
    const uint32_t* k = kl + (second ? 4 : 0);
    const uint32_t hbits = threefry_bits(k[0], k[1], 0u, i);
    const uint32_t lbits = threefry_bits(k[2], k[3], 0u, i);
    const uint32_t rank = ((hbits % span) * mult + lbits % span) % span;
    // the first j with cs[j] > rank (cs is non-decreasing)
    int a = 0, b = n;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if ((uint32_t)cs[mid] <= rank) a = mid + 1; else b = mid;
    }
    o[d] = (int64_t)min(a, n - 1);
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

// RANSAC's inlier vote: every model of every lane against the lane's
// correspondences, in one launch.
//
// Replaces, in the port, what irotavg_tpu/geometry/essential.py:160
// sampson_distance with its compare and count (:660-662, :672-673) and
// :456 _transfer_inliers / :468 _transfer_support compute; the JAX
// package has no Pallas kernel here.  Its counterpart
// irotavg_tpu_torch/ops/ransac.py:ransac_vote_plain states the
// arithmetic, written out term by term (no matmul), which this kernel
// repeats with -fmad=false, so masks and counts equal it bit for bit:
//
//   a_i  = (M[i][0] x1 + M[i][1] y1) + M[i][2]            (M x1h)
//   sampson:  b_j = (M[0][j] x2 + M[1][j] y2) + M[2][j]    (M^T x2h)
//             d = ((x2 a0 + y2 a1) + a2)^2
//                 / max(((a0^2 + a1^2) + b0^2) + b1^2, 1e-18) < th2
//   transfer: z = |a2| > 1e-8 ? a2 : 1;  ok = |a2| > 1e-8 and
//             (a0 / z - x2)^2 + (a1 / z - y2)^2 < th2
//   inlier = valid and the test; count = the lane's inliers per model.
//
// Bound: about 35 f64 operations a point and model (Sampson), 1.05 us of
// the card's f64 rate at the engine's 520 models x 2000 points, against
// 1 MB of mask bytes written (0.3 us at 3.35 TB/s): operations, and at
// one lane the launch latency.  Design: a block per lane and 16 models,
// the models in shared memory; one thread per point, looping over the
// lane's points; counts by warp ballot and popc, summed over the block's
// warps in a fixed order (integers: exact in any order), so no atomics
// and no zeroing launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kModels = 16;

template <int kMode>
__device__ __forceinline__ bool inlier(const double* e, double x1, double y1,
                                       double x2, double y2, double th2) {
  const double a0 = (e[0] * x1 + e[1] * y1) + e[2];
  const double a1 = (e[3] * x1 + e[4] * y1) + e[5];
  const double a2 = (e[6] * x1 + e[7] * y1) + e[8];
  if (kMode == 0) {
    const double b0 = (e[0] * x2 + e[3] * y2) + e[6];
    const double b1 = (e[1] * x2 + e[4] * y2) + e[7];
    double num = (x2 * a0 + y2 * a1) + a2;
    num = num * num;
    const double den = ((a0 * a0 + a1 * a1) + b0 * b0) + b1 * b1;
    return num / (den < 1e-18 ? 1e-18 : den) < th2;
  }
  const bool zok = fabs(a2) > 1e-8;
  const double z = zok ? a2 : 1.0;
  const double e0 = a0 / z - x2;
  const double e1 = a1 / z - y2;
  return zok && (e0 * e0 + e1 * e1 < th2);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
ransac_vote_kernel(const double* __restrict__ models,
                   const double* __restrict__ p1,
                   const double* __restrict__ p2,
                   const uint8_t* __restrict__ valid,
                   const double* __restrict__ th2p,
                   uint8_t* __restrict__ mask, int* __restrict__ counts,
                   int C, int n) {
  __shared__ double sm[kModels * 9];
  __shared__ int warp_counts[kWarps][kModels];
  const int lane = blockIdx.y;
  const int c0 = blockIdx.x * kModels;
  const int mc = min(kModels, C - c0);
  const int tid = threadIdx.x;
  const double* src = models + ((int64_t)lane * C + c0) * 9;
  for (int e = tid; e < mc * 9; e += kThreads) sm[e] = src[e];
  __syncthreads();
  const double th2 = *th2p;
  const double* q1 = p1 + (int64_t)lane * n * 2;
  const double* q2 = p2 + (int64_t)lane * n * 2;
  const uint8_t* v = valid + (int64_t)lane * n;
  uint8_t* out = mask + ((int64_t)lane * C + c0) * n;
  int cnt[kModels];
#pragma unroll
  for (int m = 0; m < kModels; ++m) cnt[m] = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool in = i < n;
    double x1 = 0.0, y1 = 0.0, x2 = 0.0, y2 = 0.0;
    bool ok = false;
    if (in) {
      x1 = q1[2 * i];
      y1 = q1[2 * i + 1];
      x2 = q2[2 * i];
      y2 = q2[2 * i + 1];
      ok = v[i] != 0;
    }
#pragma unroll
    for (int m = 0; m < kModels; ++m) {
      if (m < mc) {                     // uniform over the block
        const bool inl =
            ok && inlier<kMode>(sm + 9 * m, x1, y1, x2, y2, th2);
        if (in) out[(int64_t)m * n + i] = inl;
        cnt[m] += __popc(__ballot_sync(0xffffffffu, inl));
      }
    }
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int m = 0; m < kModels; ++m) warp_counts[tid >> 5][m] = cnt[m];
  }
  __syncthreads();
  if (tid < mc) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_counts[w][tid];
    counts[(int64_t)lane * C + c0 + tid] = s;
  }
}

}  // namespace

// models: (lanes, C, 3, 3) f64; p1, p2: (lanes, n, 2) f64; valid: (lanes,
// n) uint8; th2: one f64 on the card; mask: (lanes, C, n) uint8 (bool);
// counts: (lanes, C) int32; mode 0 Sampson, 1 transfer.  Returns a
// cudaError_t (0 on success).
extern "C" int ransac_vote(const void* models, const void* p1, const void* p2,
                           const void* valid, const void* th2, void* mask,
                           void* counts, int lanes, int C, int n, int mode,
                           void* stream) {
  if (lanes <= 0 || C <= 0) return (int)cudaSuccess;
  if (lanes > 65535 || n < 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kModels - 1) / kModels, lanes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    ransac_vote_kernel<0><<<grid, kThreads, 0, s>>>(
        (const double*)models, (const double*)p1, (const double*)p2,
        (const uint8_t*)valid, (const double*)th2, (uint8_t*)mask,
        (int*)counts, C, n);
  else
    ransac_vote_kernel<1><<<grid, kThreads, 0, s>>>(
        (const double*)models, (const double*)p1, (const double*)p2,
        (const uint8_t*)valid, (const double*)th2, (uint8_t*)mask,
        (int*)counts, C, n);
  return (int)cudaGetLastError();
}

// Gated best-2 Hamming matcher for 256-bit ORB descriptors (Hopper, sm_90a).
//
// Replaces the TPU kernel irotavg_tpu/ops/match_pallas.py:_make_kernel
// (launched by _fused_best2_padded).  For each frame-1 descriptor (row) it
// returns the smallest and second-smallest Hamming distance over the
// frame-2 descriptors (columns) that pass the gate, and the first column
// that attains the smallest.  Gates (match_pallas.py:_tile_mask):
//   0 none, 1 node, 2 local, 3 epipolar, 4 epipolar_nonode.
//
// What bounds it on the card: integer ALU.  Each (row, column) pair costs
// 8 XOR + 8 POPC + the adds and the gate test, about N1*N2*B*16 integer
// operations; the bytes read are tiny (column tiles are staged once per
// block in shared memory and reused by all 128 rows).  The TPU kernel
// turned XOR+popcount into a ±1 bf16 matmul for its matrix unit; here the
// popcount is native and exact, so no ±1 expansion and no tensor cores.
//
// Design (simple and exact first; making it fast is later work):
//   * one thread per row, 128 rows per block, grid (ceil(N1/128), B);
//   * the block stages 128-column tiles of frame-2 words and column
//     features in shared memory; the ragged last tile is masked;
//   * each thread walks the columns in increasing order and keeps
//     (d1, d2, idx) in registers, so ties go to the first column and a tie
//     at the minimum gives d2 == d1, exactly like best2_reference;
//   * a row with no passing column gives 10000 / 10000 / -1.
//
// Numerics of the epipolar gate: the reference rounds every product and
// sum separately, (a*x + b*y) + c and a*a + b*b, num*num < th*den.  The
// intrinsics below forbid FMA contraction (the build also passes
// -fmad=false), so gate decisions agree bit for bit with the plain
// PyTorch version.
//
// Layout: desc1 (B, N1, 8) int32 words, desc2 (B, N2, 8) int32 words,
// rowf (B, N1, 8) f32, colf (B, N2, 8) f32 (untransposed), outputs d1, d2
// (B, N1) f32 and idx (B, N1) int32.  All contiguous.
//   rowf: 0 valid, 1 node, 2 gx/x1, 3 gy/y1, 4 octave, 5 th/radius
//   colf: 0 valid, 1 node, 2 x2, 3 y2, 4 octave, 5 a, 6 b, 7 c

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // rows per block (one thread each)
constexpr int kCols = 128;   // columns per shared-memory tile
constexpr int kWords = 8;    // 256 bits
constexpr int kFeat = 8;     // per-row / per-column feature width
constexpr float kBig = 10000.0f;

__device__ __forceinline__ bool gate_pass(int gate, const float* rf,
                                          const float* cf) {
  if (!(rf[0] > 0.0f && cf[0] > 0.0f)) return false;
  if (gate == 1 || gate == 3) {
    if (!(rf[1] == cf[1])) return false;
  }
  if (gate == 2) {
    const float r = rf[5];
    if (!(fabsf(__fsub_rn(cf[2], rf[2])) <= r)) return false;
    if (!(fabsf(__fsub_rn(cf[3], rf[3])) <= r)) return false;
    const float o1 = rf[4], o2 = cf[4];
    const float lo = fmaxf(__fsub_rn(o1, 2.0f), 0.0f);
    const float hi = fminf(__fadd_rn(o1, 2.0f), 7.0f);
    if (!(o2 >= lo && o2 <= hi)) return false;
  } else if (gate == 3 || gate == 4) {
    const float a = cf[5], b = cf[6], c = cf[7];
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(a, rf[2]),
                                          __fmul_rn(b, rf[3])), c);
    const float den = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
    if (!(__fmul_rn(num, num) < __fmul_rn(rf[5], den))) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kRows)
match_best2_kernel(const int32_t* __restrict__ desc1,
                   const int32_t* __restrict__ desc2,
                   const float* __restrict__ rowf,
                   const float* __restrict__ colf,
                   float* __restrict__ d1_out, float* __restrict__ d2_out,
                   int32_t* __restrict__ idx_out,
                   int n1, int n2, int gate) {
  __shared__ uint32_t s_words[kCols * kWords];
  __shared__ float s_feat[kCols * kFeat];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n1;

  const int32_t* d2b = desc2 + (size_t)b * n2 * kWords;
  const float* c2b = colf + (size_t)b * n2 * kFeat;

  uint32_t a[kWords];
  float rf[kFeat];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    a[w] = live ? (uint32_t)desc1[((size_t)b * n1 + row) * kWords + w] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kFeat; ++k) {
    rf[k] = live ? rowf[((size_t)b * n1 + row) * kFeat + k] : 0.0f;
  }

  float best = kBig, second = kBig;
  int best_idx = -1;

  for (int c0 = 0; c0 < n2; c0 += kCols) {
    const int nc = min(kCols, n2 - c0);
    __syncthreads();
    // cooperative, coalesced staging of the tile (words, then features)
    for (int e = threadIdx.x; e < kCols * kWords; e += kRows) {
      const int c = e / kWords;
      s_words[e] = c < nc ? (uint32_t)d2b[(size_t)c0 * kWords + e] : 0u;
      s_feat[e] = c < nc ? c2b[(size_t)c0 * kFeat + e] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < nc; ++c) {
      const float* cf = s_feat + c * kFeat;
      if (!gate_pass(gate, rf, cf)) continue;
      const uint32_t* bw = s_words + c * kWords;
      int d = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) d += __popc(a[w] ^ bw[w]);
      const float df = (float)d;
      if (df < best) {
        second = best;
        best = df;
        best_idx = c0 + c;
      } else if (df < second) {
        second = df;
      }
    }
  }
  if (live) {
    const size_t o = (size_t)b * n1 + row;
    d1_out[o] = best;
    d2_out[o] = second;
    idx_out[o] = best_idx;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int match_best2(const void* desc1, const void* desc2,
                           const void* rowf, const void* colf, void* d1,
                           void* d2, void* idx, int batch, int n1, int n2,
                           int gate, void* stream) {
  if (batch <= 0 || n1 <= 0) return (int)cudaSuccess;
  const dim3 grid((n1 + kRows - 1) / kRows, batch);
  match_best2_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(
      (const int32_t*)desc1, (const int32_t*)desc2, (const float*)rowf,
      (const float*)colf, (float*)d1, (float*)d2, (int32_t*)idx, n1, n2,
      gate);
  return (int)cudaGetLastError();
}

// Gated best-2 Hamming matcher for 256-bit ORB descriptors (Hopper, sm_90a).
//
// Replaces the TPU kernel irotavg_tpu/ops/match_pallas.py:_make_kernel
// (pallas_call at :132, launched by _fused_best2_padded).  For each frame-1
// descriptor (row) it returns the smallest and second-smallest Hamming
// distance over the frame-2 descriptors (columns) that pass the gate, and
// the first column that attains the smallest.  Gates (match_pallas.py:
// _tile_mask): 0 none, 1 node, 2 local, 3 epipolar, 4 epipolar_nonode.
//
// What bounds it on the card.  A launch compares B*N1*N2 pairs of 256
// bits.  As a ±1 int8 product that is 2*256*B*N1*N2 operations: 3.10 us at
// B=3, N1=N2=2000 on the int8 tensor cores (1,979 TOP/s); its 0.84 MB of
// inputs and outputs take 0.25 us at 3.35 TB/s.  The products are so cheap
// on the tensor cores that the per-pair epilogue (gate test and running
// top-2, about a dozen CUDA-core instructions a pair) sets the pace.
//
// Design:
//  * Distances on the tensor cores, exactly.  Each descriptor is expanded
//    to 256 ±1 int8 values (bit set -> +1, clear -> -1), and
//    mma.sync m16n8k32 s8*s8->s32 gives dot = 256 - 2h exactly, so
//    h = (256 - dot) >> 1.  Rows are expanded once per block straight into
//    the A fragments in registers; column tiles are expanded from their raw
//    words into shared memory when staged.  mma.sync rather than wgmma: the
//    products are a small part of the time, and mma.sync leaves each warp's
//    accumulators in registers for its own epilogue.
//  * Fill the card.  A block holds 64 rows (4 warps of 16) and one of
//    kSplit = 8 column chunks.  The 8 blocks of a row tile are one thread
//    block cluster; rank 0 merges their partial top-2 through distributed
//    shared memory, in the same launch.  B=1, N1=2000 gives 256 blocks.
//  * Asynchronous staging.  64-column tiles of raw words and column
//    features go through a two-slot cp.async ring: the next tile's copy is
//    in flight while this one is expanded, multiplied and reduced.
//  * Epilogue straight from the accumulator registers.  Per-column terms
//    (den = a*a + b*b) are computed once per column and per-row terms once
//    per row; the gate keeps the reference's rounding order (__fmul_rn /
//    __fadd_rn, and the build passes -fmad=false), so its decisions equal
//    the plain PyTorch version's bit for bit.  A passing pair's key is
//    (h << 22) | column, one multiply-add from a per-column constant:
//    ((256 << 21) + column) - (dot << 21).  Each lane keeps, for its two
//    rows, the two smallest keys k1 <= k2.
//  * Merge rule, where exactness lives: k1 = min(k1a, k1b), k2 =
//    min(max(k1a, k1b), min(k2a, k2b)), the top-2 of distinct keys.  In
//    (d1, idx, d2) terms: d1 = min(d1a, d1b); idx = the index of the
//    strictly smaller d1, else min(ia, ib); d2 = min(max(d1a, d1b),
//    min(d2a, d2b)).  The rule is associative and commutative, so every
//    split and lane order gives the first column that attains d1, and
//    d2 == d1 on a tie, as best2_reference does.  A row with no passing
//    column gives 10000 / 10000 / -1.
//
// Fragment map.  Register r (0..15) of lane quad t (lane & 3) holds the
// expanded nibble q = 16t + r of a descriptor (bits 4q..4q+3: word
// 2t + (r >> 3), shift 4 * (r & 7)), for rows (A) and columns (B) alike.
// MMA step kk (0..7) takes registers 2kk (k 0..15 of the step) and 2kk+1
// (k 16..31).  The k order inside the product is thus a permutation of the
// 256 bits applied to both operands, which leaves the dot product
// unchanged.  In shared memory an expanded column is 16 chunks of 16 bytes;
// logical chunk 4i + t (registers 4i..4i+3 of quad t) is stored at chunk
// (4i + t) ^ ((column & 1) << 2), so the 128-bit loads of a quarter warp
// (two columns, four quads) hit eight distinct bank groups.
//
// Layout: desc1 (B, N1, 8) int32 words, desc2 (B, N2, 8) or shared (N2, 8),
// rowf (B, N1, 8) f32, colf (B, N2, 8) or shared (N2, 8) f32
// (untransposed); the batch strides of desc2 and colf are arguments (0 when
// shared).  Outputs d1, d2 (B, N1) f32 and idx (B, N1) int32.  Inputs are
// contiguous in their last two axes and 16-byte aligned.
//   rowf: 0 valid, 1 node, 2 gx/x1, 3 gy/y1, 4 octave, 5 th/radius
//   colf: 0 valid, 1 node, 2 x2, 3 y2, 4 octave, 5 a, 6 b, 7 c

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;        // rows per block
constexpr int kSplit = 8;                 // column chunks per row tile
constexpr int kTile = 64;                 // columns per staged tile
constexpr int kWords = 8;                 // 256 bits as 32-bit words
constexpr int kFeat = 8;                  // per-row / per-column features
constexpr int kExpWords = 64;             // 256 int8 values as 32-bit words
constexpr int kIdxBits = 22;
constexpr int kMaxCols = (1 << kIdxBits) - 1;              // idx sentinel
constexpr int kNoDist = 511;                               // > 256
constexpr int kNoKey = (kNoDist << kIdxBits) | kMaxCols;   // 0x7FFFFFFF
constexpr float kBig = 10000.0f;

struct Stage {
  uint32_t words[kTile * kWords];   // raw column descriptors
  float feat[kTile * kFeat];        // raw column features
};

struct RowTerms {
  float node, x, y, th, lo, hi;
  bool valid;
};

// 4 descriptor bits -> 4 packed int8, bit j -> byte j: set -> +1 (0x01),
// clear -> -1 (0xFF).  The multiply copies v to bits 0, 7, 14 and 21 (no
// overlap, so no carries) and the mask keeps bit j of copy j.
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t v) {
  const uint32_t bytes = (v * 0x00204081u) & 0x01010101u;
  return 0xFFFFFFFFu - bytes * 0xFEu;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// merge the top-2 keys (k1b, k2b) into (k1, k2): the rule of the header
__device__ __forceinline__ void merge(int& k1, int& k2, int k1b, int k2b) {
  k2 = min(min(k2, k2b), max(k1, k1b));
  k1 = min(k1, k1b);
}

// A fragments and gate terms of one row (zeros and invalid past n1)
__device__ __forceinline__ void load_row(const int32_t* desc1,
                                         const float* rowf, size_t o,
                                         bool live, int t, uint32_t (&a)[16],
                                         RowTerms& rt) {
  uint2 w = make_uint2(0u, 0u);
  float4 f0 = make_float4(0.f, 0.f, 0.f, 0.f), f1 = f0;
  if (live) {
    w = *reinterpret_cast<const uint2*>(desc1 + o * kWords + 2 * t);
    f0 = *reinterpret_cast<const float4*>(rowf + o * kFeat);
    f1 = *reinterpret_cast<const float4*>(rowf + o * kFeat + 4);
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint32_t word = r < 8 ? w.x : w.y;
    a[r] = pm1_nibble((word >> (4 * (r & 7))) & 0xFu);
  }
  rt.valid = live && f0.x > 0.0f;
  rt.node = f0.y;
  rt.x = f0.z;
  rt.y = f0.w;
  rt.th = f1.y;
  rt.lo = fmaxf(__fsub_rn(f1.x, 2.0f), 0.0f);
  rt.hi = fminf(__fadd_rn(f1.x, 2.0f), 7.0f);
}

// the gate of one (row, column) pair; f0 = colf[0:4], f1 = colf[4:8]
template <int GATE>
__device__ __forceinline__ bool gate_pass(const RowTerms& r, float4 f0,
                                          float4 f1, float den) {
  bool ok = f0.x > 0.0f;
  if (GATE == 1 || GATE == 3) ok &= r.node == f0.y;
  if (GATE == 2) {
    ok &= fabsf(__fsub_rn(f0.z, r.x)) <= r.th;
    ok &= fabsf(__fsub_rn(f0.w, r.y)) <= r.th;
    ok &= f1.x >= r.lo;
    ok &= f1.x <= r.hi;
  }
  if (GATE == 3 || GATE == 4) {
    const float num = __fadd_rn(
        __fadd_rn(__fmul_rn(f1.y, r.x), __fmul_rn(f1.z, r.y)), f1.w);
    ok &= __fmul_rn(num, num) < __fmul_rn(r.th, den);
  }
  return ok;
}

// At least 4 blocks an SM: with no floor, ptxas gave the node gate's
// instantiation 80 registers and a 4-byte spill; with it, 90-108 and none.
template <int GATE>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 4)
match_best2_kernel(const int32_t* __restrict__ desc1,
                   const int32_t* __restrict__ desc2,
                   const float* __restrict__ rowf,
                   const float* __restrict__ colf,
                   float* __restrict__ d1_out, float* __restrict__ d2_out,
                   int32_t* __restrict__ idx_out, int n1, int n2,
                   long long desc2_bstride, long long colf_bstride) {
  __shared__ __align__(16) Stage s_stage[2];
  __shared__ __align__(16) uint32_t s_exp[kTile * kExpWords];
  __shared__ float s_den[kTile];
  __shared__ int s_k1[kRows];
  __shared__ int s_k2[kRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();      // this block's chunk
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int32_t* d2b = desc2 + b * desc2_bstride;
  const float* c2b = colf + b * colf_bstride;
  const int chunk = (n2 + kSplit - 1) / kSplit;
  const int c_begin = min(n2, rank * chunk);
  const int c_end = min(n2, c_begin + chunk);
  const int n_tiles = (c_end - c_begin + kTile - 1) / kTile;

  // one 16-byte piece of words and one of features per thread; columns
  // past the chunk are zero-filled (valid = 0, so no gate passes them)
  auto issue = [&](int j) {
    if (j < n_tiles) {
      Stage& st = s_stage[j & 1];
      const int col = threadIdx.x >> 1, half = threadIdx.x & 1;
      const int c = c_begin + j * kTile + col;
      const bool in = c < c_end;
      const size_t cs = in ? c : c_begin;
      cp_async16(&st.words[col * kWords + 4 * half],
                 d2b + cs * kWords + 4 * half, in ? 16 : 0);
      cp_async16(&st.feat[col * kFeat + 4 * half],
                 c2b + cs * kFeat + 4 * half, in ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  const int rl0 = warp * 16 + g, rl1 = rl0 + 8;   // this lane's rows
  uint32_t a0[16], a1[16];
  RowTerms rt0, rt1;
  load_row(desc1, rowf, (size_t)b * n1 + row0 + rl0, row0 + rl0 < n1, t, a0,
           rt0);
  load_row(desc1, rowf, (size_t)b * n1 + row0 + rl1, row0 + rl1 < n1, t, a1,
           rt1);

  int k1_0 = kNoKey, k2_0 = kNoKey, k1_1 = kNoKey, k2_1 = kNoKey;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<1>();
    __syncthreads();
    const Stage& st = s_stage[j & 1];
    for (int e = threadIdx.x; e < kTile * 16; e += kThreads) {
      const int col = e >> 4, p = e & 15;
      const int lp = p ^ ((col & 1) << 2);
      const int i = lp >> 2, tq = lp & 3;
      const uint32_t w =
          st.words[col * kWords + 2 * tq + (i >> 1)] >> (16 * (i & 1));
      uint4 v;
      v.x = pm1_nibble(w & 0xFu);
      v.y = pm1_nibble((w >> 4) & 0xFu);
      v.z = pm1_nibble((w >> 8) & 0xFu);
      v.w = pm1_nibble((w >> 12) & 0xFu);
      *reinterpret_cast<uint4*>(&s_exp[col * kExpWords + 4 * p]) = v;
    }
    if ((GATE == 3 || GATE == 4) && threadIdx.x < kTile) {
      const float a = st.feat[threadIdx.x * kFeat + 5];
      const float bb = st.feat[threadIdx.x * kFeat + 6];
      s_den[threadIdx.x] = __fadd_rn(__fmul_rn(a, a), __fmul_rn(bb, bb));
    }
    __syncthreads();

    const int c0 = c_begin + j * kTile;
#pragma unroll 2
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int col = nt * 8 + g;          // this lane's B column
      const uint4* src = reinterpret_cast<const uint4*>(
          &s_exp[col * kExpWords]);
      uint32_t bf[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = src[(4 * i + t) ^ ((col & 1) << 2)];
        bf[4 * i] = v.x;
        bf[4 * i + 1] = v.y;
        bf[4 * i + 2] = v.z;
        bf[4 * i + 3] = v.w;
      }
      // two independent accumulator chains (even and odd k steps)
      int acc0[4] = {0, 0, 0, 0}, acc1[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < 8; kk += 2) {
        mma_s8(acc0, a0[2 * kk], a1[2 * kk], a0[2 * kk + 1],
               a1[2 * kk + 1], bf[2 * kk], bf[2 * kk + 1]);
        mma_s8(acc1, a0[2 * kk + 2], a1[2 * kk + 2], a0[2 * kk + 3],
               a1[2 * kk + 3], bf[2 * kk + 2], bf[2 * kk + 3]);
      }
      // accumulator e: row rl0, column 2t + e; 2 + e: row rl1
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = nt * 8 + 2 * t + e;
        const float4 f0 = *reinterpret_cast<const float4*>(
            &st.feat[cl * kFeat]);
        const float4 f1 = *reinterpret_cast<const float4*>(
            &st.feat[cl * kFeat + 4]);
        const float den = (GATE == 3 || GATE == 4) ? s_den[cl] : 0.0f;
        // (h << 22) | column with h = (256 - dot) >> 1 (dot is even)
        const int base = (256 << (kIdxBits - 1)) + c0 + cl;
        constexpr int kStep = 1 << (kIdxBits - 1);
        const int key0 = gate_pass<GATE>(rt0, f0, f1, den)
            ? base - (acc0[e] + acc1[e]) * kStep : kNoKey;
        const int key1 = gate_pass<GATE>(rt1, f0, f1, den)
            ? base - (acc0[2 + e] + acc1[2 + e]) * kStep : kNoKey;
        merge(k1_0, k2_0, key0, kNoKey);
        merge(k1_1, k2_1, key1, kNoKey);
      }
    }
    __syncthreads();                 // slot j & 1 and s_exp are free
    issue(j + 2);
  }

  // the four lanes of a quad share their rows
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const int a1 = __shfl_xor_sync(0xFFFFFFFFu, k1_0, m);
    const int a2 = __shfl_xor_sync(0xFFFFFFFFu, k2_0, m);
    const int b1 = __shfl_xor_sync(0xFFFFFFFFu, k1_1, m);
    const int b2 = __shfl_xor_sync(0xFFFFFFFFu, k2_1, m);
    merge(k1_0, k2_0, a1, a2);
    merge(k1_1, k2_1, b1, b2);
  }
  if (t == 0) {
    s_k1[rl0] = rt0.valid ? k1_0 : kNoKey;
    s_k2[rl0] = rt0.valid ? k2_0 : kNoKey;
    s_k1[rl1] = rt1.valid ? k1_1 : kNoKey;
    s_k2[rl1] = rt1.valid ? k2_1 : kNoKey;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < kRows) {
    int k1 = kNoKey, k2 = kNoKey;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      const int* r1 = cluster.map_shared_rank(s_k1, s);
      const int* r2 = cluster.map_shared_rank(s_k2, s);
      merge(k1, k2, r1[threadIdx.x], r2[threadIdx.x]);
    }
    const int row = row0 + threadIdx.x;
    if (row < n1) {
      const size_t o = (size_t)b * n1 + row;
      const int d1 = k1 >> kIdxBits, d2 = k2 >> kIdxBits;
      d1_out[o] = d1 >= kNoDist ? kBig : (float)d1;
      d2_out[o] = d2 >= kNoDist ? kBig : (float)d2;
      idx_out[o] = d1 >= kNoDist ? -1 : (k1 & kMaxCols);
    }
  }
  cluster.sync();                    // keep every block's partials alive
}

template <int GATE>
int launch(const void* desc1, const void* desc2, const void* rowf,
           const void* colf, void* d1, void* d2, void* idx, int batch,
           int n1, int n2, long long desc2_bstride, long long colf_bstride,
           cudaStream_t stream) {
  const dim3 grid(kSplit, (n1 + kRows - 1) / kRows, batch);
  match_best2_kernel<GATE><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)desc1, (const int32_t*)desc2, (const float*)rowf,
      (const float*)colf, (float*)d1, (float*)d2, (int32_t*)idx, n1, n2,
      desc2_bstride, colf_bstride);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); never synchronises.  Strides are in
// elements; 0 means the column frame is shared by the batch.
extern "C" int match_best2(const void* desc1, const void* desc2,
                           const void* rowf, const void* colf, void* d1,
                           void* d2, void* idx, int batch, int n1, int n2,
                           int gate, long long desc2_bstride,
                           long long colf_bstride, void* stream) {
  if (batch <= 0 || n1 <= 0) return (int)cudaSuccess;
  if (n2 < 0 || n2 > kMaxCols || batch > 65535 ||
      (n1 + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (gate) {
    case 0: return launch<0>(desc1, desc2, rowf, colf, d1, d2, idx, batch,
                             n1, n2, desc2_bstride, colf_bstride, s);
    case 1: return launch<1>(desc1, desc2, rowf, colf, d1, d2, idx, batch,
                             n1, n2, desc2_bstride, colf_bstride, s);
    case 2: return launch<2>(desc1, desc2, rowf, colf, d1, d2, idx, batch,
                             n1, n2, desc2_bstride, colf_bstride, s);
    case 3: return launch<3>(desc1, desc2, rowf, colf, d1, d2, idx, batch,
                             n1, n2, desc2_bstride, colf_bstride, s);
    case 4: return launch<4>(desc1, desc2, rowf, colf, d1, d2, idx, batch,
                             n1, n2, desc2_bstride, colf_bstride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The kernel's geometry, for the wrapper to check its own copy against:
// rows per block, column chunks per row tile, columns per staged tile,
// largest N2.
extern "C" void match_best2_geometry(int* out) {
  out[0] = kRows;
  out[1] = kSplit;
  out[2] = kTile;
  out[3] = kMaxCols;
}

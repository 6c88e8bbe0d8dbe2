// The solver's two fused Laplacian kernels, in a fixed order of additions.
//
// laplacian_matvec: the CG matvec y = free ⊙ Aᵀ(c ⊙ A(free ⊙ x)) for
// x (nb·n, k) and c (nb·m, 1|k), in one launch for every four columns.
// For each row r the plan
// (ops/laplacian.py:matvec_plan) lists its terms in the order of the
// unfused composition (the +e terms in edge order, then the −e terms):
//
//   d = x'[j] − x'[i]   (j = r on the +e side, i = r on the −e side;
//                        x' is 0 at a fixed node)
//   e = d · c[edge]
//   y[r] = 0.0 + (±e) + (±e) + ...
//
// each rounded as the composition rounds it (__dsub_rn, __dmul_rn,
// __dadd_rn and the f32 intrinsics, built with -fmad=false), so the
// result is the composition's and the plain version's bit for bit.
// Masked edges and fixed rows have no records: a sum that starts at +0.0
// is never −0.0, so the ±0.0 those terms would add changes no bit, and a
// NaN in a masked slot is never read.
//
// laplacian_assemble: the dense A' diag(coef) A with 1 (fixed) or
// ridge (free) added to the diagonal, out (nb·n, n), in one launch.  Row
// r's records (ops/laplacian.py:dense_plan) come in the order (i, i),
// (j, j), (i, j), (j, i), each block in edge order, so each entry adds
// its ±coef terms in the order of the unfused segment sum, from 0.0, and
// then the diagonal term (+0.0 off the diagonal), as L + diag_embed(...).
//
// Counterpart of the reference's XLA programs for incidence_matvec /
// incidence_rmatvec (the gathers and .at[].add of
// irotavg_tpu/solver/graph.py:119-134) and laplacian_dense (:167-186),
// which XLA fuses; there is no Pallas kernel.  They replace the port's
// eager composition: about a dozen launches per matvec with (m, k) and
// (2m, k) intermediates in device memory, and, per dense assembly, some
// 25 launches, a sort and a segment sum over nb·n·n rows.
//
// Bound: bytes.  The matvec reads x, c, 8 bytes of record per term and 4
// of offset per row, and writes y; its flops are 3 per 16+ bytes.
// Design: one thread owns a row and keeps up to four columns in registers
// (the wrapper launches once per group of four columns of a wider x), so
// a record is read once for all columns and the intermediates never reach
// device memory; x (1.2 MB for 50k nodes) stays in L2 for the gathers,
// and the loads of four records go out before their adds.  A small
// window costs one launch, which is its time (a batch of windows is one
// graph of nb·n rows).
// The assembly writes nb·n·n outputs, nearly all zero: one warp owns a
// row, zeroes it in shared memory, its lane 0 adds the row's few records
// there in order, and the warp writes the row out coalesced with its
// diagonal term.  A row longer than shared memory holds goes in chunks of
// columns, each chunk walking the row's records again.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 128;
constexpr int kAssembleMaxWarps = 8;
constexpr int kMaxSmem = 232448;  // an H100 block's shared memory

template <typename T>
struct Rn;
template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
};
template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
};

// Records loaded ahead of their adds in one step of a row's walk: the
// loads of U terms are independent and go out together; the adds stay in
// record order.
constexpr int kUnroll = 4;

// Adds the terms of records [p, p + U) to s, in order.  x has rows of ld
// elements (K of them this launch's columns); c has rows of ldc (CB: one
// coefficient for every column).
template <typename T, int K, bool CB, int U>
__device__ __forceinline__ void matvec_terms(const T* x, const T* c,
                                             const int2* rec, int p,
                                             const T* xr, int ld, int ldc,
                                             T* s) {
  bool plus[U];
  T xo[U][K], cv[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int2 t = rec[p + u];
    plus[u] = t.x >= 0;
    const int64_t edge = plus[u] ? t.x : ~t.x;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      xo[u][q] = t.y < 0 ? T(0) : x[(int64_t)t.y * ld + q];
      cv[u][q] = c[CB ? edge : edge * ldc + q];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const T d = plus[u] ? Rn<T>::sub(xr[q], xo[u][q])
                          : Rn<T>::sub(xo[u][q], xr[q]);
      const T e = Rn<T>::mul(d, cv[u][q]);
      s[q] = Rn<T>::add(s[q], plus[u] ? e : -e);
    }
  }
}

// The matvec: one thread a row, its K columns in registers, x and c read
// through L2.
template <typename T, int K, bool CB>
__global__ void __launch_bounds__(kRowThreads)
laplacian_matvec_rows(const T* __restrict__ x, const T* __restrict__ c,
                      const int2* __restrict__ rec,
                      const int* __restrict__ offsets, T* __restrict__ y,
                      int rows, int ld, int ldc) {
  const int r = blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= rows) return;
  const int beg = offsets[r], end = offsets[r + 1];
  T s[K], xr[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    s[q] = T(0);
    xr[q] = T(0);
  }
  if (beg < end) {
#pragma unroll
    for (int q = 0; q < K; ++q) xr[q] = x[(int64_t)r * ld + q];
  }
  int p = beg;
  for (; p + kUnroll <= end; p += kUnroll)
    matvec_terms<T, K, CB, kUnroll>(x, c, rec, p, xr, ld, ldc, s);
  for (; p < end; ++p)
    matvec_terms<T, K, CB, 1>(x, c, rec, p, xr, ld, ldc, s);
#pragma unroll
  for (int q = 0; q < K; ++q) y[(int64_t)r * ld + q] = s[q];
}

template <typename T, int K, bool CB>
int launch_matvec(const void* x, const void* c, const void* rec,
                  const void* offsets, void* y, int rows, int ld, int ldc,
                  cudaStream_t stream) {
  const long long blocks = ((long long)rows + kRowThreads - 1) / kRowThreads;
  laplacian_matvec_rows<T, K, CB><<<(unsigned)blocks, kRowThreads, 0,
                                    stream>>>(
      (const T*)x, (const T*)c, (const int2*)rec, (const int*)offsets,
      (T*)y, rows, ld, ldc);
  return (int)cudaGetLastError();
}

template <typename T, bool CB>
int matvec_k(const void* x, const void* c, const void* rec,
             const void* offsets, void* y, int rows, int ld, int ldc, int k,
             cudaStream_t s) {
  switch (k) {
    case 1: return launch_matvec<T, 1, CB>(x, c, rec, offsets, y, rows, ld,
                                           ldc, s);
    case 2: return launch_matvec<T, 2, CB>(x, c, rec, offsets, y, rows, ld,
                                           ldc, s);
    case 3: return launch_matvec<T, 3, CB>(x, c, rec, offsets, y, rows, ld,
                                           ldc, s);
    case 4: return launch_matvec<T, 4, CB>(x, c, rec, offsets, y, rows, ld,
                                           ldc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The assembly: one warp a row, the row accumulated in shared memory in
// chunks of `chunk` columns.
template <typename T>
__global__ void laplacian_assemble_kernel(const T* __restrict__ coef,
                                          const int2* __restrict__ rec,
                                          const int* __restrict__ offsets,
                                          const unsigned char* __restrict__
                                              free_rows,
                                          T* __restrict__ out, int rows, int n,
                                          int chunk, double ridge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* srow = (T*)smem + (size_t)warp * chunk;
  const T one = T(1), rdg = T(ridge);
  for (int r = blockIdx.x * warps + warp; r < rows;
       r += gridDim.x * warps) {
    const int rl = r % n;
    const T dg = free_rows[r] ? rdg : one;
    T* o = out + (int64_t)r * n;
    for (int c0 = 0; c0 < n; c0 += chunk) {
      const int w = n - c0 < chunk ? n - c0 : chunk;
      for (int s = lane; s < w; s += 32) srow[s] = T(0);
      __syncwarp();
      if (lane == 0) {
        const int end = offsets[r + 1];
        for (int p = offsets[r]; p < end; ++p) {
          const int2 t = rec[p];
          const unsigned col = (unsigned)(t.x - c0);
          if (col >= (unsigned)w) continue;
          const T v = coef[t.y >= 0 ? t.y : ~t.y];
          srow[col] = Rn<T>::add(srow[col], t.y >= 0 ? v : -v);
        }
      }
      __syncwarp();
      for (int s = lane; s < w; s += 32)
        o[c0 + s] = Rn<T>::add(srow[s], c0 + s == rl ? dg : T(0));
      __syncwarp();
    }
  }
}

template <typename T>
int launch_assemble(const void* coef, const void* rec, const void* offsets,
                    const void* free_rows, void* out, int rows, int n,
                    double ridge, cudaStream_t stream) {
  const size_t row_bytes = (size_t)n * sizeof(T);
  int warps = (int)(kMaxSmem / row_bytes);
  warps = warps < 1 ? 1 : (warps > kAssembleMaxWarps ? kAssembleMaxWarps
                                                     : warps);
  const size_t cap = kMaxSmem / ((size_t)warps * sizeof(T));
  const int chunk = (size_t)n < cap ? n : (int)cap;
  const size_t bytes = (size_t)warps * chunk * sizeof(T);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplacian_assemble_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = ((long long)rows + warps - 1) / warps;
  laplacian_assemble_kernel<T><<<(unsigned)blocks, warps * 32, bytes,
                                 stream>>>(
      (const T*)coef, (const int2*)rec, (const int*)offsets,
      (const unsigned char*)free_rows, (T*)out, rows, n, chunk, ridge);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: nb·n; ld: the row stride of x and y (k of whose columns, at most
// four, this launch takes); c_stride: 0 for one coefficient for every
// column, else the row stride of c; dtype: 0 = float64, 1 = float32.
// Returns a cudaError_t (0 on success).
extern "C" int laplacian_matvec(const void* x, const void* c,
                                const void* rec, const void* offsets,
                                void* y, int rows, int ld, int k,
                                int c_stride, int dtype, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const bool cb = c_stride == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return cb ? matvec_k<double, true>(x, c, rec, offsets, y, rows, ld,
                                         c_stride, k, s)
                : matvec_k<double, false>(x, c, rec, offsets, y, rows, ld,
                                          c_stride, k, s);
    case 1:
      return cb ? matvec_k<float, true>(x, c, rec, offsets, y, rows, ld,
                                        c_stride, k, s)
                : matvec_k<float, false>(x, c, rec, offsets, y, rows, ld,
                                         c_stride, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int laplacian_assemble(const void* coef, const void* rec,
                                  const void* offsets, const void* free_rows,
                                  void* out, int rows, int n, double ridge,
                                  int dtype, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_assemble<double>(coef, rec, offsets, free_rows, out,
                                           rows, n, ridge, s);
    case 1: return launch_assemble<float>(coef, rec, offsets, free_rows, out,
                                          rows, n, ridge, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

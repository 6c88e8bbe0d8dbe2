// Fixed-order segment sum: the solver's scatter-adds without atomics.
//
//   out[r, c] = sum over p in [offsets[r], offsets[r+1]) of v[perm[p], c]
//
// added in p order from 0.0, for v (N, k) row-major and out (R, k).
// perm is a stable argsort of the destination row ids and offsets their
// CSR row pointers (ops/segment.py:segment_plan), so each row's terms
// come in the order of their index in v: the order in which a sequential
// index_add_ on the CPU adds them.  The result is therefore the plain
// version's bit for bit, and the same on every run.
//
// Counterpart of the reference's XLA scatter-adds (.at[].add in
// irotavg_tpu/solver/graph.py: incidence_rmatvec, laplacian_diag,
// laplacian_dense); no Pallas kernel.  It replaces CUDA's atomic
// index_add_ / scatter_add_, whose order of additions changes from run
// to run.  Written for determinism, not speed: one thread per (r, c).
//
// Bound: bytes.  Each term reads an 8-byte perm entry and k values, each
// row two offsets, and each output is written once; the adds are a few
// per 16-24 bytes.  Neighbouring threads take neighbouring columns of a
// row, so the k values of one term are read together; the gather through
// perm is the uncoalesced part.
//
// Built with -fmad=false; the adds go through __dadd_rn / __fadd_rn so
// that nothing can reassociate them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ v, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ offsets, T* __restrict__ out,
                   int64_t rows, int k) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * k) return;
  const int64_t r = t / k;
  const int c = (int)(t - r * k);
  const int64_t end = offsets[r + 1];
  T s = T(0);
  for (int64_t p = offsets[r]; p < end; ++p)
    s = add_rn(s, v[perm[p] * k + c]);
  out[t] = s;
}

template <typename T>
int launch(const void* v, const void* perm, const void* offsets, void* out,
           long long rows, int k, void* stream) {
  if (rows <= 0 || k <= 0) return (int)cudaSuccess;
  const long long blocks = (rows * k + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)v, (const int64_t*)perm, (const int64_t*)offsets, (T*)out,
      rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float64, 1 = float32.  Returns a cudaError_t (0 on success).
extern "C" int segment_sum(const void* v, const void* perm,
                           const void* offsets, void* out, long long rows,
                           int k, int dtype, void* stream) {
  switch (dtype) {
    case 0: return launch<double>(v, perm, offsets, out, rows, k, stream);
    case 1: return launch<float>(v, perm, offsets, out, rows, k, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// RANSAC's minimal-sample hypotheses of every lane in one launch: the
// draws, the 8-point essential candidates (projected onto singular values
// (1, 1, 0)) and the 4-point homographies.
//
// Replaces, in the port, what irotavg_tpu/geometry/essential.py:620-641
// (the draws), :309 _eight_point_samples with :543 _project_essential and
// :353 _homography_samples compute; the JAX package has no Pallas kernel
// here (the repo's one Pallas kernel is the matcher's).  Its counterpart
// irotavg_tpu_torch/ops/ransac.py:ransac_hypotheses_plain states the
// arithmetic; this kernel repeats it operation for operation:
//
//   positions  JAX's threefry draws (csrc/threefry.cuh), or given;
//   Hartley    centroid and mean squared radius of the 8 (4) points,
//              summed left to right; s = sqrt(2 / max(var, 1e-12));
//   design     8x9: rows x2h (x) x1h, or the DLT rows ra of the 4
//              points then rb;
//   null       Householder QR with column pivoting of the design's
//              transpose (9x8): per step the remaining column of largest
//              norm (the first on ties), stop when its squared norm is
//              <= kRankTol2 of the first pivot's; NULL_PICK is taken
//              through Q^T, its first `rank` entries zeroed, back
//              through Q, and normalised;
//   undone     E = T2^T En T1 or H = T2^-1 Hn T1, written out, over its
//              Frobenius norm;
//   project    E only: one-sided Jacobi on its 3 columns (pairs (0,1),
//              (0,2), (1,2), at most kMaxSweeps3 sweeps, none after a
//              sweep that rotated nothing), then the two longest
//              columns over their norms times the matching columns of W.
//
// Every sum runs left to right; only IEEE + - * / sqrt (built with
// -fmad=false), so the result equals the plain version bit for bit.
//
// Bound: about 1.8e3 f64 operations of QR and 0.3e3 more per hypothesis
// (0.08 us of the card's f64 rate for the engine's 704 hypotheses), and
// some 100 kB of points and models: at one lane the launch is bound by
// its latency, the sequential chain of one hypothesis (eight pivoted
// Householder steps, the Jacobi sweeps).  Design: one thread per
// hypothesis, its 9x8 matrix in local memory (cached in L1); every block
// of a lane scans the lane's flags into shared memory itself for the
// draws' binary search.  A warp per
// hypothesis would shorten the chain, at the price of a fixed reduction
// order across lanes; it is left for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rank2.cuh"
#include "threefry.cuh"

constexpr int kMaxLanes = kDrawMaxLanes;

namespace {

constexpr int kThreads = 64;
constexpr int kMaxN = 57344;          // 224 KB of int32 cs
constexpr double kRankTol2 = 1e-20;
__constant__ double kNullPick[9] = {1.0, 2.0, 3.0, 4.0, 5.0,
                                    6.0, 7.0, 8.0, 9.0};

struct Hartley {
  double cx, cy, s;
};

// Hartley normalisation of k points in place; returns (c, s).
__device__ __forceinline__ Hartley hartley(double* x, double* y, int k) {
  double sx = x[0], sy = y[0];
  for (int t = 1; t < k; ++t) {
    sx = sx + x[t];
    sy = sy + y[t];
  }
  const double cx = sx / (double)k, cy = sy / (double)k;
  double var = 0.0;
  for (int t = 0; t < k; ++t) {
    const double dx = x[t] - cx, dy = y[t] - cy;
    x[t] = dx;
    y[t] = dy;
    const double r = dx * dx + dy * dy;
    var = t ? var + r : r;
  }
  var = var / (double)k;
  const double s = sqrt(2.0 / clamp_min(var, 1e-12));
  for (int t = 0; t < k; ++t) {
    x[t] = x[t] * s;
    y[t] = y[t] * s;
  }
  return {cx, cy, s};
}

// H_k y = y - (beta (v . y[k:])) v on rows k.. of y; v is column k of m
// from row k
__device__ __forceinline__ void reflect(double (*m)[8], const double* beta,
                                        int k, double* y) {
  double dot = m[k][k] * y[k];
  for (int i = k + 1; i < 9; ++i) dot = dot + m[i][k] * y[i];
  const double f = beta[k] * dot;
  for (int i = k; i < 9; ++i) y[i] = y[i] - f * m[i][k];
}

// The unit null direction e (9) of the 8x9 design whose transpose is m
// (9x8; overwritten by the reflectors).
__device__ __forceinline__ void null_direction(double (*m)[8], double* e) {
  double beta[8];
  double first = 0.0;
  int rank = 0;
  for (int k = 0; k < 8; ++k) {
    double best = 0.0;
    int piv = k;
    for (int j = k; j < 8; ++j) {
      double nrm = m[k][j] * m[k][j];
      for (int i = k + 1; i < 9; ++i) nrm = nrm + m[i][j] * m[i][j];
      if (j == k || nrm > best) {
        best = nrm;
        piv = j;
      }
    }
    if (k == 0) first = best;
    if (best <= kRankTol2 * first) break;
    if (piv != k) {
      for (int i = 0; i < 9; ++i) {
        const double t = m[i][k];
        m[i][k] = m[i][piv];
        m[i][piv] = t;
      }
    }
    const double sg = m[k][k] >= 0.0 ? 1.0 : -1.0;
    m[k][k] = m[k][k] + sg * sqrt(best);        // v, kept in column k
    double vn2 = m[k][k] * m[k][k];
    for (int i = k + 1; i < 9; ++i) vn2 = vn2 + m[i][k] * m[i][k];
    beta[k] = 2.0 / vn2;
    for (int j = k + 1; j < 8; ++j) {
      double dot = m[k][k] * m[k][j];
      for (int i = k + 1; i < 9; ++i) dot = dot + m[i][k] * m[i][j];
      const double f = beta[k] * dot;
      for (int i = k; i < 9; ++i) m[i][j] = m[i][j] - f * m[i][k];
    }
    rank = k + 1;
  }
  for (int i = 0; i < 9; ++i) e[i] = kNullPick[i];
  for (int k = 0; k < rank; ++k) reflect(m, beta, k, e);
  for (int i = 0; i < rank; ++i) e[i] = 0.0;
  for (int k = rank - 1; k >= 0; --k) reflect(m, beta, k, e);
  double nrm = e[0] * e[0];
  for (int i = 1; i < 9; ++i) nrm = nrm + e[i] * e[i];
  nrm = clamp_min(sqrt(nrm), 1e-300);
  for (int i = 0; i < 9; ++i) e[i] = e[i] / nrm;
}

// out = M T1 over its Frobenius norm, T1 = [[s,0,-s cx],[0,s,-s cy],
// [0,0,1]]
__device__ __forceinline__ void times_t1_unit(double (*M)[3], double cx,
                                              double cy, double s,
                                              double* out) {
  const double tx = -(s * cx), ty = -(s * cy);
  for (int i = 0; i < 3; ++i) {
    out[3 * i] = M[i][0] * s;
    out[3 * i + 1] = M[i][1] * s;
    out[3 * i + 2] = (M[i][0] * tx + M[i][1] * ty) + M[i][2];
  }
  double f = out[0] * out[0];
  for (int i = 1; i < 9; ++i) f = f + out[i] * out[i];
  const double nrm = clamp_min(sqrt(f), 1e-30);
  for (int i = 0; i < 9; ++i) out[i] = out[i] / nrm;
}

__global__ void __launch_bounds__(kThreads)
ransac_hyp_kernel(const double* __restrict__ p1,
                  const double* __restrict__ p2,
                  const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ pos_in,
                  double* __restrict__ E_out, double* __restrict__ H_out,
                  int n, int n_e, int n_h, DrawKeys keys) {
  extern __shared__ int cs[];
  const int lane = blockIdx.y;
  const int draws = 8 * n_e + 4 * n_h;
  if (pos_in == nullptr)
    scan_flags<kThreads>(valid + (int64_t)lane * n, n, cs);
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= n_e + n_h) return;
  const bool ess = h < n_e;
  const int k = ess ? 8 : 4;
  const int hh = ess ? h : h - n_e;
  const int first_draw = ess ? 8 * hh : 8 * n_e + 4 * hh;

  const double* q1 = p1 + (int64_t)lane * n * 2;
  const double* q2 = p2 + (int64_t)lane * n * 2;
  // one array for the four coordinates: declared as four local arrays,
  // x1 and x2 came out equal under nvcc 12.9 at -O3 (a build with -G, or
  // this layout, computes what the source says).  Not reduced to a
  // reproducer, so a compiler fault is unconfirmed; phase 2 of
  // chip_smoke.py holds this kernel bit for bit to its plain version
  double pt[4][8];
  double* x1 = pt[0];
  double* y1 = pt[1];
  double* x2 = pt[2];
  double* y2 = pt[3];
  uint32_t span = 1, mult = 0;
  if (pos_in == nullptr) {
    span = (uint32_t)max(cs[n - 1], 1);
    mult = draw_mult(span);
  }
  const uint32_t* kl = keys.k + lane * 8 + (ess ? 0 : 4);
  for (int t = 0; t < k; ++t) {
    const int64_t pos =
        pos_in != nullptr
            ? pos_in[(int64_t)lane * draws + first_draw + t]
            : (int64_t)draw_position(cs, n, span, mult, kl,
                                     (uint32_t)(k * hh + t));
    x1[t] = q1[2 * pos];
    y1[t] = q1[2 * pos + 1];
    x2[t] = q2[2 * pos];
    y2[t] = q2[2 * pos + 1];
  }
  const Hartley n1 = hartley(x1, y1, k);
  const Hartley n2 = hartley(x2, y2, k);
  const double c2x = n2.cx, c2y = n2.cy, s2 = n2.s;

  double m[9][8];                      // the design's transpose
  for (int j = 0; j < 8; ++j) {
    double row[9];
    if (ess) {
      row[0] = x2[j] * x1[j];
      row[1] = x2[j] * y1[j];
      row[2] = x2[j];
      row[3] = y2[j] * x1[j];
      row[4] = y2[j] * y1[j];
      row[5] = y2[j];
      row[6] = x1[j];
      row[7] = y1[j];
      row[8] = 1.0;
    } else if (j < 4) {
      row[0] = x1[j];
      row[1] = y1[j];
      row[2] = 1.0;
      row[3] = 0.0;
      row[4] = 0.0;
      row[5] = 0.0;
      row[6] = -x2[j] * x1[j];
      row[7] = -x2[j] * y1[j];
      row[8] = -x2[j];
    } else {
      const int t = j - 4;
      row[0] = 0.0;
      row[1] = 0.0;
      row[2] = 0.0;
      row[3] = x1[t];
      row[4] = y1[t];
      row[5] = 1.0;
      row[6] = -y2[t] * x1[t];
      row[7] = -y2[t] * y1[t];
      row[8] = -y2[t];
    }
    for (int i = 0; i < 9; ++i) m[i][j] = row[i];
  }
  double e[9];
  null_direction(m, e);

  double M[3][3], out[9];
  if (ess) {
    for (int j = 0; j < 3; ++j) {
      M[0][j] = s2 * e[j];
      M[1][j] = s2 * e[3 + j];
      M[2][j] = (-(s2 * c2x) * e[j] + -(s2 * c2y) * e[3 + j]) + e[6 + j];
    }
  } else {
    const double si2 = 1.0 / s2;
    for (int j = 0; j < 3; ++j) {
      M[0][j] = si2 * e[j] + c2x * e[6 + j];
      M[1][j] = si2 * e[3 + j] + c2y * e[6 + j];
      M[2][j] = e[6 + j];
    }
  }
  times_t1_unit(M, n1.cx, n1.cy, n1.s, out);
  double* dst;
  if (ess) {
    project_rank2(out);
    dst = E_out + ((int64_t)lane * n_e + hh) * 9;
  } else {
    dst = H_out + ((int64_t)lane * n_h + hh) * 9;
  }
  for (int i = 0; i < 9; ++i) dst[i] = out[i];
}

}  // namespace

// The limits that ops/ransac.py checks at load: {kMaxLanes, kMaxN,
// kMaxSweeps3}.
extern "C" void ransac_hyp_limits(int* out) {
  out[0] = kMaxLanes;
  out[1] = kMaxN;
  out[2] = kMaxSweeps3;
}

// The constants that ops/ransac.py checks at load: {kRankTol2,
// kJacobiTol, kZeroTol2, NULL_PICK[0..8]}.
extern "C" void ransac_hyp_constants(double* out) {
  out[0] = kRankTol2;
  out[1] = kJacobiTol;
  out[2] = kZeroTol2;
  const double pick[9] = {1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0};
  for (int i = 0; i < 9; ++i) out[3 + i] = pick[i];
}

// p1, p2: (lanes, n, 2) f64; valid: (lanes, n) uint8; pos_in: null (draw
// from keys) or (lanes, 8 n_e + 4 n_h) int64 positions; E_out: (lanes,
// n_e, 3, 3) f64; H_out: (lanes, n_h, 3, 3) f64.  Returns a cudaError_t
// (0 on success).
extern "C" int ransac_hyp(const void* p1, const void* p2, const void* valid,
                          const void* pos_in, void* E_out, void* H_out,
                          int lanes, int n, int n_e, int n_h, DrawKeys keys,
                          void* stream) {
  if (lanes <= 0 || n_e + n_h <= 0) return (int)cudaSuccess;
  if (lanes > kMaxLanes || n <= 0 || n > kMaxN || n_e < 0 || n_h < 0 ||
      (n_e > 0 && E_out == nullptr) || (n_h > 0 && H_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = pos_in == nullptr ? (size_t)n * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ransac_hyp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_e + n_h + kThreads - 1) / kThreads;
  ransac_hyp_kernel<<<dim3(blocks, lanes), kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const double*)p1, (const double*)p2, (const uint8_t*)valid,
      (const int64_t*)pos_in, (double*)E_out, (double*)H_out, n, n_e, n_h,
      keys);
  return (int)cudaGetLastError();
}

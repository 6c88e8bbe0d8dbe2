// RANSAC's tail for every lane of a call, in five launches between the
// votes: the homography rescue's refit (tail_homography_refit), the keep
// choice and the 8 motions of the kept H written into the pool
// (tail_homography_pool), the cheirality re-rank of the pool's Sampson top
// K (tail_cheirality_rerank), the 8-point refit of the pick
// (tail_essential_refit), and the refit's check with cv::recoverPose
// (tail_finish).
//
// Replaces, in the port, the lane-by-lane loops of
// irotavg_tpu_torch/geometry/essential.py (the refit by torch.linalg.eigh,
// the decomposition and projections by torch.linalg.svd, the re-rank's
// sort and cheirality counts, recover_pose), after what
// irotavg_tpu/geometry/essential.py:409 _homography_ls, :472
// _decompose_homography, :543 _project_essential, :553
// _cheirality_counts, :256 _eight_point and :713 recover_pose compute;
// the JAX package has no Pallas kernel here.  The plain versions in
// irotavg_tpu_torch/ops/ransac.py (homography_refit_plain ...
// ransac_finish_plain) state the arithmetic; these kernels repeat it
// operation for operation, built with -fmad=false, so every output equals
// its plain version bit for bit:
//
//   sums over points  thread t of kThreads adds the points t, t +
//              kThreads, ... to 0, each warp halves its 32 partials
//              (shuffles), the block halves its 8 warps' (block_sum);
//   9x9 null   cyclic two-sided Jacobi of the symmetric Gram matrix in
//              the rounds of kRounds9 (4 disjoint pairs, all rotated from
//              the round's matrix: rows, then columns, the rotated entry
//              set to 0, the upper triangle mirrored), then NULL_PICK
//              projected onto the eigenvectors whose eigenvalues lie below
//              kGramRankTol of the largest, and the smallest's;
//   3x3 SVD    the one-sided Jacobi of csrc/rank2.cuh, the
//              columns ordered by norm, the first two signed so that
//              u . (1, 2, 3) >= 0, the third their cross product;
//   every other sum left to right; only IEEE + - * / sqrt.
//
// Bound: a few thousand f64 operations a lane for each Gram matrix and its
// Jacobi (about 8 sweeps of 36 rotations over 81 + 81 entries), ~40 a
// point and candidate for the cheirality counts (4 candidates x K models x
// N points: ~0.3 us of the card's f64 rate at K = 48, N = 2000), and the
// masks read once: microseconds at most, against a launch latency of a
// few.  Each kernel is bound by its sequential chain: the Jacobi sweeps of
// one warp, the counting loop over points of one block.  Design: a block
// of kThreads per lane (and per re-ranked model in the re-rank), its
// points strided over the threads, counts by warp reductions and shared
// atomics (integers: exact in any order), the Gram matrices reduced in the
// fixed order above, the 9x9 Jacobi by one warp with the matrix and its
// eigenvectors in shared memory (each entry of a round computed by one
// thread from the round's matrix, so any assignment of entries to threads
// gives the same bits), the 3x3 solves by one thread in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rank2.cuh"

#define ROUNDS9_INIT                                                  \
  {{{1, 8}, {2, 7}, {3, 6}, {4, 5}}, {{0, 1}, {3, 8}, {4, 7}, {5, 6}}, \
   {{0, 2}, {1, 3}, {5, 8}, {6, 7}}, {{0, 3}, {1, 5}, {2, 4}, {7, 8}}, \
   {{0, 4}, {1, 7}, {2, 6}, {3, 5}}, {{0, 5}, {2, 8}, {3, 7}, {4, 6}}, \
   {{0, 6}, {1, 2}, {4, 8}, {5, 7}}, {{0, 7}, {1, 4}, {2, 3}, {6, 8}}, \
   {{0, 8}, {1, 6}, {2, 5}, {3, 4}}}

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSweeps9 = 32;
constexpr double kJacobi9Tol = 1e-14;
constexpr double kGramRankTol = 1e-12;
constexpr double kDistThresh = 50.0;
constexpr double kDepthDetTol = 1e-12;
constexpr unsigned kFull = 0xffffffffu;

__constant__ int kRounds9[9][4][2] = ROUNDS9_INIT;
const int kRounds9Host[9][4][2] = ROUNDS9_INIT;

// -- sums over the block ----------------------------------------------------

// out[k] = the block's sum of v[k] (module doc's order); ws holds kWarps * K
// doubles.  Every thread of the block calls it; out is valid on return.
template <int K>
__device__ void block_sum(const double (&v)[K], double* ws, double* out) {
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = x + __shfl_down_sync(kFull, x, off);
    if (ln == 0) ws[warp * K + k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    double a[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a[w] = ws[w * K + k];
#pragma unroll
    for (int h = kWarps / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int w = 0; w < h; ++w) a[w] = a[w] + a[w + h];
    }
    out[k] = a[0];
  }
  __syncthreads();
}

// adds each of the block's 4 counts into cnt (shared, zeroed beforehand);
// every thread calls it, cnt is complete after the next __syncthreads
__device__ __forceinline__ void add_counts(const int (&c)[4], int* cnt) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = __reduce_add_sync(kFull, c[k]);
    if ((threadIdx.x & 31) == 0) atomicAdd(cnt + k, s);
  }
}

// -- 3x3 ------------------------------------------------------------------

__device__ __forceinline__ void cross3(const double* a, const double* b,
                                       double* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// (c0 x c1) . c2 of M's columns
__device__ double det3(const double (&M)[3][3]) {
  const double c0[3] = {M[0][0], M[1][0], M[2][0]};
  const double c1[3] = {M[0][1], M[1][1], M[2][1]};
  double cr[3];
  cross3(c0, c1, cr);
  return (cr[0] * M[0][2] + cr[1] * M[1][2]) + cr[2] * M[2][2];
}

__device__ void mm3(const double (&A)[3][3], const double (&B)[3][3],
                    double (&C)[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i][j] = (A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j];
}

// M (row-major, 9) ~ U diag(d) V^T: d descending, U and V proper rotations
// (column k of U is u_k)
__device__ void svd3(const double* M, double (&U)[3][3], double (&d)[3],
                     double (&V)[3][3]) {
  double b[3][3], w[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      b[i][j] = M[3 * i + j];
      w[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  jacobi3(b, w);
  double sig[3];
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrt((b[0][j] * b[0][j] + b[1][j] * b[1][j])
                  + b[2][j] * b[2][j]);
  int i0 = 0;
  if (sig[1] > sig[i0]) i0 = 1;
  if (sig[2] > sig[i0]) i0 = 2;
  const int ra = i0 == 0 ? 1 : 0, rb = i0 == 2 ? 1 : 2;
  const bool first = sig[ra] >= sig[rb];
  const int ord[3] = {i0, first ? ra : rb, first ? rb : ra};
  for (int k = 0; k < 3; ++k) d[k] = sig[ord[k]];
  double u[2][3], v[2][3];
  for (int k = 0; k < 2; ++k) {
    const int j = ord[k];
    const double dk = clamp_min(d[k], 1e-300);
    for (int r = 0; r < 3; ++r) {
      u[k][r] = b[r][j] / dk;
      v[k][r] = w[r][j];
    }
    if ((u[k][0] * 1.0 + u[k][1] * 2.0) + u[k][2] * 3.0 < 0.0) {
      for (int r = 0; r < 3; ++r) {
        u[k][r] = -u[k][r];
        v[k][r] = -v[k][r];
      }
    }
  }
  double u2[3], v2[3];
  cross3(u[0], u[1], u2);
  cross3(v[0], v[1], v2);
  for (int r = 0; r < 3; ++r) {
    U[r][0] = u[0][r];
    U[r][1] = u[1][r];
    U[r][2] = u2[r];
    V[r][0] = v[0][r];
    V[r][1] = v[1][r];
    V[r][2] = v2[r];
  }
}

// the four (R, t) of E: (Ra, u2), (Ra, -u2), (Rb, u2), (Rb, -u2); cand[c]
// holds R row-major then t
__device__ void pose_candidates(const double* E, double (*cand)[12]) {
  double U[3][3], d[3], V[3][3];
  svd3(E, U, d, V);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const double ra = (U[i][1] * V[j][0] + (-U[i][0]) * V[j][1])
                        + U[i][2] * V[j][2];
      const double rb = ((-U[i][1]) * V[j][0] + U[i][0] * V[j][1])
                        + U[i][2] * V[j][2];
      cand[0][3 * i + j] = ra;
      cand[1][3 * i + j] = ra;
      cand[2][3 * i + j] = rb;
      cand[3][3 * i + j] = rb;
    }
  }
  for (int i = 0; i < 3; ++i) {
    cand[0][9 + i] = U[i][2];
    cand[1][9 + i] = -U[i][2];
    cand[2][9 + i] = U[i][2];
    cand[3][9 + i] = -U[i][2];
  }
}

// both two-ray depths of a point positive and its distance under the
// cutoff, for the candidate c (R row-major, then t); bb = |x2h|^2, r1 =
// |x1h|
__device__ __forceinline__ bool ray_ok(const double* c, double x1, double y1,
                                       double x2, double y2, double bb,
                                       double r1) {
  const double a0 = (c[0] * x1 + c[1] * y1) + c[2];
  const double a1 = (c[3] * x1 + c[4] * y1) + c[5];
  const double a2 = (c[6] * x1 + c[7] * y1) + c[8];
  const double aa = (a0 * a0 + a1 * a1) + a2 * a2;
  const double ab = (a0 * x2 + a1 * y2) + a2;
  const double at = (a0 * c[9] + a1 * c[10]) + a2 * c[11];
  const double bt = (x2 * c[9] + y2 * c[10]) + c[11];
  const double det = aa * bb - ab * ab;
  if (!(det > (kDepthDetTol * aa) * bb)) return false;
  const double z1 = ((-at) * bb + ab * bt) / det;
  const double z2 = (aa * bt - ab * at) / det;
  return z1 > 0.0 && z2 > 0.0 && fabs(z1) * r1 < kDistThresh;
}

// each thread's counts over its points of the 4 candidates under mask m
__device__ __forceinline__ void count_candidates(
    const double (*cand)[12], const double* q1, const double* q2,
    const uint8_t* m, int n, int (&c)[4]) {
  for (int k = 0; k < 4; ++k) c[k] = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!m[i]) continue;
    const double x1 = q1[2 * i], y1 = q1[2 * i + 1];
    const double x2 = q2[2 * i], y2 = q2[2 * i + 1];
    const double bb = (x2 * x2 + y2 * y2) + 1.0;
    const double r1 = sqrt((x1 * x1 + y1 * y1) + 1.0);
    for (int k = 0; k < 4; ++k)
      c[k] += ray_ok(cand[k], x1, y1, x2, y2, bb, r1);
  }
}

// -- 9x9 Gram matrices, one warp --------------------------------------------

struct Gram9 {
  double A[2][81];      // the matrix, and the next round's
  double V[2][81];      // the eigenvectors (columns), and the next round's
  double c[9], s[9];    // each index's rotation in the round
  int role[9], part[9]; // 1: first of a rotated pair, 2: second; partner
  double M[81], P[81];  // 8-point conditioning, M G
  double T1[9], T2[9];
  double e[9];          // the null direction
};

// (i, j) of entry e of the upper triangle, row by row
__device__ __forceinline__ void upper9(int e, int& i, int& j) {
  i = 0;
  while (e >= 9 - i) {
    e -= 9 - i;
    ++i;
  }
  j = i + e;
}

__device__ __forceinline__ double row_rot(const double* A, const Gram9& g,
                                          int i, int k) {
  const int r = g.role[i];
  if (r == 1) return g.c[i] * A[9 * i + k] - g.s[i] * A[9 * g.part[i] + k];
  if (r == 2) return g.s[i] * A[9 * g.part[i] + k] + g.c[i] * A[9 * i + k];
  return A[9 * i + k];
}

// the null direction of the symmetric g.A[0] into g.e (module doc); the
// warp's lanes all call it
__device__ void gram_null_warp(Gram9& g) {
  const int ln = threadIdx.x & 31;
  int cur = 0;
  for (int e = ln; e < 81; e += 32) g.V[0][e] = e / 9 == e % 9 ? 1.0 : 0.0;
  __syncwarp();
  for (int sweep = 0; sweep < kMaxSweeps9; ++sweep) {
    bool moved = false;
    for (int r = 0; r < 9; ++r) {
      const double* A = g.A[cur];
      if (ln < 9) g.role[ln] = 0;
      __syncwarp();
      if (ln < 4) {
        const int p = kRounds9[r][ln][0], q = kRounds9[r][ln][1];
        const double app = A[9 * p + p], aqq = A[9 * q + q];
        const double apq = A[9 * p + q];
        if (fabs(apq) > kJacobi9Tol * sqrt(fabs(app) * fabs(aqq))) {
          const double tau = (aqq - app) / (2.0 * apq);
          const double sgn = tau >= 0.0 ? 1.0 : -1.0;
          const double t = sgn / (fabs(tau) + sqrt(1.0 + tau * tau));
          const double c = 1.0 / sqrt(1.0 + t * t);
          const double s = c * t;
          g.c[p] = c;
          g.c[q] = c;
          g.s[p] = s;
          g.s[q] = s;
          g.part[p] = q;
          g.part[q] = p;
          g.role[p] = 1;
          g.role[q] = 2;
        }
      }
      __syncwarp();
      bool any = false;
      for (int i = 0; i < 9; ++i) any = any || g.role[i] != 0;
      if (!any) continue;
      moved = true;
      double* A2 = g.A[cur ^ 1];
      const double* V = g.V[cur];
      double* V2 = g.V[cur ^ 1];
      for (int e = ln; e < 45; e += 32) {
        int i, k;
        upper9(e, i, k);
        double val;
        const int rk = g.role[k];
        if (g.role[i] == 1 && g.part[i] == k)
          val = 0.0;
        else if (rk == 1)
          val = g.c[k] * row_rot(A, g, i, k)
                - g.s[k] * row_rot(A, g, i, g.part[k]);
        else if (rk == 2)
          val = g.s[k] * row_rot(A, g, i, g.part[k])
                + g.c[k] * row_rot(A, g, i, k);
        else
          val = row_rot(A, g, i, k);
        A2[9 * i + k] = val;
        A2[9 * k + i] = val;
      }
      for (int e = ln; e < 81; e += 32) {
        const int i = e / 9, k = e % 9;
        const int rk = g.role[k];
        if (rk == 1)
          V2[e] = g.c[k] * V[9 * i + k] - g.s[k] * V[9 * i + g.part[k]];
        else if (rk == 2)
          V2[e] = g.s[k] * V[9 * i + g.part[k]] + g.c[k] * V[9 * i + k];
        else
          V2[e] = V[e];
      }
      __syncwarp();
      cur ^= 1;
    }
    if (!moved) break;
  }
  if (ln == 0) {
    const double* A = g.A[cur];
    const double* V = g.V[cur];
    double w[9];
    for (int i = 0; i < 9; ++i) w[i] = A[10 * i];
    double wmax = w[0];
    for (int i = 1; i < 9; ++i)
      if (w[i] > wmax) wmax = w[i];
    int jmin = 0;
    for (int i = 1; i < 9; ++i)
      if (w[i] < w[jmin]) jmin = i;
    const double thr = kGramRankTol * wmax;
    double e[9];
    for (int k = 0; k < 9; ++k) e[k] = 0.0;
    for (int i = 0; i < 9; ++i) {
      if (!(w[i] < thr || i == jmin)) continue;
      double d = V[i] * 1.0;
      for (int k = 1; k < 9; ++k) d = d + V[9 * k + i] * (double)(k + 1);
      for (int k = 0; k < 9; ++k) e[k] = e[k] + d * V[9 * k + i];
    }
    double nrm = e[0] * e[0];
    for (int k = 1; k < 9; ++k) nrm = nrm + e[k] * e[k];
    nrm = clamp_min(sqrt(nrm), 1e-300);
    for (int k = 0; k < 9; ++k) g.e[k] = e[k] / nrm;
  }
  __syncwarp();
}

// g.A[0] from the 45 upper-triangle entries
__device__ __forceinline__ void fill_sym9(Gram9& g, const double* u) {
  for (int e = threadIdx.x & 31; e < 45; e += 32) {
    int i, k;
    upper9(e, i, k);
    g.A[0][9 * i + k] = u[e];
    g.A[0][9 * k + i] = u[e];
  }
  __syncwarp();
}

// Hartley transform (row-major) from weighted moments
__device__ void hartley_T(double sw, double sx, double sy, double sxx,
                          double syy, double* T) {
  const double w = clamp_min(sw, 1e-12);
  const double cx = sx / w, cy = sy / w;
  const double var = clamp_min((sxx + syy) / w - cx * cx - cy * cy, 1e-12);
  const double s = sqrt(2.0 / var);
  T[0] = s;
  T[1] = 0.0;
  T[2] = -(s * cx);
  T[3] = 0.0;
  T[4] = s;
  T[5] = -(s * cy);
  T[6] = 0.0;
  T[7] = 0.0;
  T[8] = 1.0;
}

// unit E (row-major) of the 8-point Gram matrix in g.A[0], conditioned as
// M G M^T, M = T2 (x) T1; the warp's lanes all call it; E valid in lane 0
__device__ void solve_gram_warp(Gram9& g, double* E) {
  const int ln = threadIdx.x & 31;
  const double* G = g.A[0];
  if (ln == 0) {
    hartley_T(G[80], G[78], G[79], G[60], G[70], g.T1);
    hartley_T(G[80], G[26], G[53], G[20], G[50], g.T2);
  }
  __syncwarp();
  for (int e = ln; e < 81; e += 32) {
    const int i = e / 9, k = e % 9;
    g.M[e] = g.T2[3 * (i / 3) + k / 3] * g.T1[3 * (i % 3) + k % 3];
  }
  __syncwarp();
  for (int e = ln; e < 81; e += 32) {
    const int i = e / 9, j = e % 9;
    double s = g.M[9 * i] * G[j];
    for (int k = 1; k < 9; ++k) s = s + g.M[9 * i + k] * G[9 * k + j];
    g.P[e] = s;
  }
  __syncwarp();
  double* A = g.A[1];
  for (int e = ln; e < 45; e += 32) {
    int i, j;
    upper9(e, i, j);
    double s = g.P[9 * i] * g.M[9 * j];
    for (int k = 1; k < 9; ++k) s = s + g.P[9 * i + k] * g.M[9 * j + k];
    A[9 * i + j] = s;
    A[9 * j + i] = s;
  }
  __syncwarp();
  for (int e = ln; e < 81; e += 32) g.A[0][e] = A[e];
  __syncwarp();
  gram_null_warp(g);
  if (ln == 0) {
    double e[9];
    for (int k = 0; k < 9; ++k) {
      double s = g.M[k] * g.e[0];
      for (int i = 1; i < 9; ++i) s = s + g.M[9 * i + k] * g.e[i];
      e[k] = s;
    }
    double nrm = e[0] * e[0];
    for (int k = 1; k < 9; ++k) nrm = nrm + e[k] * e[k];
    nrm = clamp_min(sqrt(nrm), 1e-30);
    for (int k = 0; k < 9; ++k) E[k] = e[k] / nrm;
  }
}

// -- the kernels ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
homography_refit_kernel(const double* __restrict__ Hc,
                        const uint8_t* __restrict__ hmask,
                        const int* __restrict__ sup_h,
                        const double* __restrict__ p1,
                        const double* __restrict__ p2,
                        double* __restrict__ H_out,
                        int* __restrict__ hbest_out, int n_h, int n) {
  __shared__ double ws[kWarps * 45];
  __shared__ double sums[45];
  __shared__ Gram9 g;
  __shared__ int hb_s, cnt_s[4];
  const int lane = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    const int* sh = sup_h + (int64_t)lane * n_h;
    int j = 0, best = sh[0];
    for (int i = 1; i < n_h; ++i) {
      if (sh[i] > best) {
        best = sh[i];
        j = i;
      }
    }
    hb_s = j;
  }
  if (tid < 4) cnt_s[tid] = 0;
  __syncthreads();
  const uint8_t* w = hmask + ((int64_t)lane * n_h + hb_s) * n;
  const double* q1 = p1 + (int64_t)lane * n * 2;
  const double* q2 = p2 + (int64_t)lane * n * 2;
  double m[4] = {0.0, 0.0, 0.0, 0.0};
  int c[4] = {0, 0, 0, 0};
  for (int i = tid; i < n; i += kThreads) {
    if (!w[i]) continue;
    ++c[0];
    m[0] = m[0] + q1[2 * i];
    m[1] = m[1] + q1[2 * i + 1];
    m[2] = m[2] + q2[2 * i];
    m[3] = m[3] + q2[2 * i + 1];
  }
  add_counts(c, cnt_s);
  block_sum<4>(m, ws, sums);
  const double sw = clamp_min((double)cnt_s[0], 1e-12);
  const double c1x = sums[0] / sw, c1y = sums[1] / sw;
  const double c2x = sums[2] / sw, c2y = sums[3] / sw;
  double r[2] = {0.0, 0.0};
  for (int i = tid; i < n; i += kThreads) {
    if (!w[i]) continue;
    const double dx1 = q1[2 * i] - c1x, dy1 = q1[2 * i + 1] - c1y;
    const double dx2 = q2[2 * i] - c2x, dy2 = q2[2 * i + 1] - c2y;
    r[0] = r[0] + (dx1 * dx1 + dy1 * dy1);
    r[1] = r[1] + (dx2 * dx2 + dy2 * dy2);
  }
  block_sum<2>(r, ws, sums);
  const double s1 = sqrt(2.0 / clamp_min(sums[0] / sw, 1e-12));
  const double s2 = sqrt(2.0 / clamp_min(sums[1] / sw, 1e-12));
  double u[45];
  for (int e = 0; e < 45; ++e) u[e] = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    if (!w[i]) continue;
    const double x1 = (q1[2 * i] - c1x) * s1, y1 = (q1[2 * i + 1] - c1y) * s1;
    const double x2 = (q2[2 * i] - c2x) * s2, y2 = (q2[2 * i + 1] - c2y) * s2;
    const double ra[9] = {x1,  y1,  1.0, 0.0,      0.0,      0.0,
                          -x2 * x1, -x2 * y1, -x2};
    const double rb[9] = {0.0, 0.0, 0.0, x1,       y1,       1.0,
                          -y2 * x1, -y2 * y1, -y2};
    int e = 0;
#pragma unroll
    for (int a = 0; a < 9; ++a) {
#pragma unroll
      for (int b = a; b < 9; ++b, ++e)
        u[e] = u[e] + (ra[a] * ra[b] + rb[a] * rb[b]);
    }
  }
  block_sum<45>(u, ws, sums);
  if (tid < 32) {
    fill_sym9(g, sums);
    gram_null_warp(g);
  }
  __syncthreads();
  if (tid == 0) {
    const double* e = g.e;
    const double si2 = 1.0 / s2;
    double M[3][3], out[9];
    for (int j = 0; j < 3; ++j) {
      M[0][j] = si2 * e[j] + c2x * e[6 + j];
      M[1][j] = si2 * e[3 + j] + c2y * e[6 + j];
      M[2][j] = e[6 + j];
    }
    const double tx = -(s1 * c1x), ty = -(s1 * c1y);
    for (int i = 0; i < 3; ++i) {
      out[3 * i] = M[i][0] * s1;
      out[3 * i + 1] = M[i][1] * s1;
      out[3 * i + 2] = (M[i][0] * tx + M[i][1] * ty) + M[i][2];
    }
    double f = out[0] * out[0];
    for (int i = 1; i < 9; ++i) f = f + out[i] * out[i];
    const double nrm = clamp_min(sqrt(f), 1e-30);
    for (int i = 0; i < 9; ++i) H_out[(int64_t)lane * 9 + i] = out[i] / nrm;
    hbest_out[lane] = hb_s;
  }
}

__global__ void __launch_bounds__(kThreads)
homography_pool_kernel(const double* __restrict__ E_cand,
                       const double* __restrict__ E_seed,
                       const double* __restrict__ Hc,
                       const int* __restrict__ hbest,
                       const int* __restrict__ sup_h,
                       const double* __restrict__ H_ref,
                       const int* __restrict__ sup_ref,
                       double* __restrict__ pool, int n_e, int n_h) {
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int seeds = E_seed != nullptr ? 1 : 0;
  const int C = n_e + seeds + 8;
  double* dst = pool + (int64_t)lane * C * 9;
  const double* src = E_cand + (int64_t)lane * n_e * 9;
  for (int e = tid; e < n_e * 9; e += kThreads) dst[e] = src[e];
  if (seeds && tid < 9) dst[n_e * 9 + tid] = E_seed[(int64_t)lane * 9 + tid];
  if (tid >= 8) return;
  const int hb = hbest[lane];
  const bool keep = sup_ref[lane] >= sup_h[(int64_t)lane * n_h + hb];
  const double* hs = keep ? H_ref + (int64_t)lane * 9
                          : Hc + ((int64_t)lane * n_h + hb) * 9;
  double H[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) H[i][j] = hs[3 * i + j];
  const double sg = det3(H) < 0.0 ? -1.0 : 1.0;
  double Hf[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Hf[3 * i + j] = H[i][j] * sg;
  double U[3][3], d[3], V[3][3];
  svd3(Hf, U, d, V);
  const double s = det3(U) * det3(V);
  const double d1 = d[0], d2 = d[1], d3 = d[2];
  const double d2s = fabs(d2) > 1e-12 ? d2 : 1.0;
  const double denom = clamp_min(d1 * d1 - d3 * d3, 1e-24);
  const double x1a = sqrt(clamp_min((d1 * d1 - d2 * d2) / denom, 0.0));
  const double x3a = sqrt(clamp_min((d2 * d2 - d3 * d3) / denom, 0.0));
  const int m = tid;
  const double x1 = ((m >> 2) ? -1.0 : 1.0) * x1a;
  const double x3 = (((m >> 1) & 1) ? -1.0 : 1.0) * x3a;
  double Rx[3][3], tx[3];
  if ((m & 1) == 0) {                  // d' = +d2
    const double st = (d1 - d3) * x1 * x3 / d2s;
    const double ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s;
    const double R0[3][3] = {{ct, 0.0, -st}, {0.0, 1.0, 0.0}, {st, 0.0, ct}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Rx[i][j] = R0[i][j];
    tx[0] = (d1 - d3) * x1;
    tx[1] = 0.0;
    tx[2] = (-(d1 - d3)) * x3;
  } else {                             // d' = -d2
    const double sf = (d1 + d3) * x1 * x3 / d2s;
    const double cf = (d3 * x1 * x1 - d1 * x3 * x3) / d2s;
    const double R0[3][3] = {{cf, 0.0, sf}, {0.0, -1.0, 0.0}, {sf, 0.0, -cf}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Rx[i][j] = R0[i][j];
    tx[0] = (d1 + d3) * x1;
    tx[1] = 0.0;
    tx[2] = (d1 + d3) * x3;
  }
  double Vt[3][3], UR[3][3], R[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Vt[i][j] = V[j][i];
  mm3(U, Rx, UR);
  mm3(UR, Vt, R);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = s * R[i][j];
  double t[3];
  for (int i = 0; i < 3; ++i)
    t[i] = (U[i][0] * tx[0] + U[i][1] * tx[1]) + U[i][2] * tx[2];
  const double nrm =
      clamp_min(sqrt((t[0] * t[0] + t[1] * t[1]) + t[2] * t[2]), 1e-12);
  for (int i = 0; i < 3; ++i) t[i] = t[i] / nrm;
  const double S[3][3] = {
      {0.0, -t[2], t[1]}, {t[2], 0.0, -t[0]}, {-t[1], t[0], 0.0}};
  double Em[3][3], E[9];
  mm3(S, R, Em);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) E[3 * i + j] = Em[i][j];
  project_rank2(E);
  double* out = dst + (int64_t)(n_e + seeds + m) * 9;
  for (int i = 0; i < 9; ++i) out[i] = E[i];
}

__global__ void __launch_bounds__(kThreads)
cheirality_rerank_kernel(const double* __restrict__ models,
                         const uint8_t* __restrict__ inl,
                         const int* __restrict__ scores,
                         const double* __restrict__ p1,
                         const double* __restrict__ p2,
                         int* __restrict__ top, int* __restrict__ che, int C,
                         int n, int K) {
  __shared__ double cand[4][12];
  __shared__ int sel_s, cnt_s[4];
  const int slot = blockIdx.x, lane = blockIdx.y, tid = threadIdx.x;
  const int* sc = scores + (int64_t)lane * C;
  if (tid < 4) cnt_s[tid] = 0;
  // the model whose place in the stable descending order is `slot`: the
  // models above it, ties broken by the lower index
  for (int i = tid; i < C; i += kThreads) {
    const int si = sc[i];
    int rank = 0;
    for (int j = 0; j < C && rank <= slot; ++j) {
      const int sj = sc[j];
      rank += sj > si || (sj == si && j < i);
    }
    if (rank == slot) sel_s = i;
  }
  __syncthreads();
  const int sel = sel_s;
  if (tid == 0) pose_candidates(models + ((int64_t)lane * C + sel) * 9, cand);
  __syncthreads();
  int c[4];
  count_candidates(cand, p1 + (int64_t)lane * n * 2,
                   p2 + (int64_t)lane * n * 2,
                   inl + ((int64_t)lane * C + sel) * n, n, c);
  add_counts(c, cnt_s);
  __syncthreads();
  if (tid == 0) {
    int best = cnt_s[0];
    for (int k = 1; k < 4; ++k) best = cnt_s[k] > best ? cnt_s[k] : best;
    che[(int64_t)lane * K + slot] = best;
    top[(int64_t)lane * K + slot] = sel;
  }
}

__global__ void __launch_bounds__(kThreads)
essential_refit_kernel(const int* __restrict__ top,
                       const int* __restrict__ che,
                       const uint8_t* __restrict__ inl,
                       const double* __restrict__ p1,
                       const double* __restrict__ p2,
                       int* __restrict__ best_out,
                       int* __restrict__ che_max_out,
                       double* __restrict__ E_out, int C, int n, int K) {
  __shared__ double ws[kWarps * 45];
  __shared__ double sums[45];
  __shared__ Gram9 g;
  __shared__ int best_s, che_s;
  const int lane = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    const int* ch = che + (int64_t)lane * K;
    int bi = 0, cm = ch[0];
    for (int m = 1; m < K; ++m) {
      if (ch[m] > cm) {
        cm = ch[m];
        bi = m;
      }
    }
    best_s = top[(int64_t)lane * K + bi];
    che_s = cm;
  }
  __syncthreads();
  const uint8_t* w = inl + ((int64_t)lane * C + best_s) * n;
  const double* q1 = p1 + (int64_t)lane * n * 2;
  const double* q2 = p2 + (int64_t)lane * n * 2;
  double u[45];
  for (int e = 0; e < 45; ++e) u[e] = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    if (!w[i]) continue;
    const double x1 = q1[2 * i], y1 = q1[2 * i + 1];
    const double x2 = q2[2 * i], y2 = q2[2 * i + 1];
    const double a[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1,
                         y2,      x1,      y1, 1.0};
    int e = 0;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
#pragma unroll
      for (int k = r; k < 9; ++k, ++e) u[e] = u[e] + a[r] * a[k];
    }
  }
  block_sum<45>(u, ws, sums);
  __shared__ double E[9];
  if (tid < 32) {
    fill_sym9(g, sums);
    solve_gram_warp(g, E);
  }
  __syncthreads();
  if (tid == 0) {
    double Ep[9];
    for (int i = 0; i < 9; ++i) Ep[i] = E[i];
    project_rank2(Ep);
    for (int i = 0; i < 9; ++i) E_out[(int64_t)lane * 9 + i] = Ep[i];
    best_out[lane] = best_s;
    che_max_out[lane] = che_s;
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const double* __restrict__ E_ref,
              const uint8_t* __restrict__ inl_ref,
              const double* __restrict__ models,
              const uint8_t* __restrict__ inl, const int* __restrict__ best,
              const int* __restrict__ che_max, const double* __restrict__ p1,
              const double* __restrict__ p2, double* __restrict__ E_out,
              uint8_t* __restrict__ mask_out, double* __restrict__ R_out,
              double* __restrict__ t_out, long long* __restrict__ n_che,
              uint8_t* __restrict__ pose_mask, int C, int n, int round_f32) {
  __shared__ double cand[4][12];
  __shared__ int cnt_s[4], better_s, k_s;
  const int lane = blockIdx.x, tid = threadIdx.x;
  const double* q1 = p1 + (int64_t)lane * n * 2;
  const double* q2 = p2 + (int64_t)lane * n * 2;
  const double* er = E_ref + (int64_t)lane * 9;
  const uint8_t* mref = inl_ref + (int64_t)lane * n;
  int c[4];
  if (tid == 0) better_s = 1;
  if (models != nullptr) {
    if (tid == 0) pose_candidates(er, cand);
    if (tid < 4) cnt_s[tid] = 0;
    __syncthreads();
    count_candidates(cand, q1, q2, mref, n, c);
    add_counts(c, cnt_s);
    __syncthreads();
    if (tid == 0) {
      int che_ref = cnt_s[0];
      for (int k = 1; k < 4; ++k)
        che_ref = cnt_s[k] > che_ref ? cnt_s[k] : che_ref;
      better_s = che_ref >= che_max[lane];
    }
  }
  __syncthreads();
  const bool better = better_s != 0;
  const int b = models != nullptr ? best[lane] : 0;
  const uint8_t* msel = better ? mref : inl + ((int64_t)lane * C + b) * n;
  if (tid == 0) {
    const double* src = better ? er : models + ((int64_t)lane * C + b) * 9;
    double E[9];
    for (int i = 0; i < 9; ++i) {
      E[i] = round_f32 ? (double)__double2float_rn(src[i]) : src[i];
      E_out[(int64_t)lane * 9 + i] = E[i];
    }
    pose_candidates(E, cand);
  }
  if (tid < 4) cnt_s[tid] = 0;
  __syncthreads();
  for (int k = 0; k < 4; ++k) c[k] = 0;
  uint8_t* mo = mask_out + (int64_t)lane * n;
  for (int i = tid; i < n; i += kThreads) {
    const uint8_t mi = msel[i];
    mo[i] = mi;
    if (!mi) continue;
    const double x1 = q1[2 * i], y1 = q1[2 * i + 1];
    const double x2 = q2[2 * i], y2 = q2[2 * i + 1];
    const double bb = (x2 * x2 + y2 * y2) + 1.0;
    const double r1 = sqrt((x1 * x1 + y1 * y1) + 1.0);
    for (int k = 0; k < 4; ++k)
      c[k] += ray_ok(cand[k], x1, y1, x2, y2, bb, r1);
  }
  add_counts(c, cnt_s);
  __syncthreads();
  if (tid == 0) {
    int k = 0;
    for (int j = 1; j < 4; ++j)
      if (cnt_s[j] > cnt_s[k]) k = j;
    k_s = k;
    for (int i = 0; i < 9; ++i) R_out[(int64_t)lane * 9 + i] = cand[k][i];
    for (int i = 0; i < 3; ++i) t_out[(int64_t)lane * 3 + i] = cand[k][9 + i];
    n_che[lane] = cnt_s[k];
  }
  __syncthreads();
  const double* ck = cand[k_s];
  uint8_t* pm = pose_mask + (int64_t)lane * n;
  for (int i = tid; i < n; i += kThreads) {
    bool ok = false;
    if (msel[i]) {
      const double x1 = q1[2 * i], y1 = q1[2 * i + 1];
      const double x2 = q2[2 * i], y2 = q2[2 * i + 1];
      const double bb = (x2 * x2 + y2 * y2) + 1.0;
      const double r1 = sqrt((x1 * x1 + y1 * y1) + 1.0);
      ok = ray_ok(ck, x1, y1, x2, y2, bb, r1);
    }
    pm[i] = ok;
  }
}

inline bool bad_grid(int lanes, int n) { return lanes > 65535 || n < 0; }

}  // namespace

// {kThreads, kMaxSweeps9, kMaxSweeps3, 9, kRounds9 (9 x 4 x 2)}, which
// ops/ransac.py checks at load
extern "C" void ransac_tail_limits(int* out) {
  out[0] = kThreads;
  out[1] = kMaxSweeps9;
  out[2] = kMaxSweeps3;
  out[3] = 9;
  for (int r = 0; r < 9; ++r)
    for (int k = 0; k < 4; ++k)
      for (int x = 0; x < 2; ++x)
        out[4 + 8 * r + 2 * k + x] = kRounds9Host[r][k][x];
}

// {kJacobi9Tol, kGramRankTol, kDistThresh, kDepthDetTol, kJacobiTol,
// kZeroTol2, NULL_PICK[0..8]}, which ops/ransac.py checks at load
extern "C" void ransac_tail_constants(double* out) {
  const double v[6] = {kJacobi9Tol, kGramRankTol, kDistThresh,
                       kDepthDetTol, kJacobiTol,  kZeroTol2};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  for (int i = 0; i < 9; ++i) out[6 + i] = (double)(i + 1);
}

// Hc: (lanes, n_h, 3, 3) f64; hmask: (lanes, n_h, n) uint8; sup_h: (lanes,
// n_h) int32; p1, p2: (lanes, n, 2) f64; H: (lanes, 1, 3, 3) f64; hbest:
// (lanes,) int32.  Each entry point returns a cudaError_t (0 on success).
extern "C" int tail_homography_refit(const void* Hc, const void* hmask,
                                     const void* sup_h, const void* p1,
                                     const void* p2, void* H, void* hbest,
                                     int lanes, int n_h, int n,
                                     void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  if (bad_grid(lanes, n) || n_h <= 0) return (int)cudaErrorInvalidValue;
  homography_refit_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)Hc, (const uint8_t*)hmask, (const int*)sup_h,
      (const double*)p1, (const double*)p2, (double*)H, (int*)hbest, n_h, n);
  return (int)cudaGetLastError();
}

// E_cand: (lanes, n_e, 3, 3); E_seed: null or (lanes, 3, 3); Hc, hbest,
// sup_h as above; H_ref: (lanes, 1, 3, 3); sup_ref: (lanes, 1) int32;
// pool: (lanes, n_e + [1] + 8, 3, 3) f64
extern "C" int tail_homography_pool(const void* E_cand, const void* E_seed,
                                    const void* Hc, const void* hbest,
                                    const void* sup_h, const void* H_ref,
                                    const void* sup_ref, void* pool,
                                    int lanes, int n_e, int n_h,
                                    void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  if (bad_grid(lanes, 0) || n_e < 0 || n_h <= 0)
    return (int)cudaErrorInvalidValue;
  homography_pool_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)E_cand, (const double*)E_seed, (const double*)Hc,
      (const int*)hbest, (const int*)sup_h, (const double*)H_ref,
      (const int*)sup_ref, (double*)pool, n_e, n_h);
  return (int)cudaGetLastError();
}

// models: (lanes, C, 3, 3) f64; inl: (lanes, C, n) uint8; scores: (lanes,
// C) int32; top, che: (lanes, K) int32, K <= C
extern "C" int tail_cheirality_rerank(const void* models, const void* inl,
                                      const void* scores, const void* p1,
                                      const void* p2, void* top, void* che,
                                      int lanes, int C, int n, int K,
                                      void* stream) {
  if (lanes <= 0 || K <= 0) return (int)cudaSuccess;
  if (bad_grid(lanes, n) || K > C) return (int)cudaErrorInvalidValue;
  cheirality_rerank_kernel<<<dim3(K, lanes), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const double*)models, (const uint8_t*)inl, (const int*)scores,
      (const double*)p1, (const double*)p2, (int*)top, (int*)che, C, n, K);
  return (int)cudaGetLastError();
}

// top, che: (lanes, K) int32; inl: (lanes, C, n) uint8; best, che_max:
// (lanes,) int32; E: (lanes, 1, 3, 3) f64
extern "C" int tail_essential_refit(const void* top, const void* che,
                                    const void* inl, const void* p1,
                                    const void* p2, void* best,
                                    void* che_max, void* E, int lanes, int C,
                                    int n, int K, void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  if (bad_grid(lanes, n) || K <= 0 || K > C)
    return (int)cudaErrorInvalidValue;
  essential_refit_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)top, (const int*)che, (const uint8_t*)inl,
      (const double*)p1, (const double*)p2, (int*)best, (int*)che_max,
      (double*)E, C, n, K);
  return (int)cudaGetLastError();
}

// E_ref: (lanes, 1, 3, 3) f64; inl_ref: (lanes, 1, n) uint8; models, inl,
// best, che_max: all null (E_ref and inl_ref are taken) or as above; E:
// (lanes, 3, 3) f64; mask, pose_mask: (lanes, n) uint8; R: (lanes, 3, 3),
// t: (lanes, 3) f64; n_che: (lanes,) int64
extern "C" int tail_finish(const void* E_ref, const void* inl_ref,
                           const void* models, const void* inl,
                           const void* best, const void* che_max,
                           const void* p1, const void* p2, void* E,
                           void* mask, void* R, void* t, void* n_che,
                           void* pose_mask, int lanes, int C, int n,
                           int round_f32, void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  if (bad_grid(lanes, n) ||
      (models != nullptr && (inl == nullptr || best == nullptr ||
                             che_max == nullptr || C <= 0)))
    return (int)cudaErrorInvalidValue;
  finish_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)E_ref, (const uint8_t*)inl_ref, (const double*)models,
      (const uint8_t*)inl, (const int*)best, (const int*)che_max,
      (const double*)p1, (const double*)p2, (double*)E, (uint8_t*)mask,
      (double*)R, (double*)t, (long long*)n_che, (uint8_t*)pose_mask, C, n,
      round_f32);
  return (int)cudaGetLastError();
}

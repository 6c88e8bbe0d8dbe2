// The 3x3 pieces RANSAC's kernels share (csrc/ransac_hyp.cu,
// csrc/ransac_tail.cu): a one-sided (Hestenes) Jacobi on the 3 columns of
// a matrix and the projection of E onto singular values (1, 1, 0).  Their
// plain versions are irotavg_tpu_torch/ops/ransac.py's _jacobi3 and
// _project_rank2, which this code equals bit for bit (-fmad=false).
//
// Jacobi: column pairs (0, 1), (0, 2), (1, 2) in turn, a pair rotated
// unless |b_p . b_q| <= kJacobiTol sqrt(|b_p|^2 |b_q|^2) or the squared
// norm of one is at most kZeroTol2 of the other's, at most kMaxSweeps3
// sweeps and none after a sweep that rotated nothing.  Projection: with
// E W = [b_0 b_1 b_2] and k the shortest column, sum_{j != k} (b_j /
// |b_j|) w_j^T.

#pragma once

#include <math.h>

namespace {

constexpr int kMaxSweeps3 = 16;
constexpr double kJacobiTol = 1e-14;
constexpr double kZeroTol2 = 1e-26;

__device__ __forceinline__ double clamp_min(double x, double m) {
  return x < m ? m : x;
}

// the Jacobi on the columns of b, the rotations accumulated in w
__device__ __forceinline__ void jacobi3(double (&b)[3][3], double (&w)[3][3]) {
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < kMaxSweeps3; ++sweep) {
    bool moved = false;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = P[r], q = Q[r];
      const double al = (b[0][p] * b[0][p] + b[1][p] * b[1][p])
                        + b[2][p] * b[2][p];
      const double be = (b[0][q] * b[0][q] + b[1][q] * b[1][q])
                        + b[2][q] * b[2][q];
      const double ga = (b[0][p] * b[0][q] + b[1][p] * b[1][q])
                        + b[2][p] * b[2][q];
      const bool lt = al < be;
      const double lo = lt ? al : be, hi = lt ? be : al;
      if (!(fabs(ga) > kJacobiTol * sqrt(al * be) && lo > kZeroTol2 * hi))
        continue;
      const double zeta = (be - al) / (2.0 * ga);
      const double sgn = zeta >= 0.0 ? 1.0 : -1.0;
      const double t = sgn / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t);
      const double s = c * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double xp = b[i][p], xq = b[i][q];
        b[i][p] = c * xp - s * xq;
        b[i][q] = s * xp + c * xq;
        const double wp = w[i][p], wq = w[i][q];
        w[i][p] = c * wp - s * wq;
        w[i][q] = s * wp + c * wq;
      }
      moved = true;
    }
    if (!moved) break;
  }
}

// E (row-major, 9) projected onto singular values (1, 1, 0) in place
__device__ __forceinline__ void project_rank2(double* E) {
  double b[3][3], w[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      b[i][j] = E[3 * i + j];
      w[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  jacobi3(b, w);
  double sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrt((b[0][j] * b[0][j] + b[1][j] * b[1][j])
                  + b[2][j] * b[2][j]);
  int jmin = 0;
  if (sig[1] < sig[jmin]) jmin = 1;
  if (sig[2] < sig[jmin]) jmin = 2;
  const int ka = jmin == 0 ? 1 : 0, kb = jmin == 2 ? 1 : 2;
  const double da = clamp_min(sig[ka], 1e-300);
  const double db = clamp_min(sig[kb], 1e-300);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double ua = b[i][ka] / da, ub = b[i][kb] / db;
#pragma unroll
    for (int l = 0; l < 3; ++l)
      E[3 * i + l] = ua * w[l][ka] + ub * w[l][kb];
  }
}

}  // namespace

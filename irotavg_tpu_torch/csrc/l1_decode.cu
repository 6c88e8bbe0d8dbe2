// L1-RA's outer step in four kernels: the per-axis l1 decodes of every
// lane (irotavg_tpu_torch/solver/l1ra.py:_l1decode_lanes) and the update of
// the rotations, with the Newton systems left to the solver between them.
//
//   l1_init    a block per (graph, axis): the edge residuals' log map
//              (so3.log_map(so3.delta_rel(...)), one axis) and the
//              decoder's start: u, fu1, fu2, lamu1, lamu2, A'(lamu1 -
//              lamu2), sdg, tau, the residual norm and the stop test
//   l1_pre     a block per (graph, axis): the Newton system's edge
//              weights sigx and right-hand side w1p (before the solve)
//   l1_post    a block per (graph, axis): after the solve, A dx, du, the
//              dual steps, the largest feasible step, the backtracking
//              line search (up to 32 trials, each a residual norm), the
//              accepted step and the next sdg, tau, residual norm, stop
//   l1_update  a block per graph: Q <- Q exp(X) where the graph is still
//              active, its mean update norm, iteration count and stop
//
// Each kernel repeats the plain composition's arithmetic operation for
// operation (no contractions: built with -fmad=false), so the two differ
// only in the order of their sums over edges and nodes, which here is the
// block's fixed order (a thread's items in turn, then halving), the same
// on every run.  A'e adds each node's terms in the order of the graph's
// rmatvec plan (ops/segment.py), as the composition does.  A lane that
// has stopped is frozen, so running every Newton step of every outer step
// needs no host read: the host reads one stop test per outer step.
//
// Layouts (B graphs, L = 3 axes, m edges, n nodes, all contiguous):
//   E (B, L, kEdgeArrays, m), N (B, L, kNodeArrays, n), S (B, L, kScal)
//   sigx (B, L, m), w1p (B, L, n); dx (B, n, L) read through its strides.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 3;
// the decoder's constants, solver/l1ra.py's _MAX_BACKTRACK, _ALPHA, _BETA
// and 2 * _MU (tests/test_torch_l1_kernels.py holds them equal)
constexpr int kMaxBacktrack = 32;
constexpr double kAlpha = 0.01;
constexpr double kBeta = 0.5;
constexpr double kTwoMu = 20.0;

// per-edge arrays of a lane
enum {
  kY, kU, kAx, kL1, kL2, kF1, kF2,          // decoder state
  kAdx, kDu, kDl1, kDl2, kE,                // one Newton step
  kUp, kAxp, kL1p, kL2p, kF1p, kF2p,        // the line search's trial
  kEdgeArrays
};
// per-node arrays of a lane
enum { kX, kAtv, kDx, kAtdv, kXp, kAtvp, kNodeArrays };
// scalars of a lane
enum { kSdg, kTau, kRes, kDone, kMeff, kScal };

template <typename T> __device__ __forceinline__ T big_value();
template <> __device__ __forceinline__ double big_value<double>() {
  return 1.7976931348623157e308;
}
template <> __device__ __forceinline__ float big_value<float>() {
  return 3.4028234663852886e38f;
}

// torch.minimum / amin and amax: a NaN wins
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// Sums of K values over the block, in a fixed order; every thread gets
// them.  ``red`` holds K * kThreads values.
template <typename T, int K>
__device__ void block_sum(T (&v)[K], T* red) {
  const int t = threadIdx.x;
  for (int k = 0; k < K; ++k) red[k * kThreads + t] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int k = 0; k < K; ++k)
        red[k * kThreads + t] += red[k * kThreads + t + s];
    __syncthreads();
  }
  for (int k = 0; k < K; ++k) v[k] = red[k * kThreads];
  __syncthreads();
}

template <typename T, bool kMax>
__device__ T block_minmax(T v, T* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s)
      red[t] = kMax ? nan_max(red[t], red[t + s]) : nan_min(red[t], red[t + s]);
    __syncthreads();
  }
  v = red[0];
  __syncthreads();
  return v;
}

// One lane's view of the buffers.
template <typename T>
struct Lane {
  int b, l, m, n;
  T* E;                    // (kEdgeArrays, m)
  T* N;                    // (kNodeArrays, n)
  T* S;                    // (kScal,)
  const int64_t* edges;    // (m, 2)
  const uint8_t* em;       // (m,)
  const uint8_t* fm;       // (n,)
  __device__ T* e(int k) const { return E + (size_t)k * m; }
  __device__ T* v(int k) const { return N + (size_t)k * n; }
};

template <typename T>
__device__ Lane<T> lane_of(int bl, int m, int n, T* E, T* N, T* S,
                           const int64_t* edges, const uint8_t* em,
                           const uint8_t* fm) {
  Lane<T> z;
  z.b = bl / kLanes;
  z.l = bl % kLanes;
  z.m = m;
  z.n = n;
  z.E = E + (size_t)bl * kEdgeArrays * m;
  z.N = N + (size_t)bl * kNodeArrays * n;
  z.S = S + (size_t)bl * kScal;
  z.edges = edges + (size_t)z.b * m * 2;
  z.em = em + (size_t)z.b * m;
  z.fm = fm + (size_t)z.b * n;
  return z;
}

// out[r] = free[r] ? (A' e)[r] : 0 for every node of the lane, each node
// adding its terms in the rmatvec plan's order: +e as j, then -e as i,
// each in edge order (masked edges add an exact zero and are skipped).
template <typename T>
__device__ void rmatvec(const Lane<T>& z, const T* e, const int64_t* perm,
                        const int64_t* offsets, T* out) {
  const int64_t two_m = 2 * (int64_t)z.m;
  for (int r = threadIdx.x; r < z.n; r += kThreads) {
    const int64_t row = (int64_t)z.b * z.n + r;
    T acc = T(0);
    for (int64_t p = offsets[row]; p < offsets[row + 1]; ++p) {
      const int64_t w = perm[p] - (int64_t)z.b * two_m;
      const int k = (int)(w < z.m ? w : w - z.m);
      if (!z.em[k]) continue;
      acc = (w < z.m) ? acc + e[k] : acc + (-e[k]);
    }
    out[r] = z.fm[r] ? acc : T(0);
  }
}

// resnorm_of: sqrt(sum_free rd_x^2 + sum rd_u^2 + sum rc1^2 + sum rc2^2)
// over the lane's (rd_x = Atv, l1, l2, f1, f2) at 1/tau = inv_tau.
template <typename T>
__device__ T resnorm(const Lane<T>& z, const T* atv, const T* l1,
                     const T* l2, const T* f1, const T* f2, T inv_tau,
                     T* red) {
  T s[4] = {T(0), T(0), T(0), T(0)};
  for (int r = threadIdx.x; r < z.n; r += kThreads)
    if (z.fm[r]) s[0] += atv[r] * atv[r];
  for (int k = threadIdx.x; k < z.m; k += kThreads) {
    if (!z.em[k]) continue;
    const T rdu = (T(1) - l1[k]) - l2[k];
    const T rc1 = (-l1[k]) * f1[k] - inv_tau;
    const T rc2 = (-l2[k]) * f2[k] - inv_tau;
    s[1] += rdu * rdu;
    s[2] += rc1 * rc1;
    s[3] += rc2 * rc2;
  }
  block_sum<T, 4>(s, red);
  return sqrt(((s[0] + s[1]) + s[2]) + s[3]);
}

// sdg_of: -(sum f1 l1 + sum f2 l2) over the real edges
template <typename T>
__device__ T sdg_of(const Lane<T>& z, const T* l1, const T* l2,
                    const T* f1, const T* f2, T* red) {
  T s[2] = {T(0), T(0)};
  for (int k = threadIdx.x; k < z.m; k += kThreads) {
    if (!z.em[k]) continue;
    s[0] += f1[k] * l1[k];
    s[1] += f2[k] * l2[k];
  }
  block_sum<T, 2>(s, red);
  return -(s[0] + s[1]);
}

// qmul of [x y z w] quaternions, term for term as so3.qmul
template <typename T>
__device__ __forceinline__ void qmul(const T* a, const T* c, T* o) {
  const T x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
  const T x2 = c[0], y2 = c[1], z2 = c[2], w2 = c[3];
  o[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l1_init_kernel(const T* __restrict__ Q, const T* __restrict__ QQ,
               const int64_t* __restrict__ edges,
               const uint8_t* __restrict__ em, const uint8_t* __restrict__ fm,
               const int64_t* __restrict__ perm,
               const int64_t* __restrict__ offsets, T* E, T* N, T* S,
               int m, int n, double pdtol) {
  __shared__ T red[4 * kThreads];
  const Lane<T> z = lane_of<T>(blockIdx.x, m, n, E, N, S, edges, em, fm);
  const T* q = Q + (size_t)z.b * n * 4;
  const T* qq = QQ + (size_t)z.b * m * 4;
  T* y = z.e(kY);
  T* u = z.e(kU);
  T* ax = z.e(kAx);
  T* l1 = z.e(kL1);
  T* l2 = z.e(kL2);
  T* f1 = z.e(kF1);
  T* f2 = z.e(kF2);
  T* x = z.v(kX);
  T* atv = z.v(kAtv);
  // the residual's axis l and the largest |y|
  const T pi = T(3.141592653589793);
  const T two_pi = T(2.0 * 3.141592653589793);
  T rmax = T(0);
  T cnt[1] = {T(0)};
  for (int k = threadIdx.x; k < m; k += kThreads) {
    ax[k] = T(0);
    if (!z.em[k]) continue;
    cnt[0] += T(1);
    const int64_t i = z.edges[2 * k], j = z.edges[2 * k + 1];
    T qi[4], qjinv[4], t[4], d[4];
    for (int c = 0; c < 4; ++c) {
      qi[c] = q[i * 4 + c];
      qjinv[c] = q[j * 4 + c];
    }
    qjinv[3] = qjinv[3] * T(-1);   // so3.qinv_flipw
    qmul(qq + (size_t)k * 4, qi, t);
    qmul(qjinv, t, d);
    const T s2 = sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    T theta = T(2) * atan2(s2, d[3]);
    theta = theta < -pi ? theta + two_pi : theta;
    theta = theta >= pi ? theta - two_pi : theta;
    const bool small = s2 < T(2.2204e-16);
    const T scale = small ? T(0) : theta / s2;
    const T yk = d[z.l] * scale;
    y[k] = yk;
    rmax = nan_max(rmax, fabs(yk - T(0)));
  }
  rmax = block_minmax<T, true>(rmax, red);
  block_sum<T, 1>(cnt, red);
  const T m_eff = cnt[0] < T(1) ? T(1) : cnt[0];
  for (int k = threadIdx.x; k < m; k += kThreads) {
    if (!z.em[k]) continue;
    const T ra = fabs(y[k] - T(0));
    const T uk = T(0.95) * ra + T(0.10) * rmax;
    const T a = (T(0) - y[k]) - uk;
    const T c = ((-T(0)) + y[k]) - uk;
    u[k] = uk;
    f1[k] = a;
    f2[k] = c;
    l1[k] = (T(1) / a) * T(-1);
    l2[k] = (T(1) / c) * T(-1);
    // A'(lamu1 - lamu2) reads this
    z.e(kE)[k] = l1[k] - l2[k];
  }
  for (int r = threadIdx.x; r < n; r += kThreads) x[r] = T(0);
  __syncthreads();
  rmatvec(z, z.e(kE), perm, offsets, atv);
  __syncthreads();
  const T sdg = sdg_of(z, l1, l2, f1, f2, red);
  const T tau = (T(kTwoMu) * m_eff) / sdg;
  const T res = resnorm(z, atv, l1, l2, f1, f2, T(1) / tau, red);
  if (threadIdx.x == 0) {
    z.S[kSdg] = sdg;
    z.S[kTau] = tau;
    z.S[kRes] = res;
    z.S[kDone] = (sdg < T(pdtol)) ? T(1) : T(0);
    z.S[kMeff] = m_eff;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l1_pre_kernel(const int64_t* __restrict__ edges,
              const uint8_t* __restrict__ em, const uint8_t* __restrict__ fm,
              const int64_t* __restrict__ perm,
              const int64_t* __restrict__ offsets, T* E, T* N, T* S,
              T* __restrict__ sigx, T* __restrict__ w1p, int m, int n) {
  const Lane<T> z = lane_of<T>(blockIdx.x, m, n, E, N, S, edges, em, fm);
  const T inv_tau = T(1) / z.S[kTau];
  const T* l1 = z.e(kL1);
  const T* l2 = z.e(kL2);
  const T* f1 = z.e(kF1);
  const T* f2 = z.e(kF2);
  T* e1 = z.e(kDl1);   // scratch until l1_post: -1/fu1 + 1/fu2
  T* e2 = z.e(kDl2);   // (sig2 / sig1) w2
  T* sx = sigx + (size_t)blockIdx.x * m;
  T* rhs = w1p + (size_t)blockIdx.x * n;
  for (int k = threadIdx.x; k < m; k += kThreads) {
    if (!z.em[k]) {
      sx[k] = T(2);   // the composition's value on a pinned padded edge
      continue;
    }
    const T i1 = T(1) / f1[k];
    const T i2 = T(1) / f2[k];
    const T w2 = T(-1) - inv_tau * (i1 + i2);
    const T s1 = (-l1[k]) * i1 - l2[k] * i2;
    const T s2 = l1[k] * i1 - l2[k] * i2;
    sx[k] = s1 - s2 * s2 / s1;
    e1[k] = (-i1) + i2;
    e2[k] = (s2 / s1) * w2;
  }
  __syncthreads();
  T* a1 = z.v(kDx);     // scratch: A' e1
  T* a2 = z.v(kAtdv);   // scratch: A' e2
  rmatvec(z, e1, perm, offsets, a1);
  rmatvec(z, e2, perm, offsets, a2);
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += kThreads)
    rhs[r] = (-inv_tau) * a1[r] - a2[r];
}

template <typename T>
__device__ T trial(const Lane<T>& z, T sv, T inv_tau, T* red) {
  const T* x = z.v(kX);
  const T* atv = z.v(kAtv);
  const T* dx = z.v(kDx);
  const T* atdv = z.v(kAtdv);
  T* xp = z.v(kXp);
  T* atvp = z.v(kAtvp);
  for (int r = threadIdx.x; r < z.n; r += kThreads) {
    xp[r] = x[r] + sv * dx[r];
    atvp[r] = atv[r] + sv * atdv[r];
  }
  const T* y = z.e(kY);
  T* up = z.e(kUp);
  T* axp = z.e(kAxp);
  T* l1p = z.e(kL1p);
  T* l2p = z.e(kL2p);
  T* f1p = z.e(kF1p);
  T* f2p = z.e(kF2p);
  for (int k = threadIdx.x; k < z.m; k += kThreads) {
    if (!z.em[k]) continue;
    up[k] = z.e(kU)[k] + sv * z.e(kDu)[k];
    axp[k] = z.e(kAx)[k] + sv * z.e(kAdx)[k];
    l1p[k] = z.e(kL1)[k] + sv * z.e(kDl1)[k];
    l2p[k] = z.e(kL2)[k] + sv * z.e(kDl2)[k];
    f1p[k] = (axp[k] - y[k]) - up[k];
    f2p[k] = ((-axp[k]) + y[k]) - up[k];
  }
  __syncthreads();
  return resnorm(z, atvp, l1p, l2p, f1p, f2p, inv_tau, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l1_post_kernel(const int64_t* __restrict__ edges,
               const uint8_t* __restrict__ em, const uint8_t* __restrict__ fm,
               const int64_t* __restrict__ perm,
               const int64_t* __restrict__ offsets, T* E, T* N, T* S,
               const T* __restrict__ dx_in, int64_t sb, int64_t sn,
               int64_t sl, int m, int n, int last, double pdtol) {
  __shared__ T red[4 * kThreads];
  const Lane<T> z = lane_of<T>(blockIdx.x, m, n, E, N, S, edges, em, fm);
  const T tau = z.S[kTau];
  const T inv_tau = T(1) / tau;
  const T res0 = z.S[kRes];
  const bool done = z.S[kDone] != T(0);
  T* dx = z.v(kDx);
  const T* din = dx_in + z.b * sb + z.l * sl;
  for (int r = threadIdx.x; r < n; r += kThreads)
    dx[r] = z.fm[r] ? din[r * sn] : T(0);
  __syncthreads();
  const T* l1 = z.e(kL1);
  const T* l2 = z.e(kL2);
  const T* f1 = z.e(kF1);
  const T* f2 = z.e(kF2);
  T* adx = z.e(kAdx);
  T* du = z.e(kDu);
  T* dl1 = z.e(kDl1);
  T* dl2 = z.e(kDl2);
  T* ee = z.e(kE);
  const T big = big_value<T>();
  T smin = T(1);
  for (int k = threadIdx.x; k < m; k += kThreads) {
    if (!z.em[k]) continue;
    const int64_t i = z.edges[2 * k], j = z.edges[2 * k + 1];
    const T i1 = T(1) / f1[k];
    const T i2 = T(1) / f2[k];
    const T w2 = T(-1) - inv_tau * (i1 + i2);
    const T s1 = (-l1[k]) * i1 - l2[k] * i2;
    const T s2 = l1[k] * i1 - l2[k] * i2;
    const T a = dx[j] - dx[i];
    const T d = (w2 - s2 * a) / s1;
    const T d1 = (-(l1[k] * i1)) * (a - d) - l1[k] - inv_tau * i1;
    const T d2 = (l2[k] * i2) * (a + d) - l2[k] - inv_tau * i2;
    adx[k] = a;
    du[k] = d;
    dl1[k] = d1;
    dl2[k] = d2;
    ee[k] = d1 - d2;
    const T am = a - d;
    const T ap = (-a) - d;
    smin = nan_min(smin, d1 < T(0) ? (-l1[k]) / d1 : big);
    smin = nan_min(smin, d2 < T(0) ? (-l2[k]) / d2 : big);
    smin = nan_min(smin, am > T(0) ? (-f1[k]) / am : big);
    smin = nan_min(smin, ap > T(0) ? (-f2[k]) / ap : big);
  }
  const T s_step = T(0.99) * block_minmax<T, false>(smin, red);
  rmatvec(z, ee, perm, offsets, z.v(kAtdv));
  __syncthreads();
  // backtracking line search: a stopped lane still computes its first
  // trial (as the composition does) and keeps its state
  T rn = trial(z, s_step, inv_tau, red);
  bool ok = rn <= (T(1) - T(kAlpha) * s_step) * res0;
  T sv = s_step * T(kBeta);
  for (int k = 1; k <= kMaxBacktrack && !ok && !done; ++k) {
    rn = trial(z, sv, inv_tau, red);
    ok = rn <= (T(1) - T(kAlpha) * sv) * res0;
    sv = sv * T(kBeta);
  }
  if (ok && !done) {
    for (int r = threadIdx.x; r < n; r += kThreads) {
      z.v(kX)[r] = z.v(kXp)[r];
      z.v(kAtv)[r] = z.v(kAtvp)[r];
    }
    for (int k = threadIdx.x; k < m; k += kThreads) {
      if (!z.em[k]) continue;
      z.e(kU)[k] = z.e(kUp)[k];
      z.e(kAx)[k] = z.e(kAxp)[k];
      z.e(kL1)[k] = z.e(kL1p)[k];
      z.e(kL2)[k] = z.e(kL2p)[k];
      z.e(kF1)[k] = z.e(kF1p)[k];
      z.e(kF2)[k] = z.e(kF2p)[k];
    }
  }
  __syncthreads();
  const T sdg_n = sdg_of(z, l1, l2, f1, f2, red);
  const T tau_n = (T(kTwoMu) * z.S[kMeff]) / sdg_n;
  const T res_n = resnorm(z, z.v(kAtv), l1, l2, f1, f2, T(1) / tau_n, red);
  if (threadIdx.x == 0) {
    if (!done) {
      z.S[kSdg] = sdg_n;
      z.S[kTau] = tau_n;
      z.S[kRes] = res_n;
    }
    const bool stop = done || !ok || (sdg_n < T(pdtol)) || last;
    z.S[kDone] = stop ? T(1) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l1_update_kernel(T* Q, const uint8_t* __restrict__ fm, const T* N,
                 T* score, int64_t* iters, uint8_t* active, int n,
                 double change_th, int64_t max_iters) {
  __shared__ T red[kThreads];
  const int b = blockIdx.x;
  const bool act = active[b] != 0;
  T* q = Q + (size_t)b * n * 4;
  const uint8_t* f = fm + (size_t)b * n;
  const T* xs[kLanes];
  for (int l = 0; l < kLanes; ++l)
    xs[l] = N + ((size_t)(b * kLanes + l) * kNodeArrays + kX) * n;
  T s[1] = {T(0)};
  T cnt[1] = {T(0)};
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const T v0 = xs[0][r], v1 = xs[1][r], v2 = xs[2][r];
    const T theta = sqrt(v0 * v0 + v1 * v1 + v2 * v2);
    if (f[r]) {
      s[0] += theta;
      cnt[0] += T(1);
    }
    if (!act) continue;
    const T half = T(0.5) * theta;
    const T coef = theta > T(0) ? sin(half) / theta : T(0);
    const T e[4] = {v0 * coef, v1 * coef, v2 * coef, cos(half)};
    T qo[4];
    qmul(q + (size_t)r * 4, e, qo);
    for (int c = 0; c < 4; ++c) q[(size_t)r * 4 + c] = qo[c];
  }
  block_sum<T, 1>(s, red);
  block_sum<T, 1>(cnt, red);
  if (threadIdx.x == 0) {
    const T n_free = cnt[0] < T(1) ? T(1) : cnt[0];
    T sc = score[b];
    int64_t it = iters[b];
    if (act) {
      sc = s[0] / n_free;
      it += 1;
    }
    score[b] = sc;
    iters[b] = it;
    active[b] = (sc >= T(change_th) && it < max_iters) ? 1 : 0;
  }
}

template <typename T>
int init_t(const void* Q, const void* QQ, const void* edges, const void* em,
           const void* fm, const void* perm, const void* offsets, void* E,
           void* N, void* S, int B, int m, int n, double pdtol,
           cudaStream_t s) {
  l1_init_kernel<T><<<B * kLanes, kThreads, 0, s>>>(
      (const T*)Q, (const T*)QQ, (const int64_t*)edges, (const uint8_t*)em,
      (const uint8_t*)fm, (const int64_t*)perm, (const int64_t*)offsets,
      (T*)E, (T*)N, (T*)S, m, n, pdtol);
  return (int)cudaGetLastError();
}

template <typename T>
int pre_t(const void* edges, const void* em, const void* fm,
          const void* perm, const void* offsets, void* E, void* N, void* S,
          void* sigx, void* w1p, int B, int m, int n, cudaStream_t s) {
  l1_pre_kernel<T><<<B * kLanes, kThreads, 0, s>>>(
      (const int64_t*)edges, (const uint8_t*)em, (const uint8_t*)fm,
      (const int64_t*)perm, (const int64_t*)offsets, (T*)E, (T*)N, (T*)S,
      (T*)sigx, (T*)w1p, m, n);
  return (int)cudaGetLastError();
}

template <typename T>
int post_t(const void* edges, const void* em, const void* fm,
           const void* perm, const void* offsets, void* E, void* N, void* S,
           const void* dx, int64_t sb, int64_t sn, int64_t sl, int B, int m,
           int n, int last, double pdtol, cudaStream_t s) {
  l1_post_kernel<T><<<B * kLanes, kThreads, 0, s>>>(
      (const int64_t*)edges, (const uint8_t*)em, (const uint8_t*)fm,
      (const int64_t*)perm, (const int64_t*)offsets, (T*)E, (T*)N, (T*)S,
      (const T*)dx, sb, sn, sl, m, n, last, pdtol);
  return (int)cudaGetLastError();
}

template <typename T>
int update_t(void* Q, const void* fm, const void* N, void* score,
             void* iters, void* active, int B, int n, double change_th,
             int64_t max_iters, cudaStream_t s) {
  l1_update_kernel<T><<<B, kThreads, 0, s>>>(
      (T*)Q, (const uint8_t*)fm, (const T*)N, (T*)score, (int64_t*)iters,
      (uint8_t*)active, n, change_th, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int l1_geometry(int* out) {
  out[0] = kEdgeArrays;
  out[1] = kNodeArrays;
  out[2] = kScal;
  out[3] = kLanes;
  return 0;
}

extern "C" int l1_init(const void* Q, const void* QQ, const void* edges,
                       const void* em, const void* fm, const void* perm,
                       const void* offsets, void* E, void* N, void* S, int B,
                       int m, int n, double pdtol, int dtype, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return init_t<double>(Q, QQ, edges, em, fm, perm, offsets, E, N,
                                  S, B, m, n, pdtol, s);
    case 1: return init_t<float>(Q, QQ, edges, em, fm, perm, offsets, E, N,
                                 S, B, m, n, pdtol, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int l1_pre(const void* edges, const void* em, const void* fm,
                      const void* perm, const void* offsets, void* E,
                      void* N, void* S, void* sigx, void* w1p, int B, int m,
                      int n, int dtype, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return pre_t<double>(edges, em, fm, perm, offsets, E, N, S, sigx,
                                 w1p, B, m, n, s);
    case 1: return pre_t<float>(edges, em, fm, perm, offsets, E, N, S, sigx,
                                w1p, B, m, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int l1_post(const void* edges, const void* em, const void* fm,
                       const void* perm, const void* offsets, void* E,
                       void* N, void* S, const void* dx, int64_t sb,
                       int64_t sn, int64_t sl, int B, int m, int n, int last,
                       double pdtol, int dtype, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return post_t<double>(edges, em, fm, perm, offsets, E, N, S, dx,
                                  sb, sn, sl, B, m, n, last, pdtol, s);
    case 1: return post_t<float>(edges, em, fm, perm, offsets, E, N, S, dx,
                                 sb, sn, sl, B, m, n, last, pdtol, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int l1_update(void* Q, const void* fm, const void* N, void* score,
                         void* iters, void* active, int B, int n,
                         double change_th, int64_t max_iters, int dtype,
                         void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return update_t<double>(Q, fm, N, score, iters, active, B, n,
                                    change_th, max_iters, s);
    case 1: return update_t<float>(Q, fm, N, score, iters, active, B, n,
                                   change_th, max_iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

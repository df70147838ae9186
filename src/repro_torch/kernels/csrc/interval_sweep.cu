// Regression-CP critical points for the whole tenant batch in one launch.
//
// Replaces: repro/kernels/interval_sweep.py::interval_sweep, the Pallas
// kernel the JAX regression engine's intervals read runs once per tenant.
//
// What it computes, per tenant s, test row t < m and training column
// i < n (the arrival-ordered window):
//   d        = sqrt(max((|x_t|^2 + |X_i|^2) - 2 x_t.X_i, 0)), the formula of
//              sqdist.cuh (ref.sq_dists' bits);
//   enters   = live_i && d < kth_i;
//   a_i, b_i = enters ? (a'_i + kth_label_i / k, -1/k) : (a'_i, 0);
//   (lo, hi) = the interval {u : |a_i + b_i u| >= |a_test_t + u|}: the
//              roots of (b_i^2 - 1) u^2 + 2 (a_i b_i - a) u + (a_i^2 - a^2)
//              (quadratic branch) or of its linear form when b_i^2 == 1
//              (k = 1); an empty set and a non-live column are
//              (+inf, -inf).
//
// Every multiply, add, subtract and divide is an explicit round-to-nearest
// intrinsic in the order of the plain version (ref.interval_ge): without
// them nvcc contracts B1*B1 - A2*C0 and the like into FMAs and the kernel
// drifts ulps away from it. Square roots are sqd_sqrt (sqdist.cuh),
// __fsqrt_rn's bits without its branch. -1/k comes in from the caller
// rounded as the plain version rounds it.
//
// Bound: the two (S, m, n) f32 outputs, 8*S*m*n bytes, at the serving
// read's shape (0.296 ms on an H100 SXM); the products' 2p multiplies and
// adds an output (no FMA) and an epilogue of ~50 instructions (~80 where
// a cell enters: two divisions) are the other limit, near it. Design:
// - norms once: each block sums its 64 rows' and 128 columns' |x|^2 (one
//   thread a row or column, feature order, sqd_step) from the features it
//   stages anyway, into shared memory; no output recomputes a norm;
// - register tiles: the tile structure of pairwise_dist.cu, 64 x 128
//   outputs a block, 32-feature chunks of both operands staged feature-
//   major, 8 rows x 4 consecutive columns a thread, so a feature costs
//   two broadcast 16-byte loads of the rows, one 16-byte load of the
//   columns and 32 multiply-adds;
// - the dot products are parked in shared memory (over the staging
//   buffers) and read back a row at a time, so the epilogue holds 4 of
//   them, not 32: 64 registers, 4 blocks an SM;
// - per column, once a thread: upd = a' + kth_label / k and the column's
//   products a_i b_i and a_i^2 for both branches; per row: a^2;
// - a row's 4 cells first run branch-free together (the distance, the
//   gate, the discriminant and its root), so they interleave; then the
//   divisions of the entering cells;
// - no division by -1: where b_i = 0, A2 = 0*0 - 1 = -1 exactly, and
//   x / -1 == -x for every non-NaN x (signed zeros and infinities
//   included), so the roots are negations; A2 * C0 = -C0 likewise. The
//   entering branch keeps __fdiv_rn (k = 1 its linear form: a template);
// - 16-byte stores: a lane's 4 outputs of a row leave as one float4 each
//   for lo and hi where n is a multiple of 4 (a warp writes 512
//   contiguous bytes of each), scalar stores otherwise. Warps whose rows
//   are all past m skip the products and the epilogue.
// On an H100 (700 W) at S 1024, m 100, n 1024, p 30, k 7: 0.74 ms; the
// 32 x 32-tile kernel it replaced took 1.55 ms (PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>
#include <math_constants.h>

#include "sqdist.cuh"

#define IS_RM 8                   // rows a warp (and a thread)
#define IS_RN 4                   // consecutive columns a lane
#define IS_WARPS 8
#define IS_BM (IS_WARPS * IS_RM)  // 64 rows a block
#define IS_BN (32 * IS_RN)        // 128 columns a block
#define IS_PC 32                  // features a chunk

template <bool K1>
__global__ void __launch_bounds__(IS_WARPS * 32, 4) interval_sweep_kernel(
    const float* __restrict__ X, int64_t sX, const float* __restrict__ ap,
    const float* __restrict__ kth, const float* __restrict__ kl,
    const unsigned char* __restrict__ live, const float* __restrict__ Xt,
    int64_t sXt, const float* __restrict__ at, float* __restrict__ lo,
    float* __restrict__ hi, int m, int n, int p, int k, float neg_inv_k,
    bool vec) {
  // the staged chunks (pitch = 4 (mod 32): 16-byte aligned rows, 4-way
  // conflicts on staging), then the block's dot products in their place
  __shared__ __align__(16) float buf[IS_BM * IS_BN];
  float(*As)[IS_BM + 4] = reinterpret_cast<float(*)[IS_BM + 4]>(buf);
  float(*Bs)[IS_BN + 4] =
      reinterpret_cast<float(*)[IS_BN + 4]>(buf + IS_PC * (IS_BM + 4));
  float(*Ds)[IS_BN] = reinterpret_cast<float(*)[IS_BN]>(buf);
  __shared__ float a2s[IS_BM], b2s[IS_BN];
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * IS_BM, col0 = blockIdx.x * IS_BN;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int r0 = warp * IS_RM, c0 = lane * IS_RN;
  const bool rows_live = row0 + r0 < m;
  const float* Ab = Xt + s * sXt;
  const float* Bb = X + s * sX;

  // thread t < 64 sums row t's |x|^2, 64 <= t < 192 column t - 64's, over
  // the staged chunks in feature order
  const bool norm_row = t < IS_BM, norm_col = !norm_row && t < IS_BM + IS_BN;
  const float* nsrc = norm_row ? &As[0][t] : &Bs[0][norm_col ? t - IS_BM : 0];
  const int npitch = norm_row ? IS_BM + 4 : IS_BN + 4;
  float nrm = 0.f;

  float acc[IS_RM][IS_RN];
#pragma unroll
  for (int i = 0; i < IS_RM; ++i)
#pragma unroll
    for (int j = 0; j < IS_RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p; k0 += IS_PC) {
    const int kk = min(IS_PC, p - k0);
    const int f = k0 + lane;
    for (int r = warp; r < IS_BM; r += IS_WARPS) {
      const int ra = row0 + r;
      As[lane][r] = (ra < m && lane < kk) ? Ab[(int64_t)ra * p + f] : 0.f;
    }
    for (int r = warp; r < IS_BN; r += IS_WARPS) {
      const int rb = col0 + r;
      Bs[lane][r] = (rb < n && lane < kk) ? Bb[(int64_t)rb * p + f] : 0.f;
    }
    __syncthreads();
    if (norm_row || norm_col) {
      for (int j = 0; j < kk; ++j) {
        const float v = nsrc[j * npitch];
        nrm = sqd_step(nrm, v, v);
      }
    }
    if (rows_live) {
      for (int j = 0; j < kk; ++j) {
        float a[IS_RM];
#pragma unroll
        for (int i = 0; i < IS_RM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&As[j][r0 + i]);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
        const float4 b = *reinterpret_cast<const float4*>(&Bs[j][c0]);
#pragma unroll
        for (int i = 0; i < IS_RM; ++i) {
          acc[i][0] = sqd_step(acc[i][0], a[i], b.x);
          acc[i][1] = sqd_step(acc[i][1], a[i], b.y);
          acc[i][2] = sqd_step(acc[i][2], a[i], b.z);
          acc[i][3] = sqd_step(acc[i][3], a[i], b.w);
        }
      }
    }
    __syncthreads();
  }
  if (norm_row) a2s[t] = nrm;
  if (norm_col) b2s[t - IS_BM] = nrm;
  // each thread parks its dot products and reads them back a row at a
  // time: the epilogue then holds 4 of them in registers, not 32
  if (rows_live) {
#pragma unroll
    for (int i = 0; i < IS_RM; ++i)
      *reinterpret_cast<float4*>(&Ds[r0 + i][c0]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  const int col = col0 + c0;
  if (!rows_live || col >= n) return;

  // the columns' statistics, once a thread; with vec (n a multiple of 4,
  // every operand aligned) col + 3 < n and 16-byte moves
  const int64_t cb = (int64_t)s * n + col;
  float c_ap[IS_RN], c_kth[IS_RN], c_kl[IS_RN];
  bool c_lv[IS_RN];
  if (vec) {
    const float4 v0 = *reinterpret_cast<const float4*>(ap + cb);
    const float4 v1 = *reinterpret_cast<const float4*>(kth + cb);
    const float4 v2 = *reinterpret_cast<const float4*>(kl + cb);
    const uchar4 v3 = *reinterpret_cast<const uchar4*>(live + cb);
    c_ap[0] = v0.x, c_ap[1] = v0.y, c_ap[2] = v0.z, c_ap[3] = v0.w;
    c_kth[0] = v1.x, c_kth[1] = v1.y, c_kth[2] = v1.z, c_kth[3] = v1.w;
    c_kl[0] = v2.x, c_kl[1] = v2.y, c_kl[2] = v2.z, c_kl[3] = v2.w;
    c_lv[0] = v3.x, c_lv[1] = v3.y, c_lv[2] = v3.z, c_lv[3] = v3.w;
  } else {
#pragma unroll
    for (int j = 0; j < IS_RN; ++j) {
      const bool in = col + j < n;
      c_ap[j] = in ? ap[cb + j] : 0.f;
      c_kth[j] = in ? kth[cb + j] : 0.f;
      c_kl[j] = in ? kl[cb + j] : 0.f;
      c_lv[j] = in && live[cb + j] != 0;
    }
  }
  const float kf = (float)k;
  float b2[IS_RN], zb[IS_RN], zc[IS_RN], ub[IS_RN], uc[IS_RN];
#pragma unroll
  for (int j = 0; j < IS_RN; ++j) {
    const float upd = __fadd_rn(c_ap[j], __fdiv_rn(c_kl[j], kf));
    b2[j] = b2s[c0 + j];
    zb[j] = __fmul_rn(c_ap[j], 0.f);  // a_i b_i and a_i^2, not entering
    zc[j] = __fmul_rn(c_ap[j], c_ap[j]);
    ub[j] = __fmul_rn(upd, neg_inv_k);  // the same, entering
    uc[j] = __fmul_rn(upd, upd);
  }
  const float A2e = __fsub_rn(__fmul_rn(neg_inv_k, neg_inv_k), 1.f);
  const float inf = CUDART_INF_F;

  // a row's 4 cells: ref.interval_ge on (a_i, b_i, a) = (upd, -1/k, a)
  // entering (e), (a', 0, a) not. First, branch-free for all 4 (so they
  // interleave): B1 = a_i b_i - a, C0 = a_i^2 - a^2, disc = B1^2 - A2 C0
  // (A2 = 0*0 - 1 = -1 not entering: A2 C0 = -C0 exactly) and -B1 +- sqrt.
  // Then the entering cells' divisions (x / -1 == -x for every non-NaN x
  // elsewhere), or at k = 1 their linear branch (b_i^2 = 1).
  const float eps = (float)1e-12;
#pragma unroll 1
  for (int i = 0; i < IS_RM; ++i) {
    const int row = row0 + r0 + i;
    if (row >= m) break;
    const float a = at[(int64_t)s * m + row];
    const float a_sq = __fmul_rn(a, a);
    const float an = a2s[r0 + i];
    const float4 dv = *reinterpret_cast<const float4*>(&Ds[r0 + i][c0]);
    const float ab[IS_RN] = {dv.x, dv.y, dv.z, dv.w};
    float B1[IS_RN], C0[IS_RN], n1[IS_RN], n2[IS_RN];
    bool e[IS_RN], real[IS_RN];
#pragma unroll
    for (int j = 0; j < IS_RN; ++j) {
      const float d2 = sqd_combine(an, b2[j], ab[j]);
      const float d = sqd_sqrt(d2 < 0.f ? 0.f : d2);
      e[j] = c_lv[j] & (d < c_kth[j]);
      B1[j] = __fsub_rn(e[j] ? ub[j] : zb[j], a);
      C0[j] = __fsub_rn(e[j] ? uc[j] : zc[j], a_sq);
      const float disc = __fsub_rn(__fmul_rn(B1[j], B1[j]),
                                   e[j] ? __fmul_rn(A2e, C0[j]) : -C0[j]);
      real[j] = disc >= 0.f;
      const float sq = sqd_sqrt(disc);  // NaN where not real, then unused
      n1[j] = __fadd_rn(-B1[j], sq);
      n2[j] = __fsub_rn(-B1[j], sq);
    }
    float l[IS_RN], h[IS_RN];
#pragma unroll
    for (int j = 0; j < IS_RN; ++j) {
      float r1 = -n1[j], r2 = -n2[j];
      if (!K1 && e[j]) {
        r1 = __fdiv_rn(n1[j], A2e);
        r2 = __fdiv_rn(n2[j], A2e);
      }
      l[j] = real[j] ? fminf(r1, r2) : inf;
      h[j] = real[j] ? fmaxf(r1, r2) : -inf;
      if (K1 && e[j]) {
        const float t0 = __fdiv_rn(-C0[j], __fmul_rn(2.f, B1[j]));
        const float flat_lo = C0[j] >= 0.f ? -inf : inf;
        l[j] = B1[j] > eps ? t0 : (B1[j] < -eps ? -inf : flat_lo);
        h[j] = B1[j] > eps ? inf : (B1[j] < -eps ? t0 : -flat_lo);
      }
      l[j] = c_lv[j] ? l[j] : inf;  // a dead column: the empty set
      h[j] = c_lv[j] ? h[j] : -inf;
    }
    const int64_t o = ((int64_t)s * m + row) * n + col;
    if (vec) {
      *reinterpret_cast<float4*>(lo + o) = make_float4(l[0], l[1], l[2], l[3]);
      *reinterpret_cast<float4*>(hi + o) = make_float4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int j = 0; j < IS_RN; ++j)
        if (col + j < n) lo[o + j] = l[j], hi[o + j] = h[j];
    }
  }
}

extern "C" int rt_interval_sweep(const void* X, int64_t sX, const void* ap,
                                 const void* kth, const void* kl,
                                 const void* live, const void* Xt,
                                 int64_t sXt, const void* at, void* lo,
                                 void* hi, int S, int m, int n, int p, int k,
                                 float neg_inv_k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (S == 0 || m == 0 || n == 0) return 0;
  const bool vec =
      n % 4 == 0 &&
      (((uintptr_t)ap | (uintptr_t)kth | (uintptr_t)kl | (uintptr_t)lo |
        (uintptr_t)hi) % 16 == 0) && (uintptr_t)live % 4 == 0;
  dim3 grid((n + IS_BN - 1) / IS_BN, (m + IS_BM - 1) / IS_BM, S);
  // k = 1 is the one k whose entering cells take the linear branch:
  // (-1/k)^2 - 1 is 0 there and at least 3/4 in magnitude otherwise
  auto kern = k == 1 ? interval_sweep_kernel<true>
                     : interval_sweep_kernel<false>;
  kern<<<grid, IS_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)X, sX, (const float*)ap, (const float*)kth,
      (const float*)kl, (const unsigned char*)live, (const float*)Xt, sXt,
      (const float*)at, (float*)lo, (float*)hi, m, n, p, k, neg_inv_k, vec);
  return (int)cudaGetLastError();
}

// sqd_sqrt of n floats, to hold it against torch.sqrt on the card
__global__ void sqd_sqrt_kernel(const float* __restrict__ x,
                                float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = sqd_sqrt(x[i]);
}

extern "C" int rt_sqd_sqrt(const void* x, void* y, int64_t n, void* stream) {
  if (n > 0)
    sqd_sqrt_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

// Regression-CP critical points for the whole tenant batch in one launch.
//
// Replaces: repro/kernels/interval_sweep.py::interval_sweep, the Pallas
// kernel the JAX regression engine's intervals read runs once per tenant.
//
// What it computes, per tenant s, test row t < m and training column
// i < n (the arrival-ordered window):
//   d        = sqrt(max((|x_t|^2 + |X_i|^2) - 2 x_t.X_i, 0)), the fixed-order
//              form of ref.sq_dists (pairwise_sq_dists' bits);
//   enters   = live_i && d < kth_i;
//   a_i, b_i = enters ? (a'_i + kth_label_i / k, -1/k) : (a'_i, 0);
//   (lo, hi) = the interval {u : |a_i + b_i u| >= |a_test_t + u|}: the
//              roots of (b_i^2 - 1) u^2 + 2 (a_i b_i - a) u + (a_i^2 - a^2)
//              (quadratic branch) or of its linear form when b_i^2 == 1
//              (k = 1); an empty set and a non-live column are
//              (+inf, -inf).
//
// Every multiply, add, subtract, divide and square root is an explicit
// round-to-nearest intrinsic in the order of the plain version
// (ref.interval_ge): without them nvcc contracts B1*B1 - A2*C0 and the
// like into FMAs and the kernel drifts ulps away from it. -1/k comes in
// from the caller rounded as the plain version rounds it.
//
// Bound: the two (S, m, n) f32 outputs, 8*S*m*n bytes, against about
// S*m*n*(3p + 25) flops: memory at the serving shapes. Design: the tile
// structure of pairwise_dist.cu (32x32 outputs per block, 32-feature
// chunks of both operands staged in shared memory with pitch 33, each of
// the 256 threads owning four test rows of one column), so a warp writes
// 128 contiguous bytes of lo and of hi per row; a column's statistics are
// read once per thread.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math_constants.h>

#define IS_T 32
#define IS_ROWS 8

__device__ __forceinline__ void interval_ge(float ai, float bi, float a,
                                            float* lo, float* hi) {
  const float eps = (float)1e-12;
  const float inf = CUDART_INF_F;
  const float A2 = __fsub_rn(__fmul_rn(bi, bi), 1.f);
  const float B1 = __fsub_rn(__fmul_rn(ai, bi), a);
  const float C0 = __fsub_rn(__fmul_rn(ai, ai), __fmul_rn(a, a));
  const float disc = __fsub_rn(__fmul_rn(B1, B1), __fmul_rn(A2, C0));
  if (fabsf(A2) >= eps) {
    if (disc >= 0.f) {
      const float sq = __fsqrt_rn(disc);
      const float r1 = __fdiv_rn(__fadd_rn(-B1, sq), A2);
      const float r2 = __fdiv_rn(__fsub_rn(-B1, sq), A2);
      *lo = fminf(r1, r2);
      *hi = fmaxf(r1, r2);
    } else {
      *lo = inf;
      *hi = -inf;
    }
    return;
  }
  const float flat_lo = C0 >= 0.f ? -inf : inf;
  if (B1 > eps) {
    *lo = __fdiv_rn(-C0, __fmul_rn(2.f, B1));
    *hi = inf;
  } else if (B1 < -eps) {
    *lo = -inf;
    *hi = __fdiv_rn(-C0, __fmul_rn(2.f, B1));
  } else {
    *lo = flat_lo;
    *hi = -flat_lo;
  }
}

__global__ void interval_sweep_kernel(
    const float* __restrict__ X, int64_t sX, const float* __restrict__ ap,
    const float* __restrict__ kth, const float* __restrict__ kl,
    const unsigned char* __restrict__ live, const float* __restrict__ Xt,
    int64_t sXt, const float* __restrict__ at, float* __restrict__ lo,
    float* __restrict__ hi, int m, int n, int p, int k, float neg_inv_k) {
  __shared__ float As[IS_T][IS_T + 1];
  __shared__ float Bs[IS_T][IS_T + 1];
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * IS_T, col0 = blockIdx.x * IS_T;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* Ab = Xt + (int64_t)s * sXt;
  const float* Bb = X + (int64_t)s * sX;

  float ab[IS_T / IS_ROWS], a2[IS_T / IS_ROWS];
#pragma unroll
  for (int q = 0; q < IS_T / IS_ROWS; ++q) ab[q] = a2[q] = 0.f;
  float b2 = 0.f;

  for (int k0 = 0; k0 < p; k0 += IS_T) {
    const int f = k0 + tx;
    for (int r = ty; r < IS_T; r += IS_ROWS) {
      const int ra = row0 + r, rb = col0 + r;
      As[r][tx] = (ra < m && f < p) ? Ab[(int64_t)ra * p + f] : 0.f;
      Bs[r][tx] = (rb < n && f < p) ? Bb[(int64_t)rb * p + f] : 0.f;
    }
    __syncthreads();
    const int kk = min(IS_T, p - k0);
    for (int j = 0; j < kk; ++j) {
      const float b = Bs[tx][j];
      b2 = __fadd_rn(b2, __fmul_rn(b, b));
#pragma unroll
      for (int q = 0; q < IS_T / IS_ROWS; ++q) {
        const float a = As[ty + IS_ROWS * q][j];
        ab[q] = __fadd_rn(ab[q], __fmul_rn(a, b));
        a2[q] = __fadd_rn(a2[q], __fmul_rn(a, a));
      }
    }
    __syncthreads();
  }
  const int col = col0 + tx;
  if (col >= n) return;
  const int64_t c = (int64_t)s * n + col;
  const bool lv = live[c] != 0;
  const float apc = ap[c], kthc = kth[c];
  const float upd = __fadd_rn(apc, __fdiv_rn(kl[c], (float)k));
#pragma unroll
  for (int q = 0; q < IS_T / IS_ROWS; ++q) {
    const int row = row0 + ty + IS_ROWS * q;
    if (row >= m) continue;
    const float d2 = __fsub_rn(__fadd_rn(a2[q], b2), __fmul_rn(2.f, ab[q]));
    const float d = __fsqrt_rn(d2 < 0.f ? 0.f : d2);
    const bool enters = lv && d < kthc;
    float l, h;
    interval_ge(enters ? upd : apc, enters ? neg_inv_k : 0.f,
                at[(int64_t)s * m + row], &l, &h);
    const int64_t o = ((int64_t)s * m + row) * n + col;
    lo[o] = lv ? l : CUDART_INF_F;
    hi[o] = lv ? h : -CUDART_INF_F;
  }
}

extern "C" int rt_interval_sweep(const void* X, int64_t sX, const void* ap,
                                 const void* kth, const void* kl,
                                 const void* live, const void* Xt,
                                 int64_t sXt, const void* at, void* lo,
                                 void* hi, int S, int m, int n, int p, int k,
                                 float neg_inv_k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((n + IS_T - 1) / IS_T, (m + IS_T - 1) / IS_T, S);
  dim3 block(IS_T, IS_ROWS);
  interval_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)X, sX, (const float*)ap, (const float*)kth,
      (const float*)kl, (const unsigned char*)live, (const float*)Xt, sXt,
      (const float*)at, (float*)lo, (float*)hi, m, n, p, k, neg_inv_k);
  return (int)cudaGetLastError();
}

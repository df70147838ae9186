// Fused simplified-k-NN CP score update + p-value counts, whole tenant
// batch in one launch.
//
// Replaces: repro/kernels/cp_update.py::cp_knn_counts (the Pallas kernel
// the JAX engine's predict vmaps per tenant).
//
// For tenant s, test row t and label l:
//   counts[s,t,l] = #{i : alpha_i >= alpha[s,t,l]},
//   alpha_i = (y[s,i] == l && d < kth[s,i]) ? (sum[s,i] - kth[s,i]) + d
//                                          : sum[s,i],
// with d = sqrt(max((|x_t|^2 + |x_i|^2) - 2 x_t.x_i, 0)), the formula of
// sqdist.cuh (ref.sq_dists' bits). Padded or non-live columns carry label
// -1 and sum -BIG and are compared like any other.
//
// Bound: the S*m*n*(2p + 7 + 3L) flops of the fused distance and update
// (without FMA the products alone issue 2p instructions a pair), well
// above the bytes it reads. Design:
// - the TPU kernel walks the training columns on a sequential grid axis
//   and carries the counts in its output block; blocks run in no order
//   here, so a block owns a (tenant, tile of 64 test rows) pair and loops
//   over all n columns itself, 128 at a time. The counts are integers, so
//   any order of adding them is exact: each thread keeps its rows' counts
//   in registers, the 32 lanes that share a row add theirs by warp
//   shuffles at the end, and one lane writes them. No atomics, no second
//   pass;
// - register tiles: 8 warps of 8 rows, 4 consecutive columns a lane (the
//   tile of pairwise_dist.cu); 32-feature chunks staged feature-major by
//   coalesced row reads (a warp reads one row's chunk; no index division),
//   so a feature costs two broadcast 16-byte loads of the rows, one
//   16-byte load of the columns and 32 multiply-adds. Warps whose rows
//   are all past m skip the products (m = 100 fills 100 of 128 rows);
// - norms once: threads 0-127 sum the chunk's column norms and threads
//   128-191 the block's row norms (first chunk only) from the staged
//   features, in feature order (sqd_step), while the other warps start
//   their products; sum - kth once a column; d = sqd_sqrt (sqdist.cuh),
//   __fsqrt_rn's bits without its branch;
// - labels: a template on the labels a block counts (NL = L for L <= 4,
//   the label loop unrolled); above 4 labels each block counts a group of
//   4 (grid z) and the distances are recomputed per group, up to
//   CP_MAX_L = 16;
// - 80 registers (3 blocks an SM; a few spill at L = 2): faster than 120
//   registers and 2 blocks.
// On an H100 (700 W) at S 1024, m 100, n 1024, p 30, L 2: 0.53 ms; the
// one-thread-a-row kernel it replaced took 2.04 ms (PERF.md §6).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sqdist.cuh"

#define CP_RM 8                   // rows a warp (and a thread)
#define CP_RN 4                   // consecutive columns a lane
#define CP_WARPS 8
#define CP_BM (CP_WARPS * CP_RM)  // 64 rows a block
#define CP_BN (32 * CP_RN)        // 128 columns a chunk
#define CP_PC 32                  // features a chunk
#define CP_LG 4                   // labels a block counts at most
#define CP_MAX_L 16

template <int NL>
__global__ void __launch_bounds__(CP_WARPS * 32, 3) cp_knn_counts_kernel(
    const float* __restrict__ X, int64_t sX, const int* __restrict__ y,
    const float* __restrict__ sums, const float* __restrict__ kth,
    const float* __restrict__ Xt, int64_t sXt,
    const float* __restrict__ alpha, int* __restrict__ out, int n, int m,
    int p, int L) {
  // pitch = 4 (mod 32): 16-byte aligned rows, 4-way conflicts on staging
  __shared__ __align__(16) float As[CP_PC][CP_BM + 4];
  __shared__ __align__(16) float Bs[CP_PC][CP_BN + 4];
  __shared__ float a2s[CP_BM], als[CP_BM][NL];
  __shared__ __align__(16) float b2s[CP_BN], sus[CP_BN], kts[CP_BN],
      sks[CP_BN];
  __shared__ __align__(16) int ys[CP_BN];

  const int s = blockIdx.y, l0 = blockIdx.z * NL;
  const int row0 = blockIdx.x * CP_BM;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int r0 = warp * CP_RM, c0 = lane * CP_RN;
  const bool rows_live = row0 + r0 < m;
  const float* Ab = Xt + s * sXt;
  const float* Bb = X + s * sX;
  const int64_t col_base = (int64_t)s * n;

  // the rows' alphas of this block's labels (NaN past L: never counted)
  for (int e = t; e < CP_BM * NL; e += CP_WARPS * 32) {
    const int r = e / NL, l = e % NL, row = row0 + r;
    als[r][l] = (row < m && l0 + l < L)
                    ? alpha[((int64_t)s * m + row) * L + l0 + l]
                    : CUDART_NAN_F;
  }
  // thread t < 128 sums column t's |x|^2 of every chunk; 128 <= t < 192
  // row t - 128's, in the first chunk
  const bool norm_col = t < CP_BN;
  const bool norm_row = !norm_col && t < CP_BN + CP_BM;
  float an = 0.f;

  int cnt[CP_RM][NL];
#pragma unroll
  for (int i = 0; i < CP_RM; ++i)
#pragma unroll
    for (int l = 0; l < NL; ++l) cnt[i][l] = 0;

  for (int j0 = 0; j0 < n; j0 += CP_BN) {
    const bool stage_a = j0 == 0 || p > CP_PC;  // A stays for p <= 32
    float bn = 0.f;
    float acc[CP_RM][CP_RN];
#pragma unroll
    for (int i = 0; i < CP_RM; ++i)
#pragma unroll
      for (int j = 0; j < CP_RN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < p; k0 += CP_PC) {
      const int kk = min(CP_PC, p - k0);
      const int f = k0 + lane;
      if (stage_a) {
        for (int r = warp; r < CP_BM; r += CP_WARPS) {
          const int ra = row0 + r;
          As[lane][r] = (ra < m && lane < kk) ? Ab[(int64_t)ra * p + f] : 0.f;
        }
      }
      for (int r = warp; r < CP_BN; r += CP_WARPS) {
        const int rb = j0 + r;
        Bs[lane][r] = (rb < n && lane < kk) ? Bb[(int64_t)rb * p + f] : 0.f;
      }
      __syncthreads();
      if (norm_col) {
        for (int j = 0; j < kk; ++j) bn = sqd_step(bn, Bs[j][t], Bs[j][t]);
      } else if (norm_row && j0 == 0) {
        const int r = t - CP_BN;
        for (int j = 0; j < kk; ++j) an = sqd_step(an, As[j][r], As[j][r]);
      }
      if (rows_live) {
        for (int j = 0; j < kk; ++j) {
          float a[CP_RM];
#pragma unroll
          for (int i = 0; i < CP_RM; i += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(&As[j][r0 + i]);
            a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
          }
          const float4 b = *reinterpret_cast<const float4*>(&Bs[j][c0]);
#pragma unroll
          for (int i = 0; i < CP_RM; ++i) {
            acc[i][0] = sqd_step(acc[i][0], a[i], b.x);
            acc[i][1] = sqd_step(acc[i][1], a[i], b.y);
            acc[i][2] = sqd_step(acc[i][2], a[i], b.z);
            acc[i][3] = sqd_step(acc[i][3], a[i], b.w);
          }
        }
      }
      if (k0 + CP_PC >= p) {  // the chunk's column statistics
        if (norm_col) {
          const int c = j0 + t;
          const bool in = c < n;  // padding: label -1, NaN never counts
          const float su = in ? sums[col_base + c] : CUDART_NAN_F;
          const float kt = in ? kth[col_base + c] : CUDART_NAN_F;
          b2s[t] = bn;
          ys[t] = in ? y[col_base + c] : -1;
          sus[t] = su;
          kts[t] = kt;
          sks[t] = __fsub_rn(su, kt);
        } else if (norm_row && j0 == 0) {
          a2s[t - CP_BN] = an;
        }
      }
      __syncthreads();
    }
    if (rows_live) {
      const float4 vb2 = *reinterpret_cast<const float4*>(&b2s[c0]);
      const float4 vsu = *reinterpret_cast<const float4*>(&sus[c0]);
      const float4 vkt = *reinterpret_cast<const float4*>(&kts[c0]);
      const float4 vsk = *reinterpret_cast<const float4*>(&sks[c0]);
      const int4 vy = *reinterpret_cast<const int4*>(&ys[c0]);
      const float b2[CP_RN] = {vb2.x, vb2.y, vb2.z, vb2.w};
      const float su[CP_RN] = {vsu.x, vsu.y, vsu.z, vsu.w};
      const float kt[CP_RN] = {vkt.x, vkt.y, vkt.z, vkt.w};
      const float sk[CP_RN] = {vsk.x, vsk.y, vsk.z, vsk.w};
      const int lab[CP_RN] = {vy.x - l0, vy.y - l0, vy.z - l0, vy.w - l0};
#pragma unroll
      for (int i = 0; i < CP_RM; ++i) {
        const float an_i = a2s[r0 + i];
        float al[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) al[l] = als[r0 + i][l];
#pragma unroll
        for (int j = 0; j < CP_RN; ++j) {
          const float d2 = sqd_combine(an_i, b2[j], acc[i][j]);
          const float d = sqd_sqrt(d2 < 0.f ? 0.f : d2);
          const float v = d < kt[j] ? __fadd_rn(sk[j], d) : su[j];
#pragma unroll
          for (int l = 0; l < NL; ++l)
            cnt[i][l] += ((lab[j] == l ? v : su[j]) >= al[l]) ? 1 : 0;
        }
      }
    }
  }
  if (!rows_live) return;
  // the 32 lanes of a warp share its rows: add their counts
#pragma unroll
  for (int i = 0; i < CP_RM; ++i) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      int v = cnt[i][l];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      cnt[i][l] = v;
    }
    const int row = row0 + r0 + i;
    if (lane == i && row < m) {
#pragma unroll
      for (int l = 0; l < NL; ++l)
        if (l0 + l < L) out[((int64_t)s * m + row) * L + l0 + l] = cnt[i][l];
    }
  }
}

template <int NL>
static int launch(const void* X, int64_t sX, const void* y, const void* sums,
                  const void* kth, const void* Xt, int64_t sXt,
                  const void* alpha, void* out, int S, int n, int m, int p,
                  int L, cudaStream_t st) {
  dim3 grid((m + CP_BM - 1) / CP_BM, S, (L + NL - 1) / NL);
  cp_knn_counts_kernel<NL><<<grid, CP_WARPS * 32, 0, st>>>(
      (const float*)X, sX, (const int*)y, (const float*)sums,
      (const float*)kth, (const float*)Xt, sXt, (const float*)alpha,
      (int*)out, n, m, p, L);
  return (int)cudaGetLastError();
}

extern "C" int rt_cp_knn_counts(const void* X, int64_t sX, const void* y,
                                const void* sums, const void* kth,
                                const void* Xt, int64_t sXt,
                                const void* alpha, void* out, int S, int n,
                                int m, int p, int L, void* stream) {
  if (L < 1 || L > CP_MAX_L || p < 1) return (int)cudaErrorInvalidValue;
  if (S == 0 || m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return (int)cudaMemsetAsync(out, 0, sizeof(int) * S * m * L, st);
  switch (L) {
    case 1:
      return launch<1>(X, sX, y, sums, kth, Xt, sXt, alpha, out, S, n, m, p,
                       L, st);
    case 2:
      return launch<2>(X, sX, y, sums, kth, Xt, sXt, alpha, out, S, n, m, p,
                       L, st);
    case 3:
      return launch<3>(X, sX, y, sums, kth, Xt, sXt, alpha, out, S, n, m, p,
                       L, st);
    default:
      return launch<CP_LG>(X, sX, y, sums, kth, Xt, sXt, alpha, out, S, n,
                           m, p, L, st);
  }
}

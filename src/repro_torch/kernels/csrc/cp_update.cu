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
// with d = sqrt(max(|x_t|^2 + |x_i|^2 - 2 x_t.x_i, 0)) computed in the
// fixed-order round-to-nearest arithmetic of pairwise_dist.cu. Padded or
// non-live columns carry label -1 and sum -BIG and are never counted.
//
// Bound: the S*m*n*(2p + ~4) flops of the fused distance and update, well
// above the bytes it reads (X once per block, held in shared memory).
// Design: the TPU kernel walks the training columns on a sequential grid
// axis and carries the counts in its output block (pl.when(j == 0)
// initialisation); blocks run in no order here, so one block owns a
// (tenant, tile of 128 test rows) pair and loops over all n columns
// itself, staging 64 columns at a time in shared memory. Counts stay in
// registers (L <= 16): no atomics, no second pass. Test rows sit in shared
// memory with an odd pitch (p + 1 for even p) so each thread reads its own
// row without bank conflicts while the column operand is a broadcast.
#include <cuda_runtime.h>
#include <stdint.h>

#define CP_TM 128
#define CP_TN 64
#define CP_MAX_L 16

__global__ void cp_knn_counts_kernel(
    const float* __restrict__ X, int64_t sX, const int* __restrict__ y,
    const float* __restrict__ sums, const float* __restrict__ kth,
    const float* __restrict__ Xt, int64_t sXt,
    const float* __restrict__ alpha, int* __restrict__ out, int n, int m,
    int p, int L, int pitch) {
  extern __shared__ float sh[];
  float* xt = sh;                     // CP_TM * pitch
  float* xb = xt + CP_TM * pitch;     // CP_TN * pitch
  float* b2s = xb + CP_TN * pitch;    // CP_TN
  float* ss = b2s + CP_TN;            // CP_TN
  float* ks = ss + CP_TN;             // CP_TN
  int* ys = (int*)(ks + CP_TN);       // CP_TN

  const int s = blockIdx.y;
  const int r0 = blockIdx.x * CP_TM;
  const int t = threadIdx.x;
  const float* Xb = X + (int64_t)s * sX;
  const float* Xtb = Xt + (int64_t)s * sXt;
  const int64_t col_base = (int64_t)s * n;

  for (int e = t; e < CP_TM * p; e += blockDim.x) {
    const int r = e / p, f = e - (e / p) * p;
    xt[r * pitch + f] = (r0 + r < m) ? Xtb[(int64_t)(r0 + r) * p + f] : 0.f;
  }
  __syncthreads();

  const int row = r0 + t;
  const bool active = row < m;
  const float* xr = xt + t * pitch;
  float a2 = 0.f;
  for (int f = 0; f < p; ++f) a2 = __fadd_rn(a2, __fmul_rn(xr[f], xr[f]));
  float al[CP_MAX_L];
  int cnt[CP_MAX_L];
#pragma unroll
  for (int l = 0; l < CP_MAX_L; ++l) {
    cnt[l] = 0;
    al[l] = (l < L && active) ? alpha[((int64_t)s * m + row) * L + l] : 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += CP_TN) {
    const int tn = min(CP_TN, n - j0);
    for (int e = t; e < tn * p; e += blockDim.x) {
      const int c = e / p, f = e - (e / p) * p;
      xb[c * pitch + f] = Xb[(int64_t)(j0 + c) * p + f];
    }
    if (t < tn) {
      ys[t] = y[col_base + j0 + t];
      ss[t] = sums[col_base + j0 + t];
      ks[t] = kth[col_base + j0 + t];
    }
    __syncthreads();
    if (t < tn) {
      const float* xc = xb + t * pitch;
      float b2 = 0.f;
      for (int f = 0; f < p; ++f) b2 = __fadd_rn(b2, __fmul_rn(xc[f], xc[f]));
      b2s[t] = b2;
    }
    __syncthreads();
    if (active) {
      for (int c = 0; c < tn; ++c) {
        const float* xc = xb + c * pitch;
        float ab = 0.f;
        for (int f = 0; f < p; ++f) ab = __fadd_rn(ab, __fmul_rn(xr[f], xc[f]));
        const float d2 = __fsub_rn(__fadd_rn(a2, b2s[c]), 2.f * ab);
        const float d = sqrtf(d2 < 0.f ? 0.f : d2);
        const int lab = ys[c];
        const float su = ss[c], kt = ks[c];
        const bool closer = d < kt;
        const float upd = __fadd_rn(__fsub_rn(su, kt), d);
#pragma unroll
        for (int l = 0; l < CP_MAX_L; ++l) {
          if (l < L) {
            const float a = (lab == l && closer) ? upd : su;
            cnt[l] += (a >= al[l]) ? 1 : 0;
          }
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int l = 0; l < CP_MAX_L; ++l)
      if (l < L) out[((int64_t)s * m + row) * L + l] = cnt[l];
  }
}

extern "C" int rt_cp_knn_counts(const void* X, int64_t sX, const void* y,
                                const void* sums, const void* kth,
                                const void* Xt, int64_t sXt,
                                const void* alpha, void* out, int S, int n,
                                int m, int p, int L, void* stream) {
  if (L < 1 || L > CP_MAX_L) return (int)cudaErrorInvalidValue;
  const int pitch = p | 1;  // odd pitch: conflict-free per-thread rows
  const size_t smem =
      ((size_t)(CP_TM + CP_TN) * pitch + 3 * CP_TN) * sizeof(float) +
      CP_TN * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cp_knn_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((m + CP_TM - 1) / CP_TM, S);
  cp_knn_counts_kernel<<<grid, CP_TM, smem, (cudaStream_t)stream>>>(
      (const float*)X, sX, (const int*)y, (const float*)sums,
      (const float*)kth, (const float*)Xt, sXt, (const float*)alpha,
      (int*)out, n, m, p, L, pitch);
  return (int)cudaGetLastError();
}

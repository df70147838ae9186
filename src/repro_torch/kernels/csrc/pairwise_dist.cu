// Batched pairwise squared Euclidean distances.
//
// Replaces: repro/kernels/pairwise_dist.py::pairwise_sq_dists (the Pallas
// MXU kernel, vmapped per tenant by the JAX engine's predict).
//
// out[s, i, j] = (|A[s,i]|^2 + |B[s,j]|^2) - 2 * (A[s,i] . B[s,j]), the
// formula of sqdist.cuh: every sum in fixed order over p with explicit
// round-to-nearest multiply and add (kde_rowsums' d2 is the same bits). No
// tensor cores and no TF32: the kernel does its own arithmetic.
// Row-decomposable: each output is computed by one thread in an order
// that depends neither on m, on the tile nor on the launch shape, which
// the streaming regression state relies on (a row computed alone equals
// that row of the full matrix).
//
// Bound: at p = 30 the output bytes (4*S*m*n) dominate the inputs; the
// 3p + 3 flops an output are the other limit, near it at a k-NN fit's
// row block (2,684 x 100,000). Without FMA the products cost 2p issued
// instructions an output, so the design keeps everything else off that
// count. Design: a first launch computes every row's squared norm once
// (one thread a row, fixed order). Then 64 x 128 output tiles: A's and
// B's rows staged in shared memory feature-major in 32-feature chunks
// (a warp reads one row's chunk, coalesced); each warp owns 8 rows and
// each lane 4 consecutive columns, so a feature costs two broadcast
// 16-byte loads of A, one 16-byte load of B and 32 multiply-adds, and a
// lane's 4 outputs of a row leave as one 16-byte store (a warp writes 512
// contiguous bytes) where n is a multiple of 4. Warps whose rows are past m
// skip the products (the serving read's m = 100 fills 100 of 128 rows).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sqdist.cuh"

#define PD_RM 8                  // rows a warp (and a thread)
#define PD_RN 4                  // consecutive columns a lane
#define PD_WARPS 8
#define PD_BM (PD_WARPS * PD_RM)  // 64 rows a block
#define PD_BN (32 * PD_RN)        // 128 columns a block
#define PD_PC 32                  // features a chunk

// |row|^2 of every tenant's A rows into a2 (S, m) and B rows into b2 (S, n)
__global__ void pairwise_norms_kernel(const float* __restrict__ A,
                                      int64_t sA,
                                      const float* __restrict__ B,
                                      int64_t sB, float* __restrict__ a2,
                                      float* __restrict__ b2, int m, int n,
                                      int p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (r >= m + n) return;
  if (r < m)
    a2[(int64_t)s * m + r] = sqd_norm(A + s * sA + (int64_t)r * p, p);
  else
    b2[(int64_t)s * n + r - m] =
        sqd_norm(B + s * sB + (int64_t)(r - m) * p, p);
}

__global__ void __launch_bounds__(PD_WARPS * 32) pairwise_sq_dists_kernel(
    const float* __restrict__ A, int64_t sA, const float* __restrict__ B,
    int64_t sB, const float* __restrict__ a2, const float* __restrict__ b2,
    float* __restrict__ out, int m, int n, int p) {
  // pitch = 4 (mod 32): 16-byte aligned rows, 4-way conflicts on staging
  __shared__ __align__(16) float As[PD_PC][PD_BM + 4];
  __shared__ __align__(16) float Bs[PD_PC][PD_BN + 4];
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * PD_BM, col0 = blockIdx.x * PD_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * PD_RM, c0 = lane * PD_RN;
  const bool live = row0 + r0 < m;
  const float* Ab = A + s * sA;
  const float* Bb = B + s * sB;

  float acc[PD_RM][PD_RN];
#pragma unroll
  for (int i = 0; i < PD_RM; ++i)
#pragma unroll
    for (int j = 0; j < PD_RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p; k0 += PD_PC) {
    const int kk = min(PD_PC, p - k0);
    const int f = k0 + lane;
    for (int r = warp; r < PD_BM; r += PD_WARPS) {
      const int ra = row0 + r;
      As[lane][r] = (ra < m && lane < kk) ? Ab[(int64_t)ra * p + f] : 0.f;
    }
    for (int r = warp; r < PD_BN; r += PD_WARPS) {
      const int rb = col0 + r;
      Bs[lane][r] = (rb < n && lane < kk) ? Bb[(int64_t)rb * p + f] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < kk; ++k) {
        float a[PD_RM];
#pragma unroll
        for (int i = 0; i < PD_RM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&As[k][r0 + i]);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][c0]);
#pragma unroll
        for (int i = 0; i < PD_RM; ++i) {
          acc[i][0] = sqd_step(acc[i][0], a[i], b.x);
          acc[i][1] = sqd_step(acc[i][1], a[i], b.y);
          acc[i][2] = sqd_step(acc[i][2], a[i], b.z);
          acc[i][3] = sqd_step(acc[i][3], a[i], b.w);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const int col = col0 + c0;
  if (col >= n) return;
  float bn[PD_RN];
#pragma unroll
  for (int j = 0; j < PD_RN; ++j)
    bn[j] = col + j < n ? b2[(int64_t)s * n + col + j] : 0.f;
  const bool vec = (n % 4 == 0);  // then col + 3 < n and 16-byte aligned
#pragma unroll
  for (int i = 0; i < PD_RM; ++i) {
    const int row = row0 + r0 + i;
    if (row >= m) break;
    const float an = a2[(int64_t)s * m + row];
    float d[PD_RN];
#pragma unroll
    for (int j = 0; j < PD_RN; ++j) d[j] = sqd_combine(an, bn[j], acc[i][j]);
    float* o = out + ((int64_t)s * m + row) * n + col;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int j = 0; j < PD_RN; ++j)
        if (col + j < n) o[j] = d[j];
    }
  }
}

// norms: S * (m + n) floats of scratch the caller allocates.
extern "C" int rt_pairwise_sq_dists(const void* A, int64_t sA,
                                    const void* B, int64_t sB, void* norms,
                                    void* out, int S, int m, int n, int p,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0 || m == 0 || n == 0) return 0;
  float* a2 = (float*)norms;
  float* b2 = a2 + (int64_t)S * m;
  pairwise_norms_kernel<<<dim3((m + n + 255) / 256, S), 256, 0, st>>>(
      (const float*)A, sA, (const float*)B, sB, a2, b2, m, n, p);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 grid((n + PD_BN - 1) / PD_BN, (m + PD_BM - 1) / PD_BM, S);
  pairwise_sq_dists_kernel<<<grid, PD_WARPS * 32, 0, st>>>(
      (const float*)A, sA, (const float*)B, sB, a2, b2, (float*)out, m, n,
      p);
  return (int)cudaGetLastError();
}

// Batched pairwise squared Euclidean distances.
//
// Replaces: repro/kernels/pairwise_dist.py::pairwise_sq_dists (the Pallas
// MXU kernel, vmapped per tenant by the JAX engine's predict).
//
// out[s, i, j] = (|A[s,i]|^2 + |B[s,j]|^2) - 2 * (A[s,i] . B[s,j]), every
// sum in fixed order over p with explicit round-to-nearest multiply and
// add. No tensor cores and no TF32: the kernel does its own arithmetic.
// Row-decomposable: each output is computed by one thread in an order
// that depends neither on m, on the tile nor on the launch shape, which
// the streaming regression state relies on (a row computed alone equals
// that row of the full matrix).
//
// Bound: at p = 30 the output bytes (4*S*m*n) dominate the inputs and the
// 3*p flops per output stay far below the card's f32 rate, so the kernel
// is bound by memory. Design: 32x32 output tiles; A and B rows are staged
// in shared memory in 32-feature chunks (row pitch 33, conflict-free);
// each of the 256 threads owns four outputs of one column, so the writes
// of a warp are 128 contiguous bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#define PD_T 32
#define PD_ROWS 8

__global__ void pairwise_sq_dists_kernel(
    const float* __restrict__ A, int64_t sA, const float* __restrict__ B,
    int64_t sB, float* __restrict__ out, int m, int n, int p) {
  __shared__ float As[PD_T][PD_T + 1];
  __shared__ float Bs[PD_T][PD_T + 1];
  const int s = blockIdx.z;
  const int row0 = blockIdx.y * PD_T, col0 = blockIdx.x * PD_T;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* Ab = A + (int64_t)s * sA;
  const float* Bb = B + (int64_t)s * sB;

  float ab[PD_T / PD_ROWS], a2[PD_T / PD_ROWS];
#pragma unroll
  for (int q = 0; q < PD_T / PD_ROWS; ++q) ab[q] = a2[q] = 0.f;
  float b2 = 0.f;

  for (int k0 = 0; k0 < p; k0 += PD_T) {
    const int f = k0 + tx;
    for (int r = ty; r < PD_T; r += PD_ROWS) {
      const int ra = row0 + r, rb = col0 + r;
      As[r][tx] = (ra < m && f < p) ? Ab[(int64_t)ra * p + f] : 0.f;
      Bs[r][tx] = (rb < n && f < p) ? Bb[(int64_t)rb * p + f] : 0.f;
    }
    __syncthreads();
    const int kk = min(PD_T, p - k0);
    for (int j = 0; j < kk; ++j) {
      const float b = Bs[tx][j];
      b2 = __fadd_rn(b2, __fmul_rn(b, b));
#pragma unroll
      for (int q = 0; q < PD_T / PD_ROWS; ++q) {
        const float a = As[ty + PD_ROWS * q][j];
        ab[q] = __fadd_rn(ab[q], __fmul_rn(a, b));
        a2[q] = __fadd_rn(a2[q], __fmul_rn(a, a));
      }
    }
    __syncthreads();
  }
  const int col = col0 + tx;
  if (col >= n) return;
#pragma unroll
  for (int q = 0; q < PD_T / PD_ROWS; ++q) {
    const int row = row0 + ty + PD_ROWS * q;
    if (row < m)
      out[((int64_t)s * m + row) * n + col] =
          __fsub_rn(__fadd_rn(a2[q], b2), 2.f * ab[q]);
  }
}

extern "C" int rt_pairwise_sq_dists(const void* A, int64_t sA,
                                    const void* B, int64_t sB, void* out,
                                    int S, int m, int n, int p,
                                    void* stream) {
  dim3 grid((n + PD_T - 1) / PD_T, (m + PD_T - 1) / PD_T, S);
  dim3 block(PD_T, PD_ROWS);
  pairwise_sq_dists_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)A, sA, (const float*)B, sB, (float*)out, m, n, p);
  return (int)cudaGetLastError();
}

// Masked Gaussian-kernel row sums, the KDE measure's training phase.
//
// Replaces: repro/kernels/kde_score.py::kde_rowsums (the Pallas kernel that
// carries a (bm, 1) accumulator across the sequential n-tile grid axis).
//
// out[i] = sum_j [y_B[j] == y_A[i]] [j != i if exclude_diag]
//                * exp(-max(d2_ij, 0) / den),      den = f32(2 h^2)
// d2_ij  = (|A_i|^2 + |B_j|^2) - 2 A_i.B_j, every sum over p in fixed order
// with explicit round-to-nearest multiplies and adds (the pairwise
// kernel's form: d2_ij equals pairwise_sq_dists' entry bit for bit).
//
// Two output forms. Given y_A, one sum per row (out (m,), the target label
// y_A[i]: the fit's form). Without y_A (NULL), one sum per row and label:
// out (m, L), out[i, l] over the columns of label l (a read's form: every
// candidate label of a test point from one pass over the training set). A
// column adds to its own label's sum only, the same bits as adding 0 to
// the others (every sum is +0 or positive).
//
// Each sum over j runs strictly left to right, one rounding per add, in
// one thread. That order is what makes the KDE measure's exact properties
// hold by construction: a row's sum does not depend on m, on the tile or
// on the launch shape; the sum over [X; x] with the new column last equals
// prelim_i + kv_i (incremental == refit, optimized == standard). Any later
// redesign (split over j, tree reductions, atomics) must keep this order
// or give those properties up.
//
// exp is the CUDA math library's expf, the function torch.exp calls on a
// float32 CUDA tensor (kde_expf exposes it for that check); the division is
// __fdiv_rn, IEEE like the plain version's tensor division. No fast math
// and no flush-to-zero: far pairs reach the denormal range.
//
// Bound: ~(2p + 5) flops per (i, j) pair against ~4(m + n)(p + 1) bytes,
// so at the KDE fit's shapes (m = n = 1e5, p = 30) it is bound by
// operations. The fixed order forbids FMA: each multiply and add issues
// alone, so the kernel cannot go below about twice the f32 bound.
//
// Design: the row and column squared norms come from a first launch (one
// thread per row, fixed order). Then one of two layouts, by m against the
// caller's wide_below (the bits are the same: every pair and every sum is
// computed in the same order):
// - rows (the fit): a block of KS_BM threads owns KS_BM rows; columns come
//   in tiles of KS_TB, their features staged in shared memory in chunks of
//   KS_PC (any p works, p = 784 included), stored feature-major so one
//   16-byte broadcast load feeds four columns; each thread keeps KS_TB
//   partial dot products in registers across chunks. A thread's sum lives
//   in a register; the per-label form keeps its L sums in dynamic shared
//   memory, label-major so the block's threads hit distinct banks.
// - wide (few rows, e.g. a read's test points): one block per row, its
//   KW_T threads compute the kernel values of KW_T consecutive columns in
//   parallel into shared memory, and one thread per target label adds them
//   in column order. With few rows the rows layout leaves most SMs idle;
//   with many, the wide layout reads all of B once per row.
// The ragged edges are masked, not padded.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KS_BM 128
#define KS_TB 32
#define KS_PC 32
#define KS_PITCH (KS_TB + 4)
#define KS_MAX_LABELS 256  // per-label form: one summing thread per label
#define KW_T 256
#define KW_MAX_P 11776  // the row's features + vals + labels in 48 KB

__device__ __forceinline__ float kde_exp(float x) { return expf(x); }

__device__ __forceinline__ float kde_val(float a2i, float b2j, float ab,
                                         float den) {
  const float d2 = __fsub_rn(__fadd_rn(a2i, b2j), 2.f * ab);
  return kde_exp(__fdiv_rn(-fmaxf(d2, 0.f), den));
}

__global__ void kde_sumsq_kernel(const float* __restrict__ A, int m,
                                 const float* __restrict__ B, int n, int p,
                                 float* __restrict__ a2,
                                 float* __restrict__ b2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m + n) return;
  const float* row = r < m ? A + (int64_t)r * p : B + (int64_t)(r - m) * p;
  float acc = 0.f;
  for (int f = 0; f < p; ++f) acc = __fadd_rn(acc, __fmul_rn(row[f], row[f]));
  if (r < m)
    a2[r] = acc;
  else
    b2[r - m] = acc;
}

template <bool PER_LABEL>
__global__ void __launch_bounds__(KS_BM) kde_rowsums_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const int* __restrict__ yA, const int* __restrict__ yB,
    const float* __restrict__ a2, const float* __restrict__ b2,
    float* __restrict__ out, int m, int n, int p, int L, float den,
    int exclude_diag) {
  __shared__ float As[KS_BM][KS_PC + 1];
  __shared__ __align__(16) float Bs[KS_PC][KS_PITCH];
  __shared__ float b2s[KS_TB];
  __shared__ int ybs[KS_TB];
  extern __shared__ float accs[];  // per-label form: L x KS_BM sums
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * KS_BM;
  const int i = row0 + t;
  const bool live = i < m;
  const float a2i = live ? a2[i] : 0.f;
  const int yi = (live && !PER_LABEL) ? yA[i] : 0;
  float acc = 0.f;
  if (PER_LABEL)
    for (int l = 0; l < L; ++l) accs[l * KS_BM + t] = 0.f;

  for (int j0 = 0; j0 < n; j0 += KS_TB) {
    const int cnt = min(KS_TB, n - j0);
    float ab[KS_TB];
#pragma unroll
    for (int q = 0; q < KS_TB; ++q) ab[q] = 0.f;
    for (int c0 = 0; c0 < p; c0 += KS_PC) {
      const int kk = min(KS_PC, p - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int e = t; e < KS_BM * KS_PC; e += KS_BM) {
        const int r = e / KS_PC, f = e % KS_PC, ra = row0 + r;
        As[r][f] = (ra < m && f < kk) ? A[(int64_t)ra * p + c0 + f] : 0.f;
      }
      for (int e = t; e < KS_TB * KS_PC; e += KS_BM) {
        const int q = e / KS_PC, f = e % KS_PC;
        Bs[f][q] = (q < cnt && f < kk) ? B[(int64_t)(j0 + q) * p + c0 + f]
                                       : 0.f;
      }
      if (c0 == 0 && t < KS_TB) {
        b2s[t] = t < cnt ? b2[j0 + t] : 0.f;
        ybs[t] = t < cnt ? yB[j0 + t] : 0;
      }
      __syncthreads();
      for (int f = 0; f < kk; ++f) {
        const float a = As[t][f];
#pragma unroll
        for (int q = 0; q < KS_TB; q += 4) {
          const float4 b = *reinterpret_cast<const float4*>(&Bs[f][q]);
          ab[q] = __fadd_rn(ab[q], __fmul_rn(a, b.x));
          ab[q + 1] = __fadd_rn(ab[q + 1], __fmul_rn(a, b.y));
          ab[q + 2] = __fadd_rn(ab[q + 2], __fmul_rn(a, b.z));
          ab[q + 3] = __fadd_rn(ab[q + 3], __fmul_rn(a, b.w));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < KS_TB; ++q) {
      if (q < cnt) {  // columns in order: the sums stay left to right
        const int j = j0 + q;
        const float v = kde_val(a2i, b2s[q], ab[q], den);
        const bool diag = exclude_diag && j == i;
        if (PER_LABEL) {
          const int l = ybs[q];
          if (!diag && l >= 0 && l < L)
            accs[l * KS_BM + t] = __fadd_rn(accs[l * KS_BM + t], v);
        } else {
          acc = __fadd_rn(acc, (ybs[q] == yi && !diag) ? v : 0.f);
        }
      }
    }
  }
  if (!live) return;
  if (PER_LABEL)
    for (int l = 0; l < L; ++l) out[(int64_t)i * L + l] = accs[l * KS_BM + t];
  else
    out[i] = acc;
}

template <bool PER_LABEL>
__global__ void __launch_bounds__(KW_T) kde_rowsums_wide_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const int* __restrict__ yA, const int* __restrict__ yB,
    const float* __restrict__ a2, const float* __restrict__ b2,
    float* __restrict__ out, int n, int p, int L, float den,
    int exclude_diag) {
  extern __shared__ float arow[];  // p floats
  __shared__ float vals[KW_T];
  __shared__ int labs[KW_T];
  const int t = threadIdx.x;
  const int i = blockIdx.x;
  for (int f = t; f < p; f += KW_T) arow[f] = A[(int64_t)i * p + f];
  const float a2i = a2[i];
  const int yi = PER_LABEL ? 0 : yA[i];
  const int nsum = PER_LABEL ? L : 1;  // thread t < nsum sums label t (or yi)
  __syncthreads();
  float acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += KW_T) {
    const int j = j0 + t;
    float v = 0.f;
    int lab = -1;
    if (j < n) {
      const float* b = B + (int64_t)j * p;
      float ab = 0.f;
      for (int f = 0; f < p; ++f) ab = __fadd_rn(ab, __fmul_rn(arow[f], b[f]));
      const float kv = kde_val(a2i, b2[j], ab, den);
      lab = yB[j];
      const bool keep = !(exclude_diag && j == i) && (PER_LABEL || lab == yi);
      v = keep ? kv : 0.f;
    }
    vals[t] = v;
    labs[t] = lab;
    __syncthreads();
    if (t < nsum) {  // columns in order: the sums stay left to right
      const int cnt = min(KW_T, n - j0);
      for (int q = 0; q < cnt; ++q)
        acc = __fadd_rn(acc, (!PER_LABEL || labs[q] == t) ? vals[q] : 0.f);
    }
    __syncthreads();
  }
  if (t < nsum) out[(int64_t)i * nsum + t] = acc;
}

__global__ void kde_expf_kernel(const float* __restrict__ x,
                                float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = kde_exp(x[i]);
}

// a2 (m) and b2 (n) are scratch the caller allocates. yA NULL selects the
// per-label form (out (m, L), 1 <= L <= KS_MAX_LABELS). Fewer rows than
// wide_below take the wide layout (while p fits its shared memory).
extern "C" int rt_kde_rowsums(const void* A, const void* B, const void* yA,
                              const void* yB, void* a2, void* b2, void* out,
                              int m, int n, int p, int L, float den,
                              int exclude_diag, int wide_below,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool per_label = yA == nullptr;
  if (per_label && (L < 1 || L > KS_MAX_LABELS))
    return (int)cudaErrorInvalidValue;
  if (m + n > 0) {
    kde_sumsq_kernel<<<(m + n + 255) / 256, 256, 0, st>>>(
        (const float*)A, m, (const float*)B, n, p, (float*)a2, (float*)b2);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const float* fA = (const float*)A;
  const float* fB = (const float*)B;
  const int* iA = (const int*)yA;
  const int* iB = (const int*)yB;
  const float* fa2 = (const float*)a2;
  const float* fb2 = (const float*)b2;
  float* fo = (float*)out;
  if (m > 0 && m < wide_below && p <= KW_MAX_P) {
    const size_t sh = p * sizeof(float);
    if (per_label)
      kde_rowsums_wide_kernel<true><<<m, KW_T, sh, st>>>(
          fA, fB, iA, iB, fa2, fb2, fo, n, p, L, den, exclude_diag);
    else
      kde_rowsums_wide_kernel<false><<<m, KW_T, sh, st>>>(
          fA, fB, iA, iB, fa2, fb2, fo, n, p, 1, den, exclude_diag);
  } else if (m > 0) {
    const int grid = (m + KS_BM - 1) / KS_BM;
    if (per_label) {
      const int sh = L * KS_BM * (int)sizeof(float);
      const int rc = (int)cudaFuncSetAttribute(
          kde_rowsums_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, sh);
      if (rc != 0) return rc;
      kde_rowsums_kernel<true><<<grid, KS_BM, sh, st>>>(
          fA, fB, iA, iB, fa2, fb2, fo, m, n, p, L, den, exclude_diag);
    } else {
      kde_rowsums_kernel<false><<<grid, KS_BM, 0, st>>>(
          fA, fB, iA, iB, fa2, fb2, fo, m, n, p, 1, den, exclude_diag);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_kde_expf(const void* x, void* y, int64_t n, void* stream) {
  if (n > 0)
    kde_expf_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

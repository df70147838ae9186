// Streaming observe front end, both modes, for the whole tenant batch in
// one launch.
//
// Replaces: repro/kernels/stream_update.py::stream_update (mode="class"
// and mode="reg"), the Pallas kernel the JAX engines vmap once per tenant.
//
// Classification mode, per tenant s and ring-block row i < w:
//   d[s, i]  = sqrt(max(sum_j (X[s,i,j] - x_new[s,j])^2, 0)) if slot i is
//              live under (head, n, wrap), else BIG;
//   L'[s, i] = the ascending k-best list L[s, i] with candidate
//              c = (live && y[s,i] == y_new[s]) ? d : BIG inserted strictly
//              after equal values, largest entry dropped.
//
// Bound: memory. It reads X, y and the lists once and writes d and the
// new lists, about S*w*(4p + 8k + 12) bytes, against ~S*w*(3p + 2k) flops.
// Design: one thread per (tenant, row); x_new[s] sits in shared memory;
// the list (k <= 32) lives in registers behind fully unrolled loops, and
// the insert is the branch-free select pos = #{L[j] <= c}. Ring liveness
// is integer arithmetic. The sum runs in fixed order with explicit
// round-to-nearest multiply and add (no FMA contraction), the order of
// the plain version in ref.py, so the two agree bit for bit. The row
// stride of X is p and of the lists k; tenants are reached by the given
// tenant strides, so the [:w] ring-block views of the capacity-padded
// state are read in place.
//
// Regression mode (rt_stream_update_reg), same layout, per row i:
//   d        = sqrt(max((|x_new|^2 + |X_i|^2) - 2 x_new.X_i, 0)), the
//              fixed-order form of ref.sq_dists, so the row equals
//              pairwise_sq_dists (and the regression fit) bit for bit;
//   d_row[i] = live ? d : BIG;
//   c        = (live && d < L[k-1]) ? d : BIG, strict and on the raw d;
//   L', Y'   = c inserted into the ascending list L strictly after equal
//              values, the label y_new riding along into the label list
//              Y; slots left at BIG carry the row's own label y[i].
// Bound: memory, S*w*(4p + 16k + 8) bytes against ~S*w*(6p + 4k) flops.
#include <cuda_runtime.h>
#include <stdint.h>

#define SU_MAX_K 32
#define SU_THREADS 256
#define SU_BIG 1e30f

__global__ void stream_update_class_kernel(
    const float* __restrict__ X, int64_t sX,
    const int* __restrict__ y, int64_t sy,
    const float* __restrict__ L, int64_t sL,
    const float* __restrict__ x_new, const int* __restrict__ y_new,
    const int* __restrict__ n, const int* __restrict__ head,
    const int* __restrict__ wrap,
    float* __restrict__ d_out, float* __restrict__ L_out,
    int w, int p, int k) {
  extern __shared__ float xs[];
  const int s = blockIdx.y;
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    xs[j] = x_new[(int64_t)s * p + j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;

  const int hd = head[s], m = wrap[s], cnt = n[s];
  const int age = i >= hd ? i - hd : i - hd + m;
  const bool live = (age < cnt) && (i < m);

  const float* xr = X + (int64_t)s * sX + (int64_t)i * p;
  float acc = 0.f;
  for (int j = 0; j < p; ++j) {
    const float t = __fsub_rn(xr[j], xs[j]);
    acc = __fadd_rn(acc, __fmul_rn(t, t));
  }
  const float d = live ? sqrtf(acc < 0.f ? 0.f : acc) : SU_BIG;
  const bool gate = live && (y[(int64_t)s * sy + i] == y_new[s]);
  const float c = gate ? d : SU_BIG;

  const float* lr = L + (int64_t)s * sL + (int64_t)i * k;
  float Lr[SU_MAX_K];
  int pos = 0;
#pragma unroll
  for (int j = 0; j < SU_MAX_K; ++j) {
    if (j < k) {
      Lr[j] = lr[j];
      pos += (Lr[j] <= c) ? 1 : 0;
    }
  }
  float* lo = L_out + ((int64_t)s * w + i) * k;
#pragma unroll
  for (int j = 0; j < SU_MAX_K; ++j) {
    if (j < k) {
      const float prev = Lr[j > 0 ? j - 1 : 0];
      lo[j] = j < pos ? Lr[j] : (j == pos ? c : prev);
    }
  }
  d_out[(int64_t)s * w + i] = d;
}

__global__ void stream_update_reg_kernel(
    const float* __restrict__ X, int64_t sX,
    const float* __restrict__ y, int64_t sy,
    const float* __restrict__ L, int64_t sL,
    const float* __restrict__ Y, int64_t sY,
    const float* __restrict__ x_new, const float* __restrict__ y_new,
    const int* __restrict__ n, const int* __restrict__ head,
    const int* __restrict__ wrap,
    float* __restrict__ d_out, float* __restrict__ L_out,
    float* __restrict__ Y_out, int w, int p, int k) {
  extern __shared__ float xs[];
  const int s = blockIdx.y;
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    xs[j] = x_new[(int64_t)s * p + j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;

  const int hd = head[s], m = wrap[s], cnt = n[s];
  const int age = i >= hd ? i - hd : i - hd + m;
  const bool live = (age < cnt) && (i < m);

  const float* xr = X + (int64_t)s * sX + (int64_t)i * p;
  float xx = 0.f, XX = 0.f, ab = 0.f;
  for (int j = 0; j < p; ++j) {
    const float a = xs[j], b = xr[j];
    xx = __fadd_rn(xx, __fmul_rn(a, a));
    XX = __fadd_rn(XX, __fmul_rn(b, b));
    ab = __fadd_rn(ab, __fmul_rn(a, b));
  }
  const float d2 = __fsub_rn(__fadd_rn(xx, XX), __fmul_rn(2.f, ab));
  const float d = __fsqrt_rn(d2 < 0.f ? 0.f : d2);

  const float* lr = L + (int64_t)s * sL + (int64_t)i * k;
  const float* yr = Y + (int64_t)s * sY + (int64_t)i * k;
  float Lr[SU_MAX_K], Yr[SU_MAX_K];
  float kth = SU_BIG;
#pragma unroll
  for (int j = 0; j < SU_MAX_K; ++j) {
    if (j < k) {
      Lr[j] = lr[j];
      Yr[j] = yr[j];
      if (j == k - 1) kth = Lr[j];
    }
  }
  const float c = (live && d < kth) ? d : SU_BIG;
  int pos = 0;
#pragma unroll
  for (int j = 0; j < SU_MAX_K; ++j)
    if (j < k) pos += (Lr[j] <= c) ? 1 : 0;

  const float yn = y_new[s], yo = y[(int64_t)s * sy + i];
  float* lo = L_out + ((int64_t)s * w + i) * k;
  float* yo_out = Y_out + ((int64_t)s * w + i) * k;
#pragma unroll
  for (int j = 0; j < SU_MAX_K; ++j) {
    if (j < k) {
      const int q = j > 0 ? j - 1 : 0;
      const float v = j < pos ? Lr[j] : (j == pos ? c : Lr[q]);
      const float lab = j < pos ? Yr[j] : (j == pos ? yn : Yr[q]);
      lo[j] = v;
      yo_out[j] = v >= SU_BIG ? yo : lab;
    }
  }
  d_out[(int64_t)s * w + i] = live ? d : SU_BIG;
}

extern "C" int rt_stream_update_reg(
    const void* X, int64_t sX, const void* y, int64_t sy, const void* L,
    int64_t sL, const void* Y, int64_t sY, const void* x_new,
    const void* y_new, const void* n, const void* head, const void* wrap,
    void* d_out, void* L_out, void* Y_out, int S, int w, int p, int k,
    void* stream) {
  if (k < 1 || k > SU_MAX_K) return (int)cudaErrorInvalidValue;
  dim3 grid((w + SU_THREADS - 1) / SU_THREADS, S);
  stream_update_reg_kernel<<<grid, SU_THREADS, p * sizeof(float),
                             (cudaStream_t)stream>>>(
      (const float*)X, sX, (const float*)y, sy, (const float*)L, sL,
      (const float*)Y, sY, (const float*)x_new, (const float*)y_new,
      (const int*)n, (const int*)head, (const int*)wrap, (float*)d_out,
      (float*)L_out, (float*)Y_out, w, p, k);
  return (int)cudaGetLastError();
}

extern "C" int rt_stream_update_class(
    const void* X, int64_t sX, const void* y, int64_t sy, const void* L,
    int64_t sL, const void* x_new, const void* y_new, const void* n,
    const void* head, const void* wrap, void* d_out, void* L_out, int S,
    int w, int p, int k, void* stream) {
  if (k < 1 || k > SU_MAX_K) return (int)cudaErrorInvalidValue;
  dim3 grid((w + SU_THREADS - 1) / SU_THREADS, S);
  stream_update_class_kernel<<<grid, SU_THREADS, p * sizeof(float),
                               (cudaStream_t)stream>>>(
      (const float*)X, sX, (const int*)y, sy, (const float*)L, sL,
      (const float*)x_new, (const int*)y_new, (const int*)n,
      (const int*)head, (const int*)wrap, (float*)d_out, (float*)L_out, w,
      p, k);
  return (int)cudaGetLastError();
}

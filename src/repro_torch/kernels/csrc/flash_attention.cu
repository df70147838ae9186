// Online-softmax attention, the LM substrate's full-sequence path.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel that keeps a (bq, D) accumulator and the running max and
// denominator in VMEM scratch across the sequential kv-grid axis).
//
// q (B, Sq, H, D), k and v (B, Skv, Hkv, D), o like q, all contiguous,
// bf16 or f32 (T); every sum and the softmax in f32. Query head h reads kv
// head h / (H / Hkv): GQA by index, repeated K/V are never formed. Query
// row i sits at position i + Skv - Sq (right-aligned); key j is kept when
// j < Skv, j <= pos if causal, and j > pos - window if window > 0. Logits
// are q.k * scale, then softcap * tanhf(s / softcap) when softcap > 0, then
// masked to NEG_INF = -1e30, finite as in the Pallas body: a row whose
// first live tile holds none of its keys adds exp(0) terms that the first
// real key's alpha = expf(-1e30 - m) = 0 wipes out (-INFINITY would give
// -inf - -inf = NaN there). The output is acc / max(l, 1e-30) in T. No
// fast math: expf, tanhf and the division are the IEEE ones.
//
// Bound: ~4 B H D flops per live (query, key) pair against the bytes of
// q, k, v and o, so at the embedding pass's shape (B 256, S 512, H 12,
// Hkv 2, D 128, causal, bf16) the card's tensor cores would make it
// bound by bytes (~0.28 ms). This first kernel runs its products on the
// f32 CUDA cores (the f32 inputs need full f32 anyway), about 3 ms of
// f32 FMAs at that shape at best; a bf16 tensor-core (wgmma) design is
// later work.
//
// Design: one block of 256 threads per (64-row query tile, head, batch),
// the tiles with the most live key tiles launched first. The query tile
// and each key and value tile are staged in shared memory as f32 (row
// pitch D + 4, so the float4 reads below hit distinct banks). Thread (ty,
// tx) = (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 and keys tx + 16 j
// (j < 4) of the 64 x 64 score tile: per feature step it reads four row
// float4s (broadcast) and four key float4s for 64 FMAs. A row's 64 scores
// sit in one half-warp, so its max and sum are xor-shuffles over 16 lanes;
// the running max, denominator and the row's slice of the accumulator (4
// rows x D/16 features, features tx*4 + 64 t + e) stay in registers. P goes
// to shared memory key-major (over the key tile, whose scores are done)
// and P.V reads one float4 of P and D/64 float4s of V per key. Key tiles
// that no row of the query tile can see (causal, window) are skipped, as
// pl.when(live) does: causal attention does about half the work, windowed
// attention O(S W). Head dims up to 256 are padded with zeros to 64, 128
// or 256 in shared memory; the padded products add exact zeros. The
// kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_NT 256
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float fa_in(float x) { return x; }
__device__ __forceinline__ float fa_in(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T fa_out(float x);
template <>
__device__ __forceinline__ float fa_out<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 fa_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(FA_NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int H,
    int Hkv, int D, int causal, int window, float scale, float softcap) {
  constexpr int PITCH = DP + 4;  // row pitch of the Q, K, V tiles (floats)
  constexpr int PP = FA_BQ + 4;  // pitch of the key-major P tile
  constexpr int DT = DP / 64;    // float4 slices of a row per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [FA_BQ][PITCH]
  float* Ks = Qs + FA_BQ * PITCH;  // [FA_BK][PITCH], then P [FA_BK][PP]
  float* Vs = Ks + FA_BK * PITCH;  // [FA_BK][PITCH]
  float* Ps = Ks;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int shift = Skv - Sq;  // query i sits at position i + shift
  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * Sq * qs + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Skv * ks + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Skv * ks + (int64_t)hk * D;

  for (int e = tid; e < FA_BQ * DP; e += FA_NT) {
    const int r = e / DP, d = e % DP;
    Qs[r * PITCH + d] =
        (q0 + r < Sq && d < D) ? fa_in(qb[(q0 + r) * qs + d]) : 0.f;
  }
  float acc[4][4 * DT];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = FA_NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DT; ++c) acc[i][c] = 0.f;
  }

  const int pos_min = q0 + shift, pos_max = q0 + FA_BQ - 1 + shift;
  const int nk = (Skv + FA_BK - 1) / FA_BK;
  for (int k0 = 0; k0 < nk * FA_BK; k0 += FA_BK) {
    bool live = true;  // some row of the tile sees some key of it
    if (causal) live = k0 <= pos_max;
    if (window > 0) live = live && k0 + FA_BK - 1 > pos_min - window;
    if (!live) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < FA_BK * DP; e += FA_NT) {
      const int c = e / DP, d = e % DP;
      const bool in = k0 + c < Skv && d < D;
      const int64_t g = (k0 + c) * ks + d;
      Ks[c * PITCH + d] = in ? fa_in(kb[g]) : 0.f;
      Vs[c * PITCH + d] = in ? fa_in(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * PITCH + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * PITCH + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every score is read out of Ks: it now takes P

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = pos_min + ty * 4 + i;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = kp < Skv;
        if (causal) keep = keep && kp <= pos;
        if (window > 0) keep = keep && kp > pos - window;
        s[i][j] = keep ? x : FA_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_run[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 4 * DT; ++c) acc[i][c] *= alpha;
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * PP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * PP + ty * 4]);
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(&Vs[c * PITCH + t * 64 + tx * 4]);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * t + 0] = fmaf(pr[i], w4.x, acc[i][4 * t + 0]);
          acc[i][4 * t + 1] = fmaf(pr[i], w4.y, acc[i][4 * t + 1]);
          acc[i][4 * t + 2] = fmaf(pr[i], w4.z, acc[i][4 * t + 2]);
          acc[i][4 * t + 3] = fmaf(pr[i], w4.w, acc[i][4 * t + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
    T* orow = o + (int64_t)b * Sq * qs + r * qs + (int64_t)h * D;
#pragma unroll
    for (int t = 0; t < DT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = t * 64 + tx * 4 + e;
        if (d < D) orow[d] = fa_out<T>(acc[i][4 * t + e] / den);
      }
  }
}

template <typename T, int DP>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int H, int Hkv, int D,
                     int causal, int window, float scale, float softcap,
                     cudaStream_t st) {
  const int sh = (FA_BQ + 2 * FA_BK) * (DP + 4) * (int)sizeof(float);
  const int rc = (int)cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sh);
  if (rc != 0) return rc;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<T, DP><<<grid, FA_NT, sh, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, Hkv, D,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int H, int Hkv, int D,
                       int causal, int window, float scale, float softcap,
                       cudaStream_t st) {
  if (D <= 64)
    return fa_launch<T, 64>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal,
                            window, scale, softcap, st);
  if (D <= 128)
    return fa_launch<T, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal,
                             window, scale, softcap, st);
  return fa_launch<T, 256>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal,
                           window, scale, softcap, st);
}

// bf16 != 0 selects bfloat16 operands, else float32. window <= 0 and
// softcap <= 0 mean none. 1 <= D <= 256, H % Hkv == 0, Skv >= 1, B and H at
// most 65535 (grid dimensions).
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int B, int Sq,
                                  int Skv, int H, int Hkv, int D, int bf16,
                                  int causal, int window, float scale,
                                  float softcap, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || Skv < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return fa_dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D,
                                      causal, window, scale, softcap, st);
  return fa_dispatch<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal,
                            window, scale, softcap, st);
}

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
// -inf - -inf = NaN there). P stays f32. The output is acc / max(l, 1e-30)
// in T. No fast math: expf, tanhf and the division are the IEEE ones.
//
// Bound: ~4 B H D flops per live (query, key) pair against the bytes of
// q, k, v and o. At the embedding pass's shape (B 256, S 512, H 12, Hkv 2,
// D 128, causal, bf16) that is 2.07e11 flops, 0.21 ms at the 989 TFLOP/s
// of the bf16 tensor cores, against 0.28 ms for the bytes: bound by bytes
// once the products run on the tensor cores, and by the f32 CUDA cores
// (67 TFLOP/s, ~3 ms) while they do not.
//
// bf16 body (fa_bf16_kernel): a persistent block on each SM, of two
// consumer warpgroups (64 query rows each) and one producer warp. The
// block walks (128-row query tile, head, batch) items, those with the most
// live key tiles first. Q (two buffers) and a ring of 64-key K and V tiles
// (four stages at D <= 128) stay bf16 in shared memory, in 64-column
// chunks of 64 rows x 128 B with the 128-byte swizzle that both TMA and the
// wgmma descriptors read. Where the strides allow (D % 8 == 0, 16-byte
// aligned bases) the producer fills them with TMA (cp.async.bulk.tensor,
// full and empty mbarriers per stage) while the consumers compute; TMA's
// out-of-bounds fill gives the zero padding of the head dim and of the
// ragged tiles. Elsewhere (a head dim off a multiple of 8) the producer
// warp fills the same layout with plain loads, much more slowly. Both
// warpgroups share each K/V tile; each computes only on the tiles some row
// of its own sees (as pl.when(live) skips the rest), and masks element by
// element only the tiles that cross the diagonal, the window's edge or the
// end of the keys.
//
// S = Q.K^T is wgmma m64n64k16 with both operands in shared memory:
// bf16 x bf16 products are exact in f32, so only the order of the f32 sum
// differs from the plain version's. The 64 x 64 scores stay in the
// accumulator registers for the softmax (a row's 16 values in a thread,
// its maximum and sum over a quad of lanes), in log2 units so that one
// ex2.approx a score gives P (relative error ~1e-6 at the scores that
// matter). P.V keeps P in f32 through a split: P_hi = bf16_rn(P) and P_lo
// = bf16_rn(P - P_hi) (the difference is exact in f32) are two register A
// operands of wgmma m64n64k16 against V, read transposed through its
// descriptor, into one f32 accumulator per 64 columns of the head dim. V is
// exact in bf16, so what is lost is P_lo's rounding, at most 2^-16 |P| and
// far less on average. Rounding P once to bf16, as tensor-core attention
// usually does, loses up to 2^-8 |P|, about 1e-4 at outputs that cancel
// near zero: another function, on which one bf16 ulp of the plain output
// plus 1e-5 does not hold. The second product costs half the useful flops
// again. The output goes out by TMA through the warpgroup's Q tile.
//
// At the embedding pass's shape the kernel is bound by neither bytes nor
// tensor-core flops but by the softmax on the CUDA cores (its ex2 and bf16
// conversions run at a quarter of the FMA rate) and by how little of it
// overlaps the products: the two warpgroups of an SM interleave, each one's
// own products and softmax run one after the other.
//
// f32 body (flash_attention_kernel): the f32 inputs need full f32 (TF32
// keeps 10 mantissa bits), so its products stay f32 FMAs on the CUDA
// cores. One block of 256 threads per (64-row query tile, head, batch).
// The query tile and each key and value tile are staged in shared memory
// (row pitch D + 4, so the float4 reads below hit distinct banks). Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 and keys tx +
// 16 j (j < 4) of the 64 x 64 score tile: per feature step it reads four
// row float4s (broadcast) and four key float4s for 64 FMAs. A row's 64
// scores sit in one half-warp, so its max and sum are xor-shuffles over 16
// lanes; the running max, denominator and the row's slice of the
// accumulator (4 rows x D/16 features, features tx*4 + 64 t + e) stay in
// registers. P goes to shared memory key-major (over the key tile, whose
// scores are done) and P.V reads one float4 of P and D/64 float4s of V per
// key. Key tiles that no row of the query tile can see are skipped. Head
// dims up to 256 are padded with zeros to 64, 128 or 256 in shared memory;
// the padded products add exact zeros.
//
// Both bodies launch once per call on the caller's stream and allocate
// nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define FA_NEG_INF (-1e30f)

// ---------------------------------------------------------------------------
// f32 body: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

#define FA_BQ 64
#define FA_BK 64
#define FA_NT 256

__device__ __forceinline__ float fa_in(float x) { return x; }
template <typename T>
__device__ __forceinline__ T fa_out(float x);
template <>
__device__ __forceinline__ float fa_out<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bf16 body: wgmma on the tensor cores, TMA, P split in two bf16 parts
// ---------------------------------------------------------------------------

#define FB_BQ 64       // query rows a consumer warpgroup
#define FB_WG 2        // consumer warpgroups a block, on one K/V ring
#define FB_BK 64       // keys a tile
#define FB_NT (128 * FB_WG + 32)  // the consumers, then a producer warp
#define FB_CHUNK 8192  // 64 rows x 64 bf16 columns (128 B rows), swizzled

__device__ __forceinline__ uint32_t fb_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma descriptor of a 128-byte-swizzled operand whose 1024-byte atoms
// (8 rows of 128 B) start on 1024-byte boundaries: start address, leading
// byte offset (between 64-column chunks of an MN-major operand; unused
// here), stride byte offset (between 8-row groups), layout 1 = 128B.
__device__ __forceinline__ uint64_t fb_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(FB_CHUNK >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fb_mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fb_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void fb_mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fb_mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nFB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra FB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 64 x 64 box of a (D, heads, rows, B) map into a swizzled chunk.
__device__ __forceinline__ void fb_tma(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int d0, int head,
                                       int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(d0), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// The inverse: a swizzled 64 x 64 chunk out to a (D, heads, rows, B) map.
__device__ __forceinline__ void fb_tma_store(const CUtensorMap* map,
                                             uint32_t src, int d0, int head,
                                             int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"((uint64_t)map),
      "r"(src), "r"(d0), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// The 128 threads of consumer warpgroup g (named barrier 1 + g).
__device__ __forceinline__ void fb_wg_bar(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
}

__device__ __forceinline__ void fb_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void fb_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N commit groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void fb_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pins wgmma's register operands in place around the asynchronous
// products: their values are set before wgmma.fence, and read only after
// the wait (the asm below names them as outputs when it is issued). A
// register written between fence and wait makes ptxas serialize the
// products.
__device__ __forceinline__ void fb_fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fb_fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// The 32 accumulator registers of a thread in an m64n64 wgmma, as asm
// operands %0..%31.
#define FB_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FB_ACC(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem,
// K-major: 64 rows of keys)
__device__ __forceinline__ void fb_wgmma_ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      FB_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FB_ACC(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major:
// 16 rows of keys, each 64 head-dim values, read transposed)
__device__ __forceinline__ void fb_wgmma_rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      FB_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FB_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special function unit (ex2.approx.ftz: relative error about
// 2^-22). With the logits in log2 units, e^(s - m) = 2^(s l - m l) for l =
// log2(e); the product's rounding adds |s l| 2^-24 to the exponent: about
// 1e-6 of P at s - m = -20, against the 2^-9 of one bf16 ulp of the output.
__device__ __forceinline__ float fb_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Plain loads of a (64 rows, D) tile into NC swizzled chunks by the 32
// lanes of the producer warp, zeros past `rows` and D: the layout TMA
// writes, for strides it cannot take.
template <int NC>
__device__ __forceinline__ void fb_fill(uint8_t* dst,
                                        const __nv_bfloat16* src,
                                        int64_t row_stride, int rows, int D) {
  for (int e = threadIdx.x & 31; e < 64 * NC * 64; e += 32) {
    const int r = e / (NC * 64), c = e % (NC * 64), cc = c & 63;
    const __nv_bfloat16 x = (r < rows && c < D)
                                ? src[r * row_stride + c]
                                : __float2bfloat16_rn(0.f);
    *reinterpret_cast<__nv_bfloat16*>(
        dst + (c >> 6) * FB_CHUNK + r * 128 +
        ((((cc >> 3) ^ (r & 7)) << 4) | ((cc & 7) << 1))) = x;
  }
  // generic-proxy writes, read next by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Key tiles [lo, hi) that some row of the 64 query rows from r0 sees (none
// when r0 >= Sq): one run, since causal cuts a suffix and the window a
// prefix. The same test as pl.when(live).
__device__ __forceinline__ void fb_live(int r0, int Sq, int Skv, int causal,
                                        int window, int& lo, int& hi) {
  const int pmin = r0 + Skv - Sq, pmax = pmin + FB_BQ - 1;
  lo = 0;
  hi = r0 < Sq ? (Skv + FB_BK - 1) / FB_BK : 0;
  if (causal) hi = min(hi, pmax < 0 ? 0 : pmax / FB_BK + 1);
  if (window > 0) {  // t FB_BK + FB_BK - 1 > pmin - window
    const int x = pmin - window - (FB_BK - 1);
    lo = x < 0 ? 0 : x / FB_BK + 1;
  }
  hi = max(hi, lo);
}

// The block's key tiles [lo, hi): the union of its warpgroups' runs, from
// the block's first query row qb (lo >= hi: none).
__device__ __forceinline__ void fb_block_live(int qb, int Sq, int Skv,
                                              int causal, int window,
                                              int& lo, int& hi) {
  lo = 1 << 30;
  hi = 0;
#pragma unroll
  for (int g = 0; g < FB_WG; ++g) {
    int l, e;
    fb_live(qb + g * FB_BQ, Sq, Skv, causal, window, l, e);
    if (e > l) {
      lo = min(lo, l);
      hi = max(hi, e);
    }
  }
}

// Shared memory of the kernel at NC chunks of the head dim: QBUF buffers
// of the block's Q tiles and a ring of STAGES K and V tiles, below 227 KB.
template <int NC>
struct FbCfg {
  static constexpr int QBUF = NC <= 3 ? 2 : 1;
  static constexpr int STAGES = NC <= 2 ? 4 : 2;
  static constexpr int QB = FB_WG * NC * FB_CHUNK;  // one Q buffer
  static constexpr int KV = NC * FB_CHUNK;          // one K or V tile
  static constexpr int TILES = QBUF * QB + 2 * STAGES * KV;
  static constexpr int SMEM = TILES + 1024 + 8 * (2 * STAGES + 2 * QBUF);
};

// Row u's maximum and sum of a thread's 16 values sc[4 j + 2 u + w], as
// trees (short dependency chains), then over the quad of lanes that holds
// the row.
__device__ __forceinline__ float fb_rowmax(const float (&sc)[32], int u) {
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    m[j] = fmaxf(sc[4 * j + 2 * u], sc[4 * j + 2 * u + 1]);
#pragma unroll
  for (int d = 4; d > 0; d >>= 1)
#pragma unroll
    for (int j = 0; j < d; ++j) m[j] = fmaxf(m[j], m[j + d]);
  m[0] = fmaxf(m[0], __shfl_xor_sync(0xffffffffu, m[0], 1));
  return fmaxf(m[0], __shfl_xor_sync(0xffffffffu, m[0], 2));
}
__device__ __forceinline__ float fb_rowsum(const float (&sc)[32], int u) {
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = sc[4 * j + 2 * u] + sc[4 * j + 2 * u + 1];
#pragma unroll
  for (int d = 4; d > 0; d >>= 1)
#pragma unroll
    for (int j = 0; j < d; ++j) m[j] += m[j + d];
  m[0] += __shfl_xor_sync(0xffffffffu, m[0], 1);
  return m[0] + __shfl_xor_sync(0xffffffffu, m[0], 2);
}

// Positions of a thread's two rows and of its warpgroup's first and last.
struct FbRows {
  int pos_a, pos_b, pos_min, pos_max;
};

// The online softmax of one 64 x 64 tile of logits whose keys start at k0,
// in f32 with the logits in log2 units: sc[4 j + 2 u + w] (row u of the
// thread's two, key k0 + 8 j + cq + w) becomes P; the running max m and
// sum l move on; al = 2^(m_old - m_new) is what the accumulator owes.
__device__ __forceinline__ void fb_softmax(
    float (&sc)[32], int k0, const FbRows& rw, int cq, int Skv, int causal,
    int window, float scale, float softcap, float& m_a, float& m_b,
    float& l_a, float& l_b, float& al_a, float& al_b) {
  const float L2E = 1.4426950408889634f;
  // one branch a pass, not one an element
  if (softcap > 0.f) {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sc[e] = softcap * tanhf(sc[e] * scale / softcap) * L2E;
  } else {
    const float sl2 = scale * L2E;
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= sl2;
  }
  if (k0 + FB_BK > Skv || (causal && k0 + FB_BK - 1 > rw.pos_min) ||
      (window > 0 && k0 <= rw.pos_max - window)) {  // an edge tile
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kp = k0 + 8 * (e >> 2) + cq + (e & 1);
      const int pos = (e & 2) ? rw.pos_b : rw.pos_a;
      bool keep = kp < Skv;
      if (causal) keep = keep && kp <= pos;
      if (window > 0) keep = keep && kp > pos - window;
      sc[e] = keep ? sc[e] : FA_NEG_INF;
    }
  }
  const float mn_a = fmaxf(m_a, fb_rowmax(sc, 0));
  const float mn_b = fmaxf(m_b, fb_rowmax(sc, 1));
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = fb_ex2(sc[e] - ((e & 2) ? mn_b : mn_a));
  al_a = fb_ex2(m_a - mn_a);
  al_b = fb_ex2(m_b - mn_b);
  l_a = l_a * al_a + fb_rowsum(sc, 0);
  l_b = l_b * al_b + fb_rowsum(sc, 1);
  m_a = mn_a;
  m_b = mn_b;
}

// P split in two bf16 parts, P_hi = bf16_rn(P) and P_lo = bf16_rn(P -
// P_hi), as wgmma's register A operand: k-step i (keys 16 i ..) takes
// a[r] = (sc[8 i + 2 r], sc[8 i + 2 r + 1]).
__device__ __forceinline__ void fb_split(const float (&sc)[32],
                                         uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * i + 2 * r], x1 = sc[8 * i + 2 * r + 1];
      const __nv_bfloat162 ph = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(ph);
      const __nv_bfloat162 pl = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      p_hi[i][r] = *reinterpret_cast<const uint32_t*>(&ph);
      p_lo[i][r] = *reinterpret_cast<const uint32_t*>(&pl);
    }
}

// Issues S (64 x 64, f32) = Q . K^T, Q at qa and K at ka: all 4 NC steps
// of 16 (the zero padding of the head dim adds zeros), one commit group.
template <int NC>
__device__ __forceinline__ void fb_issue_qk(float (&sc)[32], uint32_t qa,
                                            uint32_t ka) {
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = 0.f;
  fb_fence_regs(sc);
  fb_wg_fence();
#pragma unroll
  for (int st = 0; st < 4 * NC; ++st) {
    const uint32_t off = (st >> 2) * FB_CHUNK + (st & 3) * 32;
    fb_wgmma_ss(sc, fb_desc(qa + off), fb_desc(ka + off), st > 0);
  }
  fb_wg_commit();
}

// A persistent block: FB_WG consumer warpgroups and one producer warp walk
// the work items blockIdx.x, + gridDim.x, ...; item w is query tile nq - 1
// - w / (H B) of FB_WG x 64 rows (the most live key tiles first), head w %
// H, batch w % (H B) / H. The producer fills a Q buffer and the ring with
// the key tiles of the union of the warpgroups' runs, as far ahead as the
// buffers allow; each warpgroup computes on the tiles of its own run and
// passes the others. NC = ceil(D / 64). tma != 0: tq, tk, tv, to are the
// (D, heads, rows, B) maps of q, k, v, o with 64 x 64 boxes, and the
// output goes out through the warpgroup's Q tile; else the producer warp
// fills with plain loads and the consumers store directly.
template <int NC>
__global__ void __launch_bounds__(FB_NT, 1) fa_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ o, int B, int Sq, int Skv, int H, int Hkv,
    int D, int causal, int window, float scale, float softcap, int tma) {
  using C = FbCfg<NC>;
  extern __shared__ __align__(1024) uint8_t fb_raw[];
  uint8_t* Qs = fb_raw + ((1024 - (fb_smem(fb_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + C::QBUF * C::QB;   // [stage][chunk]
  uint8_t* Vs = Ks + C::STAGES * C::KV;  // [stage][chunk]
  // mbarriers: full[s], empty[s] of the ring, then qfull[u], qempty[u]
  const uint32_t full = fb_smem(Qs + C::TILES), empty = full + 8 * C::STAGES;
  const uint32_t qfull = empty + 8 * C::STAGES, qempty = qfull + 8 * C::QBUF;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      fb_mbar_init(full + 8 * s, 1);
      fb_mbar_init(empty + 8 * s, 4 * FB_WG);  // each consumer warp
    }
    for (int u = 0; u < C::QBUF; ++u) {
      fb_mbar_init(qfull + 8 * u, 1);
      fb_mbar_init(qempty + 8 * u, 4 * FB_WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nq = (Sq + FB_BQ * FB_WG - 1) / (FB_BQ * FB_WG);
  const int items = nq * H * B, rep = H / Hkv;
  const int64_t qs = (int64_t)H * D, ks = (int64_t)Hkv * D;

  if (tid >= 128 * FB_WG) {  // ---- the producer warp ------------------------
    int j = 0, it = 0;  // items and key tiles this block has taken
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++j) {
      const int qb = (nq - 1 - w / (H * B)) * FB_BQ * FB_WG;
      const int h = w % H, b = w % (H * B) / H, hk = h / rep;
      int lo, hi;
      fb_block_live(qb, Sq, Skv, causal, window, lo, hi);
      const int u = j % C::QBUF;
      fb_mbar_wait(qempty + 8 * u, ((j / C::QBUF) & 1) ^ 1);
      uint8_t* qd = Qs + u * C::QB;
      if (tma) {
        if (lane == 0) {
          fb_mbar_expect(qfull + 8 * u, C::QB);
#pragma unroll
          for (int g = 0; g < FB_WG; ++g)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              fb_tma(fb_smem(qd + (g * NC + c) * FB_CHUNK), &tq,
                     qfull + 8 * u, c * 64, h, qb + g * FB_BQ, b);
        }
      } else {
#pragma unroll
        for (int g = 0; g < FB_WG; ++g)
          fb_fill<NC>(qd + g * NC * FB_CHUNK,
                      q + ((int64_t)b * Sq + qb + g * FB_BQ) * qs +
                          (int64_t)h * D,
                      qs, Sq - qb - g * FB_BQ, D);
        __syncwarp();
        if (lane == 0) fb_mbar_arrive(qfull + 8 * u);
      }
      for (int t = lo; t < hi; ++t, ++it) {
        const int s = it % C::STAGES;
        fb_mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        uint8_t* kd = Ks + s * C::KV;
        uint8_t* vd = Vs + s * C::KV;
        if (tma) {
          if (lane == 0) {
            fb_mbar_expect(full + 8 * s, 2 * C::KV);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              fb_tma(fb_smem(kd + c * FB_CHUNK), &tk, full + 8 * s, c * 64,
                     hk, t * FB_BK, b);
              fb_tma(fb_smem(vd + c * FB_CHUNK), &tv, full + 8 * s, c * 64,
                     hk, t * FB_BK, b);
            }
          }
        } else {
          const int64_t off = ((int64_t)b * Skv + t * FB_BK) * ks +
                              (int64_t)hk * D;
          fb_fill<NC>(kd, k + off, ks, Skv - t * FB_BK, D);
          fb_fill<NC>(vd, v + off, ks, Skv - t * FB_BK, D);
          __syncwarp();
          if (lane == 0) fb_mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups ---------------------------------------------
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  // this thread's accumulator rows: ra and ra + 8 of its warpgroup's 64;
  // its columns in each group of 8: cq, cq + 1
  const int ra = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  // The thread that stores a warpgroup's output tile from its Q buffer
  // (QBUF > 1) frees the buffer one tile later, when the store has long
  // read it: `held` is that buffer, or -1.
  const bool store = (tid & 127) == 0;
  int j = 0, it = 0, held = -1;
  auto release = [&]() {
    if (held >= 0 && store) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      fb_mbar_arrive(qempty + 8 * held);
    }
    held = -1;
  };
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++j) {
    const int qb = (nq - 1 - w / (H * B)) * FB_BQ * FB_WG;
    const int h = w % H, b = w % (H * B) / H;
    const int q0 = qb + wg * FB_BQ;  // this warpgroup's query rows
    // the block's tiles [lo, hi), this warpgroup's [a, z)
    int lo, hi, a, z;
    fb_block_live(qb, Sq, Skv, causal, window, lo, hi);
    fb_live(q0, Sq, Skv, causal, window, a, z);
    FbRows rows;
    rows.pos_min = q0 + Skv - Sq;
    rows.pos_max = rows.pos_min + FB_BQ - 1;
    rows.pos_a = rows.pos_min + ra;
    rows.pos_b = rows.pos_a + 8;
    const int u = j % C::QBUF;
    fb_mbar_wait(qfull + 8 * u, (j / C::QBUF) & 1);
    uint8_t* qt = Qs + u * C::QB + wg * NC * FB_CHUNK;  // this warpgroup's
    const uint32_t qa = fb_smem(qt);

    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    float m_a = FA_NEG_INF, m_b = FA_NEG_INF, l_a = 0.f, l_b = 0.f;

    for (int t = lo; t < hi; ++t, ++it) {
      const int s = it % C::STAGES;
      fb_mbar_wait(full + 8 * s, (it / C::STAGES) & 1);
      if (t >= a && t < z) {  // some row of this warpgroup sees tile t
        float sc[32], al_a, al_b;
        uint32_t p_hi[4][4], p_lo[4][4];
        fb_issue_qk<NC>(sc, qa, fb_smem(Ks + s * C::KV));
        fb_wg_wait<0>();
        fb_fence_regs(sc);
        fb_softmax(sc, t * FB_BK, rows, cq, Skv, causal, window, scale,
                   softcap, m_a, m_b, l_a, l_b, al_a, al_b);
        // a running max that did not move scales by exactly 1: skip it
        if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[c][e] *= (e & 2) ? al_b : al_a;
        }
        fb_split(sc, p_hi, p_lo);

        // ---- acc += P_hi . V + P_lo . V on the tensor cores ----------------
        const uint32_t va = fb_smem(Vs + s * C::KV);
#pragma unroll
        for (int c = 0; c < NC; ++c) fb_fence_regs(acc[c]);
        fb_fence_regs(p_hi);
        fb_fence_regs(p_lo);
        fb_wg_fence();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const uint64_t dv = fb_desc(va + c * FB_CHUNK + i * 2048);
            fb_wgmma_rs(acc[c], p_hi[i], dv);
            fb_wgmma_rs(acc[c], p_lo[i], dv);
          }
        fb_wg_commit();
        fb_wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) fb_fence_regs(acc[c]);
      }
      if (lane == 0) fb_mbar_arrive(empty + 8 * s);  // this warp is done
      release();
    }
    release();

    // ---- o = acc * (1 / den) in bf16 -------------------------------------
    // (within an f32 ulp of acc / den, one division a row)
    const float rd_a = 1.f / fmaxf(l_a, 1e-30f);
    const float rd_b = 1.f / fmaxf(l_b, 1e-30f);
    if (tma) {
      // through this warpgroup's Q tile, which its products no longer
      // read, in the layout TMA stores from; rows past Sq and columns past
      // D are clipped by the store
      fb_wg_bar(wg);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = ra + 8 * hr;
        const float rd = hr ? rd_b : rd_a;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<__nv_bfloat162*>(
                qt + c * FB_CHUNK + r * 128 + ((i ^ (r & 7)) << 4) + cq * 2) =
                __floats2bfloat162_rn(acc[c][4 * i + 2 * hr] * rd,
                                      acc[c][4 * i + 2 * hr + 1] * rd);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fb_wg_bar(wg);
      if (store) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          fb_tma_store(&to, fb_smem(qt + c * FB_CHUNK), c * 64, h, q0, b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // with one Q buffer the next Q needs it now
        if (C::QBUF == 1)
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      if (C::QBUF > 1) held = u;
    } else {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = q0 + ra + 8 * hr;
        if (r >= Sq) continue;
        const float rd = hr ? rd_b : rd_a;
        __nv_bfloat16* orow =
            o + ((int64_t)b * Sq + r) * qs + (int64_t)h * D;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int d = c * 64 + 8 * i + cq;
            const float y0 = acc[c][4 * i + 2 * hr] * rd;
            const float y1 = acc[c][4 * i + 2 * hr + 1] * rd;
            if (d < D) orow[d] = __float2bfloat16_rn(y0);
            if (d + 1 < D) orow[d + 1] = __float2bfloat16_rn(y1);
          }
      }
    }
    if (lane == 0 && !(held >= 0 && store)) fb_mbar_arrive(qempty + 8 * u);
  }
  // the last stores complete before the block ends
  if (store) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

typedef CUresult (*fb_encode_fn)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links only the runtime); null where the driver has none.
static fb_encode_fn fb_encoder() {
  static fb_encode_fn fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (rc == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = (fb_encode_fn)p;
    else
      (void)cudaGetLastError();
  }
  return fn;
}

// The (D, heads, rows, B) map of a contiguous (B, rows, heads, D) bf16
// tensor, 64 x 64 boxes, 128-byte swizzle, zeros out of bounds. False
// where TMA cannot take it: D % 8 != 0 (a 16-byte head stride) or a base
// off 16 bytes.
static bool fb_map(CUtensorMap* m, const void* ptr, int D, int heads,
                   int rows, int B) {
  const fb_encode_fn enc = fb_encoder();
  if (enc == nullptr || D % 8 != 0 || (uintptr_t)ptr % 16 != 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, one[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
static int fb_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int H, int Hkv, int D,
                     int causal, int window, float scale, float softcap,
                     cudaStream_t st) {
  const int sh = FbCfg<NC>::SMEM;
  const int rc = (int)cudaFuncSetAttribute(
      fa_bf16_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, sh);
  if (rc != 0) return rc;
  CUtensorMap tq, tk, tv, to;
  memset(&tq, 0, sizeof tq);
  memset(&tk, 0, sizeof tk);
  memset(&tv, 0, sizeof tv);
  memset(&to, 0, sizeof to);
  const int tma = fb_map(&tq, q, D, H, Sq, B) &&
                  fb_map(&tk, k, D, Hkv, Skv, B) &&
                  fb_map(&tv, v, D, Hkv, Skv, B) &&
                  fb_map(&to, o, D, H, Sq, B);
  // one block an SM (its shared memory), each walking its work items
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t items =
      (int64_t)((Sq + FB_BQ * FB_WG - 1) / (FB_BQ * FB_WG)) * H * B;
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  fa_bf16_kernel<NC><<<grid, FB_NT, sh, st>>>(
      tq, tk, tv, to, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, B, Sq, Skv, H, Hkv, D,
      causal, window, scale, softcap, tma);
  return (int)cudaGetLastError();
}

static int fb_dispatch(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int H, int Hkv, int D,
                       int causal, int window, float scale, float softcap,
                       cudaStream_t st) {
  switch ((D + 63) / 64) {
    case 1:
      return fb_launch<1>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window,
                          scale, softcap, st);
    case 2:
      return fb_launch<2>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window,
                          scale, softcap, st);
    case 3:
      return fb_launch<3>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window,
                          scale, softcap, st);
    default:
      return fb_launch<4>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window,
                          scale, softcap, st);
  }
}

// bf16 != 0 selects bfloat16 operands (the tensor-core body), else float32.
// window <= 0 and softcap <= 0 mean none. 1 <= D <= 256, H % Hkv == 0,
// Skv >= 1, B and H at most 65535 (grid dimensions).
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
    return fb_dispatch(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window,
                       scale, softcap, st);
  return fa_dispatch<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal,
                            window, scale, softcap, st);
}

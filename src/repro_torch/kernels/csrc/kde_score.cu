// Masked Gaussian-kernel row sums, the KDE measure's training phase.
//
// Replaces: repro/kernels/kde_score.py::kde_rowsums (the Pallas kernel that
// carries a (bm, 1) accumulator across the sequential n-tile grid axis).
//
// out[i] = sum_j [y_B[j] == y_A[i]] [j != i if exclude_diag]
//                * exp(-max(d2_ij, 0) / den),      den = f32(2 h^2)
// d2_ij from sqdist.cuh, the formula pairwise_sq_dists uses: d2_ij equals
// that kernel's entry bit for bit.
//
// Two output forms. Given y_A, one sum per row (out (m,), the target label
// y_A[i]: the fit's form). Without y_A (NULL), one sum per row and label:
// out (m, L), out[i, l] over the columns of label l (a read's form: every
// candidate label of a test point from one pass over the training set).
//
// Each sum over j runs strictly left to right, one rounding per add, in
// one thread. That order is what makes the KDE measure's exact properties
// hold by construction: a row's sum does not depend on m, on the tile or
// on the launch shape; the sum over [X; x] with the new column last equals
// prelim_i + kv_i (incremental == refit, optimized == standard). Any later
// redesign (split over j, tree reductions, atomics) must keep this order
// or give those properties up. A sum skips the columns it masks: every
// kernel value is +0 or positive, so adding the plain version's +0 for
// them leaves the bits unchanged, provided the kept columns stay in order.
//
// exp is the CUDA math library's expf, the function torch.exp calls on a
// float32 CUDA tensor (kde_expf exposes it for that check). The division
// is __fdiv_rn, IEEE like the plain version's tensor division; where den is
// a power of two whose reciprocal is a normal float (h = 1: den = 2) the
// caller passes that reciprocal instead and the kernel multiplies by it,
// which rounds the same real number once. No fast math and no
// flush-to-zero: far pairs reach the denormal range.
//
// Bound: ~(2p + 5) flops per kept (i, j) pair against ~4(m + n)(p + 1)
// bytes, so at the KDE fit's shapes (m = n = 1e5, p = 30, two balanced
// labels: ~5e9 same-label pairs) it is bound by operations. The fixed
// order forbids FMA: each multiply and add issues alone, so the kernel
// cannot go below about twice the f32 bound.
//
// Design, two layouts (the bits are the same: every kept pair and every
// sum is computed in the same order):
// - grouped (many rows): the launch first groups the columns by label on
//   the device (a warp per chunk of labels counts them, one block scans
//   the counts, the warps then place each column at its label's next slot:
//   a stable partition, so each label keeps its original column order) and
//   packs each label's B rows, |B_j|^2 and labels into tiles of KT columns,
//   feature-major, padded to whole tiles with columns whose |B|^2 is +inf
//   (their kernel value is +0, so they need no mask). In the fit's form it
//   groups A's rows the same way (row order is free) and a block of KS_BM
//   rows shares one label; in the read's form a block takes KS_BM rows and
//   one label. Either way a block visits only its label's columns. Labels
//   outside [0, L) form one extra group whose rows compare labels column by
//   column (exact for any int32 label; empty on the measure's data). A
//   thread owns KS_R rows, their features in registers for the block's
//   lifetime (p <= KS_PC) or in shared memory (larger p, chunked by KS_PC),
//   and a register tile of KS_R x KS_C dot products; the column tiles come
//   through a double-buffered shared-memory stage by cp.async and are read
//   by 16-byte broadcast loads. The diagonal is excluded by position.
// - wide (few rows, e.g. a read's test points): one block per row, its
//   KW_T threads compute the kernel values of KW_T consecutive columns in
//   parallel into shared memory, and one thread per target label adds them
//   in column order. With few rows the grouped layout leaves most SMs idle;
//   with many, the wide layout reads all of B once per row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sqdist.cuh"

#define KS_R 2                  // rows a thread (grouped layout)
#define KS_C 16                 // columns of a thread's register tile
#define KS_T 64                 // threads a block (p <= KS_PC)
#define KS_BM (KS_T * KS_R)     // rows a block (p <= KS_PC)
#define KS_PC 32                // features a chunk
#define KS_KT 64                // columns a packed tile (p <= KS_PC)
#define KS_A_SMEM (200 * 1024)  // the block's rows in shared memory (p > KS_PC)
#define KS_MAX_LABELS 256       // labels the grouping tells apart
#define KG_CH 1024              // labels a warp ranks in the grouping passes
#define KW_T 256
#define KW_MAX_P 11776  // the row's features + vals + labels in 48 KB

__device__ __forceinline__ float kde_exp(float x) { return expf(x); }

// exp(-max(d2, 0) / den); with MUL, den holds 1 / den, exact (see above)
template <bool MUL>
__device__ __forceinline__ float kde_val(float a2i, float b2j, float ab,
                                         float den) {
  const float x = -fmaxf(sqd_combine(a2i, b2j, ab), 0.f);
  return kde_exp(MUL ? __fmul_rn(x, den) : __fdiv_rn(x, den));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// |row|^2 of A's m rows into a2 and of B's n rows into b2 (n = 0: A only)
__global__ void kde_sumsq_kernel(const float* __restrict__ A, int m,
                                 const float* __restrict__ B, int n, int p,
                                 float* __restrict__ a2,
                                 float* __restrict__ b2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m + n) return;
  if (r < m)
    a2[r] = sqd_norm(A + (int64_t)r * p, p);
  else
    b2[r - m] = sqd_norm(B + (int64_t)(r - m) * p, p);
}

// ---------------------------------------------------------------------------
// grouped layout: the grouping passes
// ---------------------------------------------------------------------------

// The scratch the grouped layout carves (int32 / float32 words).
struct KdeGroups {
  int G;           // label groups: L labels + the extra group
  int nchB, nchA;  // chunks of KG_CH labels of B and (fit form) of A
  int* histB;      // (nchB, G) counts, then each chunk's offset in its group
  int* histA;      // (nchA, G)
  int* colPad;     // (G + 1) packed start of each group, whole tiles
  int* cntB;       // (G) columns of each group
  int* rowStart;   // (G + 1) start of each group in permA
  int* cntA;       // (G)
  int* tileStart;  // (G + 1) first block of each group (fit form)
  int* invB;       // (n) packed position of column j
  int* permA;      // (m) original row of each grouped row (fit form)
  float* Bt;       // (colPad[G] / KT, p + 2, KT) packed tiles
};

__device__ __forceinline__ int label_group(int y, int L) {
  return (y >= 0 && y < L) ? y : L;
}

// One warp per chunk of KG_CH labels. Without SCATTER: the chunk's count of
// each group into hist. With SCATTER: each element's place in its group,
// stable (lane order within a step, steps in order, chunks by the scanned
// offsets): B's columns are packed into Bt (features, |B_j|^2, label) and
// invB; A's rows into permA. Spare blocks after the chunks pad each group's
// last tile (zero features, |B|^2 = +inf: kernel value +0).
template <bool SCATTER>
__global__ void __launch_bounds__(32) kde_group_rank_kernel(
    const int* __restrict__ yB, int n, const int* __restrict__ yA, int m,
    const float* __restrict__ B, int p, int L, int KT, KdeGroups gr) {
  __shared__ int run[KS_MAX_LABELS + 1];
  const int lane = threadIdx.x;
  int chunk = blockIdx.x;
  const int G = gr.G;
  if (chunk >= gr.nchB + gr.nchA) {  // SCATTER only: pad group g's last tile
    const int g = chunk - gr.nchB - gr.nchA;
    const int c0 = gr.colPad[g] + gr.cntB[g], c1 = gr.colPad[g + 1];
    for (int e = lane; e < (c1 - c0) * (p + 2); e += 32) {
      const int c = c0 + e / (p + 2), f = e % (p + 2);
      gr.Bt[((int64_t)(c / KT) * (p + 2) + f) * KT + c % KT] =
          f < p ? 0.f : (f == p ? __int_as_float(0x7f800000)
                                : __int_as_float(-1));
    }
    return;
  }
  const bool isA = chunk >= gr.nchB;
  if (isA) chunk -= gr.nchB;
  const int* lab = isA ? yA : yB;
  const int cnt = isA ? m : n;
  int* hist = (isA ? gr.histA : gr.histB) + (int64_t)chunk * G;
  const int* base = isA ? gr.rowStart : gr.colPad;
  for (int g = lane; g < G; g += 32) run[g] = SCATTER ? hist[g] + base[g] : 0;
  __syncwarp();
  const int end = min(cnt, (chunk + 1) * KG_CH);
  for (int k = chunk * KG_CH; k < end; k += 32) {
    const int j = k + lane;
    const bool valid = j < end;
    const int y = valid ? lab[j] : 0;
    const int g = valid ? label_group(y, L) : G;
    const unsigned same = __match_any_sync(0xffffffffu, g);
    const int pos = valid ? run[g] + __popc(same & ((1u << lane) - 1)) : 0;
    __syncwarp();
    if (valid && lane == __ffs(same) - 1) run[g] += __popc(same);
    __syncwarp();
    if (!SCATTER || !valid) continue;
    if (isA) {
      gr.permA[pos] = j;
    } else {
      gr.invB[j] = pos;
      const float* row = B + (int64_t)j * p;
      float* dst = gr.Bt + (int64_t)(pos / KT) * (p + 2) * KT + pos % KT;
      float acc = 0.f;  // |B_j|^2 in sqd_norm's order
      for (int f = 0; f < p; ++f) {
        const float x = row[f];
        dst[(int64_t)f * KT] = x;
        acc = sqd_step(acc, x, x);
      }
      dst[(int64_t)p * KT] = acc;
      dst[(int64_t)(p + 1) * KT] = __int_as_float(y);
    }
  }
  if (!SCATTER)
    for (int g = lane; g < G; g += 32) hist[g] = run[g];
}

// One block: per group, the chunks' counts become exclusive offsets and
// the totals cntB / cntA; then the groups' starts (B's padded to whole
// tiles of KT) and, in the fit form, the first block of each group.
__global__ void kde_group_scan_kernel(int KT, int BM, KdeGroups gr) {
  const int G = gr.G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    int acc = 0;
    for (int c = 0; c < gr.nchB; ++c) {
      const int h = gr.histB[(int64_t)c * G + g];
      gr.histB[(int64_t)c * G + g] = acc;
      acc += h;
    }
    gr.cntB[g] = acc;
    acc = 0;
    for (int c = 0; c < gr.nchA; ++c) {
      const int h = gr.histA[(int64_t)c * G + g];
      gr.histA[(int64_t)c * G + g] = acc;
      acc += h;
    }
    gr.cntA[g] = acc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int col = 0, row = 0, tile = 0;
  for (int g = 0; g < G; ++g) {
    gr.colPad[g] = col;
    gr.rowStart[g] = row;
    gr.tileStart[g] = tile;
    col += (gr.cntB[g] + KT - 1) / KT * KT;
    row += gr.cntA[g];
    tile += (gr.cntA[g] + BM - 1) / BM;
  }
  gr.colPad[G] = col;
  gr.rowStart[G] = row;
  gr.tileStart[G] = tile;
}

// ---------------------------------------------------------------------------
// grouped layout: the sums
// ---------------------------------------------------------------------------

// The block's rows against one group's packed columns [cs, cs + nc), in
// order. AREG: p <= KS_PC, each thread's rows in registers (a), tiles of
// KS_KT columns, one chunk; else the rows in shared memory As (p, BM),
// tiles of KS_C columns, KS_PC features a stage. CHK: compare labels (the
// extra group). stage: 2 x (KS_PC + 2) x KT floats.
template <bool AREG, bool MUL, bool CHK>
__device__ __forceinline__ void kde_group_columns(
    const float* __restrict__ Bt, int cs, int nc, int p, float den,
    const float (&a)[KS_R][KS_PC], const float* As, int BM,
    const float (&a2)[KS_R], const int (&yr)[KS_R], const int (&dpos)[KS_R],
    float (&sum)[KS_R], float* stage) {
  constexpr int KT = AREG ? KS_KT : KS_C;
  constexpr int BUF = (KS_PC + 2) * KT;
  const int T = blockDim.x, t = threadIdx.x;
  const int nch = AREG ? 1 : (p + KS_PC - 1) / KS_PC;
  const int nst = (nc + KT - 1) / KT * nch;
  const float* tiles = Bt + (int64_t)(cs / KT) * (p + 2) * KT;
  // stage s: tile s / nch, features [c0, c0 + kk) of it, and in the last
  // chunk also its |B|^2 and label rows
  auto issue = [&](int s) {
    const int tile = s / nch, c0 = (s - tile * nch) * KS_PC;
    const int rows = min(KS_PC, p - c0) + (c0 + KS_PC >= p ? 2 : 0);
    const float* src = tiles + ((int64_t)tile * (p + 2) + c0) * KT;
    float* dst = stage + (s & 1) * BUF;
    for (int e = t; e < rows * KT / 4; e += T)
      cp_async16(dst + 4 * e, src + 4 * e);
    cp_async_commit();
  };
  float ab[KS_R][KS_C];
  if (nst > 0) issue(0);
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tile = s / nch, c0 = (s - tile * nch) * KS_PC;
    const int kk = min(KS_PC, p - c0);
    const bool last = c0 + KS_PC >= p;
    const float* bs = stage + (s & 1) * BUF;
#pragma unroll 1
    for (int sub = 0; sub < KT; sub += KS_C) {
      const int j0 = tile * KT + sub;  // the sub-tile's first column
      if (j0 >= nc) break;
      if (c0 == 0) {
#pragma unroll
        for (int r = 0; r < KS_R; ++r)
#pragma unroll
          for (int c = 0; c < KS_C; ++c) ab[r][c] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < KS_PC; ++f) {
        if (f < kk) {
          float av[KS_R];
#pragma unroll
          for (int r = 0; r < KS_R; ++r)
            av[r] = AREG ? a[r][f] : As[(c0 + f) * BM + t + r * T];
#pragma unroll
          for (int c4 = 0; c4 < KS_C; c4 += 4) {
            const float4 b =
                *reinterpret_cast<const float4*>(bs + f * KT + sub + c4);
#pragma unroll
            for (int r = 0; r < KS_R; ++r) {
              ab[r][c4] = sqd_step(ab[r][c4], av[r], b.x);
              ab[r][c4 + 1] = sqd_step(ab[r][c4 + 1], av[r], b.y);
              ab[r][c4 + 2] = sqd_step(ab[r][c4 + 2], av[r], b.z);
              ab[r][c4 + 3] = sqd_step(ab[r][c4 + 3], av[r], b.w);
            }
          }
        }
      }
      if (!last) continue;
      // the sub-tile's columns in order; padding columns add +0
#pragma unroll
      for (int c4 = 0; c4 < KS_C; c4 += 4) {
        const float4 b2 =
            *reinterpret_cast<const float4*>(bs + kk * KT + sub + c4);
        const int4 yb =
            *reinterpret_cast<const int4*>(bs + (kk + 1) * KT + sub + c4);
        const float b2c[4] = {b2.x, b2.y, b2.z, b2.w};
        const int ybc[4] = {yb.x, yb.y, yb.z, yb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + c4 + q;
#pragma unroll
          for (int r = 0; r < KS_R; ++r) {
            const float v = kde_val<MUL>(a2[r], b2c[q], ab[r][c4 + q], den);
            if (j != dpos[r] && (!CHK || ybc[q] == yr[r]))
              sum[r] = __fadd_rn(sum[r], v);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled by stage s + 2
  }
}

// One block a task. Fit form (yA given): the blocks of group g are
// [tileStart[g], tileStart[g + 1]); each takes BM of the group's rows
// (permA) against the group's columns, out[i]. Read form (yA NULL): block
// b takes rows (b / L) * BM + [0, BM) against label b % L, out[i * L + l].
template <bool AREG, bool MUL>
__global__ void __launch_bounds__(KS_T) kde_group_kernel(
    const float* __restrict__ A, const int* __restrict__ yA,
    const float* __restrict__ a2g, float* __restrict__ out, int m, int n,
    int p, int L, float den, int exclude_diag, KdeGroups gr) {
  constexpr int KT = AREG ? KS_KT : KS_C;
  __shared__ __align__(16) float stage[2 * (KS_PC + 2) * KT];
  extern __shared__ float As[];  // !AREG: (p, BM)
  const int T = blockDim.x, t = threadIdx.x, BM = T * KS_R;
  const bool fit = yA != nullptr;
  const int b = blockIdx.x;
  int g, r0, rend;
  if (fit) {
    if (b >= gr.tileStart[gr.G]) return;
    g = 0;
    while (gr.tileStart[g + 1] <= b) ++g;
    r0 = gr.rowStart[g] + (b - gr.tileStart[g]) * BM;
    rend = gr.rowStart[g] + gr.cntA[g];
  } else {
    g = b % L;
    r0 = (b / L) * BM;
    rend = m;
  }
  const int cs = gr.colPad[g], nc = gr.cntB[g];
  int row[KS_R], yr[KS_R], dpos[KS_R];
  float a2[KS_R], sum[KS_R];
  float a[KS_R][KS_PC];
#pragma unroll
  for (int r = 0; r < KS_R; ++r) {
    const int pr = r0 + t + r * T;
    row[r] = pr < rend ? (fit ? gr.permA[pr] : pr) : -1;
    const int i = row[r];
    a2[r] = i >= 0 ? a2g[i] : 0.f;
    yr[r] = (i >= 0 && fit) ? yA[i] : 0;
    const int d = (exclude_diag && i >= 0 && i < n) ? gr.invB[i] - cs : -1;
    dpos[r] = (d >= 0 && d < nc) ? d : -1;
    sum[r] = 0.f;
    if (AREG) {
#pragma unroll
      for (int f = 0; f < KS_PC; ++f)
        a[r][f] = (i >= 0 && f < p) ? A[(int64_t)i * p + f] : 0.f;
    }
  }
  if (!AREG) {
    for (int e = t; e < BM * p; e += T) {
      const int lr = e / p, f = e - lr * p;
      const int pr = r0 + lr;
      const int i = pr < rend ? (fit ? gr.permA[pr] : pr) : -1;
      As[f * BM + lr] = i >= 0 ? A[(int64_t)i * p + f] : 0.f;
    }
    __syncthreads();
  }
  if (g == L)
    kde_group_columns<AREG, MUL, true>(gr.Bt, cs, nc, p, den, a, As, BM, a2,
                                       yr, dpos, sum, stage);
  else
    kde_group_columns<AREG, MUL, false>(gr.Bt, cs, nc, p, den, a, As, BM,
                                        a2, yr, dpos, sum, stage);
#pragma unroll
  for (int r = 0; r < KS_R; ++r) {
    if (row[r] < 0) continue;
    if (fit)
      out[row[r]] = sum[r];
    else
      out[(int64_t)row[r] * L + g] = sum[r];
  }
}

// ---------------------------------------------------------------------------
// wide layout
// ---------------------------------------------------------------------------

template <bool PER_LABEL>
__global__ void __launch_bounds__(KW_T) kde_rowsums_wide_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const int* __restrict__ yA, const int* __restrict__ yB,
    const float* __restrict__ a2, const float* __restrict__ b2,
    float* __restrict__ out, int n, int p, int L, float den, int mul,
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
      for (int f = 0; f < p; ++f) ab = sqd_step(ab, arow[f], b[f]);
      const float kv = mul ? kde_val<true>(a2i, b2[j], ab, den)
                           : kde_val<false>(a2i, b2[j], ab, den);
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

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

// Rows a block of the grouped layout at this p (0: p too large).
static int group_rows(int p) {
  if (p <= KS_PC) return KS_BM;
  const int T = min(KS_T, KS_A_SMEM / (KS_R * p * (int)sizeof(float)));
  return T * KS_R;
}

// Carve the grouped layout's scratch (NULL: only count its words).
static int64_t group_scratch(int m, int n, int p, int L, bool fit,
                             char* base, KdeGroups* gr) {
  const int KT = p <= KS_PC ? KS_KT : KS_C;
  KdeGroups g;
  g.G = L + 1;
  g.nchB = (n + KG_CH - 1) / KG_CH;
  g.nchA = fit ? (m + KG_CH - 1) / KG_CH : 0;
  int64_t off = 0;
  auto take = [&](int64_t words) {
    char* ptr = base ? base + 4 * off : nullptr;
    off += (words + 3) / 4 * 4;  // 16-byte aligned pieces
    return ptr;
  };
  g.histB = (int*)take((int64_t)g.nchB * g.G);
  g.histA = (int*)take((int64_t)g.nchA * g.G);
  g.colPad = (int*)take(g.G + 1);
  g.cntB = (int*)take(g.G);
  g.rowStart = (int*)take(g.G + 1);
  g.cntA = (int*)take(g.G);
  g.tileStart = (int*)take(g.G + 1);
  g.invB = (int*)take(n);
  g.permA = (int*)take(fit ? m : 0);
  g.Bt = (float*)take(((int64_t)n + (int64_t)g.G * KT) * (p + 2));
  if (gr) *gr = g;
  return off;
}

// Bytes of scratch rt_kde_rowsums needs: the row norms (m), then for the
// wide layout the column norms (n), else the grouping's pieces.
extern "C" int64_t rt_kde_scratch_bytes(int m, int n, int p, int L,
                                        int fit, int wide) {
  const int64_t norms = ((int64_t)m + (wide ? n : 0) + 3) / 4 * 4;
  if (wide) return 4 * norms;
  return 4 * (norms + group_scratch(m, n, p, L, fit, nullptr, nullptr));
}

// yA NULL selects the per-label form (out (m, L), 1 <= L <= KS_MAX_LABELS);
// given yA, labels in [0, L) are grouped (0 <= L <= KS_MAX_LABELS) and the
// rest compared. den is f32(2 h^2), or its reciprocal with mul. scratch:
// rt_kde_scratch_bytes(m, n, p, L, yA != NULL, wide) bytes, 16-byte
// aligned.
extern "C" int rt_kde_rowsums(const void* A, const void* B, const void* yA,
                              const void* yB, void* scratch, void* out,
                              int m, int n, int p, int L, float den, int mul,
                              int exclude_diag, int wide, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool fit = yA != nullptr;
  if (L < (fit ? 0 : 1) || L > KS_MAX_LABELS || p < 1 ||
      (wide && p > KW_MAX_P) || (!wide && group_rows(p) < 1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const float* fA = (const float*)A;
  const float* fB = (const float*)B;
  const int* iA = (const int*)yA;
  const int* iB = (const int*)yB;
  float* fo = (float*)out;
  float* a2 = (float*)scratch;
  const int64_t norms = ((int64_t)m + (wide ? n : 0) + 3) / 4 * 4;
  const int rows = m + (wide ? n : 0);
  kde_sumsq_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      fA, m, fB, wide ? n : 0, p, a2, a2 + m);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (wide) {
    const size_t sh = p * sizeof(float);
    if (fit)
      kde_rowsums_wide_kernel<false><<<m, KW_T, sh, st>>>(
          fA, fB, iA, iB, a2, a2 + m, fo, n, p, 1, den, mul, exclude_diag);
    else
      kde_rowsums_wide_kernel<true><<<m, KW_T, sh, st>>>(
          fA, fB, iA, iB, a2, a2 + m, fo, n, p, L, den, mul, exclude_diag);
    return (int)cudaGetLastError();
  }
  KdeGroups gr;
  group_scratch(m, n, p, L, fit, (char*)scratch + 4 * norms, &gr);
  const bool areg = p <= KS_PC;
  const int KT = areg ? KS_KT : KS_C, BM = group_rows(p);
  const int nrank = gr.nchB + gr.nchA;
  if (nrank > 0) {
    kde_group_rank_kernel<false><<<nrank, 32, 0, st>>>(iB, n, iA, m, fB, p,
                                                       L, KT, gr);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  }
  kde_group_scan_kernel<<<1, 256, 0, st>>>(KT, BM, gr);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  kde_group_rank_kernel<true><<<nrank + gr.G, 32, 0, st>>>(iB, n, iA, m, fB,
                                                           p, L, KT, gr);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  // fit: at most ceil(m / BM) + G blocks hold rows; the rest exit
  const int grid = fit ? (m + BM - 1) / BM + gr.G : (m + BM - 1) / BM * L;
  const int T = BM / KS_R;
  if (areg) {
    if (mul)
      kde_group_kernel<true, true><<<grid, T, 0, st>>>(
          fA, iA, a2, fo, m, n, p, L, den, exclude_diag, gr);
    else
      kde_group_kernel<true, false><<<grid, T, 0, st>>>(
          fA, iA, a2, fo, m, n, p, L, den, exclude_diag, gr);
  } else {
    const int sh = BM * p * (int)sizeof(float);
    auto kern = mul ? kde_group_kernel<false, true>
                    : kde_group_kernel<false, false>;
    rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sh);
    if (rc != 0) return rc;
    kern<<<grid, T, sh, st>>>(fA, iA, a2, fo, m, n, p, L, den, exclude_diag,
                              gr);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_kde_expf(const void* x, void* y, int64_t n, void* stream) {
  if (n > 0)
    kde_expf_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

// The serving tick's front end, both modes, for the whole tenant batch in
// one launch: the exact decremental repair of the point each tenant has
// just evicted, then the distance row of its new point and the gated
// ordered insert of that point into every row's k-best list.
//
// Replaces: repro/kernels/stream_update.py::stream_update (mode="class"
// and mode="reg"), the Pallas kernel the JAX engines vmap once per
// tenant, together with the eviction repair they run before it in plain
// XLA (repro/core/online.py::drop_backfill, at repro/serving/
// session.py:237 and repro/regression/session.py:163).
//
// Per tenant s, (head, n, wrap) is the window after the eviction; slot i
// is live iff i < wrap and its age (i - head) mod wrap is below n. With
// ev[s] set, the point at slot head - 1 (mod wrap) has just left it.
//
// Repair (ev[s] only). Its distances es[i] are row head - 1 of D: D is
// symmetric bit for bit (every write puts the same row into a row and a
// column), so the row is the column, read in one contiguous run. Row i is
// affected iff live, es[i] <= its k-th best and, in classification, its
// label is the evicted point's. Only affected rows -- about k of a window,
// as each point sits in about k lists -- read their row of D:
//   pos0 = #{L[j] < es}, tprime = L[k-1] if pos0 <= k-2 else L[k-2] (-1 at
//   k = 1), mprime = #{L[j] == tprime} - [es == tprime];
//   over the candidate columns c (live; classification: same label),
//   cnt = #{D[i,c] == tprime} and gtmin = min{D[i,c] > tprime} (BIG);
//   b = cnt > mprime ? tprime : gtmin; L' = L without slot pos0, b last.
// Regression also repairs the label and arrival-id lists: thr = max over
// j of (L[j] == tprime ? La[j] - aid0 : -1) when b == tprime, else -1
// (int32 wrap-subtracted ids, aid0 the evicted id); the backfill label and
// id come from the slot of the smallest age among the live columns with
// D[i,c] == b and aid[c] - aid0 > thr (rank w - 1 when there is none);
// slots left at BIG carry the row's own label and id 0. Every output is a
// selected stored value, every reduction order-free (an integer count, an
// f32 min, an int32 max and min): the bits of ref.stream_tick, the plain
// composition, whose drop_backfill repairs every row and keeps the
// affected ones.
//
// Classification then, per row i of the repaired window:
//   d[i]  = sqrt(max(sum_j (X[i,j] - x_new[j])^2, 0)) if live, else BIG;
//   M[i]  = L[i] with c = (live && y[i] == y_new) ? d : BIG inserted
//           strictly after equal values, largest entry dropped;
//   base[i] = L[i][0] + ... + L[i][k-2] left to right (0 at k = 1), the
//           score the tick prices against, less its k-th term.
// Regression:
//   d     = sqrt(max((|x_new|^2 + |X_i|^2) - 2 x_new.X_i, 0)), the fixed-
//           order form of ref.sq_dists, bitwise equal to pairwise_sq_dists;
//   d_row = live ? d : BIG; c = (live && d < L[k-1]) ? d : BIG;
//   M, Y', A' = c inserted into L after equal values, y_new into the label
//           list and new_aid into the id list at the same place; BIG slots
//           carry the row's own label and id 0;
//   ysum  = Y[i][0] + ... + Y[i][k-1] left to right, of the repaired labels.
//
// Bound: memory. A tick reads X, y and the lists once, the evicted rows of
// D (S*w*4 bytes) and the affected rows of D, and writes d, the merged
// lists and the repaired rows in place; the flops are ~S*w*(3p + 2k).
// Design: one block per (tenant, tile of SU_ROWS rows), one thread a row.
// The tile's rows of X (in chunks of 32 features), its lists and x_new are
// staged into shared memory by coalesced 16-byte loads, several in flight
// a thread (rows padded to an odd word stride against bank conflicts, the
// row of an element found by a multiply-high); the outputs leave through
// shared memory (the spent feature tile where they fit) by coalesced
// 16-byte stores. Each thread flags its row; a warp ballot and a
// prefix over the warps compact the affected rows; one warp per affected
// row scans its row of D (16-byte loads where the strides allow) against
// the ring liveness and the labels or ids (read through the read-only
// cache, one 4 KB row a tenant), reduces with shuffles, repairs the list in
// shared memory and writes the row back in place. The other rows never
// read D. Sums run in fixed order with explicit round-to-nearest multiply
// and add (no FMA contraction), the order of the plain versions in ref.py,
// so the two agree bit for bit. Tenants are reached by the given strides,
// so the [:w] ring-block views of capacity-padded state pass in place.
// A template flag drops the repair for the callers that never evict.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SU_MAX_K 32
#define SU_ROWS 128  // rows of one tenant per block, one thread each
#define SU_WARPS (SU_ROWS / 32)
#define SU_XC 32       // features staged per chunk
#define SU_XS 33       // their padded row stride
#define SU_BIG 1e30f
#define SU_FULL 0xffffffffu

struct Ring {  // one tenant's window after the eviction
  int head, n, wrap, w;
  __device__ __forceinline__ int age(int c) const {
    if (c >= wrap) return w;
    const int a = c - head;
    return a < 0 ? a + wrap : a;
  }
  __device__ __forceinline__ bool live(int c) const { return age(c) < n; }
  __device__ __forceinline__ int slot(int r) const {
    const int t = r + head;
    return t >= wrap ? t - wrap : t;
  }
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(SU_FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(SU_FULL, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(SU_FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_fmin(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(SU_FULL, v, o));
  return v;
}

// e / d by a multiply-high with m = ceil(2^32 / d): exact for e < 2^32 / d
// (a tile holds at most SU_ROWS * SU_XS elements); d == 1 apart.
struct Div {
  unsigned d, m;
  __device__ __forceinline__ explicit Div(unsigned dd)
      : d(dd), m(dd > 1 ? 0xffffffffu / dd + 1u : 0u) {}
  __device__ __forceinline__ unsigned operator()(unsigned e) const {
    return d > 1 ? __umulhi(e, m) : e;
  }
};

// rows x width contiguous 4-byte values (src) -> shared rows of stride ws
// (dst), 16 bytes a load where src allows. Plain loads: the lists are
// written in place later in the launch (by each block only its own rows,
// after reading them).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ws, const T* src,
                                      int width, int rows) {
  static_assert(sizeof(T) == 4, "4-byte values");
  const int total = rows * width;
  const Div div(width);
  int* out = reinterpret_cast<int*>(dst);
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    const int n4 = total >> 2;
#pragma unroll 4
    for (int e4 = threadIdx.x; e4 < n4; e4 += SU_ROWS) {
      const int4 v4 = s4[e4];
      const int v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned e = 4u * e4 + q, r = div(e);
        out[r * ws + e - r * width] = v[q];
      }
    }
    e0 = n4 << 2;
  }
  const int* in = reinterpret_cast<const int*>(src);
  for (int e = e0 + threadIdx.x; e < total; e += SU_ROWS) {
    const unsigned r = div(e);
    out[r * ws + e - r * width] = in[e];
  }
}

// shared rows of stride ws (src) -> rows x width contiguous 4-byte values
// (dst), 16 bytes a store where dst allows
template <typename T>
__device__ __forceinline__ void unstage(T* dst, const T* src, int ws,
                                        int width, int rows) {
  static_assert(sizeof(T) == 4, "4-byte values");
  const int total = rows * width;
  const Div div(width);
  const int* in = reinterpret_cast<const int*>(src);
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int n4 = total >> 2;
#pragma unroll 4
    for (int e4 = threadIdx.x; e4 < n4; e4 += SU_ROWS) {
      int v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned e = 4u * e4 + q, r = div(e);
        v[q] = in[r * ws + e - r * width];
      }
      d4[e4] = make_int4(v[0], v[1], v[2], v[3]);
    }
    e0 = n4 << 2;
  }
  int* out = reinterpret_cast<int*>(dst);
  for (int e = e0 + threadIdx.x; e < total; e += SU_ROWS) {
    const unsigned r = div(e);
    out[e] = in[r * ws + e - r * width];
  }
}

// The next chunk of the tile's features into xt (stride SU_XS): columns
// j0 .. j0 + pc of rows of stride p. One chunk (p <= SU_XC) is a contiguous
// run; wider rows are copied a row per warp.
__device__ __forceinline__ void stage_x(float* xt, const float* Xs, int p,
                                        int j0, int pc, int rows) {
  if (pc == p) {
    stage(xt, SU_XS, Xs, p, rows);
    return;
  }
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = threadIdx.x >> 5; r < rows; r += SU_WARPS)
    if (lane < pc) xt[r * SU_XS + lane] = __ldg(Xs + (int64_t)r * p + j0 + lane);
}

// Compacts the block's flagged rows into rows[]; returns their count.
__device__ __forceinline__ int compact(bool flag, int* rows, int* wcnt) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(SU_FULL, flag);
  if (lane == 0) wcnt[wid] = __popc(bal);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int q = 0; q < SU_WARPS; ++q) {
    base += q < wid ? wcnt[q] : 0;
    total += wcnt[q];
  }
  if (flag) rows[base + __popc(bal & ((1u << lane) - 1u))] = threadIdx.x;
  __syncthreads();
  return total;
}

// One warp's scan of row Drow for (cnt, gtmin) at tprime over the columns
// cand() admits: the count and min of the repair.
template <bool LABEL>
__device__ __forceinline__ void scan_tprime(
    const float* __restrict__ Drow, const int* __restrict__ lab, int yr,
    const Ring& ring, float tp, bool vec, int& cnt, float& gm) {
  const int lane = threadIdx.x & 31, w = ring.w;
  cnt = 0;
  gm = SU_BIG;
  if (vec) {
#pragma unroll 4
    for (int c4 = lane; c4 < (w >> 2); c4 += 32) {
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(Drow) + c4);
      int4 l4 = make_int4(0, 0, 0, 0);
      if (LABEL) l4 = __ldg(reinterpret_cast<const int4*>(lab) + c4);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      const int lb[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * c4 + q;
        const bool cand = ring.live(c) && (!LABEL || lb[q] == yr);
        cnt += (cand && v[q] == tp) ? 1 : 0;
        if (cand && v[q] > tp) gm = fminf(gm, v[q]);
      }
    }
  } else {
    for (int c = lane; c < w; c += 32) {
      const float v = __ldg(Drow + c);
      const bool cand = ring.live(c) && (!LABEL || __ldg(lab + c) == yr);
      cnt += (cand && v == tp) ? 1 : 0;
      if (cand && v > tp) gm = fminf(gm, v);
    }
  }
  cnt = warp_sum(cnt);
  gm = warp_fmin(gm);
}

// The regression backfill pick: the smallest age among the live columns
// at distance b whose id (less aid0) exceeds thr; w when there is none.
__device__ __forceinline__ int scan_pick(
    const float* __restrict__ Drow, const int* __restrict__ aid, int aid0,
    const Ring& ring, float b, int thr, bool vec) {
  const int lane = threadIdx.x & 31, w = ring.w;
  int am = w;
  if (vec) {
#pragma unroll 4
    for (int c4 = lane; c4 < (w >> 2); c4 += 32) {
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(Drow) + c4);
      const int4 a4 = __ldg(reinterpret_cast<const int4*>(aid) + c4);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      const int av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * c4 + q, age = ring.age(c);
        const int rel = (int)((unsigned)av[q] - (unsigned)aid0);
        if (v[q] == b && age < ring.n && rel > thr) am = min(am, age);
      }
    }
  } else {
    for (int c = lane; c < w; c += 32) {
      const int age = ring.age(c);
      const int rel = (int)((unsigned)__ldg(aid + c) - (unsigned)aid0);
      if (__ldg(Drow + c) == b && age < ring.n && rel > thr)
        am = min(am, age);
    }
  }
  return warp_min(am);
}

// The repair's list arithmetic for one affected row, in one warp, lane j
// holding entry j of the list lr (shared memory, k <= 32): (pos0, tprime,
// mprime) of the evicted distance es.
__device__ __forceinline__ void drop_stats(const float* lr, int k, float es,
                                           float& Lj, int& pos0, float& tp,
                                           int& mp) {
  const int lane = threadIdx.x & 31;
  Lj = lane < k ? lr[lane] : 0.f;
  pos0 = __popc(__ballot_sync(SU_FULL, lane < k && Lj < es));
  tp = k >= 2 ? (pos0 <= k - 2 ? lr[k - 1] : lr[k - 2]) : -1.f;
  mp = __popc(__ballot_sync(SU_FULL, lane < k && Lj == tp)) -
       (es == tp ? 1 : 0);
}

// Shared memory of the two kernels, in floats: x_new, the feature tile,
// the lists, and the merged lists (on the feature tile where they fit).
__host__ __device__ __forceinline__ int class_smem(int p, int k) {
  return p + SU_ROWS * SU_XS + SU_ROWS * (k | 1);
}
__host__ __device__ __forceinline__ bool reg_alias(int k) {
  return 3 * (k | 1) <= SU_XS;
}
__host__ __device__ __forceinline__ int reg_smem(int p, int k) {
  return p + SU_ROWS * SU_XS + (reg_alias(k) ? 3 : 6) * SU_ROWS * (k | 1);
}

template <bool EVICT>
__global__ void __launch_bounds__(SU_ROWS) stream_tick_class_kernel(
    const float* __restrict__ X, int64_t sX, const int* __restrict__ y,
    int64_t sy, float* __restrict__ L, int64_t sL,
    const float* __restrict__ D, int64_t sD0, int64_t sD1,
    const unsigned char* __restrict__ ev, const float* __restrict__ x_new,
    const int* __restrict__ y_new, const int* __restrict__ n,
    const int* __restrict__ head, const int* __restrict__ wrap,
    float* __restrict__ d_out, float* __restrict__ M_out,
    float* __restrict__ base_out, int w, int p, int k, int vec) {
  extern __shared__ float sm[];
  __shared__ int aff_rows[SU_ROWS], wcnt[SU_WARPS];
  __shared__ float es_s[SU_ROWS];
  const int KS = k | 1;
  float* xs = sm;                     // x_new[s], p
  float* xt = xs + p;                 // feature chunk, SU_ROWS x SU_XS
  float* lt = xt + SU_ROWS * SU_XS;   // lists, SU_ROWS x KS
  float* mt = xt;                     // merged lists, on the spent chunk

  const int s = blockIdx.y, i0 = blockIdx.x * SU_ROWS, r = threadIdx.x;
  const int i = i0 + r, rows = min(SU_ROWS, w - i0);
  const bool own = r < rows;
  const Ring ring{head[s], n[s], wrap[s], w};
  const int* ys = y + (int64_t)s * sy;
  float* Ls = L + (int64_t)s * sL + (int64_t)i0 * k;

  for (int j = r; j < p; j += SU_ROWS) xs[j] = x_new[(int64_t)s * p + j];
  stage(lt, KS, Ls, k, rows);
  const float* Xs = X + (int64_t)s * sX + (int64_t)i0 * p;
  float acc = 0.f;
  for (int j0 = 0; j0 < p; j0 += SU_XC) {
    const int pc = min(SU_XC, p - j0);
    __syncthreads();
    stage_x(xt, Xs, p, j0, pc, rows);
    __syncthreads();
    if (own) {
      for (int j = 0; j < pc; ++j) {
        const float t = __fsub_rn(xt[r * SU_XS + j], xs[j0 + j]);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
    }
  }
  const int yi = own ? __ldg(ys + i) : 0;
  __syncthreads();  // the feature tile is spent: mt may take it

  if (EVICT && ev[s]) {  // uniform over the block
    const int hd = ring.head == 0 ? ring.wrap - 1 : ring.head - 1;
    const float* Dh = D + (int64_t)s * sD0 + (int64_t)hd * sD1;
    bool aff = false;
    if (own) {
      const float es = __ldg(Dh + i);
      es_s[r] = es;
      aff = yi == __ldg(ys + hd) && ring.live(i) && es <= lt[r * KS + k - 1];
    }
    const int n_aff = compact(aff, aff_rows, wcnt);
    const int lane = r & 31;
    for (int a = r >> 5; a < n_aff; a += SU_WARPS) {
      const int ra = aff_rows[a], ia = i0 + ra;
      float* lr = lt + ra * KS;
      float Lj, tp;
      int pos0, mp, cnt;
      drop_stats(lr, k, es_s[ra], Lj, pos0, tp, mp);
      float gm;
      scan_tprime<true>(D + (int64_t)s * sD0 + (int64_t)ia * sD1, ys,
                        __ldg(ys + ia), ring, tp, vec, cnt, gm);
      const float b = cnt > mp ? tp : gm;
      const float Lj1 = lane + 1 < k ? lr[lane + 1] : 0.f;
      __syncwarp();
      if (lane < k) {
        const float v = lane < pos0 ? Lj : (lane < k - 1 ? Lj1 : b);
        lr[lane] = v;
        Ls[(int64_t)ra * k + lane] = v;
      }
    }
    __syncthreads();
  }

  if (own) {
    const bool live = ring.live(i);
    const float d = live ? sqrtf(acc < 0.f ? 0.f : acc) : SU_BIG;
    const float c = (live && yi == y_new[s]) ? d : SU_BIG;
    const float* lr = lt + r * KS;
    float* mr = mt + r * KS;
    float bs = k >= 2 ? lr[0] : 0.f;
    int pos = 0;
    for (int j = 0; j < k; ++j) {
      pos += lr[j] <= c ? 1 : 0;
      if (j >= 1 && j <= k - 2) bs = __fadd_rn(bs, lr[j]);
    }
    for (int j = 0; j < k; ++j)
      mr[j] = j < pos ? lr[j] : (j == pos ? c : lr[j - 1]);
    d_out[(int64_t)s * w + i] = d;
    base_out[(int64_t)s * w + i] = bs;
  }
  __syncthreads();
  unstage(M_out + ((int64_t)s * w + i0) * k, mt, KS, k, rows);
}

template <bool EVICT>
__global__ void __launch_bounds__(SU_ROWS) stream_tick_reg_kernel(
    const float* __restrict__ X, int64_t sX, const float* __restrict__ y,
    int64_t sy, float* __restrict__ L, int64_t sL, float* __restrict__ Y,
    int64_t sY, int* __restrict__ A, int64_t sA,
    const int* __restrict__ aid, int64_t said,
    const float* __restrict__ D, int64_t sD0, int64_t sD1,
    const unsigned char* __restrict__ ev, const float* __restrict__ x_new,
    const float* __restrict__ y_new, const int* __restrict__ new_aid,
    const int* __restrict__ n, const int* __restrict__ head,
    const int* __restrict__ wrap, float* __restrict__ d_out,
    float* __restrict__ M_out, float* __restrict__ Ym_out,
    int* __restrict__ Am_out, float* __restrict__ ysum_out, int w, int p,
    int k, int vec) {
  extern __shared__ float sm[];
  __shared__ int aff_rows[SU_ROWS], wcnt[SU_WARPS];
  __shared__ float es_s[SU_ROWS];
  const int KS = k | 1, T = SU_ROWS * KS;
  float* xs = sm;                     // x_new[s], p
  float* xt = xs + p;                 // feature chunk, SU_ROWS x SU_XS
  float* lt = xt + SU_ROWS * SU_XS;   // distance lists
  float* yt = lt + T;                 // label lists
  int* at = reinterpret_cast<int*>(yt + T);  // id lists
  float* mt = reg_alias(k) ? xt : yt + 2 * T;  // merged distance lists
  float* ymt = mt + T;                // merged label lists
  int* amt = reinterpret_cast<int*>(ymt + T);  // merged id lists

  const int s = blockIdx.y, i0 = blockIdx.x * SU_ROWS, r = threadIdx.x;
  const int i = i0 + r, rows = min(SU_ROWS, w - i0);
  const bool own = r < rows;
  const Ring ring{head[s], n[s], wrap[s], w};
  const float* ys = y + (int64_t)s * sy;
  float* Ls = L + (int64_t)s * sL + (int64_t)i0 * k;
  float* Ys = Y + (int64_t)s * sY + (int64_t)i0 * k;
  int* As = A + (int64_t)s * sA + (int64_t)i0 * k;

  for (int j = r; j < p; j += SU_ROWS) xs[j] = x_new[(int64_t)s * p + j];
  stage(lt, KS, Ls, k, rows);
  stage(yt, KS, Ys, k, rows);
  stage(at, KS, As, k, rows);
  const float* Xs = X + (int64_t)s * sX + (int64_t)i0 * p;
  float xx = 0.f, XX = 0.f, ab = 0.f;
  for (int j0 = 0; j0 < p; j0 += SU_XC) {
    const int pc = min(SU_XC, p - j0);
    __syncthreads();
    stage_x(xt, Xs, p, j0, pc, rows);
    __syncthreads();
    if (own) {
      for (int j = 0; j < pc; ++j) {
        const float a = xs[j0 + j], b = xt[r * SU_XS + j];
        xx = __fadd_rn(xx, __fmul_rn(a, a));
        XX = __fadd_rn(XX, __fmul_rn(b, b));
        ab = __fadd_rn(ab, __fmul_rn(a, b));
      }
    }
  }
  const float yi = own ? __ldg(ys + i) : 0.f;
  __syncthreads();  // the feature tile is spent: the merged lists may take it

  if (EVICT && ev[s]) {  // uniform over the block
    const int hd = ring.head == 0 ? ring.wrap - 1 : ring.head - 1;
    const int* aids = aid + (int64_t)s * said;
    const int aid0 = __ldg(aids + hd);
    const float* Dh = D + (int64_t)s * sD0 + (int64_t)hd * sD1;
    bool aff = false;
    if (own) {
      const float es = __ldg(Dh + i);
      es_s[r] = es;
      aff = ring.live(i) && es <= lt[r * KS + k - 1];
    }
    const int n_aff = compact(aff, aff_rows, wcnt);
    const int lane = r & 31;
    for (int a = r >> 5; a < n_aff; a += SU_WARPS) {
      const int ra = aff_rows[a], ia = i0 + ra;
      float* lr = lt + ra * KS;
      float* yr = yt + ra * KS;
      int* arow = at + ra * KS;
      float Lj, tp;
      int pos0, mp, cnt;
      drop_stats(lr, k, es_s[ra], Lj, pos0, tp, mp);
      const float* Drow = D + (int64_t)s * sD0 + (int64_t)ia * sD1;
      float gm;
      scan_tprime<false>(Drow, nullptr, 0, ring, tp, vec, cnt, gm);
      const float b = cnt > mp ? tp : gm;
      const int Aj = lane < k ? arow[lane] : 0;
      const int cand_thr = lane < k
          ? (Lj == tp ? (int)((unsigned)Aj - (unsigned)aid0) : -1) : INT_MIN;
      int thr = warp_max(cand_thr);
      if (b != tp) thr = -1;
      const int am = scan_pick(Drow, aids, aid0, ring, b, thr, vec);
      const int sl = ring.slot(am < w - 1 ? am : w - 1);
      const float yb = __ldg(ys + sl);
      const int abk = __ldg(aids + sl);
      const float Yj = lane < k ? yr[lane] : 0.f;
      const float Lj1 = lane + 1 < k ? lr[lane + 1] : 0.f;
      const float Yj1 = lane + 1 < k ? yr[lane + 1] : 0.f;
      const int Aj1 = lane + 1 < k ? arow[lane + 1] : 0;
      __syncwarp();
      if (lane < k) {
        const bool keep = lane < pos0, up = lane < k - 1;
        const float v = keep ? Lj : (up ? Lj1 : b);
        const bool big = v >= SU_BIG;
        const float lab = big ? __ldg(ys + ia) : (keep ? Yj : (up ? Yj1 : yb));
        const int idv = big ? 0 : (keep ? Aj : (up ? Aj1 : abk));
        lr[lane] = v;
        yr[lane] = lab;
        arow[lane] = idv;
        Ls[(int64_t)ra * k + lane] = v;
        Ys[(int64_t)ra * k + lane] = lab;
        As[(int64_t)ra * k + lane] = idv;
      }
    }
    __syncthreads();
  }

  if (own) {
    const bool live = ring.live(i);
    const float d2 = __fsub_rn(__fadd_rn(xx, XX), __fmul_rn(2.f, ab));
    const float d = __fsqrt_rn(d2 < 0.f ? 0.f : d2);
    const float* lr = lt + r * KS;
    const float c = (live && d < lr[k - 1]) ? d : SU_BIG;
    const float yn = y_new[s];
    const int an = new_aid[s];
    const float* yr = yt + r * KS;
    const int* arow = at + r * KS;
    float* mr = mt + r * KS;
    float* ymr = ymt + r * KS;
    int* amr = amt + r * KS;
    float sy_ = yr[0];
    int pos = 0;
    for (int j = 0; j < k; ++j) {
      pos += lr[j] <= c ? 1 : 0;
      if (j >= 1) sy_ = __fadd_rn(sy_, yr[j]);
    }
    for (int j = 0; j < k; ++j) {
      const int q = j > 0 ? j - 1 : 0;
      const float v = j < pos ? lr[j] : (j == pos ? c : lr[q]);
      const bool big = v >= SU_BIG;
      mr[j] = v;
      ymr[j] = big ? yi : (j < pos ? yr[j] : (j == pos ? yn : yr[q]));
      amr[j] = big ? 0 : (j < pos ? arow[j] : (j == pos ? an : arow[q]));
    }
    d_out[(int64_t)s * w + i] = live ? d : SU_BIG;
    ysum_out[(int64_t)s * w + i] = sy_;
  }
  __syncthreads();
  const int64_t o = ((int64_t)s * w + i0) * k;
  unstage(M_out + o, mt, KS, k, rows);
  unstage(Ym_out + o, ymt, KS, k, rows);
  unstage(Am_out + o, amt, KS, k, rows);
}

static bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

template <typename K>
static int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Classification tick. L (the lists) is read and, where ev is given,
// repaired in place; ev == NULL drops the repair (D is then not read).
extern "C" int rt_stream_update_class(
    const void* X, int64_t sX, const void* y, int64_t sy, void* L,
    int64_t sL, const void* D, int64_t sD0, int64_t sD1, const void* ev,
    const void* x_new, const void* y_new, const void* n, const void* head,
    const void* wrap, void* d_out, void* M_out, void* base_out, int S,
    int w, int p, int k, void* stream) {
  if (k < 1 || k > SU_MAX_K || w < 1 || p < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)class_smem(p, k);
  const int vec = (w % 4 == 0) && aligned16(D) && sD0 % 4 == 0 &&
                  sD1 % 4 == 0 && aligned16(y) && sy % 4 == 0;
  const dim3 grid((w + SU_ROWS - 1) / SU_ROWS, S);
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (ev) {
    if ((rc = prepare(stream_tick_class_kernel<true>, smem))) return rc;
    stream_tick_class_kernel<true><<<grid, SU_ROWS, smem, st>>>(
        (const float*)X, sX, (const int*)y, sy, (float*)L, sL,
        (const float*)D, sD0, sD1, (const unsigned char*)ev,
        (const float*)x_new, (const int*)y_new, (const int*)n,
        (const int*)head, (const int*)wrap, (float*)d_out, (float*)M_out,
        (float*)base_out, w, p, k, vec);
  } else {
    if ((rc = prepare(stream_tick_class_kernel<false>, smem))) return rc;
    stream_tick_class_kernel<false><<<grid, SU_ROWS, smem, st>>>(
        (const float*)X, sX, (const int*)y, sy, (float*)L, sL, nullptr, 0, 0,
        nullptr, (const float*)x_new, (const int*)y_new, (const int*)n,
        (const int*)head, (const int*)wrap, (float*)d_out, (float*)M_out,
        (float*)base_out, w, p, k, 0);
  }
  return (int)cudaGetLastError();
}

// Regression tick. L, Y and A (the distance, label and id lists) are read
// and, where ev is given, repaired in place (aid required then).
extern "C" int rt_stream_update_reg(
    const void* X, int64_t sX, const void* y, int64_t sy, void* L,
    int64_t sL, void* Y, int64_t sY, void* A, int64_t sA, const void* aid,
    int64_t said, const void* D, int64_t sD0, int64_t sD1, const void* ev,
    const void* x_new, const void* y_new, const void* new_aid,
    const void* n, const void* head, const void* wrap, void* d_out,
    void* M_out, void* Ym_out, void* Am_out, void* ysum_out, int S, int w,
    int p, int k, void* stream) {
  if (k < 1 || k > SU_MAX_K || w < 1 || p < 1 || A == nullptr ||
      new_aid == nullptr || Am_out == nullptr || (ev && aid == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)reg_smem(p, k);
  const int vec = (w % 4 == 0) && aligned16(D) && sD0 % 4 == 0 &&
                  sD1 % 4 == 0 && aligned16(aid) && said % 4 == 0;
  const dim3 grid((w + SU_ROWS - 1) / SU_ROWS, S);
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (ev) {
    if ((rc = prepare(stream_tick_reg_kernel<true>, smem))) return rc;
    stream_tick_reg_kernel<true><<<grid, SU_ROWS, smem, st>>>(
        (const float*)X, sX, (const float*)y, sy, (float*)L, sL, (float*)Y,
        sY, (int*)A, sA, (const int*)aid, said, (const float*)D, sD0, sD1,
        (const unsigned char*)ev, (const float*)x_new, (const float*)y_new,
        (const int*)new_aid, (const int*)n, (const int*)head,
        (const int*)wrap, (float*)d_out, (float*)M_out, (float*)Ym_out,
        (int*)Am_out, (float*)ysum_out, w, p, k, vec);
  } else {
    if ((rc = prepare(stream_tick_reg_kernel<false>, smem))) return rc;
    stream_tick_reg_kernel<false><<<grid, SU_ROWS, smem, st>>>(
        (const float*)X, sX, (const float*)y, sy, (float*)L, sL, (float*)Y,
        sY, (int*)A, sA, nullptr, 0, nullptr, 0, 0, nullptr,
        (const float*)x_new, (const float*)y_new, (const int*)new_aid,
        (const int*)n, (const int*)head, (const int*)wrap, (float*)d_out,
        (float*)M_out, (float*)Ym_out, (int*)Am_out, (float*)ysum_out, w, p,
        k, 0);
  }
  return (int)cudaGetLastError();
}

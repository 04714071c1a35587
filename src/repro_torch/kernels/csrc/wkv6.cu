// Chunked WKV6 recurrence for Hopper (RWKV-6 "Finch" time-mix).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py:20
// (_wkv6_kernel, entry wkv6_pallas at :56).  Per head, from a zero state
// S [N, N], with r, k, v and the log decay lw = log(clip(w, 1e-8, 1)) in
// chunks of c steps and lc the inclusive cumulative sum of lw over a chunk:
//   att[t, s] = sum_n r[t,n] k[s,n] exp(clip(lc[t-1,n] - lc[s,n], -60, 0)), s < t
//   o[t]      = att[t] v + (sum_n r[t,n] u[n] k[t,n]) v[t] + (r[t] * exp(clip(lc[t-1]))) S
//   S        <- exp(clip(lc[c-1])) S + (k * exp(clip(lc[c-1] - lc)))^T v
// and the final S, which the reference's prefill takes from its XLA twin
// (models/rwkv6.py:106 wkv6_chunked).
//
// What bounds it: at the main path's shape (B*H = 256, T = 512, N = 64,
// c = 64) the inputs and outputs are 172 MB, 0.051 ms at 3.35 TB/s; the
// chunk products of this design take about 4.4 GFLOP of f32 on CUDA cores
// (0.066 ms at the 67 TFLOP/s f32 peak; no TF32, which would change the
// numbers), and the pairwise decay of the reference's form 0.28 G
// exponentials (0.067 ms at 16 a clock per SM and 1.98 GHz).  The design:
//
//  * Chunks in parallel.  Only the carried [N, N] state is serial.  A
//    (b, h) gets a thread-block cluster of cl = min(8, T / c) CTAs, each
//    over a contiguous range of chunks.  Each CTA first reduces its range
//    to a summary, the state it would carry out from a zero state (Lsum)
//    and its decay (the product of exp(clip(lc[c-1])), avec).  After one
//    cluster barrier each CTA forms the state entering its range from the
//    summaries of the CTAs before it, in rank order through distributed
//    shared memory (S = A_q S + L_q, the reference's own recurrence, so the
//    result does not depend on timing).  Meanwhile, before waiting, a CTA
//    with one chunk (the main shape: T / c <= 8) computes everything of its
//    chunk that needs no state: the intra-chunk attention and att v.  With
//    more chunks than 8 a CTA runs its range again after the barrier,
//    carrying S (kMulti).
//  * Fewer exponentials.  The pairwise decay factors through the
//    boundaries of 8-step sub-chunks: for s in sub-chunk j' < j (the
//    sub-chunk of t), with b = 8 j and e = 8 j' + 7,
//      exp(lc[t-1] - lc[s]) = exp(lc[t-1] - lc[b-1]) exp(lc[b-1] - lc[e])
//                             exp(lc[e] - lc[s]),
//    each factor in (0, 1] and clipped at -60 on its own, so only pairs
//    inside a sub-chunk take their own exponential (the bonus u rides on
//    the diagonal of those), and the cross terms become one product,
//    r' diag(M[j][j']) k''^T.  It differs from the reference only where
//    the -60 clip binds, by at most e^-60 |r||k| a term
//    (kernels/rwkv6/ref.py wkv6_factored mirrors it).  At c = N = 64 a
//    chunk takes 32,064 exponentials (14,336 of them inside sub-chunks)
//    where the reference's form takes 137,280.  The pairs inside a
//    sub-chunk go to lane groups by row: rows tl and 7 - tl hold 9 pairs
//    together, so every group has the same work and no index to decode.
//  * Register-tiled products.  Every product (att, att v, r' S, k^T v)
//    gives a thread 4 x 4 f32 tiles (att only below the diagonal sub-chunks,
//    two threads a tile; att v stops at the diagonal), reading 16-byte
//    vectors from rows padded by 4 floats, so a warp's loads hit distinct
//    banks or broadcast.
//  * Decays in base 2 (log2 of the clipped w, summed; 2^x by ex2.approx),
//    which the f32 comparison with the plain version absorbs (relative
//    error about 2^-22 a factor).
//  * Operands staged by cp.async, all four issued before the first wait
//    (w's log is taken in shared memory); a chunk's rows are zero-padded to
//    a multiple of 16 (lw = 0 there), which changes nothing.  At
//    c = N = 64 a CTA takes 112 KB of shared memory, so two fit on an SM:
//    one loads while the other computes.
// Inputs and outputs keep the model's [B, T, H, N] layout; S comes out as
// [B, H, N, N].
#include <cooperative_groups.h>
#include <limits.h>

#include "hopper.cuh"

namespace repro_torch {

constexpr int kWkvThreads = 256;
constexpr int kWkvMaxChunk = 64;
constexpr int kWkvSub = 8;          // sub-chunk length
constexpr int kWkvMaxSubs = kWkvMaxChunk / kWkvSub;
constexpr int kWkvMRows = kWkvMaxSubs * (kWkvMaxSubs - 1) / 2;  // M rows: j' < j, packed
constexpr int kWkvMaxCluster = 8;
constexpr int kWkvPad = 4;          // floats of padding per row
// a chunk's rows are padded to a multiple of 16: the cumulative sum splits
// them into 256 / N segments (16 at N = 16), and sub-chunks must be whole
constexpr int kWkvRowAlign = 16;
static_assert(kWkvRowAlign % kWkvSub == 0, "padded chunks hold whole sub-chunks");
constexpr size_t kWkvSmemLimit = 232448;

// The decays are kept in base 2: lc holds log2 of the cumulative decay, and
// exp(clip(x, -60, 0)) of the reference is 2^clip(x2, -60 log2(e), 0), one
// ex2.approx (relative error about 2^-22).
constexpr float kWkvClip2 = -86.56170245f;  // -60 log2(e)

__device__ __forceinline__ float decay(float x2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fminf(fmaxf(x2, kWkvClip2), 0.f)));
  return y;
}

// Shared memory, in floats, for a chunk padded to cp rows (a multiple of 16)
// at head size N.  M holds one row per sub-chunk pair j' < j, packed.  Rows of N are padded to P = N + 4, rows of cp to
// pc = cp + 4.  Regions are reused as the chunk's work moves on: r and k
// take their factored forms, lc the attention and (one chunk per CTA) the
// entering state.
struct WkvLayout {
  int cp, N, P, pc, nshift;  // nshift = log2 N: a thread's channel is tid & (N - 1)
  int r, k, lc, v, x, lsum, s, m, blk, seg, uvec, avec, anew, total;
};

__host__ __device__ inline WkvLayout wkv_layout(int cp, int N, bool multi) {
  WkvLayout l;
  l.cp = cp, l.N = N, l.P = N + kWkvPad, l.pc = cp + kWkvPad;
  for (l.nshift = 0; (1 << l.nshift) < N; ++l.nshift) {
  }
  const int rows = cp * l.P;
  const int att = cp * l.pc;
  int o = 0;
  l.r = o, o += rows;                                       // r, then r'
  l.k = o, o += rows;                                       // k, then k''
  int lc = rows > att ? rows : att;
  if (!multi && lc < N * N) lc = N * N;
  l.lc = o, o += lc;                                        // lw -> lc, then att [cp][pc], then S
  l.v = o, o += rows;
  l.x = o, o += rows;                                       // kdec, then rdec
  l.lsum = o, o += N * N;                                   // this CTA's summary state
  l.s = multi ? o : l.lc, o += multi ? N * N : 0;           // the carried state
  l.m = o, o += kWkvMRows * l.P;                            // M [j (j - 1) / 2 + j'][P]
  l.blk = o, o += cp * kWkvSub;                             // att inside each sub-chunk
  l.seg = o, o += kWkvThreads;                              // segment sums of the cumsum
  l.uvec = o, o += N;
  l.avec = o, o += N;                                       // this CTA's range decay
  l.anew = o, o += N;                                       // one chunk's decay
  l.total = o;
  return l;
}

struct WkvArgs {
  const float *r, *k, *v, *w, *u;
  float *o, *state;
  int T, H, N, c, cp, n_chunks, per_cta;
};

struct WkvSmem {
  float *R, *K, *LC, *V, *X, *Lsum, *S, *M, *blk, *seg, *uvec, *avec, *anew;
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Chunk ci of the head into R, K, V and LC by cp.async, every copy issued
// before the first wait; then LC <- log2 of the clipped decay.  Rows past c
// are zero (lw = 0: no decay).  Ends with a barrier.
__device__ void wkv_load(const WkvArgs& a, const WkvLayout& l, const WkvSmem& sm, size_t base,
                         int ci) {
  const int P = l.P, qshift = l.nshift - 2;  // 16-byte vectors a row: N / 4
  const size_t row = (size_t)a.H * a.N;
  const size_t g0 = base + (size_t)ci * a.c * row;
  for (int i = threadIdx.x; i < l.cp << qshift; i += kWkvThreads) {
    const int t = i >> qshift, n = (i & ((1 << qshift) - 1)) * 4;
    float* dst[4] = {sm.R + t * P + n, sm.K + t * P + n, sm.V + t * P + n, sm.LC + t * P + n};
    if (t < a.c) {
      const size_t g = g0 + t * row + n;
      cp_async16(dst[0], a.r + g);
      cp_async16(dst[1], a.k + g);
      cp_async16(dst[2], a.v + g);
      cp_async16(dst[3], a.w + g);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) *reinterpret_cast<float4*>(dst[j]) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const int n = threadIdx.x & (l.N - 1);
#pragma unroll 4
  for (int t = threadIdx.x >> l.nshift; t < a.c; t += kWkvThreads >> l.nshift) {
    float* lw = sm.LC + t * P + n;
    *lw = log2f(fminf(fmaxf(*lw, 1e-8f), 1.f));
  }
  __syncthreads();
}

// LC <- the inclusive cumulative sum of lw over t, per channel: each thread
// sums a segment of its channel, then adds the segments before it.
__device__ void wkv_cumsum(const WkvLayout& l, const WkvSmem& sm) {
  const int segs = kWkvThreads >> l.nshift, len = l.cp / segs;
  const int n = threadIdx.x & (l.N - 1), g = threadIdx.x >> l.nshift;
  float acc = 0.f;
#pragma unroll 4
  for (int t = g * len; t < (g + 1) * len; ++t) {
    acc += sm.LC[t * l.P + n];
    sm.LC[t * l.P + n] = acc;
  }
  sm.seg[g * l.N + n] = acc;
  __syncthreads();
  float pre = 0.f;
  for (int q = 0; q < g; ++q) pre += sm.seg[q * l.N + n];
  for (int t = g * len; t < (g + 1) * len; ++t) sm.LC[t * l.P + n] += pre;
  __syncthreads();
}

// lc[t - 1] (0 before the chunk)
__device__ __forceinline__ float lc_before(const WkvLayout& l, const WkvSmem& sm, int t, int n) {
  return t > 0 ? sm.LC[(t - 1) * l.P + n] : 0.f;
}

// X <- kdec = k exp(clip(lc[cp-1] - lc)) and anew <- exp(clip(lc[cp-1])).
// No barrier.
__device__ void wkv_kdec(const WkvLayout& l, const WkvSmem& sm) {
  const float* end = sm.LC + (l.cp - 1) * l.P;
  const int n = threadIdx.x & (l.N - 1);
  const float e = end[n];
#pragma unroll 4
  for (int s = threadIdx.x >> l.nshift; s < l.cp; s += kWkvThreads >> l.nshift)
    sm.X[s * l.P + n] = sm.K[s * l.P + n] * decay(e - sm.LC[s * l.P + n]);
  for (int n = threadIdx.x; n < l.N; n += kWkvThreads) sm.anew[n] = decay(end[n]);
}

// dst[n][m] = scale[n] dst[n][m] + sum_s X[s][n] V[s][m] (scale null: no
// old value), over N x N, a thread holding rows 4 ta .. 4 ta + 3 and
// columns m0 .. m0 + 3 (16-byte loads of both operands).  No barrier.
__device__ void wkv_state_product(const WkvLayout& l, const WkvSmem& sm, float* dst,
                                  const float* scale) {
  const int n0 = (threadIdx.x / 16) * 4, m0 = (threadIdx.x % 16) * 4;
  if (m0 >= l.N || n0 >= l.N) return;
  float acc[4][4] = {};
#pragma unroll 4
  for (int s = 0; s < l.cp; ++s) {
    const float4 a = ld4(sm.X + s * l.P + n0), b = ld4(sm.V + s * l.P + m0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = at(a, i);
      acc[i][0] = fmaf(av, b.x, acc[i][0]);
      acc[i][1] = fmaf(av, b.y, acc[i][1]);
      acc[i][2] = fmaf(av, b.z, acc[i][2]);
      acc[i][3] = fmaf(av, b.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* d = dst + (n0 + i) * l.N + m0;
    const float sc = scale ? scale[n0 + i] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = (scale ? sc * d[j] : 0.f) + acc[i][j];
  }
}

// The pairs of each sub-chunk, s <= t: blk[t][s - b] = r[t] . (k[s]
// exp(clip(lc[t-1] - lc[s]))) for s < t, r[t] . (u k[t]) on the diagonal;
// and M[j][j'] = exp(clip(lc[8 j - 1] - lc[8 j' + 7])) for j' < j (row
// j (j - 1) / 2 + j').  A group
// of N / 8 neighbouring lanes takes rows tl and 7 - tl of a sub-chunk, 9
// pairs between them, lane g the 16-byte vectors g and g + N / 8 of each
// row (at N = 64 eight lanes read eight neighbouring vectors: distinct
// banks), and adds its parts by shuffles.  Reads raw r and k.  No barrier.
__device__ void wkv_pairs(const WkvLayout& l, const WkvSmem& sm) {
  const int lanes = l.N / 8;  // 2, 4 or 8: a power of two that divides 32
  const int groups = kWkvThreads / lanes, g = threadIdx.x % lanes;
  const int tasks = (l.cp / kWkvSub) * (kWkvSub / 2);
  for (int task0 = 0; task0 < tasks; task0 += groups) {
    const int task = task0 + threadIdx.x / lanes;
    const int b = (task / (kWkvSub / 2)) * kWkvSub, ta = task % (kWkvSub / 2);
    const int tb = kWkvSub - 1 - ta;
    // rows ta and tb: r[t] and lc[t - 1] held in registers
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ra[2] = {zero, zero}, rb[2] = {zero, zero}, la[2] = {zero, zero}, lb[2] = {zero, zero};
    if (task < tasks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 4 * (g + h * lanes);
        ra[h] = ld4(sm.R + (b + ta) * l.P + n);
        rb[h] = ld4(sm.R + (b + tb) * l.P + n);
        if (b + ta > 0) la[h] = ld4(sm.LC + (b + ta - 1) * l.P + n);
        lb[h] = ld4(sm.LC + (b + tb - 1) * l.P + n);
      }
    }
#pragma unroll
    for (int k = 0; k <= kWkvSub; ++k) {
      const bool first = k <= ta;
      const int t = first ? ta : tb, sl = first ? k : k - ta - 1, s = b + sl;
      float acc = 0.f;
      if (task < tasks) {
        float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 4 * (g + h * lanes);
          const float4 a = first ? ra[h] : rb[h], kv = ld4(sm.K + s * l.P + n);
          float4 d;
          if (sl == t) {
            d = ld4(sm.uvec + n);
          } else {
            const float4 x = first ? la[h] : lb[h], y = ld4(sm.LC + s * l.P + n);
            d = make_float4(decay(x.x - y.x), decay(x.y - y.y), decay(x.z - y.z),
                            decay(x.w - y.w));
          }
          part.x = fmaf(a.x * d.x, kv.x, part.x);
          part.y = fmaf(a.y * d.y, kv.y, part.y);
          part.z = fmaf(a.z * d.z, kv.z, part.z);
          part.w = fmaf(a.w * d.w, kv.w, part.w);
        }
        acc = (part.x + part.y) + (part.z + part.w);
      }
      for (int o = 1; o < lanes; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (task < tasks && g == 0) sm.blk[(b + t) * kWkvSub + sl] = acc;
    }
  }
  const int subs = l.cp / kWkvSub;
  for (int i = threadIdx.x; i < (subs * (subs - 1) / 2) << l.nshift; i += kWkvThreads) {
    const int row = i >> l.nshift, n = i & (l.N - 1);
    int j = 1;
    while (j * (j + 1) / 2 <= row) ++j;  // row = j (j - 1) / 2 + j'
    const int jp = row - j * (j - 1) / 2;
    sm.M[row * l.P + n] =
        decay(sm.LC[(kWkvSub * j - 1) * l.P + n] - sm.LC[(kWkvSub * jp + kWkvSub - 1) * l.P + n]);
  }
}

// X <- rdec = r exp(clip(lc[t-1])).  Reads raw r.  No barrier.
__device__ void wkv_rdec(const WkvLayout& l, const WkvSmem& sm) {
  const int n = threadIdx.x & (l.N - 1);
#pragma unroll 4
  for (int t = threadIdx.x >> l.nshift; t < l.cp; t += kWkvThreads >> l.nshift)
    sm.X[t * l.P + n] = sm.R[t * l.P + n] * decay(lc_before(l, sm, t, n));
}

// One pass over the chunk: X <- rdec = r exp(clip(lc[t-1])), R <- r' =
// r exp(clip(lc[t-1] - lc[b-1])) (b: the start of t's sub-chunk), K <- k'' =
// k exp(clip(lc[e] - lc[t])) (e: the end of t's sub-chunk).  Call after
// every reader of raw r and k; ends with a barrier, after which LC is free.
__device__ void wkv_factor(const WkvLayout& l, const WkvSmem& sm) {
  const int n = threadIdx.x & (l.N - 1);
#pragma unroll 4
  for (int t = threadIdx.x >> l.nshift; t < l.cp; t += kWkvThreads >> l.nshift) {
    const int b = (t / kWkvSub) * kWkvSub;
    const float before = lc_before(l, sm, t, n), lc = sm.LC[t * l.P + n];
    const float r = sm.R[t * l.P + n];
    sm.X[t * l.P + n] = r * decay(before);
    if (b > 0) sm.R[t * l.P + n] = r * decay(before - sm.LC[(b - 1) * l.P + n]);
    sm.K[t * l.P + n] *= decay(sm.LC[(b + kWkvSub - 1) * l.P + n] - lc);
  }
  __syncthreads();
}

// att [cp][pc] (in LC, free after wkv_factor) on and below the diagonal
// sub-chunks: for each pair j' < j of sub-chunks the 8 x 8 block
// r' diag(M[j][j']) k''^T, as four 4 x 4 tiles, two threads a tile (each
// every other 16-byte vector of the channels, added by a shuffle); the diagonal blocks from the
// sub-chunk pairs, zero above the diagonal.  Blocks above the diagonal are
// not written: att v reads none.  Ends with a barrier.
__device__ void wkv_att(const WkvLayout& l, const WkvSmem& sm) {
  const int subs = l.cp / kWkvSub;
  const int prod = 2 * 4 * (subs * (subs - 1) / 2);  // threads on the products
  const int tid = threadIdx.x;
  float acc[4][4] = {};
  int t0 = 0, s0 = 0;
  if (tid < prod) {
    const int tile = tid / 2, half = tid % 2, bp = tile / 4;
    int j = 1;
    while (j * (j + 1) / 2 <= bp) ++j;  // bp = j (j - 1) / 2 + j'
    const int jp = bp - j * (j - 1) / 2;
    t0 = kWkvSub * j + 4 * ((tile % 4) / 2);
    s0 = kWkvSub * jp + 4 * (tile % 2);
    const float* mrow = sm.M + bp * l.P;
    // the two threads of a tile take alternate 16-byte vectors of the rows
    for (int n = 4 * half; n < l.N; n += 8) {
      const float4 mv = ld4(mrow + n);
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 rv = ld4(sm.R + (t0 + i) * l.P + n);
        a[i] = make_float4(rv.x * mv.x, rv.y * mv.y, rv.z * mv.z, rv.w * mv.w);
        b[i] = ld4(sm.K + (s0 + i) * l.P + n);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = acc[i][j];
          v = fmaf(a[i].x, b[j].x, v);
          v = fmaf(a[i].y, b[j].y, v);
          v = fmaf(a[i].z, b[j].z, v);
          acc[i][j] = fmaf(a[i].w, b[j].w, v);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
  if (tid < prod && tid % 2 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sm.LC + (t0 + i) * l.pc + s0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  // the diagonal blocks, a 4 x 4 tile a thread
  for (int d = tid - prod; d >= 0 && d < 4 * subs; d += kWkvThreads) {
    const int b = kWkvSub * (d / 4), tr = b + 4 * ((d % 4) / 2), sc = b + 4 * (d % 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tr + i;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = sc + j <= t ? sm.blk[t * kWkvSub + sc + j - b] : 0.f;
      *reinterpret_cast<float4*>(sm.LC + t * l.pc + sc) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
}

// acc[i][j] += sum_k A[t_i][k] B[k][m0 + j] over k < k_end, for the thread's
// rows t_i = 4 ta + i (A rows of stride lda, B rows of stride ldb).
__device__ __forceinline__ void wkv_rows_product(float (&acc)[4][4], const float* A, int lda,
                                                 const float* B, int ldb, int k_end, int rows,
                                                 int m0) {
  const int t0 = (threadIdx.x / 16) * 4;
#pragma unroll 2
  for (int k = 0; k < k_end; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = t0 + i < rows ? ld4(A + (t0 + i) * lda + k) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = ld4(B + (k + q) * ldb + m0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = at(a[i], q);
        acc[i][0] = fmaf(av, b.x, acc[i][0]);
        acc[i][1] = fmaf(av, b.y, acc[i][1]);
        acc[i][2] = fmaf(av, b.z, acc[i][2]);
        acc[i][3] = fmaf(av, b.w, acc[i][3]);
      }
    }
  }
}

// o rows of chunk ci from the thread's tile (rows 4 ta + i).
__device__ void wkv_store_o(const WkvArgs& a, const WkvLayout& l, size_t base, int ci,
                            const float (&acc)[4][4]) {
  const int t0 = (threadIdx.x / 16) * 4, m0 = (threadIdx.x % 16) * 4;
  if (m0 >= l.N) return;
  const size_t row = (size_t)a.H * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + i;
    if (t < a.c)
      *reinterpret_cast<float4*>(a.o + base + ((size_t)ci * a.c + t) * row + m0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The intra-chunk part of o (att v, the bonus included) into acc, from a
// loaded chunk whose lc is computed; leaves X = rdec.  Uses LC for att.
__device__ void wkv_intra(const WkvLayout& l, const WkvSmem& sm, float (&acc)[4][4]) {
  wkv_pairs(l, sm);
  __syncthreads();
  wkv_factor(l, sm);
  wkv_att(l, sm);
  const int t0 = (threadIdx.x / 16) * 4, m0 = (threadIdx.x % 16) * 4;
  // att is zero above the diagonal: rows t0 .. t0 + 3 need s < t0 + 4
  if (m0 < l.N && t0 < l.cp) wkv_rows_product(acc, sm.LC, l.pc, sm.V, l.P, t0 + 4, l.cp, m0);
}

template <bool kMulti>
__global__ void __launch_bounds__(kWkvThreads, 2) wkv6_kernel(const WkvArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 wkv_smem_raw[];
  float* smem = reinterpret_cast<float*>(wkv_smem_raw);
  const WkvLayout l = wkv_layout(a.cp, a.N, kMulti);
  const WkvSmem sm = {smem + l.r,    smem + l.k,    smem + l.lc,  smem + l.v,   smem + l.x,
                      smem + l.lsum, smem + l.s,    smem + l.m,   smem + l.blk, smem + l.seg,
                      smem + l.uvec, smem + l.avec, smem + l.anew};
  const int rank = static_cast<int>(cluster.block_rank());
  const int last_rank = static_cast<int>(cluster.num_blocks()) - 1;
  const int bh = blockIdx.x / (last_rank + 1), h = bh % a.H, tid = threadIdx.x;
  const size_t base = (size_t)(bh / a.H) * a.T * a.H * a.N + (size_t)h * a.N;
  const int first = rank * a.per_cta;
  const int mine = max(0, min(a.n_chunks, first + a.per_cta) - first);
  const int N = l.N, m0 = (tid % 16) * 4;

  for (int n = tid; n < N; n += kWkvThreads) sm.uvec[n] = a.u[h * N + n];

  // this CTA's summary: Lsum, the state its chunks carry out from zero, and
  // avec, their decay
  for (int i = 0; i < mine; ++i) {
    wkv_load(a, l, sm, base, first + i);
    wkv_cumsum(l, sm);
    wkv_kdec(l, sm);
    __syncthreads();
    wkv_state_product(l, sm, sm.Lsum, i == 0 ? nullptr : sm.anew);
    for (int n = tid; n < N; n += kWkvThreads) sm.avec[n] = i == 0 ? sm.anew[n] : sm.avec[n] * sm.anew[n];
    if (kMulti) __syncthreads();  // before the next chunk's load
  }
  if (mine == 0) {
    for (int i = tid; i < N * N; i += kWkvThreads) sm.Lsum[i] = 0.f;
    for (int n = tid; n < N; n += kWkvThreads) sm.avec[n] = 1.f;
  }
  __syncthreads();
  cluster_arrive();

  float acc[4][4] = {};
  if (!kMulti) {
    wkv_intra(l, sm, acc);  // X takes rdec: kdec's readers are past the barrier above
    __syncthreads();  // att is read; LC takes the entering state
  }

  // the state entering this CTA's range: the summaries before it, in rank order
  cluster_wait();
  for (int i = tid; i < N * N / 4; i += kWkvThreads) {
    const int n = (i * 4) >> l.nshift;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int q = 0; q < rank; ++q) {
      const float4 lq = ld4(cluster.map_shared_rank(sm.Lsum, q) + i * 4);
      const float aq = cluster.map_shared_rank(sm.avec, q)[n];
      s = make_float4(fmaf(aq, s.x, lq.x), fmaf(aq, s.y, lq.y), fmaf(aq, s.z, lq.z),
                      fmaf(aq, s.w, lq.w));
    }
    *reinterpret_cast<float4*>(sm.S + i * 4) = s;
  }
  __syncthreads();
  cluster_arrive();  // done reading the peers' summaries

  if (!kMulti) {
    if (m0 < N && rank > 0) wkv_rows_product(acc, sm.X, l.P, sm.S, N, N, l.cp, m0);
    wkv_store_o(a, l, base, first, acc);
  } else {
    for (int i = 0; i < mine; ++i) {
      wkv_load(a, l, sm, base, first + i);
      wkv_cumsum(l, sm);
      float acc_i[4][4] = {};
      wkv_rdec(l, sm);
      __syncthreads();
      if (m0 < N) wkv_rows_product(acc_i, sm.X, l.P, sm.S, N, N, l.cp, m0);
      __syncthreads();  // S and rdec are read
      wkv_kdec(l, sm);
      __syncthreads();
      wkv_state_product(l, sm, sm.S, sm.anew);
      __syncthreads();
      wkv_intra(l, sm, acc_i);
      wkv_store_o(a, l, base, first + i, acc_i);
      __syncthreads();  // before the next chunk's load
    }
  }
  if (rank == last_rank) {
    // the final state: this CTA's summary applied to the state entering it
    // (kMulti: S has been carried through the range already)
    float* so = a.state + (size_t)bh * N * N;
    for (int i = tid; i < N * N; i += kWkvThreads)
      so[i] = kMulti ? sm.S[i] : fmaf(sm.avec[i >> l.nshift], sm.S[i], sm.Lsum[i]);
  }
  cluster_wait();  // no CTA leaves while a peer may read its summary
}

}  // namespace repro_torch

// r, k, v, w, o [B, T, H, N] f32 (w the decay in (0, 1); the kernel takes
// log(clip(w, 1e-8, 1)) itself); u [H, N] f32; state [B, H, N, N] f32; all
// contiguous and 16-byte aligned.  N must be 16, 32 or 64; 1 <= chunk <= 64
// and T % chunk == 0.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, void* o, void* state, int B, int T, int H, int N,
                          int chunk, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || T <= 0 || H <= 0 || (N != 16 && N != 32 && N != 64) || chunk < 1 ||
      chunk > kWkvMaxChunk || T % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {r, k, v, w, u, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  WkvArgs a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.o = static_cast<float*>(o);
  a.state = static_cast<float*>(state);
  a.T = T, a.H = H, a.N = N, a.c = chunk;
  a.cp = (chunk + kWkvRowAlign - 1) / kWkvRowAlign * kWkvRowAlign;
  a.n_chunks = T / chunk;
  const int cl = a.n_chunks < kWkvMaxCluster ? a.n_chunks : kWkvMaxCluster;
  a.per_cta = (a.n_chunks + cl - 1) / cl;
  // the heads and their clusters share the grid's x (y would cap B*H at
  // 65535); cl * B*H CTAs past INT_MAX would need T >= cl and over 500 GB
  // of inputs, so every call that fits on a card passes
  if ((long long)B * H * cl > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool multi = a.per_cta > 1;
  const void* kernel = multi ? reinterpret_cast<const void*>(wkv6_kernel<true>)
                             : reinterpret_cast<const void*>(wkv6_kernel<false>);
  const size_t smem = sizeof(float) * wkv_layout(a.cp, N, multi).total;
  if (smem > kWkvSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kWkvSmemLimit));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * B * H);
  cfg.blockDim = dim3(kWkvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Shared inner loop of the GEMV and fused GEMV+AllReduce kernels (Hopper, sm_90a).
//
// One CTA of 256 threads computes one output tile of R rows (kRows = 8 by
// default) x kTileN columns, y[r, c] = sum_k x[row0 + r, k] * w[k, col0 + c], accumulated in
// f32 over the whole K depth.  This is the K-panel f32 accumulation of
// src/repro/kernels/gemv/kernel.py:19 (_gemv_kernel), which the TPU fused
// kernel (src/repro/kernels/fused_gemv_allreduce/kernel.py:59) repeats per
// output tile; on a GPU the sequential K grid axis becomes a loop inside the
// CTA, and the CTA splits K across its threads instead of carrying a sum
// between grid steps.
//
// Layout: thread t owns V = 16 / sizeof(T) neighbouring columns (one 16-byte
// load of a weight row) and every kLanesK-th weight row.  A warp therefore
// reads 32 / kColGroups whole 64-byte row segments per load, and each weight
// byte is read exactly once.  x is staged in shared memory one [R, kTileK]
// panel at a time (as f32), never whole: at chatglm3's d_ff the full [4, 13696]
// bf16 activation would take 110 KB per CTA.  x is read through L2
// (__ldcg), since a caller may have written it earlier in the same launch
// (the expert FFN's u in fused_gemm_a2a.cu).  The per-thread partial sums are
// reduced across the K lanes of a warp with shuffles, then across warps
// through shared memory, in a fixed order, so results are deterministic.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 32;   // output columns per tile
constexpr int kRows = 8;     // rows of x per row block (TileSmem's R)
constexpr int kTileK = 512;  // depth of one staged x panel
constexpr int kUnroll = 8;   // weight rows in flight per thread before their FMAs

// R rows of x per row block: R * kTileN f32 accumulators per thread group,
// so a caller with fewer rows (MoE decode has 2 per expert) saves FMAs and
// registers.
template <int R>
struct TileSmemR {
  float xs[R][kTileK];            // staged x panel
  float red[kWarps][R][kTileN];   // per-warp partial tiles
  float tile[R][kTileN];          // the finished f32 tile
};
using TileSmem = TileSmemR<kRows>;

static_assert(kThreads == kRows * kTileN, "one output element per thread in the epilogue");

// One weight row segment of V columns as raw bits; zero past K or N.
template <typename T>
__device__ __forceinline__ uint4 load_w(const T* __restrict__ w, int k, int K, int N, int c0,
                                        bool vec_ok) {
  constexpr int V = 16 / sizeof(T);
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (k >= K) return raw;
  const T* p = w + (size_t)k * N + c0;
  if (vec_ok && c0 + V <= N) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (c0 + j < N) e[j] = p[j];
  }
  return raw;
}

// Computes the f32 tile for rows [row0, row0 + R) and columns
// [col0, col0 + kTileN) into sm.tile.  Rows at or past `rows` and columns at
// or past N come out as zero; K need not be a multiple of kTileK.  `vec_ok`
// says every weight row starts on a 16-byte boundary (N % V == 0 and w
// aligned).  All threads of the CTA must call it; it ends with a barrier.
template <typename T, int R>
__device__ void tile_gemv(const T* __restrict__ x, const T* __restrict__ w, int rows, int K,
                          int N, int row0, int col0, bool vec_ok, TileSmemR<R>& sm) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kColGroups = kTileN / V;
  constexpr int kLanesK = kThreads / kColGroups;
  static_assert(kTileK % (kLanesK * kUnroll) == 0, "panel must split evenly over K lanes");
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kl = tid / kColGroups;
  const int c0 = col0 + cg * V;

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = tid; i < R * kTileK; i += kThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int row = row0 + r, k = k0 + kk;
      sm.xs[r][kk] = (row < rows && k < K) ? to_float(__ldcg(x + (size_t)row * K + k)) : 0.f;
    }
    __syncthreads();
    for (int kb = kl; kb < kTileK; kb += kLanesK * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = load_w<T>(w, k0 + kb + u * kLanesK, K, N, c0, vec_ok);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* e = reinterpret_cast<const T*>(&raw[u]);
        const int kk = kb + u * kLanesK;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = sm.xs[r][kk];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(xv, to_float(e[j]), acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  // K lanes of one warp differ only in the lane bits above the column group
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int o = kColGroups; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[r][j] = v;
    }
  if (lane < kColGroups) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) sm.red[warp][r][cg * V + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = tid; i < R * kTileN; i += kThreads) {
    const int r = i / kTileN, c = i % kTileN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += sm.red[q][r][c];
    sm.tile[r][c] = s;
  }
  __syncthreads();
}

}  // namespace repro_torch

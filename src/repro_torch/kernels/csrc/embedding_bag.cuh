// Mean pooling of one embedding bag by one warp, shared by embedding_pool.cu
// and fused_embedding_a2a.cu so that the two kernels give the same bits.
//
// The arithmetic is the TPU kernels': an f32 accumulator per element, the
// bag's rows added in lookup order l = 0..L-1, one division by L, one cast
// to the table's type.
//
// The lanes of the warp cover the row's D elements; the bag's indices are
// loaded 32 at a time, one per lane, and each lookup's index is broadcast by
// a shuffle.  Each lane issues kBagUnroll row loads before it adds them (in
// order), so a warp keeps that many random rows in flight.  When a row is a
// whole number of 16-byte vectors (D * sizeof(T) % 16 == 0) and the table
// and output are 16-byte aligned, a lane loads one vector of a row at a time
// (D = 92 f32 is 23 vectors: lanes 23..31 idle); otherwise each lane takes
// kBagScalarCols elements 32 apart.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kBagWarps = 8;                   // bags per CTA, one per warp
constexpr int kBagThreads = 32 * kBagWarps;
constexpr int kBagUnroll = 8;                  // row loads in flight per lane
constexpr int kBagScalarCols = 4;              // elements per lane and pass, scalar path

// out[0, D) = mean over l of table[idx[l] * D + (0, D)].  Called by all 32
// lanes of a warp (the shuffles need them all).
template <typename T>
__device__ __forceinline__ void pool_bag(const T* __restrict__ table, const int* __restrict__ idx,
                                         int L, int D, T* __restrict__ out, bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    constexpr int N = 16 / sizeof(T);          // elements per 16-byte vector
    const int cols = D / N;
    for (int c0 = 0; c0 < cols; c0 += 32) {
      const int c = c0 + lane;
      const bool have = c < cols;
      float acc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = 0.f;
      for (int l0 = 0; l0 < L; l0 += 32) {
        const int n = min(32, L - l0);
        const int mine = lane < n ? __ldg(idx + l0 + lane) : 0;
        for (int j0 = 0; j0 < n; j0 += kBagUnroll) {
          uint4 v[kBagUnroll];
#pragma unroll
          for (int u = 0; u < kBagUnroll; ++u) {
            const int row = __shfl_sync(0xffffffffu, mine, (j0 + u) & 31);
            if (have && j0 + u < n)
              v[u] = __ldg(reinterpret_cast<const uint4*>(table + (size_t)row * D) + c);
          }
#pragma unroll
          for (int u = 0; u < kBagUnroll; ++u) {
            if (have && j0 + u < n) {
              const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
              for (int k = 0; k < N; ++k) acc[k] += to_float(e[k]);
            }
          }
        }
      }
      if (have) {
        alignas(16) T o[N];
#pragma unroll
        for (int k = 0; k < N; ++k) o[k] = from_float<T>(acc[k] / (float)L);
        reinterpret_cast<uint4*>(out)[c] = *reinterpret_cast<const uint4*>(o);
      }
    }
    return;
  }
  constexpr int S = kBagScalarCols;
  for (int e0 = 0; e0 < D; e0 += 32 * S) {
    float acc[S];
#pragma unroll
    for (int k = 0; k < S; ++k) acc[k] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int n = min(32, L - l0);
      const int mine = lane < n ? __ldg(idx + l0 + lane) : 0;
      for (int j0 = 0; j0 < n; j0 += kBagUnroll) {
        T v[kBagUnroll][S];
#pragma unroll
        for (int u = 0; u < kBagUnroll; ++u) {
          const int row = __shfl_sync(0xffffffffu, mine, (j0 + u) & 31);
#pragma unroll
          for (int k = 0; k < S; ++k) {
            const int e = e0 + k * 32 + lane;
            if (e < D && j0 + u < n) v[u][k] = table[(size_t)row * D + e];
          }
        }
#pragma unroll
        for (int u = 0; u < kBagUnroll; ++u) {
#pragma unroll
          for (int k = 0; k < S; ++k)
            if (e0 + k * 32 + lane < D && j0 + u < n) acc[k] += to_float(v[u][k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int e = e0 + k * 32 + lane;
      if (e < D) out[e] = from_float<T>(acc[k] / (float)L);
    }
  }
}

// The element size of a C entry's dtype code (0 = float32, 1 = bfloat16).
inline size_t dtype_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace repro_torch

// Mean pooling of embedding bags, shared by embedding_pool.cu and
// fused_embedding_a2a.cu so that the two kernels give the same bits.
//
// The arithmetic is the TPU kernels': an f32 accumulator per element, the
// bag's rows added in lookup order l = 0..L-1, one division by L, one cast
// to the table's type.  Both paths below do exactly that, so they agree bit
// for bit.
//
// Two paths (kernels/embedding_pool/plan.py's bag_path chooses: the warp
// path at one rank, the ring path where its rows fit in an emulated world
// of more, each the faster there on an H100, PERF.md section 6):
//
//  * The ring path (ring_pool): rows travel to shared memory by the bulk
//    copy engine, not through registers.  Each warp owns a bag at a time
//    and a ring of row slots in shared memory, in groups of kRingGroup
//    slots under one mbarrier; the lane that holds a lookup's address
//    issues one 1-D bulk copy for the row (cp.async.bulk, completion as
//    transaction bytes on the group's barrier), `slots` lookups ahead of
//    the warp's reads and across bag boundaries, eight lanes at once.  The
//    warp waits once a group, reads its rows in lookup order, all 32 lanes
//    over the row's D elements (D = 92 f32: 3 a lane), adds, and re-arms
//    the group for the lookups `slots` further on.  Shared memory, not
//    registers, sets the rows in flight: a ring of kRingBytes a CTA.  CTAs
//    are persistent (as many as fit on the card) and walk units of
//    kBagWarps bags, unit c, c + gridDim.x, ..., in the order a map gives;
//    the lookups' indices are read one window of 32 ahead, one a lane.  It
//    takes rows that are a whole number of 16-byte vectors at
//    16-byte-aligned tables and outputs, D <= 32 * kRingCols.
//  * The warp path (pool_bag): one warp per bag, the row loads through
//    registers, kBagUnroll rows in flight per lane; it takes any rows, also
//    rows not a multiple of 16 bytes and unaligned tables or outputs.  When
//    a row is a whole number of 16-byte vectors and the table and output
//    are 16-byte aligned, a lane loads one vector of a row at a time (D =
//    92 f32 is 23 vectors: lanes 23..31 idle); otherwise each lane takes
//    kBagScalarCols elements 32 apart.
#pragma once

#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {

constexpr int kBagWarps = 8;                   // bags per CTA (a unit), one per warp
constexpr int kBagThreads = 32 * kBagWarps;
constexpr int kBagUnroll = 8;                  // row loads in flight per lane, warp path
constexpr int kBagScalarCols = 4;              // elements per lane and pass, scalar warp path
constexpr int kRingBytes = 24 * 1024;          // row slots of a CTA, ring path (phase 14's sweep)
constexpr int kRingMaxSlots = 64;              // row slots per warp at most
constexpr int kRingGroup = 8;                  // slots under one mbarrier, waited for together
constexpr int kRingCols = 8;                   // elements per lane: D <= 32 * kRingCols
constexpr int kRingSmemLimit = 232448;         // 227 KB, the most a CTA may take on an H100

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

// ---------------------------------------------------------------------------
// the ring path
// ---------------------------------------------------------------------------

// Where one bag lives: its table [V, D], its L indices, its D outputs.
template <typename T>
struct BagRef {
  const T* table;
  const int* idx;
  T* out;
};

// Dynamic shared memory of a ring of `slots` rows of `row_bytes` per warp:
// alignment slack, one mbarrier per group of kRingGroup slots, the slots
// (kernels/embedding_pool/plan.py's smem_bytes).
inline size_t ring_smem_bytes(int slots, int row_bytes) {
  return 128 + (size_t)kBagWarps * (slots / kRingGroup * 8 + (size_t)slots * row_bytes);
}

// One lane's next position in its warp's stream: position l of the bag of
// the warp's k-th unit (units first, first + stride, ...; a unit without a
// bag for this warp is skipped).  A bag has L lookups padded to Lp
// positions, a whole number of groups.  A Map answers bag(unit, warp, ref)
// and has `units`.
template <typename T, typename Map>
struct RingWalk {
  int k, l;
  bool live;
  BagRef<T> r;

  // Moves k to the first unit at or after it with a bag for warp w.
  __device__ __forceinline__ bool seek(const Map& m, int first, int stride, int w) {
    for (;; ++k) {
      const long long unit = first + (long long)k * stride;
      if (unit >= m.units) return false;
      if (m.bag((int)unit, w, r)) return true;
    }
  }

  __device__ __forceinline__ void advance(const Map& m, int first, int stride, int w, int Lp,
                                          int by) {
    l += by;
    while (live && l >= Lp) {
      l -= Lp;
      ++k;
      live = seek(m, first, stride, w);
    }
  }
};

// Pools the bags of this CTA's units (blockIdx.x, blockIdx.x + gridDim.x,
// ...; warp w takes bag w of each) through each warp's ring of `slots`
// rows (a multiple of kRingGroup).  Positions q = 0, 1, ... of a warp's
// stream are its bags' lookups, each bag padded to a whole number of
// groups; position q lives in slot q % slots, and the kRingGroup slots of
// a group share one mbarrier, so the warp waits once a group and re-issues
// a group's rows together, one lane each.  `after(unit)` is called by
// every thread after each of the CTA's units, once this thread's warp has
// stored its bag of it.  All threads of the CTA must call it.
template <typename T, typename Map, typename After>
__device__ __forceinline__ void ring_pool(const Map& m, int L, int D, int slots, After after) {
  extern __shared__ uint8_t ring_smem_raw[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int first = blockIdx.x, stride = gridDim.x;
  const unsigned row_bytes = D * sizeof(T);
  const int groups = slots / kRingGroup;
  const int Lp = (L + kRingGroup - 1) / kRingGroup * kRingGroup;
  uint8_t* base = ring_smem_raw + (128 - smem_addr(ring_smem_raw) % 128) % 128;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base) + w * groups;
  uint8_t* ring = base + (size_t)kBagWarps * groups * 8 + (size_t)w * slots * row_bytes;
  for (int i = lane; i < groups; i += 32) mbar_init(&bars[i], kRingGroup);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();

  // The producer side.  Position q is issued by lane q % 32: each lane
  // holds the address of its position in the current window of 32 (cur)
  // and has the index of its position in the next window on its way (nxt,
  // nidx), read when the window before began.  A position past a bag's L
  // lookups, or past the stream's end, arrives on its group's barrier
  // without a copy.
  RingWalk<T, Map> nxt{0, lane, true, {}};
  nxt.live = nxt.seek(m, first, stride, w);
  nxt.advance(m, first, stride, w, Lp, 0);
  int nidx = nxt.live && nxt.l < L ? __ldg(nxt.r.idx + nxt.l) : 0;
  const T* cur = nullptr;
  bool cur_copy = false;
  auto produce = [&](int q0, int g) {  // positions q0 .. q0 + kRingGroup - 1 into group g
    if ((q0 & 31) == 0) {  // a new window: every lane takes its next position
      cur_copy = nxt.live && nxt.l < L;
      cur = nxt.r.table + (size_t)nidx * D;
      nxt.advance(m, first, stride, w, Lp, 32);
      if (nxt.live && nxt.l < L) nidx = __ldg(nxt.r.idx + nxt.l);
    }
    const int u = (lane - q0) & 31;
    if (u < kRingGroup) {
      if (cur_copy) {
        mbar_expect_tx(&bars[g], row_bytes);
        bulk_load(ring + (size_t)(g * kRingGroup + u) * row_bytes, cur, row_bytes, &bars[g]);
      } else {
        mbar_arrive(&bars[g]);
      }
    }
  };
  for (int g = 0; g < groups; ++g) produce(g * kRingGroup, g);

  // The consumer side: the warp's bags in order, a group of rows as it lands.
  int p = 0, g = 0;
  unsigned parity = 0;
  for (int k = 0;; ++k) {
    const long long unit = first + (long long)k * stride;
    if (unit >= m.units) break;
    BagRef<T> r;
    if (m.bag((int)unit, w, r)) {
      float acc[kRingCols];
#pragma unroll
      for (int j = 0; j < kRingCols; ++j) acc[j] = 0.f;
      for (int l0 = 0; l0 < L; l0 += kRingGroup) {
        mbar_wait(&bars[g], parity);
        const T* rows = reinterpret_cast<const T*>(ring + (size_t)g * kRingGroup * row_bytes);
        const int n = min(kRingGroup, L - l0);
#pragma unroll
        for (int u = 0; u < kRingGroup; ++u) {
          if (u < n) {
#pragma unroll
            for (int j = 0; j < kRingCols; ++j) {
              const int e = lane + 32 * j;
              if (e < D) acc[j] += to_float(rows[u * D + e]);
            }
          }
        }
        __syncwarp();  // every lane has read the group before it is filled again
        produce(p + slots, g);
        p += kRingGroup;
        if (++g == groups) {
          g = 0;
          parity ^= 1u;
        }
      }
#pragma unroll
      for (int j = 0; j < kRingCols; ++j) {
        const int e = lane + 32 * j;
        if (e < D) r.out[e] = from_float<T>(acc[j] / (float)L);
      }
    }
    after((int)unit);
  }
}

// The element size of a C entry's dtype code (0 = float32, 1 = bfloat16).
inline size_t dtype_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

// Whether the ring path takes rows of D elements of `dtype` at these
// pointers, with `slots` row slots a warp and `bags` bags (mirrors
// plan.py's bag_path and bag_plan).
inline bool ring_fits(int D, int dtype, int slots, long long bags, const void* tables,
                      const void* out) {
  const size_t row = D * dtype_bytes(dtype);
  return row % 16 == 0 && D <= 32 * kRingCols && slots >= kRingGroup &&
         slots % kRingGroup == 0 && slots <= kRingMaxSlots &&
         ring_smem_bytes(slots, (int)row) <= (size_t)kRingSmemLimit && bags <= INT_MAX &&
         reinterpret_cast<uintptr_t>(tables) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Lets a ring kernel take up to the 227 KB ceiling of dynamic shared
// memory (set to the ceiling, not to one launch's size, so every launch
// and occupancy query of the kernel agrees).
inline cudaError_t allow_ring_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kRingSmemLimit);
}

// Registers per thread of `kernel`, and its CTAs of kBagThreads threads
// with `smem` bytes of dynamic shared memory that an SM holds at once
// (smem > 0: a ring kernel).  Returns a cudaError_t code (0 = answered).
inline int bag_kernel_info(const void* kernel, size_t smem, int* regs, int* ctas) {
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > 0) err = allow_ring_smem(kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kBagThreads, smem);
  *regs = attr.numRegs;
  return static_cast<int>(err);
}

}  // namespace repro_torch

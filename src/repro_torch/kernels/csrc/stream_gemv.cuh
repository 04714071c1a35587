// Streaming GEMV loop for Hopper (sm_90a), shared by the GEMV kernel
// (gemv.cu) and the fused GEMV+AllReduce kernel's GEMV path
// (fused_gemv_allreduce.cu); the expert FFN's stream path
// (fused_gemm_a2a.cu) reuses its ring, layout, x staging and host helpers.
//
// y[B, N] = x[B, K] @ w[K, N] with f32 accumulation: the K-panel loop of
// src/repro/kernels/gemv/kernel.py:19 (_gemv_kernel), which the TPU fused
// kernel (src/repro/kernels/fused_gemv_allreduce/kernel.py:59) repeats per
// output tile.  At decode rows it does about one FMA per weight element, so
// what bounds it is the weight bytes over HBM (chatglm3-6b's w_down, 112 MB,
// takes 33.5 us at 3.35 TB/s).  The design keeps that stream busy:
//
//  * Work unit: R rows (a row block) x kStreamN = 128 columns, so a weight
//    row gives 256 (bf16) or 512 (f32) contiguous bytes.  K is split over
//    the `splits` CTAs of a thread-block cluster (at most 8), each taking
//    ks rows of K (a multiple of kStreamStageRows), so that a 4096-wide
//    output of 32 tiles spreads over up to 256 CTAs rather than 32.  The
//    wrapper's planner (kernels/gemv/plan.py) picks R, splits and ks, the
//    cluster as large as lets the card hold every cluster at once
//    (stream_max_clusters): a cluster left for a second wave streams its
//    share after all the others.
//  * x is staged once per unit: the CTA's whole slice [R, ks] as f32 in
//    shared memory (stage_x: every load issued before the first store),
//    behind one barrier of the consumer warps.  The weight stream has no
//    CTA-wide barrier.
//  * Weights stream through a ring of kStreamRingBytes = 64 KB (8 stages of
//    [32, 128] bf16, 4 of f32) filled with TMA box loads by one producer
//    thread (warp 8); full barriers count the bytes, empty barriers one
//    arrival per consumer warp.  At two CTAs per SM (R <= 4) 128 KB of
//    weights are in flight per SM; TMA zero-fills past K and N, so ragged
//    shapes need no masks in the loop.
//  * Consumers (warps 0-7): thread t owns a 16-byte column group and every
//    kLanesK-th row of a stage; it moves its vectors to registers, releases
//    the stage, and does the f32 FMAs against x from shared memory.
//  * Reduction, in a fixed order, so results are deterministic: the K lanes
//    of a warp by shuffles, the 8 warps through shared memory (the ring,
//    free once the stream is done), then the cluster's CTAs through
//    distributed shared memory in cluster-rank order into the leader (rank
//    0), which runs the caller's epilogue.
//
// The tensor map of w is 3-D, [depth][K][N], so one map covers the per-rank
// weights of an emulated world.  It needs N * sizeof(T) % 16 == 0 and a
// 16-byte-aligned w; the wrappers send other shapes to tile_gemv.cuh's loop.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace repro_torch {

constexpr int kStreamN = 128;                 // output columns per unit
constexpr int kStreamConsumers = 256;         // 8 consumer warps
constexpr int kStreamConsumerWarps = kStreamConsumers / 32;
constexpr int kStreamThreads = kStreamConsumers + 32;  // + the producer warp
constexpr int kStreamStageRows = 32;          // weight rows per ring stage
constexpr int kStreamRingBytes = 64 * 1024;
constexpr int kStreamMaxRows = 8;             // rows per row block (R)
constexpr int kStreamMaxSplits = 8;           // CTAs per cluster along K
constexpr int kStreamMaxStages = 8;
// dynamic shared memory: 128 bytes of alignment slack, the ring, the
// barriers, then x's [R][ks] f32 slice (kernels/gemv/plan.py mirrors it)
constexpr size_t kStreamFixedSmem = 128 + kStreamRingBytes + 2 * kStreamMaxStages * 8;
constexpr size_t kStreamSmemLimit = 232448;   // 227 KB per CTA

inline size_t stream_smem_bytes(int rows_per_block, int ks) {
  return kStreamFixedSmem + sizeof(float) * (size_t)rows_per_block * ks;
}

template <typename T>
struct StreamLayout {
  static constexpr int V = 16 / sizeof(T);                     // elements per 16-byte vector
  static constexpr int kColGroups = kStreamN / V;              // 16 bf16, 32 f32
  static constexpr int kLanesK = kStreamConsumers / kColGroups;  // 16 bf16, 8 f32
  static constexpr int kRowsPerLane = kStreamStageRows / kLanesK;
  static constexpr int kStageElems = kStreamStageRows * kStreamN;
  static constexpr int kStageBytes = kStageElems * sizeof(T);
  static constexpr int kStages = kStreamRingBytes / kStageBytes;
  static_assert(kStages <= kStreamMaxStages, "barrier space");
};

struct StreamPeers {
  void* out[kMaxDev];        // each rank's [B, N] output
  void* rx[kMaxDev];         // each rank's [n_dev, B, bn] rx slots at the wire dtype
  unsigned* flags[kMaxDev];  // each rank's [2, n_dev, tiles * row_blocks] flag words
};

// Everything a launch needs besides w's tensor map.  x, out and rx change
// per call; the rest is fixed per call signature (the plan).
struct StreamArgs {
  const void* x;   // rank 0's [B, K]; rank r's at x + r * B * K
  StreamPeers peers;
  const int* sched;  // fused kernel: [2 * n_dev * tiles] step offsets, then sub-tiles
  int my_base, n_dev, B, K, N, tiles, row_blocks, splits, ks;
  unsigned epoch;
};

template <typename T>
struct StreamSmem {
  T* ring;
  uint64_t* full;
  uint64_t* empty;
  float* xs;
};

// The consumer warps only (the producer warp runs its own loop).
__device__ __forceinline__ void stream_consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kStreamConsumers) : "memory");
}

// Carves the dynamic shared memory and initialises the ring's barriers; all
// threads must call it.
template <typename T>
__device__ __forceinline__ StreamSmem<T> stream_smem() {
  using L = StreamLayout<T>;
  extern __shared__ uint8_t stream_smem_raw[];
  const uint32_t raw = smem_addr(stream_smem_raw);
  uint8_t* base = stream_smem_raw + (128 - raw % 128) % 128;  // TMA wants 128-byte aligned boxes
  StreamSmem<T> s;
  s.ring = reinterpret_cast<T*>(base);
  s.full = reinterpret_cast<uint64_t*>(base + kStreamRingBytes);
  s.empty = s.full + kStreamMaxStages;
  s.xs = reinterpret_cast<float*>(s.empty + kStreamMaxStages);
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kStreamConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return s;
}

// Position in the ring; each thread keeps its own across units.
struct StreamRing {
  int stage = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// x's slice [n_rows, ks] from row row0 and column k0 into xs as f32, zeros
// past the rows and past kend; the consumer threads share it.  Each thread
// issues all its loads before its first store (kXUnroll 16-byte vectors
// where x's rows allow them), so the slice costs about one L2 round trip
// rather than one per element.  kL2 reads through L2 only (__ldcg), for an
// x that other CTAs of the same launch wrote (the expert FFN's u).
constexpr int kXUnroll = 4;

template <bool kL2, typename V>
__device__ __forceinline__ V load_x(const V* p) {
  if constexpr (kL2) return __ldcg(p);
  else return __ldg(p);
}

template <typename T, bool kL2 = false>
__device__ __forceinline__ void stage_x(float* __restrict__ xs, const T* __restrict__ x, int rows,
                                        int K, int ks, int k0, int kend, int row0, int n_rows) {
  constexpr int XV = 16 / sizeof(T);
  const int tid = threadIdx.x;
  // k0 and ks are multiples of kStreamStageRows, so a vector never crosses kend
  if (K % XV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int vpr = ks / XV, nv = n_rows * vpr;
    for (int i0 = tid; i0 < nv; i0 += kStreamConsumers * kXUnroll) {
      uint4 v[kXUnroll];
#pragma unroll
      for (int u = 0; u < kXUnroll; ++u) {
        const int i = i0 + u * kStreamConsumers;
        const int r = i / vpr, k = k0 + (i - r * vpr) * XV;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < nv && row0 + r < rows && k < kend)
          v[u] = load_x<kL2>(reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * K + k));
      }
#pragma unroll
      for (int u = 0; u < kXUnroll; ++u) {
        const int i = i0 + u * kStreamConsumers;
        if (i >= nv) break;
        const T* e = reinterpret_cast<const T*>(&v[u]);
        float* dst = xs + (size_t)i * XV;  // row r at r * ks = r * vpr * XV
#pragma unroll
        for (int j = 0; j < XV; ++j) dst[j] = to_float(e[j]);
      }
    }
    return;
  }
  for (int i0 = tid; i0 < n_rows * ks; i0 += kStreamConsumers * kXUnroll) {
    float v[kXUnroll];
#pragma unroll
    for (int u = 0; u < kXUnroll; ++u) {
      const int i = i0 + u * kStreamConsumers;
      const int r = i / ks, k = k0 + (i - r * ks);
      v[u] = (i < n_rows * ks && row0 + r < rows && k < kend)
                 ? to_float(load_x<kL2>(x + (size_t)(row0 + r) * K + k))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kXUnroll; ++u) {
      const int i = i0 + u * kStreamConsumers;
      if (i < n_rows * ks) xs[i] = v[u];
    }
  }
}

// One unit: rows [row0, row0 + R) of rank `rank`'s x [rows, K] against w's
// columns [col0, col0 + kStreamN), this CTA's share being K rows
// [split * ks, split * ks + ks).  Every thread of every CTA of the cluster
// calls it.  On return the leader's (cluster rank 0's) returned [R][kStreamN]
// f32 tile holds the sum over the whole K, visible to all its threads; the
// other CTAs' returned pointers must not be used.  Rows past `rows` come
// out as zero; columns past N are whatever TMA's zero fill gives (zero).
// The caller must __syncthreads() before the next unit (the tile lives in
// the ring).
template <typename T, int R>
__device__ float* stream_unit(const CUtensorMap* wmap, const StreamSmem<T>& sm, StreamRing& ring,
                              const T* __restrict__ x, int rows, int K, int ks, int split,
                              int splits, int rank, int row0, int col0) {
  using L = StreamLayout<T>;
  static_assert((kStreamConsumerWarps + 1) * R * kStreamN * sizeof(float) <= kStreamRingBytes,
                "the reduction scratch lives in the ring");
  namespace cg = cooperative_groups;
  const int tid = threadIdx.x;
  const int k0 = split * ks;
  const int kend = min(K, k0 + ks);
  const int n_st = kend > k0 ? (kend - k0 + kStreamStageRows - 1) / kStreamStageRows : 0;
  float* red = reinterpret_cast<float*>(sm.ring);  // [warps][R][kStreamN], once the stream is done
  float* tile = red + kStreamConsumerWarps * R * kStreamN;  // [R][kStreamN]

  if (tid >= kStreamConsumers) {
    if (tid == kStreamConsumers) {
      // generic-proxy writes of the previous unit's reduction precede these loads
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int st = 0; st < n_st; ++st) {
        mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1u);
        mbar_expect_tx(&sm.full[ring.stage], L::kStageBytes);
        tma_load_3d(sm.ring + ring.stage * L::kStageElems, wmap, &sm.full[ring.stage], col0,
                    k0 + st * kStreamStageRows, rank);
        ring.advance(L::kStages);
      }
    }
    __syncwarp();
  } else {
    stage_x(sm.xs, x, rows, K, ks, k0, kend, row0, R);
    stream_consumer_sync();

    const int cgp = tid % L::kColGroups, kl = tid / L::kColGroups;
    float acc[R][L::V];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < L::V; ++j) acc[r][j] = 0.f;

    for (int st = 0; st < n_st; ++st) {
      mbar_wait(&sm.full[ring.stage], ring.phase);
      const T* s = sm.ring + ring.stage * L::kStageElems;
      uint4 raw[L::kRowsPerLane];
#pragma unroll
      for (int i = 0; i < L::kRowsPerLane; ++i)
        raw[i] = *reinterpret_cast<const uint4*>(s + (kl + i * L::kLanesK) * kStreamN + cgp * L::V);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&sm.empty[ring.stage]);  // the vectors are in registers
      ring.advance(L::kStages);
#pragma unroll
      for (int i = 0; i < L::kRowsPerLane; ++i) {
        const T* e = reinterpret_cast<const T*>(&raw[i]);
        const int kk = st * kStreamStageRows + kl + i * L::kLanesK;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = sm.xs[r * ks + kk];
#pragma unroll
          for (int j = 0; j < L::V; ++j) acc[r][j] = fmaf(xv, to_float(e[j]), acc[r][j]);
        }
      }
    }

    // K lanes of one warp differ in the lane bits above the column group
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < L::V; ++j) {
        float v = acc[r][j];
#pragma unroll
        for (int o = L::kColGroups; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        acc[r][j] = v;
      }
    stream_consumer_sync();  // every warp is done reading the ring
    if (lane < L::kColGroups) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < L::V; ++j)
          red[(warp * R + r) * kStreamN + cgp * L::V + j] = acc[r][j];
    }
    stream_consumer_sync();
    for (int i = tid; i < R * kStreamN; i += kStreamConsumers) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kStreamConsumerWarps; ++w) v += red[w * R * kStreamN + i];
      tile[i] = v;
    }
  }

  // the cluster's partial tiles, summed by the leader in cluster-rank order
  cg::cluster_group cluster = cg::this_cluster();
  __syncwarp();
  cluster.sync();
  if (split == 0 && tid < kStreamConsumers) {
    for (int i = tid; i < R * kStreamN; i += kStreamConsumers) {
      float v = tile[i];
      for (int q = 1; q < splits; ++q) v += cluster.map_shared_rank(tile, q)[i];
      tile[i] = v;
    }
  }
  cluster.sync();  // the peers' tiles stay in place until the leader has read them
  return tile;
}

// ---------------------------------------------------------------------------
// host side: a launch plan built once per call signature
// ---------------------------------------------------------------------------
// A tensor map over a contiguous [depth][rows][cols] array of 2- or 4-byte
// elements with boxes of [1][kStreamStageRows][kStreamN], no swizzle (the
// consumers read 16-byte vectors along a row), zeros outside the array.
static cudaError_t make_stream_map(CUtensorMap* map, const void* base, int elem_bytes,
                                   uint64_t cols, uint64_t rows, uint64_t depth) {
  EncodeTiledFn encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols * elem_bytes, rows * cols * elem_bytes};
  const cuuint32_t box[3] = {kStreamN, kStreamStageRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
      const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lets `kernel` take up to kStreamSmemLimit bytes of dynamic shared memory
// on the current device.  The attribute belongs to the kernel, for the whole
// process, and a launch fails above it: set to one plan's size, it would
// refuse a cached plan of the same kernel that needs more.  So it is the
// ceiling, never a plan's size; each launch and occupancy query states its
// own size (cudaLaunchConfig_t::dynamicSmemBytes).
static cudaError_t allow_stream_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kStreamSmemLimit));
}

struct StreamPlan {
  CUtensorMap wmap;  // w's map, encoded once: a layer's weights do not move
  StreamArgs args;   // x, out, rx and the epoch are filled per call
  const void* kernel;
  dim3 grid;
  size_t smem;
  bool cooperative;         // every CTA must be resident (n_dev > 1)
  size_t out_rank_bytes;    // rank r's output at out + r * out_rank_bytes
  size_t rx_rank_bytes;     // rank r's rx slots at rx + r * rx_rank_bytes
};

// A launch of kStreamThreads-thread CTAs in clusters of `splits` along x,
// with the cooperative attribute when every CTA must be resident.
static void stream_launch_config(dim3 grid, size_t smem, int splits, bool cooperative,
                                 cudaStream_t stream, cudaLaunchAttribute (&attrs)[2],
                                 cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kStreamThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg->attrs = attrs;
  cfg->numAttrs = cooperative ? 2 : 1;
}

static void stream_launch_config(const StreamPlan& p, cudaStream_t stream,
                                 cudaLaunchAttribute (&attrs)[2], cudaLaunchConfig_t* cfg) {
  stream_launch_config(p.grid, p.smem, p.args.splits, p.cooperative, stream, attrs, cfg);
}

// Fills the plan's map, shared memory and grid: units_per_rank clusters of
// `splits` CTAs per rank, or, when cooperative, as many as are resident at
// once (sized by cudaOccupancyMaxActiveClusters), looping over the units.
static cudaError_t stream_plan_init(StreamPlan* p, const void* kernel, const void* w,
                                    int elem_bytes, int ranks_in_launch, int rows_per_block,
                                    int units_per_rank, bool cooperative) {
  const StreamArgs& a = p->args;
  if (a.splits < 1 || a.splits > kStreamMaxSplits || a.ks % kStreamStageRows != 0 ||
      (long long)a.splits * a.ks < a.K || (a.N * elem_bytes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  p->kernel = kernel;
  p->smem = stream_smem_bytes(rows_per_block, a.ks);
  if (p->smem > kStreamSmemLimit) return cudaErrorInvalidValue;
  p->cooperative = cooperative;
  cudaError_t err = make_stream_map(&p->wmap, w, elem_bytes, a.N, a.K, ranks_in_launch);
  if (err == cudaSuccess) err = allow_stream_smem(kernel);
  if (err != cudaSuccess) return err;
  p->grid = dim3(units_per_rank * a.splits, ranks_in_launch);
  if (!cooperative) return cudaSuccess;
  // CTAs wait on flags set by other CTAs: all of them must be resident
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  stream_launch_config(*p, nullptr, attrs, &cfg);
  cfg.numAttrs = 1;  // the cluster shape; residency is what is asked
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  const int per_rank = clusters / ranks_in_launch;
  if (per_rank < 1) return cudaErrorCooperativeLaunchTooLarge;
  p->grid.x = (units_per_rank < per_rank ? units_per_rank : per_rank) * a.splits;
  return cudaSuccess;
}

// How many clusters of `splits` CTAs of `kernel`, each with `smem` bytes of
// dynamic shared memory, the card holds at once.
static cudaError_t stream_max_clusters(const void* kernel, int splits, size_t smem,
                                       int* clusters) {
  const cudaError_t err = allow_stream_smem(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  stream_launch_config(dim3(splits), smem, splits, false, nullptr, attrs, &cfg);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The instantiation of a stream kernel for R = rows_per_block rows a unit
// (1, 2, 4 or 8): make(std::integral_constant<int, R>{}), or null.
template <typename Make>
static const void* stream_kernel_for_rows(int rows_per_block, Make make) {
  switch (rows_per_block) {
    case 1: return make(std::integral_constant<int, 1>{});
    case 2: return make(std::integral_constant<int, 2>{});
    case 4: return make(std::integral_constant<int, 4>{});
    case 8: return make(std::integral_constant<int, 8>{});
    default: return nullptr;
  }
}

// The stream kernel for an element type (0 = float32, 1 = bfloat16), and for
// the fused kernel its wire (0 = the element type, 1 = bfloat16), at
// rows_per_block; null where there is none.  gemv.cu and
// fused_gemv_allreduce.cu define them.
const void* gemv_stream_kernel_for(int dtype, int rows_per_block);
const void* fused_stream_kernel_for(int dtype, int wire, int rows_per_block);

static int stream_plan_launch(const StreamPlan* p, const void* x, void* out, void* rx,
                              unsigned epoch, cudaStream_t stream) {
  StreamArgs a = p->args;
  a.x = x;
  a.epoch = epoch;
  for (int d = 0; d < a.n_dev; ++d) {
    a.peers.out[d] = static_cast<char*>(out) + d * p->out_rank_bytes;
    a.peers.rx[d] = rx ? static_cast<char*>(rx) + d * p->rx_rank_bytes : nullptr;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  stream_launch_config(*p, stream, attrs, &cfg);
  void* args[] = {const_cast<CUtensorMap*>(&p->wmap), &a};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, p->kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

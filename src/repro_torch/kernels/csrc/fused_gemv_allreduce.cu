// Device-initiated fused GEMV/GEMM + AllReduce for Hopper (paper Sec. III-B,
// Fig. 7).
//
// Replaces the TPU kernel src/repro/kernels/fused_gemv_allreduce/kernel.py:59
// (_fused_kernel, entry fused_matmul_allreduce_pallas at :219).  Every rank r
// holds x_r [B, K] and w_r [K, N]; every rank ends with y = sum_r x_r @ w_r.
// The output columns split into n_dev chunks of bn = N / n_dev; chunk d is
// reduced by rank d.  Each TPU grid step is a jnp.dot of the whole
// [B, tile_k] x against a [tile_k, tile_n] weight panel, so at decode rows it
// is a GEMV and at prefill rows a GEMM.  Here two paths share the protocol
// below and differ in their unit of work; kernels/fused_gemv_allreduce/ops.py
// chooses by dtype and shape (fused_path):
//
//  * GEMV path (the wrapper's "stream"; every call the tile path does not
//    take whose w TMA can read, every f32 call among them): stream_gemv.cuh's
//    loop.  A unit is (step of the schedule, row block of up to 8 rows): a
//    thread-block cluster of up to 8 CTAs splits the unit's K, each CTA
//    streaming its share of a [K, 128] weight column tile through a TMA-fed
//    shared-memory ring, and the leader (cluster rank 0) sums the partial
//    tiles in cluster-rank order through distributed shared memory and runs
//    the protocol below.  What bounds it: at decode rows about one FMA per
//    weight element, so the weight bytes over HBM bandwidth; chatglm3-6b's
//    FFN down projection at tp = 1 reads 13696 x 4096 x 2 B = 112 MB, about
//    33.5 us on an H100 SXM (3.35 TB/s).  The cluster split spreads a
//    4096-wide output over 256 CTAs, and the ring keeps 64 KB of weights in
//    flight per CTA.
//  * Panel path (the other shapes: N * sizeof(T) not a multiple of 16, an
//    unaligned w, or x's slice too large for shared memory): a CTA of 256
//    threads owns a [B, 32] output strip and loops over row blocks of 8 and
//    all of K with f32 FMAs on CUDA cores (tile_gemv.cuh), staging x in
//    512-deep panels.
//  * Tile path (bf16 with B >= TILE_ROWS, K % 8 == 0 and bn a multiple of
//    128): the tensor-core tile loop of tile_mma.cuh on [128, 128] output
//    tiles, TMA-fed wgmma with f32 accumulators, each weight panel read once
//    per 128 rows.  What bounds it: at rwkv6's prefill rows the operations
//    (2 B K N at 989 TFLOP/s: 0.0695 ms for [2048, 4096] x [4096, 4096]).
//    TILE_ROWS comes from the row sweep of chip_smoke.py phase 18.
//
// The protocol, per output tile (the TPU grid's order, not its grid):
//  * Tiles are taken in the order of the step schedule
//    (kernels/tile_pipeline.py step_schedule) over a rank's column
//    sub-tiles: remote tiles first, farthest peer first when comm-aware, the
//    rank's own tiles last; the row blocks of a sub-tile come next to each
//    other.  A CTA (on the GEMV path a cluster) computes its tile over all
//    of K itself; nothing carries between them.
//  * A finished remote tile is stored at the wire dtype straight into the
//    owner's per-source rx slot, then the sender publishes a flag with
//    release semantics (the paper's sliceRdy): one per (source, sub-tile) on
//    the panel path, one per (source, sub-tile, row block) on the GEMV and
//    tile paths,
//    so a rank has n_dev * (bn / 128) * row blocks units to spread over its
//    CTAs.
//  * An own tile is computed first, then its CTA acquires the flags of all
//    sources for that unit, adds the rx slots in f32 in source order to its
//    f32 tile, and writes the result at x's dtype into every rank's output
//    (phase 2, the direct broadcast), publishing a phase-2 flag to each peer
//    (the paper's WG_Done).
//  * Before the launch ends, CTA 0 of each rank acquires every peer's phase-2
//    flag, so the whole output is in place when the next kernel on the stream
//    reads it.
// Flags hold the call's epoch, a counter the caller increments per call, so
// they are never reset.  Peer buffers come in a by-value pointer table, so
// the same kernel serves an emulated world (gridDim.y = n_dev ranks in one
// launch on one card, pointers into per-rank slices of single allocations;
// the tile path's tensor maps are 3-D over the ranks) and, later, real peers
// whose pointers come from symmetric memory.  A CTA waits only after all of
// its remote tiles are out, and remote tiles never wait, so the protocol
// cannot deadlock as long as every CTA is resident: with n_dev > 1 the grid
// is sized from the occupancy (with the dynamic shared memory counted; on
// the GEMV path in whole clusters, cudaOccupancyMaxActiveClusters) and
// launched cooperatively (the GEMV path through cudaLaunchKernelEx with both
// the cluster and the cooperative attribute), which refuses a grid that does
// not fit; CTAs then loop over the units.
//
// At tp = 1 (the serving path) n_dev = 1: every tile is an own tile, there
// are no flags, and the kernel is the tiled GEMV or GEMM, one CTA (or
// cluster) per tile.
#include "stream_gemv.cuh"
#include "tile_gemv.cuh"
#include "tile_mma.cuh"

namespace repro_torch {

using PeerTable = StreamPeers;

// The GEMV path.  Unit u of a rank is step u / row_blocks of its schedule at
// row block u % row_blocks; cluster c of the rank takes units c, c + clusters,
// ...
template <typename T, typename WT, int R>
__global__ void __launch_bounds__(kStreamThreads, R <= 4 ? 2 : 1)
    fused_stream_kernel(const __grid_constant__ CUtensorMap wmap, const StreamArgs a) {
  const StreamSmem<T> sm = stream_smem<T>();
  StreamRing ring;
  const int split = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int my = a.my_base + blockIdx.y;
  const T* x = static_cast<const T*>(a.x) + (size_t)blockIdx.y * a.B * a.K;
  const int n_dev = a.n_dev, B = a.B, N = a.N;
  const int bn = N / n_dev;
  const int num_steps = n_dev * a.tiles;
  const int units = num_steps * a.row_blocks;
  const size_t words = (size_t)a.tiles * a.row_blocks;  // flag words per (phase, source)
  unsigned* my_flags = a.peers.flags[my];
  const int tid = threadIdx.x;

  for (int u = blockIdx.x / a.splits; u < units; u += gridDim.x / a.splits) {
    const int step = u / a.row_blocks, rb = u % a.row_blocks;
    const int off = a.sched[step], sub = a.sched[num_steps + step];
    const int dest = (my + off) % n_dev;
    const int ccol = sub * kStreamN, row0 = rb * R;  // ccol: column inside the chunk
    const float* tile = stream_unit<T, R>(&wmap, sm, ring, x, B, a.K, a.ks, split, a.splits,
                                          blockIdx.y, row0, dest * bn + ccol);
    if (split == 0 && tid < kStreamConsumers) {
      const size_t unit = (size_t)sub * a.row_blocks + rb;
      if (off != 0) {
        // phase 1: PUT the tile into the owner's slot for this source
        WT* rx = static_cast<WT*>(a.peers.rx[dest]);
        for (int i = tid; i < R * kStreamN; i += kStreamConsumers) {
          const int row = row0 + i / kStreamN, col = ccol + i % kStreamN;
          if (row < B && col < bn) rx[((size_t)my * B + row) * bn + col] = from_float<WT>(tile[i]);
        }
        stream_consumer_sync();
        if (tid == 0) {
          __threadfence_system();
          store_release(a.peers.flags[dest] + (size_t)my * words + unit, a.epoch);
        }
      } else {
        // own tiles come last: every source's tile for this unit, added in
        // source order, then the result into every rank's output
        if (n_dev > 1) {
          if (tid < n_dev && tid != my) wait_flag(my_flags + (size_t)tid * words + unit, a.epoch);
          __threadfence();
          stream_consumer_sync();
        }
        const WT* rx = static_cast<const WT*>(a.peers.rx[my]);
        for (int i = tid; i < R * kStreamN; i += kStreamConsumers) {
          const int row = row0 + i / kStreamN, col = ccol + i % kStreamN;
          if (row >= B || col >= bn) continue;
          float v = tile[i];
          for (int s = 0; s < n_dev; ++s)
            if (s != my) v += to_float(__ldcg(rx + ((size_t)s * B + row) * bn + col));
          const T o = from_float<T>(v);
          for (int d = 0; d < n_dev; ++d)
            static_cast<T*>(a.peers.out[d])[(size_t)row * N + my * bn + col] = o;
        }
        if (n_dev > 1) {
          stream_consumer_sync();
          if (tid == 0) {
            __threadfence_system();
            for (int d = 0; d < n_dev; ++d)
              if (d != my)
                store_release(a.peers.flags[d] + ((size_t)n_dev + my) * words + unit, a.epoch);
          }
        }
      }
    }
    __syncthreads();  // the next unit's stream reuses the ring that holds the tile
  }

  if (n_dev > 1 && blockIdx.x == 0) {
    for (size_t i = tid; i < n_dev * words; i += kStreamThreads) {
      const int s = static_cast<int>(i / words);
      if (s != my) wait_flag(my_flags + (size_t)n_dev * words + i, a.epoch);
    }
  }
}

template <typename T, typename WT>
static const void* fused_stream_fn(int rows_per_block) {
  return stream_kernel_for_rows(rows_per_block, [](auto r) {
    return reinterpret_cast<const void*>(fused_stream_kernel<T, WT, decltype(r)::value>);
  });
}

const void* fused_stream_kernel_for(int dtype, int wire, int rows_per_block) {
  return dtype == 1                ? fused_stream_fn<__nv_bfloat16, __nv_bfloat16>(rows_per_block)
         : dtype == 0 && wire == 0 ? fused_stream_fn<float, float>(rows_per_block)
         : dtype == 0 && wire == 1 ? fused_stream_fn<float, __nv_bfloat16>(rows_per_block)
                                   : nullptr;
}

// The panel path (tile_gemv.cuh).
template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads)
    fused_gemv_allreduce_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                long long x_rank_stride, long long w_rank_stride, PeerTable peers,
                                const int* __restrict__ sched, int my_base, int n_dev, int B,
                                int K, int N, int tiles_per_rank, unsigned epoch, bool vec_ok) {
  __shared__ TileSmem sm;
  const int my = my_base + blockIdx.y;
  x += blockIdx.y * x_rank_stride;
  w += blockIdx.y * w_rank_stride;
  const int bn = N / n_dev;
  const int num_tiles = n_dev * tiles_per_rank;
  const int tid = threadIdx.x;
  const int r = tid / kTileN, c = tid % kTileN;
  unsigned* my_flags = peers.flags[my];

  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int off = sched[t];
    const int sub = sched[num_tiles + t];
    const int dest = (my + off) % n_dev;
    const int ccol = sub * kTileN;  // column inside the chunk
    for (int row0 = 0; row0 < B; row0 += kRows) {
      tile_gemv<T>(x, w, B, K, N, row0, dest * bn + ccol, vec_ok, sm);
      const int row = row0 + r;
      if (off != 0) {
        // phase 1: PUT the tile into the owner's slot for this source
        WT* rx = static_cast<WT*>(peers.rx[dest]);
        if (row < B) rx[((size_t)my * B + row) * bn + ccol + c] = from_float<WT>(sm.tile[r][c]);
        continue;
      }
      if (row0 == 0 && n_dev > 1) {
        // own tiles come last: every source's tile for this sub-tile
        if (tid < n_dev && tid != my)
          wait_flag(my_flags + (size_t)tid * tiles_per_rank + sub, epoch);
        __threadfence();
        __syncthreads();
      }
      if (row < B) {
        float v = sm.tile[r][c];
        const WT* rx = static_cast<const WT*>(peers.rx[my]);
        for (int s = 0; s < n_dev; ++s)
          if (s != my) v += to_float(__ldcg(rx + ((size_t)s * B + row) * bn + ccol + c));
        const T o = from_float<T>(v);
        for (int d = 0; d < n_dev; ++d)
          static_cast<T*>(peers.out[d])[(size_t)row * N + my * bn + ccol + c] = o;
      }
    }
    if (n_dev > 1) {
      __syncthreads();
      if (tid == 0) {
        __threadfence_system();
        if (off != 0) {
          store_release(peers.flags[dest] + (size_t)my * tiles_per_rank + sub, epoch);
        } else {
          for (int d = 0; d < n_dev; ++d)
            if (d != my)
              store_release(peers.flags[d] + ((size_t)n_dev + my) * tiles_per_rank + sub, epoch);
        }
      }
    }
  }

  if (n_dev > 1 && blockIdx.x == 0) {
    for (int i = tid; i < num_tiles; i += kThreads) {
      const int s = i / tiles_per_rank;
      if (s != my) wait_flag(my_flags + ((size_t)n_dev + s) * tiles_per_rank + i % tiles_per_rank, epoch);
    }
  }
}

template <typename T, typename WT>
static int launch_fused(const void* x, const void* w, long long x_rank_stride,
                        long long w_rank_stride, const PeerTable& peers, const int* sched,
                        int my_base, int ranks_in_launch, int n_dev, int B, int K, int N,
                        int tiles_per_rank, unsigned epoch, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto kernel = fused_gemv_allreduce_kernel<T, WT>;
  const bool vec_ok = (N % V == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                      (w_rank_stride % V == 0);
  const int num_tiles = n_dev * tiles_per_rank;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  if (n_dev == 1) {
    fused_gemv_allreduce_kernel<T, WT><<<dim3(num_tiles, ranks_in_launch), kThreads, 0, stream>>>(
        xp, wp, x_rank_stride, w_rank_stride, peers, sched, my_base, n_dev, B, K, N,
        tiles_per_rank, epoch, vec_ok);
    return static_cast<int>(cudaGetLastError());
  }
  // CTAs wait on flags set by other CTAs: all of them must be resident
  int per_rank = 0;
  cudaError_t err = resident_ctas(kernel, kThreads, ranks_in_launch, &per_rank);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_rank < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(num_tiles < per_rank ? num_tiles : per_rank, ranks_in_launch);
  void* args[] = {(void*)&xp,      (void*)&wp,       (void*)&x_rank_stride,
                  (void*)&w_rank_stride, (void*)&peers, (void*)&sched,
                  (void*)&my_base, (void*)&n_dev,    (void*)&B,
                  (void*)&K,       (void*)&N,        (void*)&tiles_per_rank,
                  (void*)&epoch,   (void*)&vec_ok};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The tile path (bf16, wire bf16).  Unit u of a rank is step u / row_blocks of
// its schedule at row block u % row_blocks.
__global__ void __launch_bounds__(kMmaThreads)
    fused_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, PeerTable peers,
                      const int* __restrict__ sched, int my_base, int n_dev, int B, int K, int N,
                      int tiles_per_rank, unsigned epoch) {
  const int my = my_base + blockIdx.y;
  const int bn = N / n_dev;
  const int row_blocks = (B + kMmaBM - 1) / kMmaBM;
  const int num_steps = n_dev * tiles_per_rank;
  const size_t words = (size_t)tiles_per_rank * row_blocks;  // flag words per (phase, source)
  unsigned* my_flags = peers.flags[my];
  const int ct = threadIdx.x;  // consumer thread, in the epilogue

  auto coords = [&](int u) {
    const int step = u / row_blocks;
    const int dest = (my + sched[step]) % n_dev;
    return TileCoord{static_cast<int>(blockIdx.y), (u % row_blocks) * kMmaBM,
                     dest * bn + sched[num_steps + step] * kMmaBN};
  };
  auto epilogue = [&](int u, TileCoord tc, float(&acc)[kMmaAccs], int wg, int t) {
    const int step = u / row_blocks;
    const int off = sched[step];
    const int dest = (my + off) % n_dev;
    const int ccol = sched[num_steps + step] * kMmaBN;  // column inside the chunk
    const size_t unit = (size_t)(ccol / kMmaBN) * row_blocks + u % row_blocks;
    if (off != 0) {
      // phase 1: PUT the tile into the owner's slot for this source
      __nv_bfloat16* rx = static_cast<__nv_bfloat16*>(peers.rx[dest]) + (size_t)my * B * bn + ccol;
      for_each_acc_pair(acc, wg, t, [&](int r, int c, float& v0, float& v1) {
        if (tc.row0 + r < B) store_pair(rx + (size_t)(tc.row0 + r) * bn + c, v0, v1);
      });
      consumer_sync();
      if (ct == 0) {
        __threadfence_system();
        store_release(peers.flags[dest] + (size_t)my * words + unit, epoch);
      }
      return;
    }
    // own tiles come last: add every source's tile for this unit, in source
    // order, then write the result into every rank's output.  The source and
    // rank loops stay outside the unrolled pair loop to keep the code short.
    if (n_dev > 1) {
      if (ct < n_dev && ct != my) wait_flag(my_flags + (size_t)ct * words + unit, epoch);
      __threadfence();
      consumer_sync();
    }
#pragma unroll 1
    for (int s = 0; s < n_dev; ++s) {
      if (s == my) continue;
      const __nv_bfloat16* rx =
          static_cast<const __nv_bfloat16*>(peers.rx[my]) + (size_t)s * B * bn + ccol;
      for_each_acc_pair(acc, wg, t, [&](int r, int c, float& v0, float& v1) {
        if (tc.row0 + r >= B) return;
        const __nv_bfloat162 p =
            __ldcg(reinterpret_cast<const __nv_bfloat162*>(rx + (size_t)(tc.row0 + r) * bn + c));
        v0 += __low2float(p);
        v1 += __high2float(p);
      });
    }
#pragma unroll 1
    for (int d = 0; d < n_dev; ++d) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(peers.out[d]) + my * bn + ccol;
      for_each_acc_pair(acc, wg, t, [&](int r, int c, float& v0, float& v1) {
        if (tc.row0 + r < B) store_pair(out + (size_t)(tc.row0 + r) * N + c, v0, v1);
      });
    }
    if (n_dev > 1) {
      consumer_sync();
      if (ct == 0) {
        __threadfence_system();
        for (int d = 0; d < n_dev; ++d)
          if (d != my) store_release(peers.flags[d] + ((size_t)n_dev + my) * words + unit, epoch);
      }
    }
  };
  mma_tile_loop(&xmap, &wmap, (K + kMmaBK - 1) / kMmaBK, num_steps * row_blocks, coords,
                epilogue);

  if (n_dev > 1 && blockIdx.x == 0 && threadIdx.x < kMmaConsumerThreads) {
    for (size_t i = threadIdx.x; i < n_dev * words; i += kMmaConsumerThreads) {
      const int s = static_cast<int>(i / words);
      if (s != my) wait_flag(my_flags + (size_t)n_dev * words + i, epoch);
    }
  }
}

static int launch_fused_tile(const void* x, const void* w, const PeerTable& peers,
                             const int* sched, int my_base, int ranks_in_launch, int n_dev, int B,
                             int K, int N, int tiles_per_rank, unsigned epoch,
                             cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = make_mma_maps(&xmap, &wmap, x, w, ranks_in_launch, B, K, N);
  if (err == cudaSuccess) err = allow_mma_smem(fused_tile_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = n_dev * tiles_per_rank * ((B + kMmaBM - 1) / kMmaBM);
  if (n_dev == 1) {
    fused_tile_kernel<<<dim3(units, ranks_in_launch), kMmaThreads, kMmaSmemBytes, stream>>>(
        xmap, wmap, peers, sched, my_base, n_dev, B, K, N, tiles_per_rank, epoch);
    return static_cast<int>(cudaGetLastError());
  }
  // CTAs wait on flags set by other CTAs: all of them must be resident
  int per_rank = 0;
  err = resident_ctas(fused_tile_kernel, kMmaThreads, ranks_in_launch, &per_rank, kMmaSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_rank < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(units < per_rank ? units : per_rank, ranks_in_launch);
  void* args[] = {(void*)&xmap, (void*)&wmap,  (void*)&peers,          (void*)&sched,
                  (void*)&my_base, (void*)&n_dev, (void*)&B,            (void*)&K,
                  (void*)&N,    (void*)&tiles_per_rank, (void*)&epoch};
  err = cudaLaunchCooperativeKernel((const void*)fused_tile_kernel, grid, dim3(kMmaThreads), args,
                                    kMmaSmemBytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// x, w: rank base pointers (rank r's operands at x + r * x_rank_stride, in
// elements); out_ptrs/rx_ptrs/flag_ptrs: host arrays of n_dev device
// pointers; sched: device int32 [2 * n_dev * tiles_per_rank] (offsets, then
// sub-tiles).  ranks_in_launch is n_dev for an emulated world (gridDim.y) and
// 1 when each rank launches its own kernel.  dtype: 0 = float32,
// 1 = bfloat16; wire: 0 = x's dtype, 1 = bfloat16.  Returns a cudaError_t
// code (0 = launched).
extern "C" int repro_fused_gemv_allreduce(const void* x, const void* w, long long x_rank_stride,
                                          long long w_rank_stride, const uint64_t* out_ptrs,
                                          const uint64_t* rx_ptrs, const uint64_t* flag_ptrs,
                                          const void* sched, int my_base, int ranks_in_launch,
                                          int n_dev, int B, int K, int N, int tiles_per_rank,
                                          unsigned epoch, int dtype, int wire, void* stream) {
  using namespace repro_torch;
  if (n_dev < 1 || n_dev > kMaxDev || B <= 0 || K <= 0 || N <= 0 || tiles_per_rank <= 0 ||
      N != n_dev * tiles_per_rank * kTileN || (ranks_in_launch != 1 && ranks_in_launch != n_dev))
    return static_cast<int>(cudaErrorInvalidValue);
  PeerTable peers = {};
  for (int d = 0; d < n_dev; ++d) {
    peers.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    peers.rx[d] = reinterpret_cast<void*>(rx_ptrs[d]);
    peers.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
  }
  const int* s = static_cast<const int*>(sched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16, __nv_bfloat16>(x, w, x_rank_stride, w_rank_stride, peers,
                                                      s, my_base, ranks_in_launch, n_dev, B, K,
                                                      N, tiles_per_rank, epoch, st);
  if (dtype == 0 && wire == 0)
    return launch_fused<float, float>(x, w, x_rank_stride, w_rank_stride, peers, s, my_base,
                                      ranks_in_launch, n_dev, B, K, N, tiles_per_rank, epoch, st);
  if (dtype == 0 && wire == 1)
    return launch_fused<float, __nv_bfloat16>(x, w, x_rank_stride, w_rank_stride, peers, s,
                                              my_base, ranks_in_launch, n_dev, B, K, N,
                                              tiles_per_rank, epoch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile path: bf16 x [ranks_in_launch, B, K] and w [ranks_in_launch, K, N],
// contiguous, K % 8 == 0, N == n_dev * tiles_per_rank * 128, 16-byte-aligned
// bases; the wire is bf16.  out_ptrs/rx_ptrs/flag_ptrs and sched as above,
// with tiles_per_rank 128-column sub-tiles and 2 * n_dev * tiles_per_rank *
// ceil(B / 128) flag words per rank.  Returns a cudaError_t code (0 =
// launched).
extern "C" int repro_fused_gemm_allreduce_tile(const void* x, const void* w,
                                               const uint64_t* out_ptrs, const uint64_t* rx_ptrs,
                                               const uint64_t* flag_ptrs, const void* sched,
                                               int my_base, int ranks_in_launch, int n_dev, int B,
                                               int K, int N, int tiles_per_rank, unsigned epoch,
                                               void* stream) {
  using namespace repro_torch;
  if (n_dev < 1 || n_dev > kMaxDev || B <= 0 || K <= 0 || tiles_per_rank <= 0 ||
      N != n_dev * tiles_per_rank * kMmaBN || !mma_shape_ok(x, w, K, N) ||
      (ranks_in_launch != 1 && ranks_in_launch != n_dev))
    return static_cast<int>(cudaErrorInvalidValue);
  PeerTable peers = {};
  for (int d = 0; d < n_dev; ++d) {
    peers.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    peers.rx[d] = reinterpret_cast<void*>(rx_ptrs[d]);
    peers.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
  }
  return launch_fused_tile(x, w, peers, static_cast<const int*>(sched), my_base, ranks_in_launch,
                           n_dev, B, K, N, tiles_per_rank, epoch,
                           static_cast<cudaStream_t>(stream));
}

// The GEMV path's launch plan for w [ranks_in_launch, K, N] (contiguous,
// 16-byte aligned, N * sizeof(T) % 16 == 0) at B rows: rows_per_block rows
// per unit (1, 2, 4 or 8), K split into `splits` shares of ks rows across a
// cluster (kernels/gemv/plan.py), tiles_per_rank = ceil(N / n_dev / 128)
// sub-tiles per rank, flag_ptrs (host array of n_dev device pointers, each
// 2 * n_dev * tiles_per_rank * ceil(B / rows_per_block) words) and sched
// (device int32 [2 * n_dev * tiles_per_rank]) as above; both stay valid for
// the plan's life.  Writes a handle for repro_stream_launch, whose out is
// [ranks_in_launch, B, N] and rx [ranks_in_launch, n_dev, B, N / n_dev] at
// the wire dtype (null at n_dev = 1).  n_dev > 1 launches cooperatively
// with clusters.  dtype and wire as above.  Returns a cudaError_t code (0 =
// built).
extern "C" int repro_fused_stream_plan(void** plan, const void* w, const uint64_t* flag_ptrs,
                                       const void* sched, int my_base, int ranks_in_launch,
                                       int n_dev, int B, int K, int N, int tiles_per_rank,
                                       int rows_per_block, int splits, int ks, int dtype,
                                       int wire) {
  using namespace repro_torch;
  *plan = nullptr;
  const void* kernel = fused_stream_kernel_for(dtype, wire, rows_per_block);
  if (kernel == nullptr || n_dev < 1 || n_dev > kMaxDev || B <= 0 || K <= 0 || N <= 0 ||
      N % n_dev != 0 || tiles_per_rank != (N / n_dev + kStreamN - 1) / kStreamN ||
      (ranks_in_launch != 1 && ranks_in_launch != n_dev))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2, wsize = dtype == 0 && wire == 0 ? 4 : 2;
  StreamPlan* p = new StreamPlan{};
  StreamArgs& a = p->args;
  for (int d = 0; d < n_dev; ++d) a.peers.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
  a.sched = static_cast<const int*>(sched);
  a.my_base = my_base;
  a.n_dev = n_dev;
  a.B = B;
  a.K = K;
  a.N = N;
  a.tiles = tiles_per_rank;
  a.row_blocks = (B + rows_per_block - 1) / rows_per_block;
  a.splits = splits;
  a.ks = ks;
  p->out_rank_bytes = (size_t)B * N * esize;
  p->rx_rank_bytes = (size_t)n_dev * B * (N / n_dev) * wsize;
  const cudaError_t err =
      stream_plan_init(p, kernel, w, esize, ranks_in_launch, rows_per_block,
                       n_dev * tiles_per_rank * a.row_blocks, n_dev > 1);
  if (err != cudaSuccess) {
    delete p;
    return static_cast<int>(err);
  }
  *plan = p;
  return 0;
}

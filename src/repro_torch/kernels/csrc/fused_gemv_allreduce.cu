// Device-initiated fused GEMV + AllReduce for Hopper (paper Sec. III-B, Fig. 7).
//
// Replaces the TPU kernel src/repro/kernels/fused_gemv_allreduce/kernel.py:59
// (_fused_kernel, entry fused_matmul_allreduce_pallas at :219).  Every rank r
// holds x_r [B, K] and w_r [K, N]; every rank ends with y = sum_r x_r @ w_r.
// The output columns split into n_dev chunks of bn = N / n_dev; chunk d is
// reduced by rank d.
//
// What bounds it: at decode batch sizes the work is about one FMA per weight
// element, so the time is the weight bytes over HBM bandwidth.  For
// chatglm3-6b's FFN down projection at tp = 1 one launch reads
// 13696 x 4096 x 2 B = 112 MB of w_down, which bounds it at about 33 us on an
// H100 SXM (3.35 TB/s), 28 launches per decode step.  The design reads every
// weight byte once with coalesced 16-byte loads (tile_gemv.cuh), gives each
// CTA a 32-column tile so a 4096-wide output spreads over 128 CTAs, and keeps
// the peer protocol out of the K loop.  TMA/wgmma pipelining is later work.
//
// What it computes, tile by tile (the TPU grid's order, not its grid):
//  * A CTA owns one [B, 32] output tile at a time and loops over all of K
//    itself; nothing carries between CTAs.  Tiles are taken in the order of
//    the step schedule (kernels/tile_pipeline.py step_schedule): remote tiles
//    first, farthest peer first when comm-aware, the rank's own tiles last.
//  * A finished remote tile is stored at the wire dtype straight into the
//    owner's per-source rx slot, then the sender publishes a per-(source,
//    sub-tile) flag with release semantics (the paper's sliceRdy).
//  * An own tile is computed first, then the CTA acquires the flags of all
//    sources for that sub-tile, adds the rx slots in f32 in source order to
//    its f32 tile, and writes the result at x's dtype into every rank's output
//    (phase 2, the direct broadcast), publishing a phase-2 flag to each peer
//    (the paper's WG_Done).
//  * Before the launch ends, CTA 0 of each rank acquires every peer's phase-2
//    flag, so the whole output is in place when the next kernel on the stream
//    reads it.
// Flags hold the call's epoch, a counter the caller increments per call, so
// they are never reset.  Peer buffers come in a by-value pointer table, so
// the same kernel serves an emulated world (gridDim.y = n_dev ranks in one
// launch on one card, pointers into per-rank slices of single allocations)
// and, later, real peers whose pointers come from symmetric memory.  A CTA
// waits only after all of its remote tiles are out, and remote tiles never
// wait, so the protocol cannot deadlock as long as every CTA is resident:
// with n_dev > 1 the grid is sized from the occupancy and launched
// cooperatively, which refuses a grid that does not fit.
//
// At tp = 1 (the serving path) n_dev = 1: every tile is an own tile, there are
// no flags, and the kernel is the tiled f32-accumulated GEMV.
#include "tile_gemv.cuh"

namespace repro_torch {

struct PeerTable {
  void* out[kMaxDev];        // each rank's [B, N] output
  void* rx[kMaxDev];         // each rank's [n_dev, B, bn] rx slots at the wire dtype
  unsigned* flags[kMaxDev];  // each rank's [2, n_dev, tiles_per_rank] flag words
};

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

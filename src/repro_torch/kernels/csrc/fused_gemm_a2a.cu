// Device-initiated fused expert FFN + combine All-to-All for Hopper (paper
// Sec. III, GEMM + All-to-All).
//
// Replaces the TPU kernel src/repro/kernels/fused_gemm_a2a/kernel.py:67
// (_gemm_a2a_kernel, entry fused_gemm_a2a_pallas at :194).  Every EP rank
// holds xt [n_dev, B, E, C, D], dispatched tokens stacked by combine
// destination, and its own experts' w_up, w_gate [E, D, F] and
// w_down [E, F, D].  For each destination d and each group (b, e):
//   h = x w_up[e], g = x w_gate[e]   f32 over all of D
//   u = act(g) h                     rounded to x's dtype (kernel.py:145)
//   y = u w_down[e]                  f32 over all of F, rounded to x's dtype
// and y lands in rank d's output slot for this source, out_d[my, b, e]:
// each rank ends with [n_dev, B, E, C, D] stacked by source.
//
// What bounds it: at decode C is a few rows, so the work is about one FMA
// per weight element and the time is the weight bytes over HBM bandwidth.
// At dbrx-132b's shapes on one card (n_dev = 1, B = 1, E = 16, C = 2,
// D = 6144, F = 10752, bf16) a call reads 3 E D F x 2 B = 6.34 GB of
// weights, a 1.89 ms bound at 3.35 TB/s; its 12.7 GFLOP take 13 us at the
// bf16 tensor-core peak.  Every weight byte is read once per destination,
// as the TPU kernel streams them, with tile_gemv.cuh's coalesced 16-byte
// loads, spread over every SM; a tile holds as many rows as the group has
// (2 at decode) up to 8, so few rows spend few FMAs and registers.
// TMA/wgmma pipelining is later work.
//
// The dependency inside a group: y needs all F columns of u, which the TPU
// kernel carries across grid steps; CTAs carry nothing.  So one persistent
// cooperative launch works through items of two kinds:
//  * up/gate item (group, F tile): the [C, 32] tile of u for 32 columns of
//    F, stored at x's dtype in the scratch buffer u [n_dev, B, E, C, F];
//    then the item's flag is released.
//  * down item (group, D tile): waits for all of the group's up/gate flags,
//    then computes the [C, 32] tile of y for 32 columns of D.
// Items are dealt round-robin in a static order: groups in the step
// schedule's order (kernels/tile_pipeline.py step_schedule: remote
// destinations first, farthest first when comm-aware, rotated by `skew`,
// the rank's own destination last), and a group's down items after the next
// group's up/gate items, so a down item seldom waits.  A wait is only ever
// for an item earlier in the order, so with every CTA resident (grid sized
// from the occupancy) no wait deadlocks.
//
// The combine exchange is fused_dispatch_a2a.cu's protocol: a remote y tile
// is stored at the wire dtype straight into the destination's slot for this
// source (its rx staging when the wire is narrower than x), and the tile's
// flag (source, b, e, D tile) is released; after its own items each CTA
// waits for a share of the tiles the peers send here and, with a narrowed
// wire, widens them into the output.  At n_dev = 1 (the serving path) every
// group is local and only the up/gate -> down flags are used.
#include "tile_gemv.cuh"

namespace repro_torch {

struct GemmA2APeers {
  void* out[kMaxDev];        // each rank's [n_dev, B, E, C, D] output, by source
  void* recv[kMaxDev];       // where peers store y tiles for each rank: rx staging or out
  unsigned* flags[kMaxDev];  // each rank's [n_dev * B * E * (f_tiles + d_tiles)] flag words
};

struct GemmA2AArgs {
  const void *x, *w_up, *w_gate, *w_down;  // rank 0's operands
  long long x_rank_stride, w_rank_stride;  // in elements (w_down has the same stride)
  void* u;                                 // rank 0's [n_dev, B, E, C, F] scratch
  long long u_rank_stride;
  GemmA2APeers peers;
  const int* sched;  // [n_dev] step offsets
  int my_base, n_dev, B, E, C, D, F;
  unsigned epoch;
  int act;           // 0 = silu, 1 = gelu (tanh form), 2 = relu
  bool use_rx;       // the wire is narrower than x: y tiles arrive in rx staging
  bool vec_f, vec_d; // w_up/w_gate rows (F wide) and w_down rows (D wide) 16-byte aligned
};

__device__ __forceinline__ float activate(float g, int act) {
  if (act == 0) return g / (1.f + __expf(-g));
  if (act == 1) return 0.5f * g * (1.f + tanhf(0.7978845608f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.f);
}

template <typename T, typename WT, int R>
__global__ void __launch_bounds__(kThreads) gemm_a2a_kernel(GemmA2AArgs a) {
  __shared__ TileSmemR<R> sm;
  const int my = a.my_base + blockIdx.y;
  const T* x = static_cast<const T*>(a.x) + blockIdx.y * a.x_rank_stride;
  const T* w_up = static_cast<const T*>(a.w_up) + blockIdx.y * a.w_rank_stride;
  const T* w_gate = static_cast<const T*>(a.w_gate) + blockIdx.y * a.w_rank_stride;
  const T* w_down = static_cast<const T*>(a.w_down) + blockIdx.y * a.w_rank_stride;
  T* u = static_cast<T*>(a.u) + blockIdx.y * a.u_rank_stride;
  const int tid = threadIdx.x, r = tid / kTileN, c = tid % kTileN;
  const int C = a.C, D = a.D, F = a.F, E = a.E;
  const int f_tiles = (F + kTileN - 1) / kTileN, d_tiles = (D + kTileN - 1) / kTileN;
  const int per_dest = a.B * E;             // groups of one destination
  const int groups = a.n_dev * per_dest;
  const int per = f_tiles + d_tiles;
  unsigned* my_flags = a.peers.flags[my];
  unsigned* recv_flags = my_flags + (size_t)groups * f_tiles;  // [n_dev (source), B, E, d_tiles]
  const size_t block = (size_t)per_dest * C * D;               // one destination's [B, E, C, D]

  for (int it = blockIdx.x; it < groups * per; it += gridDim.x) {
    // order: up(0) | up(1) down(0) | ... | up(G-1) down(G-2) | down(G-1)
    int k, tile;
    bool up;
    if (it < f_tiles) {
      k = 0, tile = it, up = true;
    } else {
      const int j = (it - f_tiles) / per + 1, rem = (it - f_tiles) % per;
      up = j < groups && rem < f_tiles;
      k = up ? j : j - 1;
      tile = up ? rem : (j < groups ? rem - f_tiles : rem);
    }
    const int off = a.sched[k / per_dest];
    const int dest = (my + off) % a.n_dev;
    const int be = k % per_dest;             // b * E + e
    const int e = be % E;
    const int g = dest * per_dest + be;      // the group's index in x and u
    const T* xg = x + (size_t)g * C * D;
    T* ug = u + (size_t)g * C * F;
    const int col0 = tile * kTileN;
    if (up) {
      for (int row0 = 0; row0 < C; row0 += R) {
        tile_gemv<T>(xg, w_up + (size_t)e * D * F, C, D, F, row0, col0, a.vec_f, sm);
        const float h = r < R ? sm.tile[r][c] : 0.f;
        tile_gemv<T>(xg, w_gate + (size_t)e * D * F, C, D, F, row0, col0, a.vec_f, sm);
        const int row = row0 + r, col = col0 + c;
        if (r < R && row < C && col < F)
          ug[(size_t)row * F + col] = from_float<T>(activate(sm.tile[r][c], a.act) * h);
      }
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        store_release(my_flags + (size_t)g * f_tiles + tile, a.epoch);
      }
      continue;
    }
    for (int i = tid; i < f_tiles; i += kThreads) wait_flag(my_flags + (size_t)g * f_tiles + i, a.epoch);
    __threadfence();
    __syncthreads();
    const size_t slot = my * block + (size_t)be * C * D;  // this source's [C, D] at the destination
    for (int row0 = 0; row0 < C; row0 += R) {
      tile_gemv<T>(ug, w_down + (size_t)e * F * D, C, F, D, row0, col0, a.vec_d, sm);
      const int row = row0 + r, col = col0 + c;
      if (r < R && row < C && col < D) {
        const size_t o = slot + (size_t)row * D + col;
        if (off == 0)
          static_cast<T*>(a.peers.out[my])[o] = from_float<T>(sm.tile[r][c]);
        else
          static_cast<WT*>(a.peers.recv[dest])[o] = from_float<WT>(sm.tile[r][c]);
      }
    }
    if (off != 0) {
      __syncthreads();
      if (tid == 0) {
        __threadfence_system();
        store_release(a.peers.flags[dest] + (size_t)groups * f_tiles +
                          ((size_t)my * per_dest + be) * d_tiles + tile,
                      a.epoch);
      }
    }
  }
  if (a.n_dev == 1) return;

  // the y tiles every peer sends here
  const int tiles_in = per_dest * d_tiles;
  for (int it = blockIdx.x; it < (a.n_dev - 1) * tiles_in; it += gridDim.x) {
    const int kk = it / tiles_in, rem = it % tiles_in;
    const int src = kk < my ? kk : kk + 1;
    const int be = rem / d_tiles, col0 = (rem % d_tiles) * kTileN;
    if (tid == 0) wait_flag(recv_flags + (size_t)src * tiles_in + rem, a.epoch);
    __threadfence();
    __syncthreads();
    if (a.use_rx) {
      const size_t slot = src * block + (size_t)be * C * D;
      for (int i = tid; i < C * kTileN; i += kThreads) {
        const int row = i / kTileN, col = col0 + i % kTileN;
        if (col < D) {
          const size_t o = slot + (size_t)row * D + col;
          static_cast<T*>(a.peers.out[my])[o] =
              from_float<T>(to_float(__ldcg(static_cast<const WT*>(a.peers.recv[my]) + o)));
        }
      }
    }
  }
}

template <typename T, typename WT, int R>
static int launch_rows(const GemmA2AArgs& a, int ranks_in_launch, cudaStream_t stream) {
  auto kernel = gemm_a2a_kernel<T, WT, R>;
  // down items wait on up/gate items of other CTAs: all CTAs must be resident
  int per_rank = 0;
  cudaError_t err = resident_ctas(kernel, kThreads, ranks_in_launch, &per_rank);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_rank < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int items = a.n_dev * a.B * a.E * ((a.F + kTileN - 1) / kTileN + (a.D + kTileN - 1) / kTileN);
  const dim3 grid(items < per_rank ? items : per_rank, ranks_in_launch);
  GemmA2AArgs args_copy = a;
  void* args[] = {(void*)&args_copy};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A tile holds kDecodeRows rows of a group when C is that small (decode:
// C = 2), kRows otherwise: the weights are streamed once per R rows.
constexpr int kDecodeRows = 2;

template <typename T, typename WT>
static int launch_gemm_a2a(const GemmA2AArgs& a, int ranks_in_launch, cudaStream_t stream) {
  if (a.C <= kDecodeRows) return launch_rows<T, WT, kDecodeRows>(a, ranks_in_launch, stream);
  return launch_rows<T, WT, kRows>(a, ranks_in_launch, stream);
}

}  // namespace repro_torch

// x, w_up, w_gate, w_down, u: rank 0's operands and scratch (rank r's at
// + r * the rank stride, in elements; w_down shares w_up's stride);
// out_ptrs/recv_ptrs/flag_ptrs: host arrays of n_dev device pointers
// (recv_ptrs[d] == out_ptrs[d] unless the wire is narrower than x); sched:
// device int32 [n_dev] step offsets.  ranks_in_launch is n_dev for an
// emulated world (gridDim.y) and 1 when each rank launches its own kernel.
// act: 0 = silu, 1 = gelu (tanh), 2 = relu; dtype: 0 = float32,
// 1 = bfloat16; wire: 0 = x's dtype, 1 = bfloat16.  Returns a cudaError_t
// code (0 = launched).
extern "C" int repro_fused_gemm_a2a(const void* x, const void* w_up, const void* w_gate,
                                    const void* w_down, long long x_rank_stride,
                                    long long w_rank_stride, void* u, long long u_rank_stride,
                                    const uint64_t* out_ptrs, const uint64_t* recv_ptrs,
                                    const uint64_t* flag_ptrs, const void* sched, int my_base,
                                    int ranks_in_launch, int n_dev, int B, int E, int C, int D,
                                    int F, unsigned epoch, int act, int dtype, int wire,
                                    void* stream) {
  using namespace repro_torch;
  if (n_dev < 1 || n_dev > kMaxDev || B <= 0 || E <= 0 || C <= 0 || D <= 0 || F <= 0 ||
      act < 0 || act > 2 || (ranks_in_launch != 1 && ranks_in_launch != n_dev))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmA2AArgs a = {};
  a.x = x;
  a.w_up = w_up;
  a.w_gate = w_gate;
  a.w_down = w_down;
  a.x_rank_stride = x_rank_stride;
  a.w_rank_stride = w_rank_stride;
  a.u = u;
  a.u_rank_stride = u_rank_stride;
  for (int d = 0; d < n_dev; ++d) {
    a.peers.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    a.peers.recv[d] = reinterpret_cast<void*>(recv_ptrs[d]);
    a.peers.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
  }
  a.sched = static_cast<const int*>(sched);
  a.my_base = my_base;
  a.n_dev = n_dev;
  a.B = B;
  a.E = E;
  a.C = C;
  a.D = D;
  a.F = F;
  a.epoch = epoch;
  a.act = act;
  a.use_rx = dtype == 0 && wire == 1;
  // tile_gemv's 16-byte weight loads: every row of each expert's matrix
  // starts on a 16-byte boundary
  const int V = dtype == 1 ? 8 : 4;
  const bool w_aligned = reinterpret_cast<uintptr_t>(w_up) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w_gate) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w_down) % 16 == 0 && w_rank_stride % V == 0;
  a.vec_f = w_aligned && F % V == 0;
  a.vec_d = w_aligned && D % V == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_gemm_a2a<__nv_bfloat16, __nv_bfloat16>(a, ranks_in_launch, st);
  if (dtype == 0 && wire == 0) return launch_gemm_a2a<float, float>(a, ranks_in_launch, st);
  if (dtype == 0 && wire == 1) return launch_gemm_a2a<float, __nv_bfloat16>(a, ranks_in_launch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// as the TPU kernel streams them.
//
// The dependency inside a group: y needs all F columns of u, which the TPU
// kernel carries across grid steps; CTAs carry nothing.  So one persistent
// cooperative launch works through units of two kinds:
//  * up/gate unit (group, F tile): the [C, tile] block of u = act(g) h,
//    stored at x's dtype in the scratch buffer u [n_dev, B, E, C, F]; then
//    the unit's flag is released.
//  * down unit (group, D tile): waits for the group's up/gate flags, then
//    computes the [C, tile] block of y.
// Units are dealt round-robin in a static order: groups in the step
// schedule's order (kernels/tile_pipeline.py step_schedule: remote
// destinations first, farthest first when comm-aware, rotated by `skew`,
// the rank's own destination last), and a group's down units after the next
// group's up/gate units, so a down unit seldom waits.  A wait is only ever
// for a unit earlier in the order, so with every CTA resident (grid sized
// from the occupancy, cooperative launch) no wait deadlocks.
//
// Two paths share that order and the protocol below; kernels/fused_gemm_a2a
// chooses (gemm_a2a_path):
//  * stream (every call TMA can read: D and F rows of a multiple of 16
//    bytes at 16-byte-aligned weights, C <= 8, x's slice within shared
//    memory): stream_gemv.cuh's ring, layout and x staging on units of
//    kStreamN = 128 columns, so a weight row gives 256 contiguous bytes.
//    An up/gate unit streams the same 128 columns of w_up and w_gate
//    through one ring into two accumulators, against x staged once.  K (D
//    for up/gate, F for down) is split over a thread-block cluster of
//    `splits` CTAs; each CTA's partial [R, 128] tiles are summed by the
//    cluster's leader (rank 0) through distributed shared memory in
//    cluster-rank order, so results are deterministic, and the leader's
//    epilogue forms act(g) h, or stores y.  The partials are handed over
//    with mbarriers (a `ready` barrier in the leader, a `freed` one in each
//    peer), not cluster barriers, so the producer warp never stops: it runs
//    ahead into the next unit's weights and the ring does not drain between
//    units.  Clusters are persistent and walk the order.  The resident
//    clusters (cudaOccupancyMaxActiveClusters) must fit in one group's
//    up/gate units, so a down unit's group was dealt a round earlier; of
//    such splits the one with the most resident CTAs is taken, so that two
//    CTAs share an SM where shared memory allows
//    (kernels/fused_gemm_a2a/plan.py computes the partition; the C side
//    sizes the grid from the same query).
//  * panel (the other shapes): tile_gemv.cuh's loop on 32-column items, x
//    staged in 512-deep panels; an up/gate item streams w_up, then w_gate.
//  * tile (bf16 at prefill and training rows, C > 8, D and F multiples of
//    8, 16-byte-aligned operands): tile_mma.cuh's tensor-core loop (TMA,
//    wgmma, f32 accumulators) in two launches on the stream.  The up/gate
//    launch's unit is a [128 rows, 64 columns] block of u: one pass over D
//    with w_gate's 64 columns in the tile's first half and w_up's same
//    columns in its second, so the epilogue holds g and h of each element
//    in one thread and stores u = act(g) h rounded to bf16.  The down
//    launch's unit is a [128 rows, 128 columns] block of y = u w_down[e],
//    stored into the destination's slot and, for a remote destination, its
//    flag (source, b, e, row block, D tile) released; then each CTA waits
//    for a share of the tiles the peers send here (a cooperative launch
//    where n_dev > 1).  The stream order between the launches carries the
//    up/gate -> down dependency, so the u flags of the other paths are not
//    needed.  The weights are read once per 128 capacity rows, where the
//    panel path reads them once per 8.
//
// The combine exchange is fused_dispatch_a2a.cu's protocol: a remote y tile
// is stored at the wire dtype straight into the destination's slot for this
// source (its rx staging when the wire is narrower than x), and the tile's
// flag (source, b, e, D tile) is released; after its own units each CTA
// waits for a share of the tiles the peers send here and, with a narrowed
// wire, widens them into the output.  At n_dev = 1 (the serving path) every
// group is local and only the up/gate -> down flags are used.
#include "stream_gemv.cuh"
#include "tile_gemv.cuh"
#include "tile_mma.cuh"

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

// ---------------------------------------------------------------------------
// the stream path
// ---------------------------------------------------------------------------
struct FfnArgs {
  const void* x;   // rank 0's xt [n_dev, B, E, C, D]; rank r's at x + r * x_rank_stride
  void* u;         // rank 0's [n_dev, B, E, C, F] scratch; rank r's at u + r * u_rank_stride
  long long x_rank_stride, u_rank_stride;  // in elements
  GemmA2APeers peers;
  const int* sched;  // [n_dev] step offsets
  int my_base, n_dev, B, E, C, D, F;
  int splits, ks_up, ks_down;  // CTAs per cluster; K rows per CTA of D (up/gate), of F (down)
  unsigned epoch;
  int act;
  bool use_rx;
};

// Dynamic shared memory: 128 bytes of alignment slack, the ring, its full
// and empty barriers, `ready` and `freed`, then per row of the row block the
// warps' partials and the CTA's two partial tiles, then x's [R][ks] slice
// (kernels/fused_gemm_a2a/plan.py mirrors it).
constexpr size_t kFfnFixedSmem = 128 + kStreamRingBytes + (2 * kStreamMaxStages + 2) * 8;

inline size_t ffn_smem_bytes(int rows_per_block, int ks) {
  return kFfnFixedSmem +
         sizeof(float) * (size_t)rows_per_block * ((kStreamConsumerWarps + 2) * kStreamN + ks);
}

template <typename T, int R>
struct FfnSmem {
  T* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* ready;  // the leader's: every peer's partial is in place (splits - 1 arrivals)
  uint64_t* freed;  // a peer's: the leader has read its partial (1 arrival)
  float* red;       // [kStreamConsumerWarps][R][kStreamN]
  float* part;      // [2][R][kStreamN]: the CTA's partial tiles, in the leader their sum
  float* xs;        // [R][ks]
};

template <typename T, int R>
__device__ __forceinline__ FfnSmem<T, R> ffn_smem(int splits) {
  using L = StreamLayout<T>;
  extern __shared__ uint8_t ffn_smem_raw[];
  const uint32_t raw = smem_addr(ffn_smem_raw);
  uint8_t* base = ffn_smem_raw + (128 - raw % 128) % 128;  // TMA wants 128-byte aligned boxes
  FfnSmem<T, R> s;
  s.ring = reinterpret_cast<T*>(base);
  s.full = reinterpret_cast<uint64_t*>(base + kStreamRingBytes);
  s.empty = s.full + kStreamMaxStages;
  s.ready = s.empty + kStreamMaxStages;
  s.freed = s.ready + 1;
  s.red = reinterpret_cast<float*>(s.freed + 1);
  s.part = s.red + kStreamConsumerWarps * R * kStreamN;
  s.xs = s.part + 2 * R * kStreamN;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kStreamConsumerWarps);
    }
    mbar_init(s.ready, splits > 1 ? splits - 1 : 1);
    mbar_init(s.freed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return s;
}

// Unit `it` of the static order: up(0) | up(1) down(0) | ... | up(G-1)
// down(G-2) | down(G-1), groups in the step schedule's order.
struct FfnUnit {
  bool up;
  int tile, off, dest, be, e, g;  // be = b * E + e; g: the group's index in x and u
};

__device__ __forceinline__ FfnUnit ffn_unit(const FfnArgs& a, int my, int it, int f_tiles,
                                            int d_tiles) {
  const int per = f_tiles + d_tiles, per_dest = a.B * a.E, groups = a.n_dev * per_dest;
  FfnUnit un;
  int k;
  if (it < f_tiles) {
    k = 0, un.tile = it, un.up = true;
  } else {
    const int j = (it - f_tiles) / per + 1, rem = (it - f_tiles) % per;
    un.up = j < groups && rem < f_tiles;
    k = un.up ? j : j - 1;
    un.tile = un.up ? rem : (j < groups ? rem - f_tiles : rem);
  }
  un.off = a.sched[k / per_dest];
  un.dest = (my + un.off) % a.n_dev;
  un.be = k % per_dest;
  un.e = un.be % a.E;
  un.g = un.dest * per_dest + un.be;
  return un;
}

// The consumers' share of one unit: n_st ring stages of each of M weight
// matrices (M = 2: w_up then w_gate, stage by stage; M = 1: w_down) against
// xs, reduced over the warps into sm.part[m] (this CTA's partial).  A peer
// CTA first waits until the leader has read its previous partial.
template <typename T, int R, int M>
__device__ __forceinline__ void ffn_consume(const FfnSmem<T, R>& sm, StreamRing& ring, int n_st,
                                            int ks, bool wait_freed, unsigned freed_parity) {
  using L = StreamLayout<T>;
  const int tid = threadIdx.x, cgp = tid % L::kColGroups, kl = tid / L::kColGroups;
  float acc[M][R][L::V] = {};
  for (int st = 0; st < n_st; ++st) {
    uint4 raw[M][L::kRowsPerLane];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mbar_wait(&sm.full[ring.stage], ring.phase);
      const T* s = sm.ring + ring.stage * L::kStageElems;
#pragma unroll
      for (int i = 0; i < L::kRowsPerLane; ++i)
        raw[m][i] = *reinterpret_cast<const uint4*>(s + (kl + i * L::kLanesK) * kStreamN + cgp * L::V);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&sm.empty[ring.stage]);  // the vectors are in registers
      ring.advance(L::kStages);
    }
#pragma unroll
    for (int i = 0; i < L::kRowsPerLane; ++i) {
      const int kk = st * kStreamStageRows + kl + i * L::kLanesK;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = sm.xs[r * ks + kk];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const T* e = reinterpret_cast<const T*>(&raw[m][i]);
#pragma unroll
          for (int j = 0; j < L::V; ++j) acc[m][r][j] = fmaf(xv, to_float(e[j]), acc[m][r][j]);
        }
      }
    }
  }
  // K lanes of one warp differ in the lane bits above the column group
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < L::V; ++j) {
        float v = acc[m][r][j];
#pragma unroll
        for (int o = L::kColGroups; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        acc[m][r][j] = v;
      }
  if (wait_freed) mbar_wait<true>(sm.freed, freed_parity);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (lane < L::kColGroups) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < L::V; ++j)
          sm.red[(warp * R + r) * kStreamN + cgp * L::V + j] = acc[m][r][j];
    }
    stream_consumer_sync();
    for (int i = tid; i < R * kStreamN; i += kStreamConsumers) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kStreamConsumerWarps; ++w) v += sm.red[w * R * kStreamN + i];
      sm.part[m * R * kStreamN + i] = v;
    }
    stream_consumer_sync();
  }
}

// One cluster of a.splits CTAs per unit at a time; cluster c of a rank walks
// units c, c + clusters, ...  Warp 8's first thread is the producer: it
// streams the weights of every unit the cluster takes, in order, without
// waiting for anything but free ring stages.  Warps 0-7 consume.
template <typename T, typename WT, int R>
__global__ void __launch_bounds__(kStreamThreads, R <= 2 ? 2 : 1)
    ffn_stream_kernel(const __grid_constant__ CUtensorMap up_map,
                      const __grid_constant__ CUtensorMap gate_map,
                      const __grid_constant__ CUtensorMap down_map, const FfnArgs a) {
  using L = StreamLayout<T>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const FfnSmem<T, R> sm = ffn_smem<T, R>(a.splits);
  cluster.sync();  // every CTA's barriers are initialised before a peer arrives on them
  const int split = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, rank = blockIdx.y, my = a.my_base + rank;
  const int C = a.C, D = a.D, F = a.F;
  const int f_tiles = (F + kStreamN - 1) / kStreamN, d_tiles = (D + kStreamN - 1) / kStreamN;
  const int per_dest = a.B * a.E, groups = a.n_dev * per_dest;
  const int units = groups * (f_tiles + d_tiles);
  const int clusters = gridDim.x / a.splits, cid = blockIdx.x / a.splits;

  if (tid >= kStreamConsumers) {
    if (tid == kStreamConsumers) {
      StreamRing ring;
      for (int it = cid; it < units; it += clusters) {
        const FfnUnit un = ffn_unit(a, my, it, f_tiles, d_tiles);
        const int K = un.up ? D : F, ks = un.up ? a.ks_up : a.ks_down;
        const int k0 = split * ks, kend = min(K, k0 + ks);
        const int n_st = kend > k0 ? (kend - k0 + kStreamStageRows - 1) / kStreamStageRows : 0;
        const int z = rank * a.E + un.e, col0 = un.tile * kStreamN;
        for (int st = 0; st < n_st; ++st)
          for (int m = 0; m < (un.up ? 2 : 1); ++m) {
            mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1u);
            mbar_expect_tx(&sm.full[ring.stage], L::kStageBytes);
            tma_load_3d(sm.ring + ring.stage * L::kStageElems,
                        !un.up ? &down_map : m == 0 ? &up_map : &gate_map, &sm.full[ring.stage],
                        col0, k0 + st * kStreamStageRows, z);
            ring.advance(L::kStages);
          }
      }
    }
    __syncwarp();
  } else {
    const T* x = static_cast<const T*>(a.x) + rank * a.x_rank_stride;
    T* u = static_cast<T*>(a.u) + rank * a.u_rank_stride;
    unsigned* my_flags = a.peers.flags[my];
    const size_t block = (size_t)per_dest * C * D;  // one destination's [B, E, C, D]
    StreamRing ring;
    int j = 0;  // units this cluster has done
    for (int it = cid; it < units; it += clusters, ++j) {
      const FfnUnit un = ffn_unit(a, my, it, f_tiles, d_tiles);
      const int K = un.up ? D : F, ks = un.up ? a.ks_up : a.ks_down;
      const int k0 = split * ks, kend = min(K, k0 + ks);
      const int n_st = kend > k0 ? (kend - k0 + kStreamStageRows - 1) / kStreamStageRows : 0;
      const int col0 = un.tile * kStreamN;
      if (!un.up && kend > k0) {
        // this CTA's rows of u: the group's up/gate units over [k0, kend)
        for (int i = k0 / kStreamN + tid; i <= (kend - 1) / kStreamN; i += kStreamConsumers)
          wait_flag(my_flags + (size_t)un.g * f_tiles + i, a.epoch);
        __threadfence();
      }
      stream_consumer_sync();
      if (un.up)
        stage_x<T, false>(sm.xs, x + (size_t)un.g * C * D, C, D, ks, k0, kend, 0, R);
      else
        stage_x<T, true>(sm.xs, u + (size_t)un.g * C * F, C, F, ks, k0, kend, 0, R);
      stream_consumer_sync();
      const bool wait_freed = split != 0 && j > 0;
      if (un.up)
        ffn_consume<T, R, 2>(sm, ring, n_st, ks, wait_freed, (j - 1) & 1);
      else
        ffn_consume<T, R, 1>(sm, ring, n_st, ks, wait_freed, (j - 1) & 1);
      if (a.splits > 1) {
        if (split != 0) {
          if (tid == 0) mbar_arrive_cluster(sm.ready, 0);  // this partial is in place
          continue;
        }
        // the leader: its own partial, then the peers' in cluster-rank order
        mbar_wait<true>(sm.ready, j & 1);
        for (int i = tid; i < (un.up ? 2 : 1) * R * kStreamN; i += kStreamConsumers) {
          float v = sm.part[i];
          for (int q = 1; q < a.splits; ++q) v += cluster.map_shared_rank(sm.part, q)[i];
          sm.part[i] = v;
        }
        stream_consumer_sync();
        if (tid > 0 && tid < a.splits) mbar_arrive_cluster(sm.freed, tid);
      }
      if (un.up) {
        // u = act(g) h, rounded to x's dtype as the TPU kernel rounds it
        T* ug = u + (size_t)un.g * C * F;
        for (int i = tid; i < R * kStreamN; i += kStreamConsumers) {
          const int row = i / kStreamN, col = col0 + i % kStreamN;
          if (row < C && col < F)
            ug[(size_t)row * F + col] =
                from_float<T>(activate(sm.part[R * kStreamN + i], a.act) * sm.part[i]);
        }
        stream_consumer_sync();
        if (tid == 0) {
          __threadfence();
          store_release(my_flags + (size_t)un.g * f_tiles + un.tile, a.epoch);
        }
        continue;
      }
      const size_t slot = my * block + (size_t)un.be * C * D;  // this source's [C, D] at the destination
      for (int i = tid; i < R * kStreamN; i += kStreamConsumers) {
        const int row = i / kStreamN, col = col0 + i % kStreamN;
        if (row < C && col < D) {
          const size_t o = slot + (size_t)row * D + col;
          if (un.off == 0)
            static_cast<T*>(a.peers.out[my])[o] = from_float<T>(sm.part[i]);
          else
            static_cast<WT*>(a.peers.recv[un.dest])[o] = from_float<WT>(sm.part[i]);
        }
      }
      if (un.off != 0) {
        stream_consumer_sync();
        if (tid == 0) {
          __threadfence_system();
          store_release(a.peers.flags[un.dest] + (size_t)groups * f_tiles +
                            ((size_t)my * per_dest + un.be) * d_tiles + un.tile,
                        a.epoch);
        }
      }
    }

    if (a.n_dev > 1) {
      // the y tiles every peer sends here
      const unsigned* recv_flags = my_flags + (size_t)groups * f_tiles;
      const int tiles_in = per_dest * d_tiles;
      for (int it = blockIdx.x; it < (a.n_dev - 1) * tiles_in; it += gridDim.x) {
        const int kk = it / tiles_in, rem = it % tiles_in;
        const int src = kk < my ? kk : kk + 1;
        const int be = rem / d_tiles, col0 = (rem % d_tiles) * kStreamN;
        if (tid == 0) wait_flag(recv_flags + (size_t)src * tiles_in + rem, a.epoch);
        __threadfence();
        stream_consumer_sync();
        if (a.use_rx) {
          const size_t slot = src * block + (size_t)be * C * D;
          for (int i = tid; i < C * kStreamN; i += kStreamConsumers) {
            const int row = i / kStreamN, col = col0 + i % kStreamN;
            if (col < D) {
              const size_t o = slot + (size_t)row * D + col;
              static_cast<T*>(a.peers.out[my])[o] =
                  from_float<T>(to_float(__ldcg(static_cast<const WT*>(a.peers.recv[my]) + o)));
            }
          }
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while the leader reads its partial or arrives on its barrier
}

template <typename T, typename WT>
static const void* ffn_stream_fn(int rows_per_block) {
  return stream_kernel_for_rows(rows_per_block, [](auto r) {
    return reinterpret_cast<const void*>(ffn_stream_kernel<T, WT, decltype(r)::value>);
  });
}

static const void* ffn_stream_kernel_for(int dtype, int wire, int rows_per_block) {
  return dtype == 1                ? ffn_stream_fn<__nv_bfloat16, __nv_bfloat16>(rows_per_block)
         : dtype == 0 && wire == 0 ? ffn_stream_fn<float, float>(rows_per_block)
         : dtype == 0 && wire == 1 ? ffn_stream_fn<float, __nv_bfloat16>(rows_per_block)
                                   : nullptr;
}

// A stream-path launch, built once per call signature: the three weight maps
// (encoded once: a layer's weights do not move), the constant arguments and
// the grid.  x, u, out, recv and the epoch are filled per call.
struct FfnPlan {
  CUtensorMap up_map, gate_map, down_map;
  FfnArgs args;
  const void* kernel;
  dim3 grid;
  size_t smem;
  size_t out_rank_bytes, recv_rank_bytes;  // rank r's out / recv at + r * these
};

// ---------------------------------------------------------------------------
// the tile path
// ---------------------------------------------------------------------------
constexpr int kTileUpN = kMmaHalfN;  // columns of u per up/gate unit (gate | up in one tile)

struct GemmA2ATileArgs {
  GemmA2APeers peers;
  __nv_bfloat16* u;  // rank 0's [n_dev, B, E, C, F] scratch; rank r's at + r * groups * C * F
  const int* sched;  // [n_dev] step offsets
  int my_base, n_dev, B, E, C, D, F;
  unsigned epoch;
  int act;
};

// The group (destination block, b, e) of step-ordered group k of rank `my`:
// its index in x and u, the destination's offset, and the expert.
struct TileGroup {
  int g, off, dest, be, e;
};

__device__ __forceinline__ TileGroup tile_group(const GemmA2ATileArgs& a, int my, int k) {
  const int per_dest = a.B * a.E;
  const int off = a.sched[k / per_dest];
  const int dest = (my + off) % a.n_dev;
  const int be = k % per_dest;
  return TileGroup{dest * per_dest + be, off, dest, be, be % a.E};
}

// Unit u of a rank: group (in the step schedule's order) u / (row_blocks *
// f_tiles), then F tile, then row block, so that consecutive units share a
// weight panel.
__global__ void __launch_bounds__(kMmaThreads)
    ffn_tile_up_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap gate_map,
                       const __grid_constant__ CUtensorMap up_map, GemmA2ATileArgs a) {
  const int my = a.my_base + blockIdx.y;
  const int row_blocks = (a.C + kMmaBM - 1) / kMmaBM;
  const int f_tiles = (a.F + kTileUpN - 1) / kTileUpN;
  const int groups = a.n_dev * a.B * a.E;
  const int per_group = row_blocks * f_tiles;
  __nv_bfloat16* u = a.u + (size_t)blockIdx.y * groups * a.C * a.F;
  auto coords = [&](int unit) {
    const TileGroup tg = tile_group(a, my, unit / per_group);
    const int rem = unit % per_group;
    TileCoord tc{static_cast<int>(blockIdx.y) * groups + tg.g, (rem % row_blocks) * kMmaBM,
                 (rem / row_blocks) * kTileUpN};
    tc.wrank = static_cast<int>(blockIdx.y) * a.E + tg.e;
    return tc;
  };
  auto epilogue = [&](int unit, TileCoord tc, float(&acc)[kMmaAccs], int wg, int t) {
    const int g = tc.rank - static_cast<int>(blockIdx.y) * groups;
    __nv_bfloat16* ug = u + (size_t)g * a.C * a.F;
    const int warp = t / 32, lane = t % 32;
    const int r = tc.row0 + wg * 64 + warp * 16 + lane / 4;
    const int c = tc.col0 + (lane % 4) * 2;
    // accumulator groups 0-7 hold g = x w_gate, 8-15 h = x w_up at the same columns
#pragma unroll
    for (int j = 0; j < kTileUpN / 8; ++j) {
      const int col = c + j * 8;
      const float* gj = acc + 4 * j;
      const float* hj = acc + 4 * (j + kTileUpN / 8);
      if (col < a.F) {
        if (r < a.C)
          store_pair(ug + (size_t)r * a.F + col, activate(gj[0], a.act) * hj[0],
                     activate(gj[1], a.act) * hj[1]);
        if (r + 8 < a.C)
          store_pair(ug + (size_t)(r + 8) * a.F + col, activate(gj[2], a.act) * hj[2],
                     activate(gj[3], a.act) * hj[3]);
      }
    }
  };
  mma_tile_loop(&xmap, &gate_map, (a.D + kMmaBK - 1) / kMmaBK, groups * per_group, coords,
                epilogue, &up_map);
}

__global__ void __launch_bounds__(kMmaThreads)
    ffn_tile_down_kernel(const __grid_constant__ CUtensorMap umap,
                         const __grid_constant__ CUtensorMap down_map, GemmA2ATileArgs a) {
  const int my = a.my_base + blockIdx.y;
  const int row_blocks = (a.C + kMmaBM - 1) / kMmaBM;
  const int d_tiles = (a.D + kMmaBN - 1) / kMmaBN;
  const int per_dest = a.B * a.E;
  const int groups = a.n_dev * per_dest;
  const int per_group = row_blocks * d_tiles;
  const size_t block = (size_t)per_dest * a.C * a.D;  // one destination's [B, E, C, D]
  auto coords = [&](int unit) {
    const TileGroup tg = tile_group(a, my, unit / per_group);
    const int rem = unit % per_group;
    TileCoord tc{static_cast<int>(blockIdx.y) * groups + tg.g, (rem % row_blocks) * kMmaBM,
                 (rem / row_blocks) * kMmaBN};
    tc.wrank = static_cast<int>(blockIdx.y) * a.E + tg.e;
    return tc;
  };
  auto epilogue = [&](int unit, TileCoord tc, float(&acc)[kMmaAccs], int wg, int t) {
    const TileGroup tg = tile_group(a, my, unit / per_group);
    // this source's [C, D] block in the destination's output
    __nv_bfloat16* slot = static_cast<__nv_bfloat16*>(a.peers.out[tg.dest]) + my * block +
                          (size_t)tg.be * a.C * a.D;
    for_each_acc_pair(acc, wg, t, [&](int r, int c, float& v0, float& v1) {
      const int row = tc.row0 + r, col = tc.col0 + c;
      if (row < a.C && col < a.D) store_pair(slot + (size_t)row * a.D + col, v0, v1);
    });
    if (tg.off != 0) {
      consumer_sync();
      if (t == 0 && wg == 0) {
        __threadfence_system();
        const int rb = tc.row0 / kMmaBM, tile = tc.col0 / kMmaBN;
        store_release(a.peers.flags[tg.dest] +
                          (((size_t)my * per_dest + tg.be) * row_blocks + rb) * d_tiles + tile,
                      a.epoch);
      }
    }
  };
  mma_tile_loop(&umap, &down_map, (a.F + kMmaBK - 1) / kMmaBK, groups * per_group, coords,
                epilogue);
  if (a.n_dev == 1 || threadIdx.x >= kMmaConsumerThreads) return;
  // the y tiles every peer sends here
  const unsigned* my_flags = a.peers.flags[my];
  const size_t per_src = (size_t)per_dest * per_group;
  for (size_t i = (size_t)blockIdx.x * kMmaConsumerThreads + threadIdx.x;
       i < (size_t)a.n_dev * per_src; i += (size_t)gridDim.x * kMmaConsumerThreads) {
    if (static_cast<int>(i / per_src) != my) wait_flag(my_flags + i, a.epoch);
  }
}

static cudaError_t allow_tile_smem() {
  static cudaError_t err = [] {
    cudaError_t e = allow_mma_smem(ffn_tile_up_kernel);
    return e == cudaSuccess ? allow_mma_smem(ffn_tile_down_kernel) : e;
  }();
  return err;
}

}  // namespace repro_torch

// The panel path.  x, w_up, w_gate, w_down, u: rank 0's operands and scratch (rank r's at
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

// The stream path's launch plan for rank-stacked weights w_up, w_gate
// [ranks_in_launch, E, D, F] and w_down [ranks_in_launch, E, F, D] (16-byte
// aligned; D and F times the element size multiples of 16), C <= rows_per_block
// rows a group (1, 2, 4 or 8), K split into `splits` CTAs of ks_up rows of D
// and ks_down rows of F (multiples of 32), as kernels/fused_gemm_a2a/plan.py
// computes them.  flag_ptrs: host array of n_dev device pointers to
// n_dev * B * E * (ceil(F / 128) + ceil(D / 128)) flag words each; sched:
// device int32 [n_dev] step offsets; act, dtype and wire as in
// repro_fused_gemm_a2a.  The grid holds as many clusters per rank as the card
// keeps resident (cudaOccupancyMaxActiveClusters), at most one per unit.
// Writes a handle for repro_gemm_a2a_stream_launch (free it with
// repro_gemm_a2a_stream_plan_free).  Returns a cudaError_t code (0 = built).
extern "C" int repro_gemm_a2a_stream_plan(void** plan, const void* w_up, const void* w_gate,
                                          const void* w_down, const uint64_t* flag_ptrs,
                                          const void* sched, int my_base, int ranks_in_launch,
                                          int n_dev, int B, int E, int C, int D, int F,
                                          int rows_per_block, int splits, int ks_up, int ks_down,
                                          int act, int dtype, int wire) {
  using namespace repro_torch;
  *plan = nullptr;
  const void* kernel = ffn_stream_kernel_for(dtype, wire, rows_per_block);
  const int eb = dtype == 0 ? 4 : 2;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (kernel == nullptr || n_dev < 1 || n_dev > kMaxDev || B <= 0 || E <= 0 || C <= 0 ||
      C > rows_per_block || D <= 0 || F <= 0 || act < 0 || act > 2 ||
      (ranks_in_launch != 1 && ranks_in_launch != n_dev) || splits < 1 ||
      splits > kStreamMaxSplits || ks_up % kStreamStageRows != 0 ||
      ks_down % kStreamStageRows != 0 || (long long)splits * ks_up < D ||
      (long long)splits * ks_down < F || (D * eb) % 16 != 0 || (F * eb) % 16 != 0 ||
      !aligned(w_up) || !aligned(w_gate) || !aligned(w_down))
    return static_cast<int>(cudaErrorInvalidValue);
  FfnPlan* p = new FfnPlan{};
  FfnArgs& a = p->args;
  for (int d = 0; d < n_dev; ++d) a.peers.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
  a.sched = static_cast<const int*>(sched);
  a.my_base = my_base;
  a.n_dev = n_dev;
  a.B = B;
  a.E = E;
  a.C = C;
  a.D = D;
  a.F = F;
  a.splits = splits;
  a.ks_up = ks_up;
  a.ks_down = ks_down;
  a.act = act;
  a.use_rx = dtype == 0 && wire == 1;
  const long long per_rank = (long long)n_dev * B * E * C;  // rows of x (and y) per rank
  a.x_rank_stride = per_rank * D;
  a.u_rank_stride = per_rank * F;
  p->out_rank_bytes = per_rank * D * eb;
  p->recv_rank_bytes = per_rank * D * (a.use_rx ? 2 : eb);
  p->kernel = kernel;
  p->smem = ffn_smem_bytes(rows_per_block, ks_up > ks_down ? ks_up : ks_down);
  const uint64_t depth = (uint64_t)ranks_in_launch * E;
  cudaError_t err = p->smem > kStreamSmemLimit ? cudaErrorInvalidValue : cudaSuccess;
  if (err == cudaSuccess) err = make_stream_map(&p->up_map, w_up, eb, F, D, depth);
  if (err == cudaSuccess) err = make_stream_map(&p->gate_map, w_gate, eb, F, D, depth);
  if (err == cudaSuccess) err = make_stream_map(&p->down_map, w_down, eb, D, F, depth);
  int clusters = 0;
  if (err == cudaSuccess) err = stream_max_clusters(kernel, splits, p->smem, &clusters);
  const int resident = clusters / ranks_in_launch;
  if (err == cudaSuccess && resident < 1) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) {
    delete p;
    return static_cast<int>(err);
  }
  const int units = n_dev * B * E * ((F + kStreamN - 1) / kStreamN + (D + kStreamN - 1) / kStreamN);
  p->grid = dim3((units < resident ? units : resident) * splits, ranks_in_launch);
  *plan = p;
  return 0;
}

// The clusters of `splits` CTAs of the stream path, each with x slices of ks
// rows, that the card holds at once (kernels/fused_gemm_a2a/plan.py sizes
// the split with it); dtype, wire and rows_per_block as in the plan.
// Returns a cudaError_t code (0 = answered).
extern "C" int repro_gemm_a2a_stream_capacity(int dtype, int wire, int rows_per_block, int splits,
                                              int ks, int* clusters) {
  using namespace repro_torch;
  const void* kernel = ffn_stream_kernel_for(dtype, wire, rows_per_block);
  if (kernel == nullptr || splits < 1 || splits > kStreamMaxSplits || ks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      stream_max_clusters(kernel, splits, ffn_smem_bytes(rows_per_block, ks), clusters));
}

// Launches a stream plan: x as in repro_fused_gemm_a2a, u the rank-stacked
// [n_dev, B, E, C, F] scratch, out the rank-stacked output, recv the rx
// staging of a narrowed wire (else out).  Returns a cudaError_t code
// (0 = launched).
extern "C" int repro_gemm_a2a_stream_launch(const void* plan, const void* x, void* u, void* out,
                                            void* recv, unsigned epoch, void* stream) {
  using namespace repro_torch;
  const FfnPlan* p = static_cast<const FfnPlan*>(plan);
  FfnArgs a = p->args;
  a.x = x;
  a.u = u;
  a.epoch = epoch;
  for (int d = 0; d < a.n_dev; ++d) {
    a.peers.out[d] = static_cast<char*>(out) + d * p->out_rank_bytes;
    a.peers.recv[d] = static_cast<char*>(recv) + d * p->recv_rank_bytes;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  stream_launch_config(p->grid, p->smem, a.splits, true, static_cast<cudaStream_t>(stream), attrs,
                       &cfg);
  void* args[] = {const_cast<CUtensorMap*>(&p->up_map), const_cast<CUtensorMap*>(&p->gate_map),
                  const_cast<CUtensorMap*>(&p->down_map), &a};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, p->kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" void repro_gemm_a2a_stream_plan_free(void* plan) {
  delete static_cast<repro_torch::FfnPlan*>(plan);
}

// The tile path (bf16; kernels/fused_gemm_a2a takes it for C > 8).  x: the
// rank-stacked [ranks_in_launch, n_dev, B, E, C, D]; w_up, w_gate
// [ranks_in_launch, E, D, F], w_down [ranks_in_launch, E, F, D]; u the
// rank-stacked [ranks_in_launch, n_dev, B, E, C, F] scratch; out_ptrs and
// flag_ptrs host arrays of n_dev device pointers (each rank's output by
// source, and n_dev * B * E * ceil(C / 128) * ceil(D / 128) flag words);
// sched the device int32 [n_dev] step offsets; act as in
// repro_fused_gemm_a2a.  D and F must be multiples of 8 and every operand
// 16-byte aligned (TMA).  Two launches on `stream`: the up/gate units, then
// the down units.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_gemm_a2a_tile(const void* x, const void* w_up, const void* w_gate,
                                   const void* w_down, void* u, const uint64_t* out_ptrs,
                                   const uint64_t* flag_ptrs, const void* sched, int my_base,
                                   int ranks_in_launch, int n_dev, int B, int E, int C, int D,
                                   int F, unsigned epoch, int act, void* stream) {
  using namespace repro_torch;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n_dev < 1 || n_dev > kMaxDev || B <= 0 || E <= 0 || C <= 0 || D <= 0 || F <= 0 ||
      D % 8 != 0 || F % 8 != 0 || act < 0 || act > 2 ||
      (ranks_in_launch != 1 && ranks_in_launch != n_dev) || !aligned(x) || !aligned(w_up) ||
      !aligned(w_gate) || !aligned(w_down) || !aligned(u))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmA2ATileArgs a = {};
  for (int d = 0; d < n_dev; ++d) {
    a.peers.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    a.peers.recv[d] = a.peers.out[d];
    a.peers.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
  }
  a.u = static_cast<__nv_bfloat16*>(u);
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
  const int groups = n_dev * B * E;
  const int depth_x = ranks_in_launch * groups, depth_w = ranks_in_launch * E;
  CUtensorMap xmap, gate_map, up_map, umap, down_map;
  cudaError_t err = allow_tile_smem();
  if (err == cudaSuccess) err = make_tile_map(&xmap, x, D, C, depth_x, kMmaBK, kMmaBM);
  if (err == cudaSuccess) err = make_tile_map(&gate_map, w_gate, F, D, depth_w, kMmaHalfN, kMmaBK);
  if (err == cudaSuccess) err = make_tile_map(&up_map, w_up, F, D, depth_w, kMmaHalfN, kMmaBK);
  if (err == cudaSuccess) err = make_tile_map(&umap, u, F, C, depth_x, kMmaBK, kMmaBM);
  if (err == cudaSuccess) err = make_tile_map(&down_map, w_down, D, F, depth_w, kMmaHalfN, kMmaBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_blocks = (C + kMmaBM - 1) / kMmaBM;
  const long long up_units = (long long)groups * row_blocks * ((F + kTileUpN - 1) / kTileUpN);
  const long long down_units = (long long)groups * row_blocks * ((D + kMmaBN - 1) / kMmaBN);
  if (up_units > INT32_MAX || down_units > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  ffn_tile_up_kernel<<<dim3(static_cast<unsigned>(up_units), ranks_in_launch), kMmaThreads,
                       kMmaSmemBytes, st>>>(xmap, gate_map, up_map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_dev == 1) {
    ffn_tile_down_kernel<<<dim3(static_cast<unsigned>(down_units), ranks_in_launch), kMmaThreads,
                           kMmaSmemBytes, st>>>(umap, down_map, a);
    return static_cast<int>(cudaGetLastError());
  }
  // CTAs wait on flags set by other CTAs: all of them must be resident
  int per_rank = 0;
  err = resident_ctas(ffn_tile_down_kernel, kMmaThreads, ranks_in_launch, &per_rank,
                      kMmaSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_rank < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(down_units < per_rank ? static_cast<unsigned>(down_units) : per_rank,
                  ranks_in_launch);
  void* args[] = {(void*)&umap, (void*)&down_map, (void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)ffn_tile_down_kernel, grid, dim3(kMmaThreads),
                                    args, kMmaSmemBytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

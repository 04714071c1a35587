// Device-initiated fused embedding pooling + All-to-All for Hopper (paper
// Sec. III-A, Fig. 6: DLRM's embedding + All-to-All).
//
// Replaces the TPU kernel src/repro/kernels/fused_embedding_a2a/kernel.py:33
// (_kernel, entry fused_embedding_a2a_pallas at :102).  Every rank holds
// T_loc tables [T_loc, V, D] and the indices of the global batch on them,
// idx [B, T_loc, L] int32; rank d ends with out_d [B / n, n * T_loc, D]:
// its batch fragment of every rank's pooled tables, source s's at columns
// [s * T_loc, (s + 1) * T_loc).
//
// What it computes, in the TPU kernel's order (not its grid):
//  * The destinations in communication-aware order, dest = (my + off) % n
//    with off = n - 1 - i (farthest first, own fragment last) or off = i.
//    Each destination's fragment is its B / n batch rows of all local
//    tables, cut into units of eight bags; a unit's bags are pooled one a
//    warp by embedding_bag.cuh's code, the same as embedding_pool.cu's, so
//    the bits are the same, and stored straight into the destination's
//    output at this source's columns.  Units are numbered in schedule
//    order, a remote fragment's before the own fragment's.
//  * A fragment is done when its last unit is.  Each finished unit counts
//    itself on a per-fragment ticket; the CTA that takes the last ticket
//    publishes the destination's flag for this source with the call's
//    epoch (release at system scope: the paper's WG_Done / sliceRdy).
//  * The taker of the rank's last unit, found by a second ticket, waits
//    for the n - 1 flags of the fragments the other ranks send here.  It
//    has no work left, and only that one CTA per rank ever waits, on CTAs
//    that never wait, so the grid needs no co-residency and no cooperative
//    launch.
//  * Tickets reset themselves: the last taker writes 0 back, after every
//    unit of the call has counted.  Flags never reset (epochs).
// At n = 1 (the one-card path) there are no flags and no tickets: the
// kernel is embedding_pool.cu's pooling with the output columns offset.
//
// Two paths, as embedding_pool.cu's (kernels/embedding_pool/plan.py picks
// one): the ring path (persistent CTAs walk the units in schedule order,
// rows through shared memory; a CTA syncs after each unit only when n > 1)
// and the warp path (one CTA a unit).  Both come without the protocol at
// n = 1 (kPeers), so that its registers cost the one-card kernel none of
// the pooling kernel's occupancy; with it the warp path is bounded to the
// pooling kernel's three CTAs an SM (it would take two).
//
// What bounds it: the same bytes as embedding_pool.cu, the random row
// gathers; the flags are a few words per fragment.
#include "embedding_bag.cuh"

namespace repro_torch {

struct EmbA2AArgs {
  const void* tables;        // rank 0's [T_loc, V, D]; rank r's at + r * tables_rank_stride
  long long tables_rank_stride, V;  // in elements; rows per table
  const int* idx;            // rank 0's [B, T_loc, L]; rank r's at + r * idx_rank_stride
  long long idx_rank_stride;
  void* out[kMaxDev];        // each rank's [B / n, n * T_loc, D]
  unsigned* flags[kMaxDev];  // each rank's [n] flag words, one per source
  unsigned* tickets;         // [ranks_in_launch, n + 1]: per destination, then the rank's
  int my_base, n_dev, B_loc, T_loc, L, D, units_per_frag;
  unsigned epoch;
  bool comm_aware, vec;
};

// Unit u of a rank: step u / units_per_frag of the schedule, whose
// destination is (my + off) % n.
__device__ __forceinline__ int unit_dest(const EmbA2AArgs& a, int my, int unit, int* off) {
  const int step = unit / a.units_per_frag;
  *off = a.comm_aware ? a.n_dev - 1 - step : step;
  return (my + *off) % a.n_dev;
}

// The units of rank ry (blockIdx.y): each holds eight bags of one
// destination's fragment, table major (s = t * B_loc + b), as PoolMap's.
template <typename T>
struct A2AMap {
  const EmbA2AArgs& a;
  int ry, my, units;

  __device__ __forceinline__ bool bag(int unit, int w, BagRef<T>& r) const {
    int off;
    const int dest = unit_dest(a, my, unit, &off);
    const int s = (unit % a.units_per_frag) * kBagWarps + w;
    if (s >= a.B_loc * a.T_loc) return false;
    const int t = s / a.B_loc, b = s - t * a.B_loc;
    r.table = static_cast<const T*>(a.tables) + ry * a.tables_rank_stride + (size_t)t * a.V * a.D;
    r.idx = a.idx + ry * a.idx_rank_stride + ((size_t)(dest * a.B_loc + b) * a.T_loc + t) * a.L;
    r.out = static_cast<T*>(a.out[dest]) +
            ((size_t)b * a.n_dev * a.T_loc + (size_t)my * a.T_loc + t) * a.D;
    return true;
  }
};

// The protocol after one unit of rank ry, by thread 0 once the CTA's bags
// of it are stored (n > 1 only).
__device__ __forceinline__ void unit_done(const EmbA2AArgs& a, int ry, int my, int unit) {
  int off;
  const int dest = unit_dest(a, my, unit, &off);
  unsigned* tk = a.tickets + (size_t)ry * (a.n_dev + 1);
  __threadfence_system();
  if (off != 0 && atomicAdd(tk + dest, 1u) == (unsigned)a.units_per_frag - 1) {
    tk[dest] = 0;
    __threadfence_system();  // every unit of the fragment fenced before its ticket
    store_release(a.flags[dest] + my, a.epoch);
  }
  if (atomicAdd(tk + a.n_dev, 1u) == (unsigned)(a.n_dev * a.units_per_frag) - 1) {
    tk[a.n_dev] = 0;
    for (int s = 0; s < a.n_dev; ++s)
      if (s != my) wait_flag(a.flags[my] + s, a.epoch);
  }
}

// The warp path: CTA x of rank y is unit x.  kPeers (n > 1) adds the
// protocol after the CTA's bags, and with it the registers that keep the
// kernel at two CTAs an SM unless it is bounded to three; at n = 1 the
// kernel is the pooling kernel's loop over the same units.
template <typename T, bool kPeers>
__global__ void __launch_bounds__(kBagThreads, 3)
    fused_embedding_a2a_kernel(const __grid_constant__ EmbA2AArgs a) {
  const int ry = blockIdx.y, my = a.my_base + ry;
  {
    const A2AMap<T> m{a, ry, my, a.n_dev * a.units_per_frag};
    BagRef<T> r;
    if (m.bag(blockIdx.x, threadIdx.x / 32, r)) pool_bag(r.table, r.idx, a.L, a.D, r.out, a.vec);
  }
  if constexpr (kPeers) {
    __syncthreads();  // the CTA's bags are stored
    if (threadIdx.x == 0) unit_done(a, ry, my, blockIdx.x);
  }
}

// The ring path: gridDim.x persistent CTAs a rank walk its units.
template <typename T, bool kPeers>
__global__ void __launch_bounds__(kBagThreads)
    fused_embedding_a2a_ring_kernel(const __grid_constant__ EmbA2AArgs a, int slots) {
  const int ry = blockIdx.y, my = a.my_base + ry;
  const A2AMap<T> m{a, ry, my, a.n_dev * a.units_per_frag};
  ring_pool<T>(m, a.L, a.D, slots, [&](int unit) {
    if constexpr (kPeers) {
      __syncthreads();  // the CTA's bags of the unit are stored
      if (threadIdx.x == 0) unit_done(a, ry, my, unit);
    }
  });
}

template <typename T>
static const void* a2a_kernel_for(bool ring, bool peers) {
  if (ring)
    return peers ? reinterpret_cast<const void*>(fused_embedding_a2a_ring_kernel<T, true>)
                 : reinterpret_cast<const void*>(fused_embedding_a2a_ring_kernel<T, false>);
  return peers ? reinterpret_cast<const void*>(fused_embedding_a2a_kernel<T, true>)
               : reinterpret_cast<const void*>(fused_embedding_a2a_kernel<T, false>);
}

template <typename T>
static int launch_emb_a2a(const EmbA2AArgs& a, int ranks_in_launch, int slots, int grid,
                          cudaStream_t stream) {
  const long long units = (long long)a.n_dev * a.units_per_frag;
  if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool peers = a.n_dev > 1;
  if (slots == 0) {
    const dim3 blocks((unsigned)units, ranks_in_launch);
    if (peers)
      fused_embedding_a2a_kernel<T, true><<<blocks, kBagThreads, 0, stream>>>(a);
    else
      fused_embedding_a2a_kernel<T, false><<<blocks, kBagThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  bool fits = grid >= 1;
  for (int d = 0; d < a.n_dev; ++d)
    fits = fits && ring_fits(a.D, sizeof(T) == 2 ? 1 : 0, slots, (long long)a.B_loc * a.T_loc,
                             a.tables, a.out[d]);
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_ring_smem(a2a_kernel_for<T>(true, peers));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 ctas(grid, ranks_in_launch);
  const size_t smem = ring_smem_bytes(slots, a.D * sizeof(T));
  if (peers)
    fused_embedding_a2a_ring_kernel<T, true><<<ctas, kBagThreads, smem, stream>>>(a, slots);
  else
    fused_embedding_a2a_ring_kernel<T, false><<<ctas, kBagThreads, smem, stream>>>(a, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// tables: rank 0's [T_loc, V, D] (rank r's at tables + r * tables_rank_stride,
// in elements); idx: rank 0's [B, T_loc, L] int32 (likewise); out_ptrs and
// flag_ptrs: host arrays of n_dev device pointers (flag_ptrs unused when
// n_dev = 1); tickets: a zeroed int32 [ranks_in_launch, n_dev + 1] buffer
// (unused when n_dev = 1).  ranks_in_launch is n_dev for an emulated world
// (gridDim.y) and 1 when each rank launches its own kernel.  dtype: 0 =
// float32, 1 = bfloat16.  slots = 0: the warp path; else the ring path with
// `slots` row slots a warp and `grid` persistent CTAs a rank
// (kernels/embedding_pool/plan.py sizes them).  Returns a cudaError_t code
// (0 = launched).
extern "C" int repro_fused_embedding_a2a(const void* tables, long long tables_rank_stride,
                                         long long V, const void* idx,
                                         long long idx_rank_stride, const uint64_t* out_ptrs,
                                         const uint64_t* flag_ptrs, void* tickets, int my_base,
                                         int ranks_in_launch, int n_dev, int B_loc, int T_loc,
                                         int L, int D, unsigned epoch, int comm_aware, int dtype,
                                         int slots, int grid, void* stream) {
  using namespace repro_torch;
  if (n_dev < 1 || n_dev > kMaxDev || B_loc <= 0 || T_loc <= 0 || L <= 0 || D <= 0 || V <= 0 ||
      (ranks_in_launch != 1 && ranks_in_launch != n_dev) || (dtype != 0 && dtype != 1) ||
      (n_dev > 1 && tickets == nullptr) || (long long)B_loc * T_loc > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  EmbA2AArgs a = {};
  a.tables = tables;
  a.tables_rank_stride = tables_rank_stride;
  a.V = V;
  a.idx = static_cast<const int*>(idx);
  a.idx_rank_stride = idx_rank_stride;
  bool aligned = D * dtype_bytes(dtype) % 16 == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0;
  for (int d = 0; d < n_dev; ++d) {
    a.out[d] = reinterpret_cast<void*>(out_ptrs[d]);
    a.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
    aligned = aligned && out_ptrs[d] % 16 == 0;
  }
  a.tickets = static_cast<unsigned*>(tickets);
  a.my_base = my_base;
  a.n_dev = n_dev;
  a.B_loc = B_loc;
  a.T_loc = T_loc;
  a.L = L;
  a.D = D;
  a.units_per_frag = (B_loc * T_loc + kBagWarps - 1) / kBagWarps;
  a.epoch = epoch;
  a.comm_aware = comm_aware != 0;
  a.vec = aligned;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_emb_a2a<float>(a, ranks_in_launch, slots, grid, st);
  return launch_emb_a2a<__nv_bfloat16>(a, ranks_in_launch, slots, grid, st);
}

// Registers per thread and CTAs resident on an SM of the kernel of a path
// (ring = 0: the warp path; else the ring path at `smem` bytes of dynamic
// shared memory) for dtype, with the peer protocol (peers != 0, n > 1) or
// without (n = 1).  Returns a cudaError_t code (0 = answered).
extern "C" int repro_fused_embedding_a2a_info(int ring, int dtype, int smem, int peers, int* regs,
                                              int* ctas) {
  using namespace repro_torch;
  if ((dtype != 0 && dtype != 1) || smem < 0 || (ring != 0) != (smem > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* k = dtype == 0 ? a2a_kernel_for<float>(ring != 0, peers != 0)
                             : a2a_kernel_for<__nv_bfloat16>(ring != 0, peers != 0);
  return bag_kernel_info(k, smem, regs, ctas);
}

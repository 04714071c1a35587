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
//    tables; a CTA pools eight of its bags (one warp each, the same
//    pool_bag as embedding_pool.cu, so the bits are the same) and stores
//    them straight into the destination's output at this source's columns.
//    CTAs are numbered in schedule order, so the hardware issues a remote
//    fragment's CTAs before the own fragment's.
//  * A fragment is done when its last CTA finishes.  Each CTA counts
//    itself on a per-fragment ticket; the CTA that takes the last ticket
//    publishes the destination's flag for this source with the call's
//    epoch (release at system scope: the paper's WG_Done / sliceRdy).
//  * The rank's last CTA, found by a second ticket, waits for the n - 1
//    flags of the fragments the other ranks send here.  Only that one CTA
//    per rank ever waits, and only on CTAs that never wait, so the grid
//    needs no co-residency and no cooperative launch.
//  * Tickets reset themselves: the last taker writes 0 back, after every
//    CTA of the call has counted.  Flags never reset (epochs).
// At n = 1 (the one-card path) there are no flags and no tickets: the
// kernel is embedding_pool.cu's pooling with the output columns offset.
//
// What bounds it: the same bytes as embedding_pool.cu, the random row
// gathers; the flags are a few words per fragment.
#include <limits.h>

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
  int my_base, n_dev, B_loc, T_loc, L, D, blocks_per_frag;
  unsigned epoch;
  bool comm_aware, vec;
};

template <typename T>
__global__ void __launch_bounds__(kBagThreads) fused_embedding_a2a_kernel(EmbA2AArgs a) {
  const int ry = blockIdx.y, my = a.my_base + ry;
  const int step = blockIdx.x / a.blocks_per_frag;
  const int off = a.comm_aware ? a.n_dev - 1 - step : step;
  const int dest = (my + off) % a.n_dev;
  const int bag = (blockIdx.x % a.blocks_per_frag) * kBagWarps + threadIdx.x / 32;
  if (bag < a.B_loc * a.T_loc) {
    const int b = bag / a.T_loc, t = bag % a.T_loc;
    const T* tab = static_cast<const T*>(a.tables) + ry * a.tables_rank_stride + (size_t)t * a.V * a.D;
    const int* ix = a.idx + ry * a.idx_rank_stride +
                    ((size_t)(dest * a.B_loc + b) * a.T_loc + t) * a.L;
    T* o = static_cast<T*>(a.out[dest]) +
           ((size_t)b * a.n_dev * a.T_loc + (size_t)my * a.T_loc + t) * a.D;
    pool_bag(tab, ix, a.L, a.D, o, a.vec);
  }
  if (a.n_dev == 1) return;
  __syncthreads();  // the CTA's bags are stored
  if (threadIdx.x != 0) return;
  unsigned* tk = a.tickets + (size_t)ry * (a.n_dev + 1);
  __threadfence_system();
  if (off != 0 && atomicAdd(tk + dest, 1u) == (unsigned)a.blocks_per_frag - 1) {
    tk[dest] = 0;
    __threadfence_system();  // every CTA of the fragment fenced before its ticket
    store_release(a.flags[dest] + my, a.epoch);
  }
  if (atomicAdd(tk + a.n_dev, 1u) == gridDim.x - 1) {
    tk[a.n_dev] = 0;
    for (int s = 0; s < a.n_dev; ++s)
      if (s != my) wait_flag(a.flags[my] + s, a.epoch);
  }
}

template <typename T>
static int launch_emb_a2a(const EmbA2AArgs& a, int ranks_in_launch, cudaStream_t stream) {
  const long long blocks = (long long)a.n_dev * a.blocks_per_frag;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fused_embedding_a2a_kernel<T>
      <<<dim3((unsigned)blocks, ranks_in_launch), kBagThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// tables: rank 0's [T_loc, V, D] (rank r's at tables + r * tables_rank_stride,
// in elements); idx: rank 0's [B, T_loc, L] int32 (likewise); out_ptrs and
// flag_ptrs: host arrays of n_dev device pointers (flag_ptrs unused when
// n_dev = 1); tickets: a zeroed int32 [ranks_in_launch, n_dev + 1] buffer
// (unused when n_dev = 1).  ranks_in_launch is n_dev for an emulated world
// (gridDim.y) and 1 when each rank launches its own kernel.  dtype: 0 =
// float32, 1 = bfloat16.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_fused_embedding_a2a(const void* tables, long long tables_rank_stride,
                                         long long V, const void* idx,
                                         long long idx_rank_stride, const uint64_t* out_ptrs,
                                         const uint64_t* flag_ptrs, void* tickets, int my_base,
                                         int ranks_in_launch, int n_dev, int B_loc, int T_loc,
                                         int L, int D, unsigned epoch, int comm_aware, int dtype,
                                         void* stream) {
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
  a.blocks_per_frag = (B_loc * T_loc + kBagWarps - 1) / kBagWarps;
  a.epoch = epoch;
  a.comm_aware = comm_aware != 0;
  a.vec = aligned;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_emb_a2a<float>(a, ranks_in_launch, st);
  return launch_emb_a2a<__nv_bfloat16>(a, ranks_in_launch, st);
}

// Device-initiated MoE dispatch All-to-All for Hopper (paper Sec. III, the
// dispatch side of GEMM + All-to-All).
//
// Replaces the TPU kernel src/repro/kernels/fused_dispatch_a2a/kernel.py:44
// (_dispatch_a2a_kernel, entry fused_dispatch_a2a_pallas at :119).  Every EP
// rank holds routed token blocks x [n_dev, B, E, C, D] stacked by
// destination rank; rank d ends with out_d [n_dev, B, E, C, D] stacked by
// source rank: out_d[s] = x_s[d], the slot layout fused_gemm_a2a.cu reads.
//
// What bounds it: it moves data only, each element read once and written
// once.  At dbrx-132b decode on one card (n_dev = 1, B = 1, E = 16, C = 2,
// D = 6144, bf16) a call copies 393 KB, which HBM moves in about 0.2 us:
// the launch costs more than the bytes, and before it the host.  So the
// wrapper launches from a plan built once per call signature (the checked
// wire and q, the schedule table, the flag words, the kernel, its grid and
// every constant argument: DispatchPlan below), and a call passes only x,
// out, the rx staging, the epoch and the stream.  At n_dev = 1 the exchange
// is the identity on the rank's own block, and dispatch_local_kernel copies
// it in 16-byte vectors spread over the SMs (one vector per thread, 96
// CTAs at dbrx's decode shape), as a device copy does.  With n_dev > 1
// dispatch_a2a_kernel gives each (b, e, c) row of D elements to one CTA,
// which copies it with 16-byte loads and stores.
//
// What it computes, step by step (the TPU grid's order, not its grid):
//  * The steps are the (destination, capacity sub-chunk) pairs of the step
//    schedule (kernels/tile_pipeline.py step_schedule): remote destinations
//    first, farthest first when comm-aware, rotated by `skew`, the rank's
//    own block last; chunks_per_rank = q splits the capacity axis C into q
//    sub-chunks of C / q rows each.  Every row of a step is one work item;
//    CTAs take items round-robin in step order.
//  * A remote row is stored at the wire dtype straight into the
//    destination's slot for this source (its rx staging buffer when the
//    wire is narrower than x, its output otherwise), then the sender
//    publishes the row's flag (source, row) with release semantics.  An
//    own row is copied into this rank's output.
//  * After its sends, each CTA takes a share of the rows the peers send
//    here: it waits for the row's flag and, with a narrowed wire, widens
//    the staged row into the output.  So when a rank's launch ends, every
//    row from every source is in place.
// Sends never wait, so with every CTA resident (cooperative launch for
// n_dev > 1, its grid sized once per plan from the occupancy) the waits
// cannot deadlock.
#include "common.cuh"

namespace repro_torch {

constexpr int kCopyThreads = 256;

struct A2APeers {
  void* out[kMaxDev];        // each rank's [n_dev, B, E, C, D] output, by source
  void* recv[kMaxDev];       // where peers store rows for each rank: rx staging or out
  unsigned* flags[kMaxDev];  // each rank's [n_dev, B * E * C] flag words (source, row)
};

struct DispatchArgs {
  const void* x;           // rank 0's [n_dev, B, E, C, D]; rank r at x + r * x_rank_stride
  long long x_rank_stride;  // in elements
  A2APeers peers;
  const int* sched;        // [2 * n_dev * q]: step offsets, then sub-chunks
  int my_base, n_dev, B, E, C, D, q;
  unsigned epoch;
  bool use_rx;             // the wire is narrower than x: rows arrive in rx staging
  bool vec_ok;             // D % 8 == 0 and every buffer 16-byte aligned
};

// dst[0, n) = src[0, n), converted; 8 elements per thread and step when
// `vec` (n % 8 == 0, both 16-byte aligned).  Reads go through L2 (__ldcg):
// a row may have been stored by another CTA earlier in the launch.
template <typename S, typename Dt>
__device__ __forceinline__ void copy_row(const S* __restrict__ src, Dt* __restrict__ dst, int n,
                                         bool vec) {
  constexpr int V = 8;
  if (vec) {
    for (int i = threadIdx.x * V; i < n; i += blockDim.x * V) {
      alignas(16) S in[V];
      alignas(16) Dt o[V];
#pragma unroll
      for (int j = 0; j < (int)(V * sizeof(S) / 16); ++j)
        reinterpret_cast<uint4*>(in)[j] = __ldcg(reinterpret_cast<const uint4*>(src + i) + j);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = from_float<Dt>(to_float(in[j]));
#pragma unroll
      for (int j = 0; j < (int)(V * sizeof(Dt) / 16); ++j)
        reinterpret_cast<uint4*>(dst + i)[j] = reinterpret_cast<const uint4*>(o)[j];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = from_float<Dt>(to_float(__ldcg(src + i)));
  }
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kCopyThreads) dispatch_a2a_kernel(DispatchArgs a) {
  const int my = a.my_base + blockIdx.y;
  const T* x = static_cast<const T*>(a.x) + blockIdx.y * a.x_rank_stride;
  const int sub = a.C / a.q;
  const int rows = a.B * a.E * a.C;        // rows of one destination block
  const int rows_per_step = a.B * a.E * sub;
  const int n_steps = a.n_dev * a.q;
  const size_t block = (size_t)rows * a.D;

  for (int it = blockIdx.x; it < n_steps * rows_per_step; it += gridDim.x) {
    const int t = it / rows_per_step, r = it % rows_per_step;
    const int off = a.sched[t];
    const int dest = (my + off) % a.n_dev;
    const int row = (r / sub) * a.C + a.sched[n_steps + t] * sub + r % sub;  // (b, e, c)
    const T* src = x + dest * block + (size_t)row * a.D;
    const size_t slot = my * block + (size_t)row * a.D;  // this source's row at the destination
    if (off == 0) {
      copy_row(src, static_cast<T*>(a.peers.out[my]) + slot, a.D, a.vec_ok);
      continue;
    }
    copy_row(src, static_cast<WT*>(a.peers.recv[dest]) + slot, a.D, a.vec_ok);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      store_release(a.peers.flags[dest] + (size_t)my * rows + row, a.epoch);
    }
  }
  if (a.n_dev == 1) return;

  // the rows every peer sends here
  for (int it = blockIdx.x; it < (a.n_dev - 1) * rows; it += gridDim.x) {
    const int k = it / rows, row = it % rows;
    const int src = k < my ? k : k + 1;
    if (threadIdx.x == 0) wait_flag(a.peers.flags[my] + (size_t)src * rows + row, a.epoch);
    __threadfence();
    __syncthreads();
    if (a.use_rx) {
      const size_t slot = src * block + (size_t)row * a.D;
      copy_row(static_cast<const WT*>(a.peers.recv[my]) + slot,
               static_cast<T*>(a.peers.out[my]) + slot, a.D, a.vec_ok);
    }
  }
}

// n_dev = 1: out = x, n elements, in 16-byte vectors when `vec` (n % 8 == 0,
// both 16-byte aligned).
template <typename T>
__global__ void __launch_bounds__(kCopyThreads)
    dispatch_local_kernel(const T* __restrict__ x, T* __restrict__ out, size_t n, bool vec) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (; i < n / V; i += stride)
      reinterpret_cast<uint4*>(out)[i] = __ldg(reinterpret_cast<const uint4*>(x) + i);
  } else {
    for (; i < n; i += stride) out[i] = x[i];
  }
}

// Everything of a launch that does not change between calls.
struct DispatchPlan {
  DispatchArgs a;       // x, the output and rx pointers and the epoch are filled per call
  const void* kernel;
  dim3 grid;            // n_dev > 1: sized from the occupancy
  int ranks_in_launch;
  size_t rank_elems;    // one rank's [n_dev, B, E, C, D] block
  int esize, wsize;     // bytes of x's and the wire's elements
  bool vec_shape;       // D % 8 == 0 (so every row and rank block is 16-byte aligned)
};

template <typename T, typename WT>
static cudaError_t dispatch_plan_init(DispatchPlan* p) {
  const DispatchArgs& a = p->a;
  p->esize = sizeof(T);
  p->wsize = sizeof(WT);
  if (a.n_dev == 1) {  // the grid depends on the call's alignment
    p->kernel = reinterpret_cast<const void*>(dispatch_local_kernel<T>);
    return cudaSuccess;
  }
  p->kernel = reinterpret_cast<const void*>(dispatch_a2a_kernel<T, WT>);
  // CTAs wait on flags set by other CTAs: all of them must be resident
  int per_rank = 0;
  const cudaError_t err =
      resident_ctas(dispatch_a2a_kernel<T, WT>, kCopyThreads, p->ranks_in_launch, &per_rank);
  if (err != cudaSuccess) return err;
  if (per_rank < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int items = a.n_dev * a.B * a.E * a.C;  // every row of every destination block
  p->grid = dim3(items < per_rank ? items : per_rank, p->ranks_in_launch);
  return cudaSuccess;
}

}  // namespace repro_torch

// The launch plan for x [ranks_in_launch, n_dev, B, E, C, D] (rank r's block
// of n_dev destinations at x + r * n_dev * B * E * C * D elements):
// flag_ptrs is a host array of n_dev device pointers (each n_dev * B * E * C
// words; unused at n_dev = 1), sched a device int32 [2 * n_dev * q] table;
// both stay valid for the plan's life.  ranks_in_launch is n_dev for an
// emulated world (gridDim.y) and 1 when each rank launches its own kernel.
// dtype: 0 = float32, 1 = bfloat16; wire: 0 = x's dtype, 1 = bfloat16.
// Writes a handle for repro_dispatch_launch (free it with
// repro_dispatch_plan_free).  Returns a cudaError_t code (0 = built).
extern "C" int repro_dispatch_plan(void** plan, const uint64_t* flag_ptrs, const void* sched,
                                   int my_base, int ranks_in_launch, int n_dev, int B, int E,
                                   int C, int D, int q, int dtype, int wire) {
  using namespace repro_torch;
  *plan = nullptr;
  if (n_dev < 1 || n_dev > kMaxDev || B <= 0 || E <= 0 || C <= 0 || D <= 0 || q <= 0 ||
      C % q != 0 || (ranks_in_launch != 1 && ranks_in_launch != n_dev) || dtype < 0 ||
      dtype > 1 || wire < 0 || wire > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DispatchPlan* p = new DispatchPlan{};
  DispatchArgs& a = p->a;
  for (int d = 0; d < n_dev; ++d) a.peers.flags[d] = reinterpret_cast<unsigned*>(flag_ptrs[d]);
  a.sched = static_cast<const int*>(sched);
  a.my_base = my_base;
  a.n_dev = n_dev;
  a.B = B;
  a.E = E;
  a.C = C;
  a.D = D;
  a.q = q;
  a.use_rx = dtype == 0 && wire == 1;
  p->ranks_in_launch = ranks_in_launch;
  p->rank_elems = (size_t)n_dev * B * E * C * D;
  a.x_rank_stride = static_cast<long long>(p->rank_elems);
  p->vec_shape = D % 8 == 0;
  const cudaError_t err = dtype == 1             ? dispatch_plan_init<__nv_bfloat16, __nv_bfloat16>(p)
                          : a.use_rx ? dispatch_plan_init<float, __nv_bfloat16>(p)
                                     : dispatch_plan_init<float, float>(p);
  if (err != cudaSuccess) {
    delete p;
    return static_cast<int>(err);
  }
  *plan = p;
  return 0;
}

// One call of a plan: x as above, out [ranks_in_launch, n_dev, B, E, C, D] at
// x's dtype, rx the same shape at the wire dtype when the wire is narrower
// than x (else null), epoch the call's flag value (n_dev > 1).  Returns a
// cudaError_t code (0 = launched).
extern "C" int repro_dispatch_launch(const void* plan, const void* x, void* out, void* rx,
                                     unsigned epoch, void* stream) {
  using namespace repro_torch;
  const DispatchPlan* p = static_cast<const DispatchPlan*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(rx)) % 16) == 0;
  const bool vec = p->vec_shape && aligned;
  if (p->a.n_dev == 1) {
    void* args[] = {(void*)&x, (void*)&out, (void*)&p->rank_elems, (void*)&vec};
    const size_t ctas = ((vec ? p->rank_elems / (16 / p->esize) : p->rank_elems) +
                         kCopyThreads - 1) / kCopyThreads;
    const dim3 grid(static_cast<unsigned>(ctas < 1024 ? ctas : 1024));
    const cudaError_t err = cudaLaunchKernel(p->kernel, grid, dim3(kCopyThreads), args, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  DispatchArgs a = p->a;
  a.x = x;
  a.epoch = epoch;
  a.vec_ok = vec;
  for (int d = 0; d < a.n_dev; ++d) {
    a.peers.out[d] = static_cast<char*>(out) + d * p->rank_elems * p->esize;
    a.peers.recv[d] = a.use_rx ? static_cast<char*>(rx) + d * p->rank_elems * p->wsize
                               : a.peers.out[d];
  }
  void* args[] = {(void*)&a};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(p->kernel, p->grid, dim3(kCopyThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" void repro_dispatch_plan_free(void* plan) {
  delete static_cast<repro_torch::DispatchPlan*>(plan);
}

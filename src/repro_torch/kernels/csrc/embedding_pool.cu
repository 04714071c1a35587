// Mean-pooled embedding gather for Hopper (paper Sec. III-A, DLRM's
// EmbeddingBag in mean mode).
//
// Replaces the TPU kernel src/repro/kernels/embedding_pool/kernel.py:20
// (_pool_kernel, entry embedding_pool_pallas at :36).  The TPU kernel pools
// one table: its grid runs over (bag, lookup), the scalar-prefetched index
// picks the row each step DMAs into VMEM, and an f32 accumulator carried
// across the lookups is divided by L on the last one.  The JAX package
// vmaps it over a rank's tables; here one launch covers every table:
// out[b, t] = mean over l of tables[t, idx[b, t, l]], for tables [T, V, D]
// and idx [B, T, L] int32.
//
// What bounds it: bytes.  Each lookup reads one random row (D = 92 f32 is
// 368 bytes) and adds it: about one operation per byte, far below the
// card's balance point.  At DLRM's main-path shape (128 tables of 1,000,000
// rows, B = 8192, L = 70) a launch gathers 73.4 M rows, 27 GB, of which
// about 20.6 GB are distinct rows; in the lookup order each row spans 12
// sectors of 32 bytes, so a gather that reads every lookup from HBM moves
// about 28.9 GB (chip_smoke.py phase 14 prints the floor).  Two paths share
// embedding_bag.cuh with fused_embedding_a2a.cu (the plan picks one,
// kernels/embedding_pool/plan.py): the ring path, where rows arrive in
// shared memory by bulk copies and persistent CTAs walk units of eight
// bags, so shared memory sets the rows in flight; and the warp path, one
// warp per bag with eight rows in flight a lane in registers, which takes
// any rows and is the one a one-rank call takes (the faster on an H100,
// PERF.md section 6).  Table offsets are 64-bit: T * V * D is 1.18e10
// elements at the main-path shape.  Indices are trusted, as the TPU kernel
// trusts them.
#include "embedding_bag.cuh"

namespace repro_torch {

// The units of a call: unit u holds bags 8u .. 8u + 7 in table-major order
// (s = t * B + b), so the bags that run at once share one table's rows in
// L2 (the faster order on both paths, PERF.md section 6).
template <typename T>
struct PoolMap {
  const T* tables;
  long long V;
  const int* idx;
  T* out;
  long long bags;
  int n_tab, B, L, D, units;

  __device__ __forceinline__ bool bag(int unit, int w, BagRef<T>& r) const {
    const long long s = (long long)unit * kBagWarps + w;
    if (s >= bags) return false;
    const long long t = s / B, b = s - t * B;
    const size_t bag = (size_t)b * n_tab + t;
    r.table = tables + (size_t)t * V * D;
    r.idx = idx + bag * L;
    r.out = out + bag * D;
    return true;
  }
};

// The warp path: CTA c is unit c.
template <typename T>
__global__ void __launch_bounds__(kBagThreads)
    embedding_pool_kernel(const __grid_constant__ PoolMap<T> m, bool vec) {
  BagRef<T> r;
  if (m.bag(blockIdx.x, threadIdx.x / 32, r)) pool_bag(r.table, r.idx, m.L, m.D, r.out, vec);
}

// The ring path: gridDim.x persistent CTAs walk the units.
template <typename T>
__global__ void __launch_bounds__(kBagThreads)
    embedding_pool_ring_kernel(const __grid_constant__ PoolMap<T> m, int slots) {
  ring_pool<T>(m, m.L, m.D, slots, [](int) {});
}

template <typename T>
static const void* pool_kernel_for(bool ring) {
  return ring ? reinterpret_cast<const void*>(embedding_pool_ring_kernel<T>)
              : reinterpret_cast<const void*>(embedding_pool_kernel<T>);
}

template <typename T>
static int launch_pool(const void* tables, long long V, const void* idx, void* out, int B, int T_,
                       int L, int D, int slots, int grid, cudaStream_t st) {
  const long long bags = (long long)B * T_, units = (bags + kBagWarps - 1) / kBagWarps;
  if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const PoolMap<T> m = {static_cast<const T*>(tables), V, static_cast<const int*>(idx),
                        static_cast<T*>(out), bags, T_, B, L, D, (int)units};
  if (slots == 0) {  // the warp path
    const bool vec = D * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    embedding_pool_kernel<T><<<(unsigned)units, kBagThreads, 0, st>>>(m, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (grid < 1 || !ring_fits(D, sizeof(T) == 2 ? 1 : 0, slots, bags, tables, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_ring_smem(pool_kernel_for<T>(true));
  if (err != cudaSuccess) return static_cast<int>(err);
  embedding_pool_ring_kernel<T>
      <<<grid, kBagThreads, ring_smem_bytes(slots, D * sizeof(T)), st>>>(m, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// tables [T, V, D], idx [B, T, L] int32, out [B, T, D], all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  slots = 0: the warp path; else the
// ring path with `slots` row slots a warp and `grid` persistent CTAs
// (kernels/embedding_pool/plan.py sizes them).  Returns a cudaError_t code
// (0 = launched).
extern "C" int repro_embedding_pool(const void* tables, long long V, const void* idx, void* out,
                                    int B, int T, int L, int D, int dtype, int slots, int grid,
                                    void* stream) {
  using namespace repro_torch;
  if (B < 0 || T <= 0 || L <= 0 || D <= 0 || V <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pool<float>(tables, V, idx, out, B, T, L, D, slots, grid, st);
  return launch_pool<__nv_bfloat16>(tables, V, idx, out, B, T, L, D, slots, grid, st);
}

// Registers per thread and CTAs resident on an SM of the kernel of a path
// (ring = 0: the warp path; else the ring path at `smem` bytes of dynamic
// shared memory) for dtype.  Returns a cudaError_t code (0 = answered).
extern "C" int repro_embedding_pool_info(int ring, int dtype, int smem, int* regs, int* ctas) {
  using namespace repro_torch;
  if ((dtype != 0 && dtype != 1) || smem < 0 || (ring != 0) != (smem > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* k = dtype == 0 ? pool_kernel_for<float>(ring != 0)
                             : pool_kernel_for<__nv_bfloat16>(ring != 0);
  return bag_kernel_info(k, smem, regs, ctas);
}

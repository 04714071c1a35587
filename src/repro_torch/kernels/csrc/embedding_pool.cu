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
// about 20.6 GB are distinct rows.  The design gives each bag to one warp
// (embedding_bag.cuh): 16-byte loads across the row, eight rows in flight
// per lane, the bag's indices read once and broadcast by shuffles, and
// eight bags per CTA, so a million bags keep every SM's memory pipeline
// full without shared memory.  Table offsets are 64-bit: T * V * D is
// 1.18e10 elements at the main-path shape.  Indices are trusted, as the
// TPU kernel trusts them.
#include <limits.h>

#include "embedding_bag.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kBagThreads)
    embedding_pool_kernel(const T* __restrict__ tables, long long V, const int* __restrict__ idx,
                          T* __restrict__ out, long long bags, int n_tab, int L, int D,
                          bool vec) {
  const long long bag = (long long)blockIdx.x * kBagWarps + threadIdx.x / 32;  // b * T + t
  if (bag >= bags) return;  // a whole warp
  const int t = (int)(bag % n_tab);
  pool_bag(tables + (size_t)t * V * D, idx + (size_t)bag * L, L, D, out + (size_t)bag * D, vec);
}

}  // namespace repro_torch

// tables [T, V, D], idx [B, T, L] int32, out [B, T, D], all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_embedding_pool(const void* tables, long long V, const void* idx, void* out,
                                    int B, int T, int L, int D, int dtype, void* stream) {
  using namespace repro_torch;
  if (B < 0 || T <= 0 || L <= 0 || D <= 0 || V <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bags = (long long)B * T;
  if (bags == 0) return 0;
  const long long blocks = (bags + kBagWarps - 1) / kBagWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D * dtype_bytes(dtype) % 16 == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    embedding_pool_kernel<float><<<(unsigned)blocks, kBagThreads, 0, st>>>(
        static_cast<const float*>(tables), V, ix, static_cast<float*>(out), bags, T, L, D, vec);
  else
    embedding_pool_kernel<__nv_bfloat16><<<(unsigned)blocks, kBagThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(tables), V, ix, static_cast<__nv_bfloat16*>(out), bags,
        T, L, D, vec);
  return static_cast<int>(cudaGetLastError());
}

// GEMV for Hopper: y[B, N] = x[B, K] @ w[K, N], f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/gemv/kernel.py:19 (_gemv_kernel,
// entry gemv_pallas at :33).  At decode batch sizes it does about one FMA per
// weight element read, far below the ~295 operations per byte where an H100
// stops being bound by memory, so its time is the weight bytes over the
// 3.35 TB/s of HBM.  Two paths, chosen by the wrapper (kernels/gemv/ops.py
// gemv_path):
//
//  * stream (every call whose w TMA can read: N * sizeof(T) % 16 == 0, a
//    16-byte-aligned w, and x's slice within shared memory): stream_gemv.cuh's
//    loop, a TMA-fed weight ring per CTA, K split over a thread-block
//    cluster, the split partials reduced through distributed shared memory
//    into the cluster's leader, which stores the tile.  One cluster per
//    (128-column tile, row block); kernels/gemv/plan.py sizes it.
//  * panel (the other shapes): tile_gemv.cuh's loop, one CTA per 32-column
//    strip, x staged in 512-deep panels, 16-byte coalesced loads with
//    kUnroll in flight per thread.  Ragged K and N are masked.
#include "stream_gemv.cuh"
#include "tile_gemv.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int B, int K,
                int N, bool vec_ok) {
  __shared__ TileSmem sm;
  const int col0 = blockIdx.x * kTileN;
  const int r = threadIdx.x / kTileN, c = threadIdx.x % kTileN;
  for (int row0 = 0; row0 < B; row0 += kRows) {
    tile_gemv<T>(x, w, B, K, N, row0, col0, vec_ok, sm);
    const int row = row0 + r, col = col0 + c;
    if (row < B && col < N) y[(size_t)row * N + col] = from_float<T>(sm.tile[r][c]);
  }
}

template <typename T>
static int launch_gemv(const void* x, const void* w, void* y, int B, int K, int N,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec_ok = (N % V == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const dim3 grid((N + kTileN - 1) / kTileN);
  gemv_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(w), static_cast<T*>(y),
                                                  B, K, N, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// The stream path: one cluster of a.splits CTAs per (column tile, row block).
template <typename T, int R>
__global__ void __launch_bounds__(kStreamThreads, R <= 4 ? 2 : 1)
    gemv_stream_kernel(const __grid_constant__ CUtensorMap wmap, const StreamArgs a) {
  const StreamSmem<T> sm = stream_smem<T>();
  StreamRing ring;
  const int split = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int u = blockIdx.x / a.splits;
  const int row0 = (u % a.row_blocks) * R, col0 = (u / a.row_blocks) * kStreamN;
  const float* tile = stream_unit<T, R>(&wmap, sm, ring, static_cast<const T*>(a.x), a.B, a.K,
                                        a.ks, split, a.splits, 0, row0, col0);
  if (split != 0) return;
  T* y = static_cast<T*>(a.peers.out[0]);
  for (int i = threadIdx.x; i < R * kStreamN; i += kStreamThreads) {
    const int row = row0 + i / kStreamN, col = col0 + i % kStreamN;
    if (row < a.B && col < a.N) y[(size_t)row * a.N + col] = from_float<T>(tile[i]);
  }
}

template <typename T>
static const void* gemv_stream_fn(int rows_per_block) {
  return stream_kernel_for_rows(rows_per_block, [](auto r) {
    return reinterpret_cast<const void*>(gemv_stream_kernel<T, decltype(r)::value>);
  });
}

const void* gemv_stream_kernel_for(int dtype, int rows_per_block) {
  return dtype == 0   ? gemv_stream_fn<float>(rows_per_block)
         : dtype == 1 ? gemv_stream_fn<__nv_bfloat16>(rows_per_block)
                      : nullptr;
}

}  // namespace repro_torch

// The stream path's launch plan for w [K, N] at B rows of x: rows_per_block
// rows per unit (1, 2, 4 or 8), K split into `splits` shares of ks rows (a
// multiple of 32) across a cluster, as kernels/gemv/plan.py computes them.
// Writes a handle for repro_stream_launch (free it with
// repro_stream_plan_free).  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t code (0 = built).
extern "C" int repro_gemv_stream_plan(void** plan, const void* w, int B, int K, int N,
                                      int rows_per_block, int splits, int ks, int dtype) {
  using namespace repro_torch;
  *plan = nullptr;
  const void* kernel = gemv_stream_kernel_for(dtype, rows_per_block);
  if (kernel == nullptr || B <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  StreamPlan* p = new StreamPlan{};
  StreamArgs& a = p->args;
  a.n_dev = 1;
  a.B = B;
  a.K = K;
  a.N = N;
  a.tiles = (N + kStreamN - 1) / kStreamN;
  a.row_blocks = (B + rows_per_block - 1) / rows_per_block;
  a.splits = splits;
  a.ks = ks;
  const cudaError_t err = stream_plan_init(p, kernel, w, dtype == 0 ? 4 : 2, 1, rows_per_block,
                                           a.tiles * a.row_blocks, false);
  if (err != cudaSuccess) {
    delete p;
    return static_cast<int>(err);
  }
  *plan = p;
  return 0;
}

// The clusters of `splits` CTAs of a stream kernel, each with ks rows of K,
// that the card holds at once (kernels/gemv/plan.py sizes the split with
// it): gemv's (fused = 0) or the fused kernel's GEMV path (fused = 1, with
// its wire), for dtype and rows_per_block as in the plans.  Returns a
// cudaError_t code (0 = answered).
extern "C" int repro_stream_capacity(int fused, int dtype, int wire, int rows_per_block,
                                     int splits, int ks, int* clusters) {
  using namespace repro_torch;
  const void* kernel = fused == 0   ? gemv_stream_kernel_for(dtype, rows_per_block)
                       : fused == 1 ? fused_stream_kernel_for(dtype, wire, rows_per_block)
                                    : nullptr;
  if (kernel == nullptr || splits < 1 || splits > kStreamMaxSplits || ks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      stream_max_clusters(kernel, splits, stream_smem_bytes(rows_per_block, ks), clusters));
}

// Launches a stream plan (gemv's or the fused kernel's) on x, writing out;
// rx (the fused kernel's rx slots at n_dev > 1, else null) and epoch as the
// plan's kernel needs them.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_stream_launch(const void* plan, const void* x, void* out, void* rx,
                                   unsigned epoch, void* stream) {
  using namespace repro_torch;
  return stream_plan_launch(static_cast<const StreamPlan*>(plan), x, out, rx, epoch,
                            static_cast<cudaStream_t>(stream));
}

extern "C" void repro_stream_plan_free(void* plan) {
  delete static_cast<repro_torch::StreamPlan*>(plan);
}

// The panel path.  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_gemv(const void* x, const void* w, void* y, int B, int K, int N, int dtype,
                          void* stream) {
  using namespace repro_torch;
  if (B <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemv<float>(x, w, y, B, K, N, s);
  if (dtype == 1) return launch_gemv<__nv_bfloat16>(x, w, y, B, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

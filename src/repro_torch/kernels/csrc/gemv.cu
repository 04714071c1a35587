// Tiled GEMV for Hopper: y[B, N] = x[B, K] @ w[K, N], f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/gemv/kernel.py:19 (_gemv_kernel,
// entry gemv_pallas at :33).  At decode batch sizes it does about one FMA per
// weight element read, far below the ~295 operations per byte where an H100
// stops being bound by memory, so its time is the weight bytes over the
// 3.35 TB/s of HBM.  The design reads every weight byte once with 16-byte
// coalesced loads, keeps kUnroll loads in flight per thread, and gives each
// CTA a narrow 32-column tile so that a 4096-wide output already spreads over
// 128 CTAs (the TPU kernel's 256-wide blocks would give 16).  Ragged K and N
// are masked.  The loop is shared with the fused GEMV+AllReduce kernel
// (tile_gemv.cuh).
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

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code (0 = launched).
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

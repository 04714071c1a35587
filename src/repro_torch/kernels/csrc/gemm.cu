// Tiled GEMM for Hopper: y[M, N] = x[M, K] @ w[K, N], f32 accumulation,
// output in x's dtype (f32 or bf16).
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py:19 (_gemm_kernel,
// entry gemm_pallas at :33), whose grid is (M/bm, N/bn, K/bk) with the K axis
// sequential and an f32 (bm, bn) accumulator in VMEM scratch.  The block
// sizes the caller passes are the TPU's; these kernels pick their own.
//
// What bounds it: a large product is bound by operations (at [2048, 4096] x
// [4096, 4096], 68.7 GFLOP against 67 MB: 0.0695 ms on bf16 tensor cores,
// 1.03 ms at the f32 CUDA-core peak).  Two kernels, chosen by dtype and
// shape in kernels/gemm/ops.py:
//  * bf16 with K % 8 == 0 and N % 8 == 0 (TMA's 16-byte rows): the
//    tensor-core tile loop of tile_mma.cuh, one CTA per 128 x 128 output
//    tile, x and w streamed by TMA through a 4-stage ring, wgmma into f32
//    accumulators, and a plain store epilogue that rounds to bf16 once.
//  * f32, and unaligned bf16: a CUDA-core kernel.  One CTA of 256 threads
//    owns a 64 x 64 output tile, loops over K in panels of 16, stages the
//    x panel (transposed) and the w panel in shared memory as f32, and each
//    thread keeps a 4 x 4 block of the tile in registers.  A tensor-core f32
//    product would be TF32 and change the numbers; this one is exact f32.
// Every edge is handled (TMA zero-fills past M, N and K; the CUDA-core
// kernel guards its loads; both skip stores past M or N), so any M, N and K
// work, as in the reference, whose wrapper falls back to whole-dimension
// blocks.
#include "tile_mma.cuh"

namespace repro_torch {

constexpr int kGemmThreads = 256;
constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 16;
constexpr int kGemmPad = 4;   // keeps each smem row 16-byte aligned for float4 reads

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int M, int N,
                int K) {
  __shared__ __align__(16) float xs[kGemmBK][kGemmBM + kGemmPad];   // x panel, [k][m]
  __shared__ __align__(16) float ws[kGemmBK][kGemmBN + kGemmPad];   // w panel, [k][n]
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    for (int i = tid; i < kGemmBM * kGemmBK; i += kGemmThreads) {
      const int mm = i / kGemmBK, kk = i % kGemmBK, gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? to_float(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < kGemmBK * kGemmBN; i += kGemmThreads) {
      const int kk = i / kGemmBN, nn = i % kGemmBN, gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N) ? to_float(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) y[(size_t)gm * N + gn] = from_float<T>(acc[i][j]);
    }
  }
}

// One 128 x 128 tile per CTA; consecutive CTAs take the row blocks of one
// column panel, so a panel of w is read from L2 by neighbours in time.
__global__ void __launch_bounds__(kMmaThreads)
    gemm_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ y,
                     int M, int N, int K) {
  const int tiles_m = (M + kMmaBM - 1) / kMmaBM;
  const int tiles_n = (N + kMmaBN - 1) / kMmaBN;
  mma_tile_loop(
      &xmap, &wmap, (K + kMmaBK - 1) / kMmaBK, tiles_m * tiles_n,
      [&](int u) { return TileCoord{0, (u % tiles_m) * kMmaBM, (u / tiles_m) * kMmaBN}; },
      [&](int, TileCoord tc, float(&acc)[kMmaAccs], int wg, int t) {
        for_each_acc_pair(acc, wg, t, [&](int r, int c, float& v0, float& v1) {
          const int row = tc.row0 + r, col = tc.col0 + c;
          if (row < M && col < N) store_pair(y + (size_t)row * N + col, v0, v1);
        });
      });
}

}  // namespace repro_torch

// x [M, K], w [K, N], y [M, N], all contiguous and of one dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_gemm(const void* x, const void* w, void* y, int M, int N, int K, int dtype,
                          void* stream) {
  using namespace repro_torch;
  const int grid_m = (M + kGemmBM - 1) / kGemmBM;
  if (M <= 0 || N <= 0 || K <= 0 || grid_m > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, grid_m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gemm_kernel<float><<<grid, kGemmThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), M, N, K);
  else
    gemm_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core path: x [M, K], w [K, N], y [M, N] contiguous bf16 with
// K % 8 == 0, N % 8 == 0 and 16-byte-aligned x and w.  Returns a cudaError_t
// code (0 = launched).
extern "C" int repro_gemm_tile(const void* x, const void* w, void* y, int M, int N, int K,
                               void* stream) {
  using namespace repro_torch;
  if (M <= 0 || N <= 0 || K <= 0 || !mma_shape_ok(x, w, K, N))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  cudaError_t err = make_mma_maps(&xmap, &wmap, x, w, 1, M, K, N);
  if (err == cudaSuccess) err = allow_mma_smem(gemm_tile_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)((M + kMmaBM - 1) / kMmaBM) * ((N + kMmaBN - 1) / kMmaBN);
  gemm_tile_kernel<<<static_cast<unsigned>(tiles), kMmaThreads, kMmaSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

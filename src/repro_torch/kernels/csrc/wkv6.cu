// Chunked WKV6 recurrence for Hopper (RWKV-6 "Finch" time-mix).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py:20
// (_wkv6_kernel, entry wkv6_pallas at :56).  Per head, from a zero state
// S [N, N], with r, k, v and the log decay lw (<= 0) in chunks of c steps
// and lc the inclusive cumulative sum of lw over the chunk:
//   att[t, s] = sum_n r[t,n] k[s,n] exp(clip(lc[t-1,n] - lc[s,n], -60, 0)), s < t
//   o[t]      = att[t] v + (sum_n r[t,n] u[n] k[t,n]) v[t] + (r[t] * exp(clip(lc[t-1]))) S
//   S        <- exp(clip(lc[c-1])) S + (k * exp(clip(lc[c-1] - lc)))^T v
// The TPU grid is (B*H, T/c) with the chunk axis sequential and S in VMEM
// scratch.  Here one CTA per (b, h) carries S in shared memory through a
// loop over the chunks (a GPU grid has no sequential axis), and also
// writes the final S, which the reference's prefill takes from its XLA
// twin (models/rwkv6.py:106 wkv6_chunked).
//
// What bounds it: at the main path's shape (B*H = 256, T = 512, N = 64,
// c = 64) the inputs and outputs are 172 MB (0.05 ms at 3.35 TB/s), while
// the chunk products take about 3.5 GFLOP and the pairwise decay 0.28 G
// exponentials: far below the card's balance point, so bytes bound it.
// This first design is simple: the four [c, N] operands are staged in
// shared memory as f32 rows padded to N + 1 (so the pairwise pass, whose
// lanes walk s, hits 32 banks), the [c, c, N] decay tensor of the reference
// is never materialised (each pairwise term forms its exponential on the
// fly), and every product runs on CUDA cores, one output per thread and
// loop step.  At c = N = 64 a CTA takes 100 KB, so two fit on an SM.
// Tensor cores for the three chunk products and TMA staging are later
// work.  Inputs and outputs keep the model's [B, T, H, N] layout (the
// wrapper folds nothing); S comes out as [B, H, N, N].
#include <limits.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kWkvThreads = 256;
constexpr int kWkvMaxChunk = 64;   // with N <= 64: N + c <= kWkvThreads

__device__ __forceinline__ float decay(float lc) { return expf(fminf(fmaxf(lc, -60.f), 0.f)); }

static size_t wkv6_smem_bytes(int c, int N) {
  const size_t P = N + 1;
  return sizeof(float) * (4 * c * P + (size_t)c * (c + 1) + (size_t)N * N + c + N);
}

__global__ void __launch_bounds__(kWkvThreads)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, float* __restrict__ o, float* __restrict__ state,
                int T, int H, int N, int c) {
  extern __shared__ float smem[];
  const int P = N + 1;
  float* rs = smem;              // [c][P]: r, then r * exp(lc[t-1])
  float* ks = rs + c * P;        // [c][P]: k, then k * exp(lc[c-1] - lc)
  float* vs = ks + c * P;        // [c][P]
  float* lc = vs + c * P;        // [c][P]: lw, then its inclusive sum over t
  float* att = lc + c * P;       // [c][c + 1]
  float* S = att + c * (c + 1);  // [N][N], carried across chunks
  float* diag = S + N * N;       // [c]: the bonus r[t] . (u * k[t])
  float* us = diag + c;          // [N]

  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const size_t row = (size_t)H * N;                        // one time step
  const size_t base = (size_t)(bh / H) * T * row + (size_t)h * N;

  for (int i = tid; i < N * N; i += kWkvThreads) S[i] = 0.f;
  for (int i = tid; i < N; i += kWkvThreads) us[i] = u[h * N + i];

  for (int t0 = 0; t0 < T; t0 += c) {
    for (int i = tid; i < c * N; i += kWkvThreads) {
      const int t = i / N, n = i % N;
      const size_t g = base + (t0 + t) * row + n;
      rs[t * P + n] = r[g];
      ks[t * P + n] = k[g];
      vs[t * P + n] = v[g];
      lc[t * P + n] = lw[g];
    }
    __syncthreads();
    if (tid < N) {                 // cumulative log decay, in order over t
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += lc[t * P + tid];
        lc[t * P + tid] = acc;
      }
    } else if (tid - N < c) {      // the bonus diagonal
      const int t = tid - N;
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += rs[t * P + n] * us[n] * ks[t * P + n];
      diag[t] = s;
    }
    __syncthreads();
    for (int i = tid; i < c * c; i += kWkvThreads) {
      const int t = i / c, s = i % c;
      float a = 0.f;
      if (s < t) {
        const float *rt = rs + t * P, *lt = lc + (t - 1) * P;
        const float *kq = ks + s * P, *lq = lc + s * P;
        for (int n = 0; n < N; ++n) a = fmaf(rt[n] * decay(lt[n] - lq[n]), kq[n], a);
      }
      att[t * (c + 1) + s] = a;
    }
    __syncthreads();
    for (int i = tid; i < c * N; i += kWkvThreads) {
      const int t = i / N, n = i % N;
      rs[t * P + n] *= decay(t > 0 ? lc[(t - 1) * P + n] : 0.f);
      ks[t * P + n] *= decay(lc[(c - 1) * P + n] - lc[t * P + n]);
    }
    __syncthreads();
    for (int i = tid; i < c * N; i += kWkvThreads) {
      const int t = i / N, m = i % N;
      float a = 0.f, b = 0.f;
      for (int s = 0; s < t; ++s) a = fmaf(att[t * (c + 1) + s], vs[s * P + m], a);
      a = fmaf(diag[t], vs[t * P + m], a);
      for (int n = 0; n < N; ++n) b = fmaf(rs[t * P + n], S[n * N + m], b);
      o[base + (t0 + t) * row + m] = a + b;
    }
    __syncthreads();               // every read of the old S is done
    for (int i = tid; i < N * N; i += kWkvThreads) {
      const int n = i / N, m = i % N;
      float a = decay(lc[(c - 1) * P + n]) * S[i];
      for (int s = 0; s < c; ++s) a = fmaf(ks[s * P + n], vs[s * P + m], a);
      S[i] = a;
    }
    __syncthreads();               // before the next chunk overwrites the rows
  }
  float* so = state + (size_t)bh * N * N;
  for (int i = tid; i < N * N; i += kWkvThreads) so[i] = S[i];
}

}  // namespace repro_torch

// r, k, v, lw, o [B, T, H, N] f32; u [H, N] f32; state [B, H, N, N] f32; all
// contiguous.  N must be 16, 32 or 64; 1 <= chunk <= 64 and T % chunk == 0.
// Returns a cudaError_t code (0 = launched).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* lw,
                          const void* u, void* o, void* state, int B, int T, int H, int N,
                          int chunk, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || T <= 0 || H <= 0 || (N != 16 && N != 32 && N != 64) || chunk < 1 ||
      chunk > kWkvMaxChunk || T % chunk != 0 || (long long)B * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wkv6_smem_bytes(chunk, N);
  cudaError_t err =
      cudaFuncSetAttribute(wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<<<B * H, kWkvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(state), T, H, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

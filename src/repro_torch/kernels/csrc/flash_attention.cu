// Flash-attention forward for Hopper (causal or not), grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:22
// (_flash_kernel, entry flash_attention_pallas at :63).  For each query row
// and head, over the keys in blocks, with f32 running max m, denominator l
// and accumulator acc (m from -1e30, the reference's mask value):
//   s   = (q . k) * scale, -1e30 where masked (causal: kpos > qpos)
//   m'  = max(m, max s);  p = exp(s - m');  corr = exp(m - m')
//   l   = l corr + sum p;  acc = acc corr + p V;  m = m'
//   out = acc / max(l, 1e-30), at the input dtype.
// The TPU grid is (B*H, S/bq, S/bkv) with the key axis sequential and the
// carries in VMEM scratch; a GPU grid has no sequential axis, so one CTA
// per (batch*head, 64-row query block) loops over the 64-key blocks with
// the carries in registers.  As there, a causal CTA stops at the diagonal:
// blocks wholly above it are never read.  CTAs start with the longest
// causal rows, so the short ones fill the tail of the grid.
//
// Where it departs from the TPU kernel:
//   - P stays f32 in the PV product.  The TPU kernel rounds P to V's dtype
//     (kernel.py:56-57); the model's own blockwise attention
//     (models/attention.py _flash_update) keeps P in f32, and this kernel
//     runs in the model's place.
//   - Any S: the last query and key blocks are masked by bounds, so there
//     is no block-divisor search and no row is dropped.
//   - Grouped heads: q, k, v keep the model's [B, S, H, d] layout, and the
//     CTA of query head h reads kv head h / (Hq / Hkv), so GQA needs no
//     expanded copy of K and V.
//
// What bounds it: at the prefill's shape (B 4, S 2048, Hq 32, Hkv 2, d 128,
// bf16, causal) the products are 1.37e11 FLOP against 143 MB of bytes, so
// on tensor cores it would be bound by operations (0.14 ms at 989 TFLOP/s).
// This first design is simple and runs on CUDA cores in f32: Q, K and V
// tiles are staged in shared memory as f32 rows padded by 4 floats (float4
// reads without bank conflicts); each of the 256 threads holds a 4 x 4
// block of the 64 x 64 score tile and the matching 4 rows x (d / 16)
// columns of acc; rows reduce over 16 lanes with shuffles; P overwrites
// the K tile once the scores are in registers, so a CTA takes 99 KB at
// d = 128 and two fit on an SM.  wgmma, TMA and a pipelined K/V ring are
// later work.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kFlashThreads = 256;
constexpr int kFlashBQ = 64;   // query rows per CTA
constexpr int kFlashBK = 64;   // keys per block
constexpr int kFlashPP = kFlashBK + 4;   // row pitch of P in shared memory
constexpr float kFlashNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows [0, 64) of a [*, D] global tile (row stride `stride` elements) into
// shared memory as f32 rows of pitch D + 4; rows from `valid` on are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t stride, int valid) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < 64 * V; i += kFlashThreads) {
    const int r = i / V, c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = load4(src + r * stride + c);
    store4(dst + r * (D + 4) + c, x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S, int Hq, int Hkv,
                           int n_qblk, float scale, int causal) {
  constexpr int PD = D + 4;    // row pitch of Q, K and V in shared memory
  constexpr int CV = D / 64;   // float4 column groups of acc per thread
  static_assert(kFlashBQ == 64 && kFlashBK == 64, "the thread layout assumes 64 x 64 tiles");
  static_assert(kFlashBQ * kFlashPP <= kFlashBK * PD, "P must fit in the K tile");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][PD]
  float* ks = qs + kFlashBQ * PD;                // [BK][PD]: K, then P [BQ][PP]
  float* vs = ks + kFlashBK * PD;                // [BK][PD]
  float* ps = ks;

  const int BH = gridDim.x / n_qblk;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qblk - 1 - blockIdx.x / BH) * kFlashBQ;   // longest causal rows first
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const size_t kbase = (size_t)b * S * kstride + (size_t)hk * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;   // rows ty + 16 i, cols tx + 16 j

  stage<T, D>(qs, q + ((size_t)b * S + q0) * qstride + (size_t)h * D, qstride,
              min(kFlashBQ, S - q0));

  float m[4], l[4], acc[4][4 * CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kFlashNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CV; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kFlashBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kFlashBK) {
    __syncthreads();   // the previous block's P and V are read
    const int valid = min(kFlashBK, S - k0);
    stage<T, D>(ks, k + kbase + (size_t)k0 * kstride, kstride, valid);
    stage<T, D>(vs, v + kbase + (size_t)k0 * kstride, kstride, valid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(qs + (ty + 16 * i) * PD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = load4(ks + (tx + 16 * j) * PD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = fmaf(a[i].x, c[j].x, s[i][j]);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          s[i][j] = fmaf(a[i].w, c[j].w, t);
        }
    }
    __syncthreads();   // every score is in registers: P takes the K tile's place

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kFlashNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : kFlashNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kFlashPP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CV; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kFlashBK; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = load4(ps + (ty + 16 * i) * kFlashPP + kk);
        p[i][0] = p4.x;
        p[i][1] = p4.y;
        p[i][2] = p4.z;
        p[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int cv = 0; cv < CV; ++cv) {
          const float4 w = load4(vs + (kk + u) * PD + 64 * cv + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * cv + 0] = fmaf(p[i][u], w.x, acc[i][4 * cv + 0]);
            acc[i][4 * cv + 1] = fmaf(p[i][u], w.y, acc[i][4 * cv + 1]);
            acc[i][4 * cv + 2] = fmaf(p[i][u], w.z, acc[i][4 * cv + 2]);
            acc[i][4 * cv + 3] = fmaf(p[i][u], w.w, acc[i][4 * cv + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + ((size_t)b * S + qpos) * qstride + (size_t)h * D;
#pragma unroll
    for (int cv = 0; cv < CV; ++cv)
      store4(out + 64 * cv + 4 * tx,
             make_float4(acc[i][4 * cv] / den, acc[i][4 * cv + 1] / den,
                         acc[i][4 * cv + 2] / den, acc[i][4 * cv + 3] / den));
  }
}

template <typename T, int D>
static cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                                int S, int Hq, int Hkv, float scale, int causal,
                                cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = sizeof(float) * (kFlashBQ + 2 * kFlashBK) * (D + 4);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qblk = (S + kFlashBQ - 1) / kFlashBQ;
  const long long grid = (long long)n_qblk * B * Hq;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Hq, Hkv, n_qblk, scale, causal);
  return cudaGetLastError();
}

}  // namespace repro_torch

// q, o [B, S, Hq, D]; k, v [B, S, Hkv, D]; all contiguous and 16-byte
// aligned, of one element type (dtype 0 = f32, 1 = bf16).  D must be 64 or
// 128 and Hq a multiple of Hkv.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int Hq, int Hkv, int D, float scale,
                                     int causal, int dtype, void* stream) {
  using namespace repro_torch;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || addr % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    err = launch_flash<float, 64>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st);
  else if (dtype == 0 && D == 128)
    err = launch_flash<float, 128>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && D == 64)
    err = launch_flash<__nv_bfloat16, 64>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st);
  else if (dtype == 1 && D == 128)
    err = launch_flash<__nv_bfloat16, 128>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st);
  return static_cast<int>(err);
}

// Flash-attention forward for Hopper (causal or not), grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:22
// (_flash_kernel, entry flash_attention_pallas at :63).  For each query row
// and head, over the keys in blocks, with f32 running max m, denominator l
// and accumulator acc (m from -1e30, the reference's mask value):
//   s   = (q . k) * scale
//   s   = cap * tanh(s / cap)                         (with a softcap)
//   s   = -1e30 where masked (causal: kpos > qpos; with a sliding window
//         also qpos - kpos >= window)
//   m'  = max(m, max s);  p = exp(s - m');  corr = exp(m - m')
//   l   = l corr + sum p;  acc = acc corr + p V;  m = m'
//   out = acc / max(l, 1e-30), at the input dtype.
// Given non-null m_out and l_out ([B, Hq, Sq] f32), each row's final m and l
// are written too, in natural units on both paths: the residuals that the
// reference's ring attention keeps for its analytic backward
// (src/repro/models/attention.py fwd_rule), and what a hop of the KV ring
// hands to the online-softmax merge of the hops (models/attention.py).
// Null pointers (prefill and serving) skip the stores and change nothing
// else.
//
// The keys may be a span of their own: q is [B, Sq, Hq, d], k and v
// [B, Sk, Hkv, d], and query row i and key j sit at relative distance
// i + delta - j (delta: the position of query row 0 minus that of key 0;
// a ring hop's span of another rank's keys).  Causal masks j > i + delta,
// the window i + delta - j >= window.  A row that sees no key (a span
// wholly above the diagonal, or left of the row's window) ends with o = 0,
// m = -1e30 and l = 0; the mask value alone would leave l counting the
// masked keys.  With Sk = Sq and delta = 0 the kernels compute what they
// computed before the span was split off, to the bit.
//
// The TPU grid is (B*H, S/bq, S/bkv) with the key axis sequential and the
// carries in VMEM scratch; a GPU grid has no sequential axis, so one CTA
// per (batch*head, query block) loops over the key blocks with the carries
// in registers.  A causal CTA stops at the diagonal, key q0 + BQ - 1 +
// delta: blocks wholly above it are never read.  With a window the CTA of
// query block [q0, q0 + BQ) starts at the block of key q0 + delta - window
// + 1: blocks wholly left of every row's window are never read either (at
// S = 32768 and window 4096 a local layer reads about 0.24 of the causal
// square).  A CTA with no block left writes its empty rows and ends.  CTAs
// start with the longest causal rows (a row sees min(i + delta + 1, Sk)
// keys, which grows with i whatever delta is), so the short ones fill the
// tail of the grid (with a window the order no longer sorts by work, and is
// kept), and the query heads of one kv head are adjacent in launch order,
// so their K and V blocks are read from L2.
//
// The window and the softcap are not in the TPU kernel (kernel.py:63 takes
// neither); they are those of the model's blockwise attention, the
// reference's _span_flash (src/repro/models/attention.py:62, the cap at
// :47-48, the mask at :86-87), which this kernel computes for gemma2's
// layers.
//
// Two kernels; the wrapper's flash_path (kernels/flash_attention/ops.py)
// picks one per call, with no fallback between them:
//
// flash_tile_kernel, bf16 at d = 128, on the tensor cores.  At the prefill's
// shape (B 4, S 2048, Hq 32 over Hkv 2, causal) the two products are
// 137.5 GFLOP against 143 MB, so the bound is operations: 0.139 ms at the
// 989 TFLOP/s bf16 peak.  A CTA of 128 query rows of one (batch, head) has
// two consumer warpgroups of 64 rows and a producer warpgroup, which hands
// its registers to them (setmaxnreg: 24 and 240 a thread, where an even
// split gives 168 and the consumers spill).  One producer thread loads Q
// once and streams 128-key blocks of K and V through a 2-stage ring
// with TMA (128-byte swizzle, full/empty mbarriers; zeros past S, so only
// the diagonal, the window's left edge and the tail block are masked).
// Per block, each warpgroup runs S = Q K^T as wgmma with A = Q and B = K,
// both K-major in shared memory; the softmax on the f32 accumulator
// fragment, in the exp2 domain with the scale folded in (and the softcap:
// see below), row max over the 4 lanes that share a row; then O += P V as
// wgmma with A = P from registers and B = V N-major (the
// transpose bit).  P is rounded to bf16 before the PV product, as the TPU
// kernel does (kernel.py:52-53); l sums it unrounded, as there.  The f32
// accumulator fragment of S is the register-A fragment of P without
// shuffles: the k16 slice kk is accumulators 8 kk .. 8 kk + 7, two
// neighbours per bf16x2 word (see for_each_acc_pair in tile_mma.cuh).
// The next block's Q K^T is issued behind the PV product, so a warpgroup's
// tensor work runs back to back and only the softmax leaves a gap, which
// the other warpgroup fills.  Left for later: explicit ping-pong of the two
// warpgroups, overlap of the softmax with the next Q K^T inside one
// warpgroup, persistent CTAs, a rescale skipped where the max did not move,
// and a shared-memory epilogue with coalesced stores.
//
// The softcap's tanh on the tile path: tanh.approx.f32 errs by about 2^-11
// relative, up to 0.025 in a score at cap 50 (2.5 % in a probability, above
// the bf16 bound), so tanh(y) = 1 - 2 / (1 + 2^(2 y log2 e)) through
// ex2.approx and rcp.approx (each within a few ulp: the capped score errs
// by about 1e-5 at cap 50).  In the exp2 domain the whole cap is
//   t log2 e = cap log2 e - (2 cap log2 e) / (1 + 2^(s * 2 scale log2 e / cap))
// one multiply, two MUFU ops and two adds a score, beside the softmax's
// exp2: the cap triples the MUFU work of a score.  The CUDA-core path
// calls the precise tanhf.
//
// flash_attention_kernel, every other call (f32, whose tensor-core product
// would be TF32, d = 64, and d = 224: zamba2-7b's shared attention), on
// CUDA cores: Q, K and V tiles staged in shared memory as f32 rows padded by
// 4 floats (float4 reads without bank conflicts); each of the 256 threads
// holds a 4 x 4 block of the 64 x 64 score tile and the matching 4 rows x
// (d / 16) columns of acc (at d = 224 the last 64-column group is half
// used: lanes past column 224 skip it, no pad is staged); rows reduce
// over 16 lanes with shuffles; P overwrites the K tile once the scores are
// in registers and stays f32 in the PV product, as the model's own
// blockwise attention (models/attention.py _flash_update) keeps it.
//
// Both depart from the TPU kernel in the same two ways:
//   - Any S: the last query and key blocks are masked by bounds, so there
//     is no block-divisor search and no row is dropped.
//   - Grouped heads: q, k, v keep the model's [B, S, H, d] layout, and the
//     CTA of query head h reads kv head h / (Hq / Hkv), so GQA needs no
//     expanded copy of K and V.
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

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

// D of 64 or 128 holds two CTAs an SM (the register cap that gives); at
// D = 224 the f32 tiles take 175 KB of shared memory, so one CTA an SM, and
// the register cap is lifted for acc's 64 floats a thread.
template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads, D <= 128 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
                           int Sk, int delta, int Hq, int Hkv, int n_qblk, float scale,
                           int causal, int window, float softcap) {
  constexpr int PD = D + 4;    // row pitch of Q, K and V in shared memory
  // float4 column groups of acc per thread: thread tx holds columns
  // 64 cv + 4 tx .. + 3.  A D off a multiple of 64 (zamba2's 224) rounds
  // up, and the groups past D (the last group's tx >= (D % 64) / 4) are
  // neither read from V nor stored; their acc stays 0.
  constexpr int CV = (D + 63) / 64;
  constexpr bool kRagged = D % 64 != 0;
  static_assert(D % 4 == 0, "rows move 4 elements at a time");
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
  const size_t kbase = (size_t)b * Sk * kstride + (size_t)hk * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;   // rows ty + 16 i, cols tx + 16 j

  stage<T, D>(qs, q + ((size_t)b * Sq + q0) * qstride + (size_t)h * D, qstride,
              min(kFlashBQ, Sq - q0));

  float m[4], l[4], acc[4][4 * CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kFlashNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CV; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kFlashBQ + delta) : Sk;
  // with a window, the first block holding a key inside row q0's window
  const int k_begin = window > 0 ? max(0, q0 + delta - window + 1) / kFlashBK * kFlashBK : 0;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kFlashBK) {
    __syncthreads();   // the previous block's P and V are read
    const int valid = min(kFlashBK, Sk - k0);
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
      // the keys this row sees: [lo, hi]
      const int lo = window > 0 ? qpos + delta - window + 1 : 0;
      const int hi = causal ? min(qpos + delta, Sk - 1) : Sk - 1;
      float mx = kFlashNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos >= lo && kpos <= hi;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        s[i][j] = ok ? x : kFlashNegInf;
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
          if (kRagged && 64 * cv + 4 * tx >= D) continue;
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
    if (qpos >= Sq) continue;
    // a row that saw no key: its l counted masked keys at the mask value
    const bool empty = m[i] == kFlashNegInf;
    if (m_out != nullptr && tx == 0) {   // the 16 lanes of a row hold the same m and l
      m_out[(size_t)bh * Sq + qpos] = m[i];
      l_out[(size_t)bh * Sq + qpos] = empty ? 0.f : l[i];
    }
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + ((size_t)b * Sq + qpos) * qstride + (size_t)h * D;
#pragma unroll
    for (int cv = 0; cv < CV; ++cv)
      if (!kRagged || 64 * cv + 4 * tx < D)
        store4(out + 64 * cv + 4 * tx,
               empty ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : make_float4(acc[i][4 * cv] / den, acc[i][4 * cv + 1] / den,
                                   acc[i][4 * cv + 2] / den, acc[i][4 * cv + 3] / den));
  }
}

template <typename T, int D>
static cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                                float* m_out, float* l_out, int B, int Sq, int Sk, int delta,
                                int Hq, int Hkv, float scale, int causal, int window,
                                float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = sizeof(float) * (kFlashBQ + 2 * kFlashBK) * (D + 4);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qblk = (Sq + kFlashBQ - 1) / kFlashBQ;
  const long long grid = (long long)n_qblk * B * Hq;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m_out, l_out, Sq, Sk, delta, Hq, Hkv, n_qblk, scale, causal, window,
      softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core path: bf16, d = 128
// ---------------------------------------------------------------------------
constexpr int kTileD = 128;
constexpr int kTileBQ = 128;    // query rows per CTA: two consumer warpgroups of 64
constexpr int kTileBK = 128;    // keys per block: one m64n128 score tile per warpgroup
constexpr int kTileHalf = 64;   // columns of one box: 64 bf16 = one 128-byte swizzle row
constexpr int kTileStages = 2;
constexpr int kTileConsumers = 256;                 // two warpgroups
constexpr int kTileThreads = kTileConsumers + 128;  // + the producer warpgroup
// registers per thread after setmaxnreg: 168 each at launch (65536 / 384,
// rounded to 8), 24 + 2 x 240 = 3 x 168 after
constexpr int kTileProducerRegs = 24;
constexpr int kTileConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FlashKV {
  __nv_bfloat16 k[2][kTileBK * kTileHalf];   // [d half][key][64 d], 16 KB a box
  __nv_bfloat16 v[2][kTileBK * kTileHalf];
};

struct FlashSmem {
  __nv_bfloat16 q[2][kTileBQ * kTileHalf];   // [d half][query row][64 d]
  FlashKV kv[kTileStages];                   // every box starts 1024-byte aligned
  uint64_t q_full;
  uint64_t full[kTileStages];
  uint64_t empty[kTileStages];
};

// the ring, Q, the barriers, and slack to align them to the swizzle's 1024 bytes
constexpr size_t kTileSmemBytes = sizeof(FlashSmem) + 1024;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Consumer thread t of warpgroup wg holds, of its warpgroup's 64 x 128
// tiles (scores and acc alike), rows r = 16 (t / 32) + (t % 32) / 4 and
// r + 8 at columns 8 j + 2 (t % 4) + {0, 1}: accumulators 4 j + {0, 1} are
// row r, 4 j + {2, 3} row r + 8 (wgmma's m64nN f32 fragment).
//
// kCap: a softcap.  Without it a score goes to the exp2 domain as s *
// scale_log2 (scale log2 e); with it as cap_log2 - 2 cap_log2 / (1 +
// 2^(s * cap_in)), cap_in = 2 scale log2 e / cap, cap_log2 = cap log2 e.
// window > 0: a sliding window of that many keys (0: none).  Query rows
// are [0, Sq), keys [0, Sk), at relative distance i + delta - j.
template <bool kCap>
__global__ void __launch_bounds__(kTileThreads, 1)
    flash_tile_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk,
                      int delta, int Hq, int Hkv, int n_qblk, float scale_log2, int causal,
                      int window, float cap_in, float cap_log2) {
  extern __shared__ uint8_t flash_smem_raw[];
  const uint32_t raw = smem_addr(flash_smem_raw);
  FlashSmem& sm = *reinterpret_cast<FlashSmem*>(flash_smem_raw + (1024 - raw % 1024) % 1024);

  const int BH = gridDim.x / n_qblk;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qblk - 1 - blockIdx.x / BH) * kTileBQ;   // longest causal rows first
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int n_blk = (max(0, causal ? min(Sk, q0 + kTileBQ + delta) : Sk) + kTileBK - 1) / kTileBK;
  // with a window, the first block holding a key inside row q0's window
  const int j0 = window > 0 ? max(0, q0 + delta - window + 1) / kTileBK : 0;
  const int tid = threadIdx.x;
  if (j0 >= n_blk) {
    const size_t stride = (size_t)Hq * kTileD;
    // no key block is left to this CTA (a hop's span wholly above the
    // diagonal or left of the window): its rows are empty
    for (int i = tid; i < kTileBQ * (kTileD / 8); i += kTileThreads) {
      const int r = q0 + i / (kTileD / 8), c = (i % (kTileD / 8)) * 8;
      if (r < Sq)
        *reinterpret_cast<uint4*>(o + ((size_t)b * Sq + r) * stride + (size_t)h * kTileD + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    if (m_out != nullptr)
      for (int r = q0 + tid; r < min(Sq, q0 + kTileBQ); r += kTileThreads) {
        m_out[(size_t)bh * Sq + r] = kFlashNegInf;
        l_out[(size_t)bh * Sq + r] = 0.f;
      }
    return;
  }
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < kTileStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kTileConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTileConsumers) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kTileProducerRegs));
    if (tid == kTileConsumers) {
      mbar_expect_tx(&sm.q_full, sizeof(sm.q));
      for (int half = 0; half < 2; ++half)
        tma_load_3d(sm.q[half], &qmap, &sm.q_full, h * kTileD + half * kTileHalf, q0, b);
      int stage = 0;
      unsigned phase = 0;
      for (int j = j0; j < n_blk; ++j) {
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        FlashKV& kv = sm.kv[stage];
        mbar_expect_tx(&sm.full[stage], sizeof(FlashKV));
        for (int half = 0; half < 2; ++half) {
          const int col = hk * kTileD + half * kTileHalf;
          tma_load_3d(kv.k[half], &kmap, &sm.full[stage], col, j * kTileBK, b);
          tma_load_3d(kv.v[half], &vmap, &sm.full[stage], col, j * kTileBK, b);
        }
        if (++stage == kTileStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kTileConsumerRegs));
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4, row1 = row0 + 8;
    const int col = (lane % 4) * 2;
    // the keys rows row0 and row1 see: [lo, hi] (one range test a score in
    // a masked block, whatever mask is on)
    const int lo0 = window > 0 ? row0 + delta - window + 1 : 0;
    const int lo1 = window > 0 ? row1 + delta - window + 1 : 0;
    const int hi0 = causal ? min(row0 + delta, Sk - 1) : Sk - 1;
    const int hi1 = causal ? min(row1 + delta, Sk - 1) : Sk - 1;
    float s[64], acc[64];
    uint32_t p[kTileBK / 16][4];   // P's register-A fragments, one per 16 keys
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m0 = kFlashNegInf, m1 = kFlashNegInf, l0 = 0.f, l1 = 0.f;   // l: this thread's columns

    // S = Q K^T into s.  A: this warpgroup's 64 query rows; B: the block's
    // 128 keys.  Both K-major: d advances 16 elements (32 bytes) inside a
    // swizzle row, a box per 64 d; 8-row groups 1024 bytes apart.
    auto scores = [&](const FlashKV& kv) {
#pragma unroll
      for (int ks = 0; ks < kTileD / 16; ++ks) {
        const uint64_t da =
            sw128_desc(sm.q[ks / 4] + wg * 64 * kTileHalf + (ks % 4) * 16, 16, 1024);
        const uint64_t db = sw128_desc(kv.k[ks / 4] + (ks % 4) * 16, 16, 1024);
        wgmma_ss_m64n128k16<0>(s, da, db, ks > 0);
      }
      wgmma_commit();
    };

    // a raw score into the exp2 domain, capped with kCap (see above)
    auto exp2_score = [&](float x) {
      if constexpr (kCap)
        return fmaf(rcp(1.f + ex2(x * cap_in)), -2.f * cap_log2, cap_log2);
      else
        return x * scale_log2;
    };

    // Block j's softmax on s: P into p, acc rescaled.  Scores go to the exp2
    // domain; masked only where the block passes the end of Sk, this
    // warpgroup's diagonal or the left edge of its last row's window.
    auto softmax = [&](int j) {
      const int k0 = j * kTileBK, wrow = q0 + wg * 64 + delta;
      const bool masked = k0 + kTileBK > Sk || (causal && k0 + kTileBK - 1 > wrow) ||
                          (window > 0 && k0 + window <= wrow + 63);
      float mx0 = kFlashNegInf, mx1 = kFlashNegInf;
#pragma unroll
      for (int jj = 0; jj < kTileBK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t0 = exp2_score(s[4 * jj + e]), t1 = exp2_score(s[4 * jj + 2 + e]);
          if (masked) {
            const int kpos = k0 + 8 * jj + col + e;
            if (kpos < lo0 || kpos > hi0) t0 = kFlashNegInf;
            if (kpos < lo1 || kpos > hi1) t1 = kFlashNegInf;
          }
          s[4 * jj + e] = t0;
          s[4 * jj + 2 + e] = t1;
          mx0 = fmaxf(mx0, t0);
          mx1 = fmaxf(mx1, t1);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTileBK / 16; ++kk) {
        // accumulators 8 kk .. 8 kk + 7 are keys 16 kk .. 16 kk + 15: rows
        // r, r + 8, r, r + 8 in pairs, the A fragment's a0 .. a3
        float e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = ex2(s[8 * kk + i] - ((i & 2) ? mn1 : mn0));
        sum0 += (e[0] + e[1]) + (e[4] + e[5]);
        sum1 += (e[2] + e[3]) + (e[6] + e[7]);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16x2(e[2 * i], e[2 * i + 1]);
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int jj = 0; jj < kTileD / 8; ++jj) {
        acc[4 * jj] *= c0;
        acc[4 * jj + 1] *= c0;
        acc[4 * jj + 2] *= c1;
        acc[4 * jj + 3] *= c1;
      }
    };

    // O += P V.  B: V N-major, keys advance 16 rows (2048 bytes) per step;
    // the two 64-column halves of d 16 KB apart (leading offset), 8-key
    // groups 1024 bytes apart (stride offset).  The fence also covers the
    // scores issued behind it.
    auto pv = [&](const FlashKV& kv) {
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTileBK / 16; ++kk)
        wgmma_rs_m64n128k16(
            acc, p[kk], sw128_desc(kv.v[0] + kk * 16 * kTileHalf, sizeof(kv.v[0]), 1024), 1);
      wgmma_commit();
    };

    // every product in flight done, then the stage goes back to the producer
    auto retire = [&](int stage) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(acc);
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < kTileBK / 16; ++kk) fence_regs(p[kk]);
      mbar_arrive(&sm.empty[stage]);
    };

    mbar_wait(&sm.q_full, 0);
    mbar_wait(&sm.full[0], 0);
    __syncwarp();   // wgmma's .aligned forms need the warp converged
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    scores(sm.kv[0]);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(s);
    int stage = 0;
    unsigned phase = 0;
    // the next block's scores go in behind each PV product, so a
    // warpgroup's tensor work runs back to back; the last block is peeled
    // off, so no wgmma is issued under a condition
    for (int j = j0; j + 1 < n_blk; ++j) {
      softmax(j);
      pv(sm.kv[stage]);
      const int next = stage + 1 == kTileStages ? 0 : stage + 1;
      const unsigned next_phase = next == 0 ? phase ^ 1u : phase;
      mbar_wait(&sm.full[next], next_phase);
      __syncwarp();
      scores(sm.kv[next]);
      retire(stage);
      stage = next;
      phase = next_phase;
    }
    softmax(n_blk - 1);
    pv(sm.kv[stage]);
    retire(stage);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    // a row that saw no key keeps the mask value as its m; its l counted the
    // masked keys, and it is empty
    const bool empty0 = m0 == kFlashNegInf, empty1 = m1 == kFlashNegInf;
    if (m_out != nullptr && lane % 4 == 0) {
      // m is in the exp2 domain of scale_log2; back to natural units
      const size_t base = (size_t)bh * Sq;
      if (row0 < Sq) {
        m_out[base + row0] = empty0 ? m0 : m0 * kLn2;
        l_out[base + row0] = empty0 ? 0.f : l0;
      }
      if (row1 < Sq) {
        m_out[base + row1] = empty1 ? m1 : m1 * kLn2;
        l_out[base + row1] = empty1 ? 0.f : l1;
      }
    }
    const float inv0 = empty0 ? 0.f : 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = empty1 ? 0.f : 1.f / fmaxf(l1, 1e-30f);
    const size_t stride = (size_t)Hq * kTileD;
    __nv_bfloat16* out0 = o + ((size_t)b * Sq + row0) * stride + (size_t)h * kTileD + col;
    __nv_bfloat16* out1 = out0 + 8 * stride;
#pragma unroll
    for (int jj = 0; jj < kTileD / 8; ++jj) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj] * inv0, acc[4 * jj + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj + 2] * inv1, acc[4 * jj + 3] * inv1);
    }
  }
}

template <bool kCap>
static cudaError_t launch_flash_tile(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                     const CUtensorMap& vmap, void* o, float* m_out,
                                     float* l_out, int B, int Sq, int Sk, int delta, int Hq,
                                     int Hkv, float scale, int causal, int window, float softcap,
                                     cudaStream_t stream) {
  auto kernel = flash_tile_kernel<kCap>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTileSmemBytes));
  if (err != cudaSuccess) return err;
  const int n_qblk = (Sq + kTileBQ - 1) / kTileBQ;
  const long long grid = (long long)n_qblk * B * Hq;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  const float cap_in = kCap ? 2.f * scale * kLog2e / softcap : 0.f;
  kernel<<<(unsigned)grid, kTileThreads, kTileSmemBytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), m_out, l_out, Sq, Sk, delta, Hq, Hkv,
      n_qblk, scale * kLog2e, causal, window, cap_in, softcap * kLog2e);
  return cudaGetLastError();
}

static cudaError_t launch_flash_tile(const void* q, const void* k, const void* v, void* o,
                                     float* m_out, float* l_out, int B, int Sq, int Sk,
                                     int delta, int Hq, int Hkv, float scale, int causal,
                                     int window, float softcap, cudaStream_t stream) {
  // q and o as [B][Sq][Hq * d], k and v as [B][Sk][Hkv * d]: a box is 128
  // rows of one 64-column half of one head; rows past each span read zeros
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = make_tile_map(&qmap, q, (uint64_t)Hq * kTileD, Sq, B, kTileHalf, kTileBQ);
  if (err == cudaSuccess)
    err = make_tile_map(&kmap, k, (uint64_t)Hkv * kTileD, Sk, B, kTileHalf, kTileBK);
  if (err == cudaSuccess)
    err = make_tile_map(&vmap, v, (uint64_t)Hkv * kTileD, Sk, B, kTileHalf, kTileBK);
  if (err != cudaSuccess) return err;
  return softcap > 0.f
             ? launch_flash_tile<true>(qmap, kmap, vmap, o, m_out, l_out, B, Sq, Sk, delta, Hq,
                                       Hkv, scale, causal, window, softcap, stream)
             : launch_flash_tile<false>(qmap, kmap, vmap, o, m_out, l_out, B, Sq, Sk, delta,
                                        Hq, Hkv, scale, causal, window, softcap, stream);
}

}  // namespace repro_torch

// q, o [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D]; all contiguous and 16-byte
// aligned, of one element type (dtype 0 = f32, 1 = bf16).  D must be 64,
// 128 or 224 and Hq a multiple of Hkv.  Query row i and key j are at relative
// distance i + delta - j.  m and l: [B, Hq, Sq] f32 softmax statistics,
// both null (none written) or both given.  window: a sliding window of that
// many keys (0 = none); softcap: cap * tanh(s / cap) on every score (0 =
// none).  Returns a cudaError_t code (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     float* m, float* l, int B, int Sq, int Sk, int delta,
                                     int Hq, int Hkv, int D, float scale, int causal, int window,
                                     float softcap, int dtype, void* stream) {
  using namespace repro_torch;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || addr % 16 != 0 ||
      (m == nullptr) != (l == nullptr) || window < 0 || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const auto launch = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, o, m, l, B, Sq, Sk, delta, Hq, Hkv, scale, causal, window,
                         softcap, st);
  };
  if (dtype == 0 && D == 64)
    err = launch(launch_flash<float, 64>);
  else if (dtype == 0 && D == 128)
    err = launch(launch_flash<float, 128>);
  else if (dtype == 1 && D == 64)
    err = launch(launch_flash<__nv_bfloat16, 64>);
  else if (dtype == 1 && D == 128)
    err = launch(launch_flash<__nv_bfloat16, 128>);
  else if (dtype == 0 && D == 224)
    err = launch(launch_flash<float, 224>);
  else if (dtype == 1 && D == 224)
    err = launch(launch_flash<__nv_bfloat16, 224>);
  return static_cast<int>(err);
}

// The tensor-core path: q, o [B, Sq, Hq, 128]; k, v [B, Sk, Hkv, 128]; all
// bf16, contiguous and 16-byte aligned; Hq a multiple of Hkv; delta, m, l,
// window and softcap as above.  Returns a cudaError_t code (0 = launched).
extern "C" int repro_flash_attention_tile(const void* q, const void* k, const void* v, void* o,
                                          float* m, float* l, int B, int Sq, int Sk, int delta,
                                          int Hq, int Hkv, int D, float scale, int causal,
                                          int window, float softcap, void* stream) {
  using namespace repro_torch;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D != kTileD ||
      addr % 16 != 0 || (m == nullptr) != (l == nullptr) || window < 0 || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_flash_tile(q, k, v, o, m, l, B, Sq, Sk, delta, Hq, Hkv, scale,
                                            causal, window, softcap,
                                            static_cast<cudaStream_t>(stream)));
}

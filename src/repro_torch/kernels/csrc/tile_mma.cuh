// Tensor-core tile loop shared by the GEMM kernel and the fused GEMM +
// AllReduce kernel's tile path (Hopper, sm_90a; bf16 in, f32 accumulators).
//
// One CTA computes one [kMmaBM, kMmaBN] output tile at a time,
// acc = x[row0 : row0 + 128, :] @ w[:, col0 : col0 + 128], and hands the f32
// accumulators to the caller's epilogue.  This is the [B, tile_k] x
// [tile_k, tile_n] jnp.dot of the TPU kernels (src/repro/kernels/gemm/kernel.py:19,
// src/repro/kernels/fused_gemv_allreduce/kernel.py:59) on Hopper's tensor
// cores: the K grid axis becomes a ring of shared-memory stages.
//
// Roles: warps 0-7 are two consumer warpgroups, each issuing
// wgmma.mma_async m64n128k16 on its 64 rows; warp 8 is the producer, one
// thread of which keeps kMmaStages stages in flight with TMA tensor loads.
// A stage is x's [128 rows, 64 k] box (K-major, the A layout wgmma takes)
// and w's [64 k, 128 n] panel as two [64 k, 64 n] boxes (N-major: w stays in
// its [K, N] row-major layout and reaches wgmma through the transpose bit,
// so the wrapper never copies it).  All boxes use the 128-byte swizzle, the
// layout wgmma reads without bank conflicts.  A full barrier per stage
// counts the bytes TMA delivers; an empty barrier per stage counts the
// consumer threads done reading it.  TMA fills out-of-range elements with
// zeros, so ragged M, N and K need no masking in the loop; the epilogue skips
// what lies past the output.  TMA needs K % 8 == 0 and N % 8 == 0 (16-byte
// row strides) and 16-byte-aligned bases; the wrappers send other shapes to
// the CUDA-core kernels.
//
// The tensor maps are 3-D, [depth][rows][cols], so one map covers the
// per-rank operands [n, B, K] and [n, K, N] of an emulated world (depth 1
// for a single product); a box never crosses from one rank into the next.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "common.cuh"

namespace repro_torch {

constexpr int kMmaBM = 128;        // rows per tile: two consumer warpgroups of m64
constexpr int kMmaBN = 128;        // columns per tile: one m64n128k16 per warpgroup and k step
constexpr int kMmaBK = 64;         // depth of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int kMmaHalfN = 64;      // columns of one w box (128 bytes)
constexpr int kMmaStages = 4;
constexpr int kMmaConsumerThreads = 256;
constexpr int kMmaThreads = kMmaConsumerThreads + 32;  // + the producer warp
constexpr int kMmaAccs = kMmaBN / 2;                   // f32 accumulators per consumer thread

struct MmaStage {
  __nv_bfloat16 a[kMmaBM * kMmaBK];  // x box: [128 rows][64 k]
  __nv_bfloat16 b[kMmaBK * kMmaBN];  // w boxes: [2 halves][64 k][64 n]
};

struct MmaSmem {
  MmaStage stage[kMmaStages];  // each 32 KB, so every box starts 1024-byte aligned
  uint64_t full[kMmaStages];
  uint64_t empty[kMmaStages];
};

// dynamic shared memory per CTA: the ring, its barriers, and slack to align
// the ring to the swizzle pattern's 1024 bytes
constexpr size_t kMmaSmemBytes = sizeof(MmaSmem) + 1024;

struct TileCoord {
  int rank;  // depth coordinate of the tensor maps
  int row0;  // first row of x and of the output tile
  int col0;  // first column of w and of the output tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the barrier's phase of parity `parity` has completed.  A stage
// that never fills (a refused copy, a wrong byte count) is a fault: trap
// after 4 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint64_t t0 = 0;
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 0) t0 = global_ns();
    else if ((polls & 1023u) == 0 && global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4) | (uint64_t((lbo >> 4) & 0x3FFFu) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// d[64 x 128] += a[64 x 16] (K-major) @ b[16 x 128] (N-major: transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kMmaAccs], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_accs(float (&d)[kMmaAccs]) {
#pragma unroll
  for (int i = 0; i < kMmaAccs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 256 consumer threads only (the producer warp runs its own loop).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kMmaConsumerThreads) : "memory");
}

// Calls fn(r, c, v0, v1) for each pair of neighbouring columns (c, c + 1)
// that consumer thread t of warpgroup wg holds, (r, c) relative to the tile
// origin, v0 and v1 the accumulators themselves.  wgmma's m64nN f32
// fragment: warp w of the warpgroup owns rows 16 w .. 16 w + 15; lane l
// holds rows l / 4 and l / 4 + 8 of them, at columns 8 j + 2 (l % 4) +
// {0, 1} for j = 0 .. N / 8 - 1, in registers 4 j + {0, 1} and 4 j + {2, 3}.
// The loop is unrolled (registers cannot be indexed at run time), so keep fn
// short: a loop inside fn is copied 64 times.
template <typename Fn>
__device__ __forceinline__ void for_each_acc_pair(float (&acc)[kMmaAccs], int wg, int t, Fn fn) {
  const int warp = t / 32, lane = t % 32;
  const int r = wg * 64 + warp * 16 + lane / 4;
  const int c = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < kMmaBN / 8; ++j) {
    fn(r, j * 8 + c, acc[4 * j], acc[4 * j + 1]);
    fn(r + 8, j * 8 + c, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The CTA's tiles are units blockIdx.x, blockIdx.x + gridDim.x, ... below
// num_units; coords(u) places unit u, and every consumer thread calls
// epi(u, coords(u), acc, wg, t) with the finished tile (the epilogue may
// synchronise the consumers with consumer_sync()).  Needs kMmaThreads
// threads and kMmaSmemBytes of dynamic shared memory.  Returns in every
// thread; the producer warp returns once its last copy is issued.
template <typename Coords, typename Epilogue>
__device__ __forceinline__ void mma_tile_loop(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                              int k_tiles, int num_units, Coords coords,
                                              Epilogue epi) {
  extern __shared__ uint8_t mma_smem_raw[];
  const uint32_t raw = smem_addr(mma_smem_raw);
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(mma_smem_raw + (1024 - raw % 1024) % 1024);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kMmaStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kMmaConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kMmaConsumerThreads) {
    if (tid != kMmaConsumerThreads) return;
    int stage = 0;
    unsigned phase = 0;
    for (int u = blockIdx.x; u < num_units; u += gridDim.x) {
      const TileCoord tc = coords(u);
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        MmaStage& st = sm.stage[stage];
        mbar_expect_tx(&sm.full[stage], sizeof(MmaStage));
        tma_load_3d(st.a, xmap, &sm.full[stage], kt * kMmaBK, tc.row0, tc.rank);
        tma_load_3d(st.b, wmap, &sm.full[stage], tc.col0, kt * kMmaBK, tc.rank);
        tma_load_3d(st.b + kMmaBK * kMmaHalfN, wmap, &sm.full[stage], tc.col0 + kMmaHalfN,
                    kt * kMmaBK, tc.rank);
        if (++stage == kMmaStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  const int wg = tid / 128, t = tid % 128;
  int stage = 0;
  unsigned phase = 0;
  float acc[kMmaAccs];
  for (int u = blockIdx.x; u < num_units; u += gridDim.x) {
#pragma unroll
    for (int i = 0; i < kMmaAccs; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&sm.full[stage], phase);
      __syncwarp();  // wgmma's .aligned forms need the warp converged
      const MmaStage& st = sm.stage[stage];
      fence_accs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kMmaBK / 16; ++ks) {
        // A: this warpgroup's 64 rows, k advanced 16 elements (32 bytes)
        // inside the swizzle row; 8-row groups 1024 bytes apart.  B: k
        // advanced 16 rows (2048 bytes); the two 64-column halves 8 KB apart
        // (leading offset), 8-row groups 1024 bytes apart (stride offset).
        const uint64_t da = sw128_desc(st.a + wg * 64 * kMmaBK + ks * 16, 16, 1024);
        const uint64_t db = sw128_desc(st.b + ks * 16 * kMmaHalfN,
                                       kMmaBK * kMmaHalfN * sizeof(__nv_bfloat16), 1024);
        wgmma_m64n128k16(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_accs(acc);
      // the previous stage's products are done once at most this one is in flight
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (prev >= 0) mbar_arrive(&sm.empty[prev]);
      prev = stage;
      if (++stage == kMmaStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_accs(acc);
    mbar_arrive(&sm.empty[prev]);
    epi(u, coords(u), acc, wg, t);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime's entry-point query, so the library needs no -lcuda.
static cudaError_t tensor_map_encoder(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A bf16 tensor map over a contiguous [depth][rows][cols] array with boxes of
// [1][box_rows][box_cols], 128-byte swizzle, zeros outside the array.
static cudaError_t make_tile_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                                 uint64_t depth, uint32_t box_cols, uint32_t box_rows) {
  EncodeTiledFn encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols * sizeof(__nv_bfloat16), rows * cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of x [depth][M][K] and w [depth][K][N] for mma_tile_loop.
static cudaError_t make_mma_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                                 const void* w, int depth, int M, int K, int N) {
  cudaError_t err = make_tile_map(xmap, x, K, M, depth, kMmaBK, kMmaBM);
  if (err == cudaSuccess) err = make_tile_map(wmap, w, N, K, depth, kMmaHalfN, kMmaBK);
  return err;
}

// What mma_tile_loop can take: bf16 rows of 16-byte multiples at 16-byte
// aligned bases.
static bool mma_shape_ok(const void* x, const void* w, int K, int N) {
  return K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// Lets `kernel` take kMmaSmemBytes of dynamic shared memory (above the
// default 48 KB).
template <typename Kernel>
static cudaError_t allow_mma_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMmaSmemBytes));
}

}  // namespace repro_torch

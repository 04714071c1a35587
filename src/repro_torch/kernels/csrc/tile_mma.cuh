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
// The mbarrier, TMA and wgmma primitives are hopper.cuh's.
#pragma once

#include "hopper.cuh"

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
  int rank;        // depth coordinate of the tensor maps
  int row0;        // first row of x and of the output tile
  int col0;        // first column of w and of the output tile
  int wrank = -1;  // depth coordinate of w's maps where it is not x's (-1: rank)
};

// d[64 x 128] += a[64 x 16] (K-major) @ b[16 x 128] (N-major: transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kMmaAccs], uint64_t da, uint64_t db) {
  wgmma_ss_m64n128k16<1>(d, da, db, 1);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_accs(float (&d)[kMmaAccs]) { fence_regs(d); }

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
// With wmap_hi the tile's second 64 columns come from that map at the same
// columns as the first (accumulators 0-63 hold x wmap, 64-127 x wmap_hi:
// two products of one x panel in one pass, as the expert FFN's gate and up).
template <typename Coords, typename Epilogue>
__device__ __forceinline__ void mma_tile_loop(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                              int k_tiles, int num_units, Coords coords,
                                              Epilogue epi,
                                              const CUtensorMap* wmap_hi = nullptr) {
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
      const int wd = tc.wrank < 0 ? tc.rank : tc.wrank;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        MmaStage& st = sm.stage[stage];
        mbar_expect_tx(&sm.full[stage], sizeof(MmaStage));
        tma_load_3d(st.a, xmap, &sm.full[stage], kt * kMmaBK, tc.row0, tc.rank);
        tma_load_3d(st.b, wmap, &sm.full[stage], tc.col0, kt * kMmaBK, wd);
        if (wmap_hi != nullptr)
          tma_load_3d(st.b + kMmaBK * kMmaHalfN, wmap_hi, &sm.full[stage], tc.col0, kt * kMmaBK,
                      wd);
        else
          tma_load_3d(st.b + kMmaBK * kMmaHalfN, wmap, &sm.full[stage], tc.col0 + kMmaHalfN,
                      kt * kMmaBK, wd);
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

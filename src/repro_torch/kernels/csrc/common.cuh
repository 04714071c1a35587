// Shared by the Hopper (sm_90a) kernels: element conversions and the peer
// protocol of the device-initiated kernels.
//
// Peer protocol: a sender stores its payload into the receiver's buffer,
// fences, and publishes a flag word holding the call's epoch with a release
// store at system scope (the paper's sliceRdy); the receiver polls with
// acquire loads until the word holds the epoch.  Epochs increase per call,
// so flags are never reset.  Peer buffers come in by-value pointer tables,
// so one kernel serves an emulated world (gridDim.y = n_dev ranks in one
// launch on one card, pointers into per-rank slices of single allocations)
// and, later, real peers whose pointers come from symmetric memory.  CTAs
// that wait on other CTAs need all of them resident: such grids are sized
// from the occupancy (resident_ctas, cached) and launched cooperatively, which
// refuses a grid that does not fit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace repro_torch {

constexpr int kMaxDev = 8;  // size of the peer pointer tables

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_release(unsigned* f, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(f), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  return v;
}

// Spins until *f == epoch.  A flag that never arrives is a protocol fault;
// trap after ~2^24 polls (seconds) instead of hanging the card.
__device__ __forceinline__ void wait_flag(const unsigned* f, unsigned epoch) {
  for (unsigned polls = 0; load_acquire(f) != epoch; ++polls) {
    if (polls > (1u << 24)) __trap();
    __nanosleep(128);
  }
}

// The CTAs of `kernel` that fit on the card at once with `dyn_smem` bytes of
// dynamic shared memory each, split evenly over the ranks of one launch; 0
// when not even one CTA per rank fits.  The occupancy query is made once per
// (kernel, device, threads, shared memory) and cached: a plan-cached launch
// should cost no more than the launch.
inline cudaError_t resident_ctas_total(const void* kernel, int threads, size_t dyn_smem,
                                       int* total) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int total;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == kernel && e.dev == dev && e.threads == threads && e.smem == dyn_smem) {
      *total = e.total;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dyn_smem);
  if (err != cudaSuccess) return err;
  *total = per_sm * sms;
  if (used < 64) cache[used++] = Entry{kernel, dev, threads, dyn_smem, *total};
  return cudaSuccess;
}

template <typename Kernel>
static cudaError_t resident_ctas(Kernel kernel, int threads, int ranks_in_launch, int* per_rank,
                                 size_t dyn_smem = 0) {
  int total = 0;
  const cudaError_t err =
      resident_ctas_total(reinterpret_cast<const void*>(kernel), threads, dyn_smem, &total);
  *per_rank = err == cudaSuccess ? total / ranks_in_launch : 0;
  return err;
}

}  // namespace repro_torch

// Shared pieces of the matvec kernels (dense_matvec.cu, band_matvec.cu):
// 16-byte vectors, Hopper's mbarriers and 1D bulk copies (cp.async.bulk),
// and the launcher's cached device facts.
//
// The stage ring both kernels use: one producer thread issues bulk copies
// from device memory into `kStages` shared-memory stages; each stage has a
// `full` barrier (one arrival from the producer, plus the copy's bytes) and
// an `empty` barrier (one arrival from each consumer warp).  Stage k of the
// stream lives in slot k % kStages; its round is k / kStages, and the
// barrier phase a waiter asks for is the round's parity (the producer's
// first wait on an empty slot passes at once, so it asks for the other
// parity).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace tpdlp {

constexpr int kWarp = 32;
constexpr int kMaxDevices = 64;

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
  __device__ static float dot_acc(const float4 a, const float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
    return acc;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
  __device__ static double dot_acc(const double2 a, const double2 b,
                                   double acc) {
    acc = fma(a.x, b.x, acc);
    acc = fma(a.y, b.y, acc);
    return acc;
  }
};

// The fixed butterfly that ends a row: every lane gets the warp's sum.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// Orders this thread's plain shared-memory stores before later bulk copies
// into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory into shared memory; the copy completes `bytes`
// transactions on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The current device's SM count (cached per device), or -1 on error.
inline int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return -1;
  }
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      return -1;
    }
    cached[dev] = sms;
  }
  return cached[dev];
}

// Opt `kernel` in to `bytes` of dynamic shared memory on the current device
// (once per device and size).
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                               int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

}  // namespace tpdlp

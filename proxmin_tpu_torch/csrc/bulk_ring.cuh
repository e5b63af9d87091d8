// Helpers of the shared-memory ring that K1 (nmf_pgm_step.cu), K2 and K5
// (nmf_adaprox_step.cu) and K3 (nmf_grad.cu) stream their input rows
// through: mbarriers, 1-D cp.async.bulk copies from global to shared
// memory, and the float / bfloat16 conversions of the store types.
//
// An edit here changes every kernel library's hash (ops/_build.py folds
// every csrc/*.cuh into it), so no stale library outlives its header.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// Stores v and returns the value stored, as the next iteration reads it.
__device__ __forceinline__ float store(float* p, long long i, float v) {
  p[i] = v;
  return v;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, long long i,
                                       float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  p[i] = b;
  return __bfloat162float(b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace

// Device building blocks shared by every kernel source but nms.cu (the
// forward attention kernel is attention_fwd.cuh, K2's GEMM gemm.cuh, K6's
// convs conv.cuh): bf16 helpers and cp.async wrappers (flash_attention.cu's
// f32 kernel). Products run on the tensor cores in bf16 with f32
// accumulation. bf16 x bf16 products are exact in f32, so against the
// reference's f32 arithmetic only the order of the sums differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kuzu {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf(const bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf(const float x) { return __float2bfloat16_rn(x); }
// bf16 + bf16 rounded to bf16, as an elementwise add in bf16 does.
__device__ __forceinline__ bf16 add_bf(const bf16 a, const bf16 b) { return to_bf(bf(a) + bf(b)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// 16-byte copy into shared memory that writes zeros where !valid (source
// size 0); src must still be a valid address.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

}  // namespace kuzu

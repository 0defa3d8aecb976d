// Device building blocks shared by every kernel source but nms.cu (the
// forward attention kernel is attention_fwd.cuh, K2's GEMM gemm.cuh): bf16
// helpers, mma.sync m16n8k16 (fused_c3k2.cu), cp.async and ldmatrix
// wrappers (flash_attention.cu's f32 kernel, fused_c3k2.cu). Products run on
// the tensor cores in bf16 with f32 accumulation. bf16 x bf16 products are
// exact in f32, so against the reference's f32 arithmetic only the order of
// the sums differs.
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

// d += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), d f32.
// Fragment layout (lane = 4 g + t): a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------ cp.async, ldmatrix

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

// Four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 address the rows
// of matrix i); lane 4g + t receives row g, columns 2t and 2t + 1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The same, transposed: lane 4g + t receives rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

}  // namespace kuzu

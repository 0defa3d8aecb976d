// Device building blocks shared by area_attention.cu, area_attention_bwd.cu,
// fused_ablock.cu, flash_attention.cu and fused_c3k2.cu (the forward
// attention kernel itself is attention_fwd.cuh):
//
//   bf16 helpers, mma.sync m16n8k16, cp.async and ldmatrix wrappers;
//   rows_gemm: acc = A W + bias for a tile of 32 rows, A (bf16) in shared
//       memory, W (bf16, K x N row-major) streamed from global memory (it
//       stays in L2: every block reads the same weights) through a two-stage
//       cp.async pipeline, the epilogue given as a functor.
// Products run on the tensor cores in bf16 with f32 accumulation. bf16 x bf16
// products are exact in f32, so against the reference's f32 arithmetic only
// the order of the sums differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace kuzu {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__device__ __forceinline__ float bf(const bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf(const float x) { return __float2bfloat16_rn(x); }
// bf16 + bf16 rounded to bf16, as an elementwise add in bf16 does.
__device__ __forceinline__ bf16 add_bf(const bf16 a, const bf16 b) { return to_bf(bf(a) + bf(b)); }

// Shared memory one block may use on Hopper (227 KB).
constexpr int kSmemLimit = 232448;

// Shared-memory parts start on 128-byte boundaries (WMMA wants 32).
__host__ __device__ inline size_t r128(size_t b) { return (b + 127) / 128 * 128; }

// Row stride of a K_h / V_h tile in shared memory (area_attention_bwd.cu):
// hd + 8 bf16, so the eight rows a warp reads at once fall in different banks.
__host__ __device__ inline int kv_stride(int hd) { return hd + 8; }

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

// ---------------------------------------------------------------- rows_gemm

constexpr int kThreads = 512;                  // GEMM block: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                      // rows per GEMM tile
constexpr int kSlab = 32;                      // rows of W per pipeline stage
constexpr int kMaxStrips = 3;                  // 16-column strips per warp: nn <= 768
// Per-warp f32 staging of two 16x16 accumulator tiles for the epilogues.
constexpr size_t kScratchBytes = (size_t)kWarps * 2 * 256 * 4;

// Shared-memory row stride (elements) of a bf16 tile with `cols` columns:
// 16 bytes of padding move consecutive rows to other banks.
__host__ __device__ inline int tile_ld(int cols) { return cols + 8; }

// Bytes of one W stage (kSlab rows of nn columns); rows_gemm uses two.
__host__ __device__ inline size_t wslab_bytes(int nn) {
  return r128((size_t)kSlab * tile_ld(nn) * 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
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

// Start copying W rows [k0, k0 + kSlab) into a stage (16-byte vectors).
__device__ __forceinline__ void load_slab(bf16* dst, const bf16* __restrict__ w, int k0, int nn) {
  const int per_row = nn / 8, ld = tile_ld(nn);
  for (int i = threadIdx.x; i < kSlab * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    cp_async16(dst + r * ld + c, w + (size_t)(k0 + r) * nn + c);
  }
  cp_async_commit();
}

// acc[r][n] = sum_k a[r * lda + k] * w[k * nn + n] + bias[n] for the 32 rows
// of the tile; epi(r, n, value) is called for r < rows only. a (bf16, lda a
// multiple of 8) is in shared memory; w (bf16, K x nn, 16-byte aligned) is
// streamed through two shared stages of kSlab rows (wbuf, 2 * wslab_bytes(nn)
// bytes) with cp.async, the next stage loading while the tensor cores work on
// the current one. kk % 32 == 0, nn % 16 == 0, nn <= 768. Warp w owns the
// 16-column strips w, w + 16, w + 32 for both 16-row halves and applies the
// epilogue from its scratch tiles.
template <typename Epi>
__device__ void rows_gemm(const bf16* __restrict__ a, int lda, int kk,
                          const bf16* __restrict__ w, int nn,
                          const float* __restrict__ bias, int rows, bf16* wbuf,
                          float* scratch, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strips = nn / 16, ldw = tile_ld(nn);
  const size_t stage = wslab_bytes(nn) / 2;  // elements
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxStrips][2];
#pragma unroll
  for (int m = 0; m < kMaxStrips; ++m) {
    wmma::fill_fragment(acc[m][0], 0.0f);
    wmma::fill_fragment(acc[m][1], 0.0f);
  }
  const int nslabs = kk / kSlab;
  load_slab(wbuf, w, 0, nn);
  for (int sl = 0; sl < nslabs; ++sl) {
    const bf16* cur = wbuf + (sl & 1) * stage;
    if (sl + 1 < nslabs) {
      load_slab(wbuf + ((sl + 1) & 1) * stage, w, (sl + 1) * kSlab, nn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < kSlab / 16; ++kq) {
      const int k0 = sl * kSlab + kq * 16;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, a + k0, lda);
      wmma::load_matrix_sync(a1, a + 16 * lda + k0, lda);
#pragma unroll
      for (int m = 0; m < kMaxStrips; ++m) {
        const int j = warp + m * kWarps;
        if (j < strips) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, cur + kq * 16 * ldw + j * 16, ldw);
          wmma::mma_sync(acc[m][0], a0, b, acc[m][0]);
          wmma::mma_sync(acc[m][1], a1, b, acc[m][1]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two slabs on
  }
  float* sc = scratch + warp * 512;
#pragma unroll
  for (int m = 0; m < kMaxStrips; ++m) {
    const int j = warp + m * kWarps;
    if (j < strips) {
      wmma::store_matrix_sync(sc, acc[m][0], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(sc + 256, acc[m][1], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 512; e += 32) {
        const int r = e / 16, c = j * 16 + e % 16;
        if (r < rows) epi(r, c, sc[e] + bias[c]);
      }
      __syncwarp();
    }
  }
}

}  // namespace kuzu

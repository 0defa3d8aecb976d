// Device building blocks shared by area_attention.cu, area_attention_bwd.cu,
// fused_ablock.cu, flash_attention.cu and fused_c3k2.cu.
//
//   attention_kernel: o = softmax(scale * q_h k_h^T) v_h over head-packed
//       (G, N, C) tensors, one block per (64 query rows, head, group);
//   rows_gemm: acc = A W + bias for a tile of 32 rows, A (bf16) in shared
//       memory, W (bf16, K x N row-major) streamed from global memory (it
//       stays in L2: every block reads the same weights) through a two-stage
//       cp.async pipeline, the epilogue given as a functor.
// Products run on the tensor cores in bf16 with f32 accumulation. bf16 x bf16
// products are exact in f32, so against the reference's f32 arithmetic only
// the order of the sums differs, plus a few f32-rounding-size steps in the
// attention (see attention_kernel).
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

// Shared-memory parts start on 128-byte boundaries (WMMA wants 32).
__host__ __device__ inline size_t r128(size_t b) { return (b + 127) / 128 * 128; }

// ------------------------------------------------------------ attention_kernel

constexpr int kAttnWarps = 4;                  // warps per attention block
constexpr int kAttnRows = 16 * kAttnWarps;     // query rows per block
constexpr int kMaxHd = 64;                     // head width: 16, 32, 48 or 64

// Row stride of K_h / V_h in shared memory: hd + 8 bf16, so the eight rows a
// warp reads at once fall in different banks.
__host__ __device__ inline int kv_stride(int hd) { return hd + 8; }

__host__ __device__ inline size_t attn_smem_bytes(int n, int hd) {
  return r128((size_t)2 * n * kv_stride(hd) * 2);
}

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

// o[g, :, h] = softmax(scale * q[g, :, h] k[g, :, h]^T) v[g, :, h] for query
// rows [64 * blockIdx.x, + 64), head h = blockIdx.y, group g = blockIdx.z;
// heads are packed along the channels (head h owns columns [h*hd, (h+1)*hd)),
// token j of tensor t is at t + (g * n + j) * t_stride. n % 16 == 0,
// hd % 16 == 0, hd <= 64. Shared memory: attn_smem_bytes(n, hd).
//
// K_h and V_h of the group go to shared memory once per block; each warp then
// owns 16 query rows and keeps its scores in registers (FlashAttention-2's
// register layout, two passes over the keys instead of a running rescale):
//   pass 1: S = Q K^T tile by tile, the row maxima m;
//   pass 2: S again, e = exp(scale * S - m), the row sums, and O += e V, e
//           entering the tensor cores as two bf16 parts (e_hi + e_lo, about
//           16 significant bits);
//   o = bf16(O * (1 / sum)).
// Against the reference (q scaled first, p = e / sum, o = p V in f32) the
// scale multiplies the dot product, the normalisation comes after P V as a
// reciprocal multiply, and e carries ~16 bits: differences of f32-rounding
// size before the single bf16 rounding of o.
__global__ void __launch_bounds__(32 * kAttnWarps)
attention_kernel(const bf16* __restrict__ q, int q_stride, const bf16* __restrict__ k,
                 int k_stride, const bf16* __restrict__ v, int v_stride,
                 bf16* __restrict__ o, int o_stride, int n, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, col = h * hd, ks = kv_stride(hd);
  const size_t tok0 = (size_t)blockIdx.z * n;
  bf16* kh = reinterpret_cast<bf16*>(smem);
  bf16* vh = kh + (size_t)n * ks;

  // K_h, V_h -> shared memory, in 16-byte vectors where all is aligned
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k + col) |
                         reinterpret_cast<uintptr_t>(v + col);
  const int vw = (k_stride % 8 == 0 && v_stride % 8 == 0 && addr % 16 == 0) ? 8 : 1;
  const int hv = hd / vw;
  for (int i = threadIdx.x; i < n * hv; i += 32 * kAttnWarps) {
    const int j = i / hv, d = (i - j * hv) * vw;
    const bf16* ksrc = k + (tok0 + j) * k_stride + col + d;
    const bf16* vsrc = v + (tok0 + j) * v_stride + col + d;
    if (vw == 8) {
      *reinterpret_cast<int4*>(kh + j * ks + d) = *reinterpret_cast<const int4*>(ksrc);
      *reinterpret_cast<int4*>(vh + j * ks + d) = *reinterpret_cast<const int4*>(vsrc);
    } else {
      kh[j * ks + d] = *ksrc;
      vh[j * ks + d] = *vsrc;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kAttnRows + warp * 16;
  if (r0 >= n) return;  // no barrier follows
  const int hk = hd / 16;

  // this warp's 16 query rows as A fragments (rows past n are zero)
  uint32_t qa[kMaxHd / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxHd / 16; ++kk) {
    if (kk >= hk) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = col + kk * 16 + 2 * t + 8 * (e >> 1);
      qa[kk][e] = r < n ? *reinterpret_cast<const uint32_t*>(q + (tok0 + r) * q_stride + c)
                        : 0u;
    }
  }

  // S for keys [j0, j0 + 8): rows g, g+8 x keys 2t, 2t+1
  auto score_tile = [&](int j0, float s[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.0f;
    const bf16* krow = kh + (size_t)(j0 + g) * ks + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kMaxHd / 16; ++kk) {
      if (kk >= hk) break;
      mma16816(s, qa[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 16),
               *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = __fmul_rn(s[e], scale);
  };

  // pass 1: row maxima (each row's 4 lanes share them through shuffles)
  float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
  for (int j0 = 0; j0 < n; j0 += 8) {
    float s[4];
    score_tile(j0, s);
    m0 = fmaxf(m0, fmaxf(s[0], s[1]));
    m1 = fmaxf(m1, fmaxf(s[2], s[3]));
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
  }

  // pass 2: e = exp(s - m), sums, O += e V over 16-key blocks
  float acc[kMaxHd / 8][4] = {};
  float sum0 = 0.0f, sum1 = 0.0f;
  for (int j0 = 0; j0 < n; j0 += 16) {
    float s[2][4];
    score_tile(j0, s[0]);
    score_tile(j0 + 8, s[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u][0] = expf(s[u][0] - m0);
      s[u][1] = expf(s[u][1] - m0);
      s[u][2] = expf(s[u][2] - m1);
      s[u][3] = expf(s[u][3] - m1);
      sum0 += s[u][0] + s[u][1];
      sum1 += s[u][2] + s[u][3];
    }
    // the two score tiles' layout is the A layout of e over this key block
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = s[e >> 1][2 * (e & 1)], x1 = s[e >> 1][2 * (e & 1) + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      ahi[e] = *reinterpret_cast<const uint32_t*>(&hi);
      alo[e] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
    }
    const bf16* vrow = vh + (size_t)(j0 + 2 * t) * ks + g;
#pragma unroll
    for (int dt = 0; dt < kMaxHd / 8; ++dt) {
      if (dt >= hd / 8) break;
      const bf16* vp = vrow + dt * 8;
      const uint32_t b0 = pack_bf16(vp[0], vp[ks]);
      const uint32_t b1 = pack_bf16(vp[8 * ks], vp[9 * ks]);
      mma16816(acc[dt], ahi, b0, b1);
      mma16816(acc[dt], alo, b0, b1);
    }
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
  }
  const float inv0 = __frcp_rn(sum0), inv1 = __frcp_rn(sum1);
#pragma unroll
  for (int dt = 0; dt < kMaxHd / 8; ++dt) {
    if (dt >= hd / 8) break;
    const int c = col + dt * 8 + 2 * t;
    if (r0 + g < n)
      *reinterpret_cast<uint32_t*>(o + (tok0 + r0 + g) * o_stride + c) =
          pack_bf16(__fmul_rn(acc[dt][0], inv0), __fmul_rn(acc[dt][1], inv0));
    if (r0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(o + (tok0 + r0 + g + 8) * o_stride + c) =
          pack_bf16(__fmul_rn(acc[dt][2], inv1), __fmul_rn(acc[dt][3], inv1));
  }
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

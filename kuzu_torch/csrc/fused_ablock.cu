// Fused ABlock (area-attention block with its MLP), BN folded into the weights.
//
// Replaces the TPU kernel kuzu/ops/fused_ablock.py::fused_ablock (_kernel).
// For each chunk g of na tokens (one image-area) and C channels:
//     qk  = bf16(x Wqk + bqk)                              (C -> 2C)
//     o_h = bf16(softmax(scale q_h k_h^T) v_h)           per head
//     x1  = x + bf16((o + pe) Wp + bp)                     (bf16 adds)
//     out = x1 + bf16(bf16(silu(x1 W1 + b1)) W2 + b2)
// v and its 5x5 depthwise pe are computed outside and come in as inputs.
//
// Design. On the TPU one grid step holds a whole chunk; here a chunk at
// x-scale (400 x 384 bf16 = 307 KB for x alone) does not fit a block's 227 KB,
// and the attention needs every key of its chunk before any query row can go
// on, so the block is three launches:
//   1. qk_gemm_kernel: qk for all tokens, 32 rows per block;
//   2. attention_fwd_kernel (attention_fwd.cuh, shared with K3 and K5): o
//      for every (128 query rows, head, chunk), wgmma and TMA, online softmax;
//   3. mlp_kernel: per 32-row tile, o + pe, the projection, both residuals
//      and the MLP with the tile's activations in shared memory.
// qk and o pass through global memory (2 x 9.8 MB at yolov12x@640 batch 8).
// Weights stream from L2 through the cp.async pipeline of rows_gemm. Every
// product is this repository's own tensor-core code (WMMA, wgmma). What bounds
// it on this card: operations, about 2 (2C^2 + C^2 + 2 C h) FLOPs per token
// plus 4 na C per token of attention. The bf16 rounding points are those of
// the reference kernel (fused_ablock.py:52-85).

#include "attention_fwd.cuh"

namespace {

using kuzu::bf16;
using kuzu::kRows;
using kuzu::kScratchBytes;
using kuzu::kThreads;
using kuzu::r128;
using kuzu::tile_ld;
using kuzu::wslab_bytes;

// Bytes of a 32-row bf16 activation tile with `cols` columns (padded rows).
__host__ __device__ inline size_t tile_bytes(int cols) {
  return r128((size_t)kRows * tile_ld(cols) * 2);
}

__host__ __device__ inline size_t qk_smem_bytes(int c) {
  return tile_bytes(c) + 2 * wslab_bytes(2 * c) + kScratchBytes;
}

// mlp_kernel's shared memory: the (o + pe) and x1 tiles, the hidden tile,
// the two W stages of rows_gemm, the epilogue scratch.
__host__ __device__ inline size_t mlp_smem_bytes(int c, int hidden) {
  const int wide = c > hidden ? c : hidden;
  return 2 * tile_bytes(c) + tile_bytes(hidden) + 2 * wslab_bytes(wide) + kScratchBytes;
}

__host__ __device__ inline size_t ablock_smem_bytes(int c, int hd, int hidden) {
  const size_t a = kuzu::fwd::attn_fwd_smem_bytes(hd), b = qk_smem_bytes(c),
               m = mlp_smem_bytes(c, hidden);
  return a > b ? (a > m ? a : m) : (b > m ? b : m);
}

__global__ void __launch_bounds__(kThreads)
qk_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqk,
               const float* __restrict__ bqk, bf16* __restrict__ qk, int m, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = tile_ld(c);
  bf16* a = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + tile_bytes(c));
  float* scratch = reinterpret_cast<float*>(smem + tile_bytes(c) + 2 * wslab_bytes(2 * c));
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - row0);
  for (int idx = threadIdx.x; idx < kRows * c; idx += kThreads) {
    const int r = idx / c, col = idx - r * c;
    a[r * lda + col] = r < rows ? x[(size_t)row0 * c + idx] : kuzu::to_bf(0.0f);
  }
  __syncthreads();
  bf16* out = qk + (size_t)row0 * 2 * c;
  kuzu::rows_gemm(a, lda, c, wqk, 2 * c, bqk, rows, wbuf, scratch, [&](int r, int n, float val) {
    out[(size_t)r * 2 * c + n] = kuzu::to_bf(val);
  });
}

__global__ void __launch_bounds__(kThreads)
mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ o,
           const bf16* __restrict__ pe, const bf16* __restrict__ wp,
           const float* __restrict__ bp, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, bf16* __restrict__ out, int m, int c, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = tile_ld(c), ldh = tile_ld(hidden);
  const int wide = c > hidden ? c : hidden;
  bf16* abuf = reinterpret_cast<bf16*>(smem);
  bf16* x1buf = reinterpret_cast<bf16*>(smem + tile_bytes(c));
  bf16* hbuf = reinterpret_cast<bf16*>(smem + 2 * tile_bytes(c));
  bf16* wbuf = reinterpret_cast<bf16*>(smem + 2 * tile_bytes(c) + tile_bytes(hidden));
  float* scratch = reinterpret_cast<float*>(smem + 2 * tile_bytes(c) + tile_bytes(hidden) +
                                            2 * wslab_bytes(wide));
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - row0);

  // a = o + pe (bf16); rows past the end are zeroed
  for (int idx = threadIdx.x; idx < kRows * c; idx += kThreads) {
    const int r = idx / c, col = idx - r * c;
    const size_t at = (size_t)row0 * c + idx;
    abuf[r * lda + col] = r < rows ? kuzu::add_bf(o[at], pe[at]) : kuzu::to_bf(0.0f);
  }
  __syncthreads();
  // x1 = x + bf16(a Wp + bp)
  kuzu::rows_gemm(abuf, lda, c, wp, c, bp, rows, wbuf, scratch, [&](int r, int n, float val) {
    x1buf[r * lda + n] = kuzu::add_bf(x[(size_t)(row0 + r) * c + n], kuzu::to_bf(val));
  });
  for (int idx = threadIdx.x; idx < (kRows - rows) * c; idx += kThreads)
    x1buf[(rows + idx / c) * lda + idx % c] = kuzu::to_bf(0.0f);
  __syncthreads();
  // hmid = bf16(silu(x1 W1 + b1)), silu on the f32 pre-activation
  kuzu::rows_gemm(x1buf, lda, c, w1, hidden, b1, rows, wbuf, scratch,
                  [&](int r, int n, float val) {
                    hbuf[r * ldh + n] = kuzu::to_bf(val * (1.0f / (1.0f + expf(-val))));
                  });
  for (int idx = threadIdx.x; idx < (kRows - rows) * hidden; idx += kThreads)
    hbuf[(rows + idx / hidden) * ldh + idx % hidden] = kuzu::to_bf(0.0f);
  __syncthreads();
  // out = x1 + bf16(hmid W2 + b2)
  kuzu::rows_gemm(hbuf, ldh, hidden, w2, c, b2, rows, wbuf, scratch,
                  [&](int r, int n, float val) {
                    out[(size_t)(row0 + r) * c + n] =
                        kuzu::add_bf(x1buf[r * lda + n], kuzu::to_bf(val));
                  });
}

}  // namespace

extern "C" size_t kuzu_fused_ablock_smem(int c, int heads, int hidden) {
  return ablock_smem_bytes(c, c / heads, hidden);
}

extern "C" int kuzu_fused_ablock(const void* x, const void* v, const void* pe,
                                 const void* wqk, const void* bqk, const void* wp,
                                 const void* bp, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* qk, void* o,
                                 void* out, int g, int na, int c, int heads, int hidden,
                                 float scale, void* stream) {
  if (g <= 0 || na <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = g * na, hd = c / heads;
  // once per kernel: allow any block size up to the limit (each launch
  // still asks only for what its shape needs)
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      qk_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kuzu::kSmemLimit);
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kuzu::kSmemLimit);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr3 != cudaSuccess) return (int)attr3;
  const size_t smem1 = qk_smem_bytes(c);
  cudaError_t err;
  qk_gemm_kernel<<<(m + kRows - 1) / kRows, kThreads, smem1, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqk),
      static_cast<const float*>(bqk), static_cast<bf16*>(qk), m, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const bf16* qkp = static_cast<const bf16*>(qk);
  err = (cudaError_t)kuzu::attention_fwd(qkp, 2 * c, qkp + c, 2 * c, v, c, o, c, g, na, heads,
                                          hd, scale, s);
  if (err != cudaSuccess) return (int)err;

  const size_t smem3 = mlp_smem_bytes(c, hidden);
  mlp_kernel<<<(m + kRows - 1) / kRows, kThreads, smem3, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o), static_cast<const bf16*>(pe),
      static_cast<const bf16*>(wp), static_cast<const float*>(bp),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out),
      m, c, hidden);
  return (int)cudaGetLastError();
}

// Backward of area attention over head-packed (G, N, C) tensors.
//
// Replaces the TPU kernel kuzu/ops/flash_attention.py::area_attention_bwd
// (_area_attn_bwd_kernel): per group g and head h, with S = scale Q K^T and
// P = softmax(S) recomputed from q and k (nothing quadratic is saved by the
// forward),
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
//     dQ = scale dS K,  dK = scale dS^T Q.
//
// Design. On the TPU one grid step holds a whole group in VMEM and the grid
// runs in order. Here one block of 16 warps takes one (head, group): Q_h, K_h,
// V_h and dO_h (N x hd bf16 each, 32 KB at N=400, hd=32) go to shared memory
// once, and the sums over every query row that dK and dV need stay inside
// the block, so no reduction crosses blocks and no atomics are used (the
// result does not depend on the run). Three phases, all on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate):
//   1. per 16-row query tile: the row maximum m, 1/l with l = sum exp(S - m),
//      and D = rowsum(dP o P), kept in shared memory;          -- barrier --
//   2. per 16-row key tile (a warp owns it and keeps dK_j, dV_j in registers):
//      loop over all query tiles, S^T = K_j Q_i^T, P^T, dP^T = V_j dO_i^T,
//      dS^T, then dV_j += P^T dO_i and dK_j += dS^T Q_i;
//   3. per 16-row query tile (as the forward): loop over all key tiles,
//      dQ_i += dS K_j.
// P and dS enter the products as two bf16 parts (hi + lo, about 16
// significant bits), as the forward's e does; Q, K, V and dO are exact bf16.
// Against the reference's f32 arithmetic only the order of the sums and
// these ~16-bit operands differ before the single bf16 rounding of the
// outputs.
// What bounds it on this card: at G=32, N=400, C=384 the operations and the
// bytes bound it alike (~0.02 ms each); the kernel computes S and dP twice
// more than the five products need (phases 1 and 3), has one 16-warp block
// per SM (133 KB of shared memory) and is latency-bound first.

#include "attention.cuh"

namespace kuzu {

constexpr int kBwdWarps = 16;

__host__ __device__ inline size_t bwd_tile_bytes(int n, int hd) {
  return r128((size_t)n * kv_stride(hd) * 2);
}
// Q_h, K_h, V_h, dO_h in bf16 (rows padded to hd + 8), then m, 1/l and D in f32.
__host__ __device__ inline size_t attn_bwd_smem_bytes(int n, int hd) {
  return 4 * bwd_tile_bytes(n, hd) + r128((size_t)3 * n * 4);
}

// rows [0, n) x columns [col, col + hd) of token rows src + (tok0 + j) * stride
__device__ void load_head(bf16* dst, const bf16* __restrict__ src, int stride, size_t tok0,
                          int col, int n, int hd) {
  const int ks = kv_stride(hd);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src + col);
  const int vw = (stride % 8 == 0 && addr % 16 == 0) ? 8 : 1;
  const int hv = hd / vw;
  for (int i = threadIdx.x; i < n * hv; i += 32 * kBwdWarps) {
    const int j = i / hv, d = (i - j * hv) * vw;
    const bf16* s = src + (tok0 + j) * stride + col + d;
    if (vw == 8)
      *reinterpret_cast<int4*>(dst + j * ks + d) = *reinterpret_cast<const int4*>(s);
    else
      dst[j * ks + d] = *s;
  }
}

// A fragments of rows [r0, r0 + 16) of a shared tile (lane = 4 g + t)
template <int HD>
__device__ __forceinline__ void load_a(uint32_t a[HD / 16][4], const bf16* tile, int r0, int g,
                                       int t) {
  const int ks = kv_stride(HD);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = *reinterpret_cast<const uint32_t*>(
          tile + (size_t)(r0 + g + 8 * (e & 1)) * ks + kk * 16 + 2 * t + 8 * (e >> 1));
  }
}

// d = A B^T for A's 16 rows (fragments a) and rows [j0, j0 + 8) of a shared
// tile as the 8 columns: rows g, g+8 x columns 2t, 2t+1
template <int HD>
__device__ __forceinline__ void abt_tile(float d[4], const uint32_t a[HD / 16][4],
                                         const bf16* tile, int j0, int g, int t) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  const bf16* row = tile + (size_t)(j0 + g) * kv_stride(HD) + 2 * t;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    mma16816(d, a[kk], *reinterpret_cast<const uint32_t*>(row + kk * 16),
             *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8));
  }
}

// acc += X Y for X (16 x 16, as two 8-column accumulator tiles x[2][4]) and
// rows [r0, r0 + 16) of a shared tile Y (16 x hd); X in two bf16 parts.
template <int HD>
__device__ __forceinline__ void xy_acc(float acc[HD / 8][4], const float x[2][4],
                                       const bf16* tile, int r0, int g, int t) {
  const int ks = kv_stride(HD);
  uint32_t ahi[4], alo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x0 = x[e >> 1][2 * (e & 1)], x1 = x[e >> 1][2 * (e & 1) + 1];
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
    ahi[e] = *reinterpret_cast<const uint32_t*>(&hi);
    alo[e] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
  }
  const bf16* yrow = tile + (size_t)(r0 + 2 * t) * ks + g;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const bf16* yp = yrow + dt * 8;
    const uint32_t b0 = pack_bf16(yp[0], yp[ks]);
    const uint32_t b1 = pack_bf16(yp[8 * ks], yp[9 * ks]);
    mma16816(acc[dt], ahi, b0, b1);
    mma16816(acc[dt], alo, b0, b1);
  }
}

// rows r0 + g, r0 + g + 8 of out (row stride os) at columns col + [0, hd)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, int os, size_t tok0, int r0, int col,
                                           const float acc[HD / 8][4], float mul, int g,
                                           int t) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = col + dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + (tok0 + r0 + g) * os + c) =
        pack_bf16(__fmul_rn(acc[dt][0], mul), __fmul_rn(acc[dt][1], mul));
    *reinterpret_cast<uint32_t*>(out + (tok0 + r0 + g + 8) * os + c) =
        pack_bf16(__fmul_rn(acc[dt][2], mul), __fmul_rn(acc[dt][3], mul));
  }
}

// One block per (head h = blockIdx.x, group blockIdx.y). q, k, v, do may be
// column slices of wider token tensors (their own row strides); dq, dk, dv
// are written with row stride c. n % 16 == 0; HD is 16, 32, 48 or 64.
template <int HD>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
attention_bwd_kernel(const bf16* __restrict__ q, int q_stride, const bf16* __restrict__ k,
                     int k_stride, const bf16* __restrict__ v, int v_stride,
                     const bf16* __restrict__ dout, int do_stride, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int c, int n, float scale) {
  constexpr int hd = HD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int col = blockIdx.x * hd;
  const size_t tok0 = (size_t)blockIdx.y * n;
  const size_t tile = bwd_tile_bytes(n, hd);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kh = reinterpret_cast<bf16*>(smem + tile);
  bf16* vh = reinterpret_cast<bf16*>(smem + 2 * tile);
  bf16* dos = reinterpret_cast<bf16*>(smem + 3 * tile);
  float* row_m = reinterpret_cast<float*>(smem + 4 * tile);
  float* row_il = row_m + n;  // 1 / l
  float* row_d = row_il + n;  // rowsum(dP o P)
  load_head(qs, q, q_stride, tok0, col, n, hd);
  load_head(kh, k, k_stride, tok0, col, n, hd);
  load_head(vh, v, v_stride, tok0, col, n, hd);
  load_head(dos, dout, do_stride, tok0, col, n, hd);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt = n / 16;

  // ---- phase 1: row statistics of every query tile
  for (int it = warp; it < nt; it += kBwdWarps) {
    const int i0 = it * 16;
    uint32_t qa[HD / 16][4], da[HD / 16][4];
    load_a<HD>(qa, qs, i0, g, t);
    load_a<HD>(da, dos, i0, g, t);
    float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
    for (int j0 = 0; j0 < n; j0 += 8) {
      float s[4];
      abt_tile<HD>(s, qa, kh, j0, g, t);
      m0 = fmaxf(m0, fmaxf(__fmul_rn(s[0], scale), __fmul_rn(s[1], scale)));
      m1 = fmaxf(m1, fmaxf(__fmul_rn(s[2], scale), __fmul_rn(s[3], scale)));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
    }
    float l0 = 0.0f, l1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
    for (int j0 = 0; j0 < n; j0 += 8) {
      float s[4], dp[4];
      abt_tile<HD>(s, qa, kh, j0, g, t);
      abt_tile<HD>(dp, da, vh, j0, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fmul_rn(s[e], scale) - (e < 2 ? m0 : m1));
        if (e < 2) {
          l0 += p;
          d0 += p * dp[e];
        } else {
          l1 += p;
          d1 += p * dp[e];
        }
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
      d0 += __shfl_xor_sync(0xffffffffu, d0, x);
      d1 += __shfl_xor_sync(0xffffffffu, d1, x);
    }
    if (t == 0) {
      const float il0 = __frcp_rn(l0), il1 = __frcp_rn(l1);
      row_m[i0 + g] = m0;
      row_m[i0 + g + 8] = m1;
      row_il[i0 + g] = il0;
      row_il[i0 + g + 8] = il1;
      row_d[i0 + g] = d0 * il0;
      row_d[i0 + g + 8] = d1 * il1;
    }
  }
  __syncthreads();

  // ---- phases 2 (key tiles: dK, dV) and 3 (query tiles: dQ), no barrier
  for (int u = warp; u < 2 * nt; u += kBwdWarps) {
    float acc0[HD / 8][4] = {}, acc1[HD / 8][4] = {};
    if (u < nt) {
      const int j0 = u * 16;
      uint32_t ka[HD / 16][4], va[HD / 16][4];
      load_a<HD>(ka, kh, j0, g, t);
      load_a<HD>(va, vh, j0, g, t);
      for (int i0 = 0; i0 < n; i0 += 16) {
        float pt[2][4], dst[2][4];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          float dpt[4];
          abt_tile<HD>(pt[w], ka, qs, i0 + 8 * w, g, t);   // S^T: keys x queries
          abt_tile<HD>(dpt, va, dos, i0 + 8 * w, g, t);    // dP^T
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = i0 + 8 * w + 2 * t + (e & 1);
            const float p = expf(__fmul_rn(pt[w][e], scale) - row_m[qi]) * row_il[qi];
            pt[w][e] = p;
            dst[w][e] = p * (dpt[e] - row_d[qi]);
          }
        }
        xy_acc<HD>(acc0, pt, dos, i0, g, t);   // dV_j += P^T dO_i
        xy_acc<HD>(acc1, dst, qs, i0, g, t);   // dK_j += dS^T Q_i
      }
      store_rows<HD>(dv, c, tok0, j0, col, acc0, 1.0f, g, t);
      store_rows<HD>(dk, c, tok0, j0, col, acc1, scale, g, t);
    } else {
      const int i0 = (u - nt) * 16;
      uint32_t qa[HD / 16][4], da[HD / 16][4];
      load_a<HD>(qa, qs, i0, g, t);
      load_a<HD>(da, dos, i0, g, t);
      const float m[2] = {row_m[i0 + g], row_m[i0 + g + 8]};
      const float il[2] = {row_il[i0 + g], row_il[i0 + g + 8]};
      const float dd[2] = {row_d[i0 + g], row_d[i0 + g + 8]};
      for (int j0 = 0; j0 < n; j0 += 16) {
        float ds[2][4];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          float s[4], dp[4];
          abt_tile<HD>(s, qa, kh, j0 + 8 * w, g, t);
          abt_tile<HD>(dp, da, vh, j0 + 8 * w, g, t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = expf(__fmul_rn(s[e], scale) - m[r]) * il[r];
            ds[w][e] = p * (dp[e] - dd[r]);
          }
        }
        xy_acc<HD>(acc0, ds, kh, j0, g, t);    // dQ_i += dS K_j
      }
      store_rows<HD>(dq, c, tok0, i0, col, acc0, scale, g, t);
    }
  }
}

template <int HD>
int launch_bwd(const void* q, int q_stride, const void* k, int k_stride, const void* v,
               int v_stride, const void* dout, int do_stride, void* dq, void* dk, void* dv,
               int g, int n, int c, int heads, float scale, cudaStream_t stream) {
  // once per instantiation: allow any block size up to the limit (each
  // launch still asks only for what its N needs)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = attn_bwd_smem_bytes(n, HD);
  attention_bwd_kernel<HD><<<dim3(heads, g), 32 * kBwdWarps, smem, stream>>>(
      static_cast<const bf16*>(q), q_stride, static_cast<const bf16*>(k), k_stride,
      static_cast<const bf16*>(v), v_stride, static_cast<const bf16*>(dout), do_stride,
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), c, n, scale);
  return (int)cudaGetLastError();
}

}  // namespace kuzu

extern "C" size_t kuzu_area_attention_bwd_smem(int n, int hd) {
  return kuzu::attn_bwd_smem_bytes(n, hd);
}

extern "C" int kuzu_area_attention_bwd(const void* q, int q_stride, const void* k, int k_stride,
                                       const void* v, int v_stride, const void* dout,
                                       int do_stride, void* dq, void* dk, void* dv, int g, int n,
                                       int c, int heads, float scale, void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c / heads) {
    case 16:
      return kuzu::launch_bwd<16>(q, q_stride, k, k_stride, v, v_stride, dout, do_stride, dq,
                                  dk, dv, g, n, c, heads, scale, s);
    case 32:
      return kuzu::launch_bwd<32>(q, q_stride, k, k_stride, v, v_stride, dout, do_stride, dq,
                                  dk, dv, g, n, c, heads, scale, s);
    case 48:
      return kuzu::launch_bwd<48>(q, q_stride, k, k_stride, v, v_stride, dout, do_stride, dq,
                                  dk, dv, g, n, c, heads, scale, s);
    case 64:
      return kuzu::launch_bwd<64>(q, q_stride, k, k_stride, v, v_stride, dout, do_stride, dq,
                                  dk, dv, g, n, c, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

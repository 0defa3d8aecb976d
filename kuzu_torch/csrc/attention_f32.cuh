// f32 attention on the CUDA cores, shared by flash_attention.cu (K5's f32
// path) and area_attention.cu (K3's f32 route):
//
//     o[g, :, h] = softmax(scale * q[g, :, h] k[g, :, h]^T) v[g, :, h]
//
// over (G, N, C) f32 tensors with heads packed along the channels (head h
// owns columns [h*D, (h+1)*D)), each of q, k, v and o with its own row
// stride: K3's head-packed layout is stride C, head offset h*D; K5's
// (BH, N, D) is the case heads = 1, stride = D.
//
// Replaces, in f32, the TPU kernels kuzu/ops/flash_attention.py::
// flash_attention (_flash_kernel: 128-key tiles with the online softmax)
// and ::area_attention (_area_attn_kernel: one group's N x N f32 scores in
// VMEM, q scaled first, exact max / exp / divide by the sum, the output in
// the input's dtype). The recurrence is the TPU flash kernel's, per 64-key
// tile: m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l alpha + rowsum(p), acc = acc alpha + p v, o = acc / max(l, 1e-30),
// m from -1e30; for K3 the exact two-pass maximum becomes this online one,
// a difference of f32-rounding size. K3's f32 training route also asks for
// each row's base-2 log-sum-exp of the scaled scores, (m + log l) log2(e),
// which the f32 backward (attention_f32_bwd.cuh) reads in place of
// recomputing the softmax statistics.
//
// Design. One block per (64 query rows, head, group), 256 threads. Register
// tiles on the CUDA cores, f32 FMAs only (no TF32: the products keep the
// reference's f32): thread (ty, tx) of a 16 x 16 layout owns query rows
// ty + 16 i (i < 4) and, of each 64-key tile, keys tx + 16 j (j < 4): a 4 x 4
// tile of S, built from 16-byte loads of Q and K rows along D (8 loads per
// 64 FMAs); then output columns [tx * D / 16, + D / 16) of the same rows,
// P V read as 16-byte loads of P rows and V rows. A row's 64 keys lie in the
// 16 lanes of one half-warp, so row maxima and sums are shuffles, and P
// passes through shared memory within that half-warp only. K and V tiles
// stream through two cp.async stages; the last tile of a ragged N is
// zero-filled and its scores are masked to -inf (exp gives exactly 0);
// query rows past N compute on zeros and are not stored. D is a template
// parameter (16 to 128 in steps of 16): nothing is padded in memory.
//
// What bounds it on this card: operations, 4 N^2 D per head (two products)
// on the 67 TFLOP/s of the f32 CUDA cores (the bytes, each input read once,
// are far below that: at K3's TrOCR shape G=1024, N=256, C=384 they are
// 0.48 GB, 0.14 ms, against 1.03e11 operations, 1.54 ms).
//
// Everything here has internal linkage: each library that includes it keeps
// its own kernels and its own once-per-instantiation attribute guards (a
// shared guard would leave the second library's kernels without their
// shared-memory attribute).
#pragma once

#include <math.h>

#include "attention.cuh"

namespace kuzu {
namespace {
namespace f32attn {

constexpr int kRows = 64;     // query rows per block
constexpr int kKeys = 64;     // keys per tile
static_assert(kRows == kKeys, "a block's row tiles and key tiles are counted alike");
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block: the scaled Q tile, two cp.async stages of a K
// and a V tile, rows padded to D + 4 floats (16-byte aligned rows, the 8 rows
// of a quarter-warp's 16-byte loads in different banks), and the 64 x 64
// tile of P, rows padded to 68.
__host__ __device__ inline size_t smem_bytes(int d) {
  return ((size_t)5 * kRows * (d + 4) + (size_t)kRows * (kKeys + 4)) * 4;
}

// K and V rows [j0, j0 + kKeys) of one head into a stage, 16 bytes per
// copy; rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const float* __restrict__ k,
                                        int k_stride, const float* __restrict__ v, int v_stride,
                                        int j0, int n) {
  constexpr int kPer = D / 4, LD = D + 4;
  for (int i = threadIdx.x; i < kKeys * kPer; i += kThreads) {
    const int r = i / kPer, c = (i - r * kPer) * 4;
    const bool ok = j0 + r < n;
    const size_t row = ok ? j0 + r : 0;
    cp_async16_zfill(ks + r * LD + c, k + row * k_stride + c, ok);
    cp_async16_zfill(vs + r * LD + c, v + row * v_stride + c, ok);
  }
  cp_async_commit();
}

// One-dimensional grid of ceil(n / 64) * heads * groups blocks, row tiles
// fastest: blockIdx.x = (group * heads + head) * ceil(n / 64) + tile (a
// grid's y and z stop at 65535, which a batch of crops outgrows).
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_f32_kernel(const float* __restrict__ q, int q_stride, const float* __restrict__ k,
                int k_stride, const float* __restrict__ v, int v_stride, float* __restrict__ o,
                int o_stride, float* __restrict__ lse, int n, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 4, LP = kKeys + 4, CPT = D / 16;
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = qs + kRows * LD;      // stage s: K at kv + 2 s kKeys LD, V after it
  float* ps = kv + 4 * kKeys * LD;  // kRows x LP
  const int ntiles = (n + kKeys - 1) / kKeys;  // = the row tiles (kRows == kKeys)
  const int gh = blockIdx.x / ntiles;
  const int grp = gh / heads, head = gh - grp * heads;
  q += (size_t)grp * n * q_stride + head * D;
  k += (size_t)grp * n * k_stride + head * D;
  v += (size_t)grp * n * v_stride + head * D;
  o += (size_t)grp * n * o_stride + head * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (blockIdx.x - gh * ntiles) * kRows;

  load_kv<D>(kv, kv + kKeys * LD, k, k_stride, v, v_stride, 0, n);
  for (int i = threadIdx.x; i < kRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < n) x = *reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * q_stride + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * LD + c) = x;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      float* nx = kv + 2 * (st ^ 1) * kKeys * LD;
      load_kv<D>(nx, nx + kKeys * LD, k, k_stride, v, v_stride, (it + 1) * kKeys, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, the first time, Q) is in place
    const float* ks = kv + 2 * st * kKeys * LD;
    const float* vs = ks + kKeys * LD;
    const int j0 = it * kKeys;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + tx + 16 * j >= n) s[i][j] = -INFINITY;  // keys past n
        tm = fmaxf(tm, s[i][j]);
      }
#pragma unroll
      for (int x = 1; x <= 8; x <<= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, x));
      const float mn = fmaxf(m[i], tm), al = expf(m[i] - mn);
      m[i] = mn;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * al + psum;  // this thread's part; rows sum over tx at the end
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= al;
    }
    __syncwarp();  // a row's P is written and read by its own half-warp

#pragma unroll 4
    for (int j = 0; j < kKeys; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
        const float* vrow = vs + (j + jj) * LD + tx * CPT;
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CPT; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = x.x, vv[c + 1] = x.y, vv[c + 2] = x.z, vv[c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pij, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // this stage and P are refilled next
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int x = 1; x <= 8; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    const int r = q0 + ty + 16 * i;
    if (r < n) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[(size_t)r * o_stride + tx * CPT + c] = acc[i][c] / den;
      if (lse != nullptr && tx == 0) lse[(size_t)gh * n + r] = (m[i] + logf(den)) * kLog2e;
    }
  }
}

template <int D>
int launch(const float* q, int q_stride, const float* k, int k_stride, const float* v,
           int v_stride, float* o, int o_stride, float* lse, int g, int n, int heads,
           float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  // once per instantiation: the block's shared memory does not depend on the call
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long blocks = (long)((n + kRows - 1) / kRows) * heads * g;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  attn_f32_kernel<D><<<grid, kThreads, smem, s>>>(q, q_stride, k, k_stride, v, v_stride, o,
                                                  o_stride, lse, n, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32attn

// softmax(scale q_h k_h^T) v_h for every head h and group of (g, n,
// heads * hd) f32 tensors with the given row strides (in floats); lse null,
// or (g, heads, n) f32 for each row's base-2 log-sum-exp. Bases and strides
// must be 16-byte aligned (the caller checks). Returns a cudaError_t
// (cudaErrorInvalidValue for a head width the kernel is not built for, or
// more than 2^31 - 1 blocks).
inline int attention_f32(const void* q, int q_stride, const void* k, int k_stride,
                         const void* v, int v_stride, void* o, int o_stride, float* lse, int g,
                         int n, int heads, int hd, float scale, cudaStream_t s) {
  if (g <= 0 || n <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
#define KUZU_F32_CASE(D)                                                                  \
  case D:                                                                                 \
    return f32attn::launch<D>(qf, q_stride, kf, k_stride, vf, v_stride, of, o_stride, lse, \
                              g, n, heads, scale, s);
  switch (hd) {
    KUZU_F32_CASE(16)
    KUZU_F32_CASE(32)
    KUZU_F32_CASE(48)
    KUZU_F32_CASE(64)
    KUZU_F32_CASE(80)
    KUZU_F32_CASE(96)
    KUZU_F32_CASE(112)
    KUZU_F32_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KUZU_F32_CASE
}

}  // namespace
}  // namespace kuzu

// Backward of area attention in f32 on the CUDA cores (K4's f32 route),
// over (G, N, C) f32 tensors with heads packed along the channels (head h
// owns columns [h*D, (h+1)*D)), each input and output with its own row
// stride.
//
// Replaces, in f32, the TPU kernel kuzu/ops/flash_attention.py::
// area_attention_bwd (_area_attn_bwd_kernel, which takes any dtype and
// computes in f32): per group and head, with S = scale Q K^T and
// P = softmax(S),
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D = rowsum(dO o O),
//     dQ = scale dS K,  dK = dS^T (scale Q).
// The TPU kernel recomputes P from S with an exact two-pass softmax; here P
// is exp2(log2(e) S - lse) from the forward's base-2 log-sum-exp
// (attention_f32.cuh writes it on K3's f32 training route), and D comes
// from the forward's f32 output O (rowsum(dP o P) = rowsum(dO o O)), so no
// pass over the keys is needed for either.
//
// Design: two kernels, each on attention_f32.cuh's register tiling (256
// threads as 16 x 16, thread (ty, tx) owning rows ty + 16 i and columns
// tx + 16 j of each 64 x 64 score tile, f32 FMAs only, no TF32) and its
// two-stage cp.async streaming; rows past N are zero-filled and their P
// masked to 0.
//   1. dq_kernel, one block per (64 query rows, head, group): D of its rows
//      from dO and O (written out for kernel 2), Q (scaled) and dO stay in
//      shared memory, K and V stream in 64-key tiles: S and dP in
//      registers, dS through shared memory within each half-warp, dQ += dS K.
//   2. dkdv_kernel, one block per (64 keys, head, group): K and V stay in
//      shared memory, Q, dO and their lse and D stream in 64-row tiles: the
//      transposed tiles S^T = K Q^T and dP^T = V dO^T in registers, then
//      P^T and dS^T through one shared tile in turn: dV += P^T dO,
//      dK += dS^T Q (scale applied once at the end).
// Every block writes only its own rows: no atomics, the result does not
// depend on the run.
//
// What bounds it on this card: operations, five products of 2 N^2 hd per
// head (S twice, dP twice, and dQ, dK, dV: 4 + 4 + 2 over two kernels, 10 N^2
// hd in all) on the 67 TFLOP/s of the f32 CUDA cores; the bytes (q, k, v,
// o, dO read, dq, dk, dv written) are far below that: at the TrOCR
// training shape G=16, N=256, C=384 they take 0.015 ms against 0.060 ms.
// A simple design first: recomputing S and dP in both kernels costs 4 of
// the 10 N^2 hd a head more than the five products need.
#pragma once

#include <math.h>

#include "attention_f32.cuh"

namespace kuzu {
namespace {
namespace f32bwd {

using f32attn::kKeys;
using f32attn::kLog2e;
using f32attn::kRows;
using f32attn::kThreads;
using f32attn::load_kv;

// Shared memory of a dq_kernel block: the scaled Q tile and the dO tile,
// two stages of a K and a V tile (rows padded to D + 4), the 64 x 64 tile of
// dS (rows padded to 68).
__host__ __device__ inline size_t dq_smem_bytes(int d) {
  return ((size_t)6 * kRows * (d + 4) + (size_t)kRows * (kKeys + 4)) * 4;
}

// Shared memory of a dkdv_kernel block: the K and V tiles, two stages of a
// Q and a dO tile, the 64 x 64 tile of P^T / dS^T, two stages of 64 lse and
// 64 D values.
__host__ __device__ inline size_t dkdv_smem_bytes(int d) {
  return ((size_t)6 * kRows * (d + 4) + (size_t)kKeys * (kRows + 4) + (size_t)4 * kRows) * 4;
}

// 64 lse and 64 D values of rows [r0, r0 + 64) into a stage, 16 bytes per
// copy (rows past n zero-filled; n % 4 == 0).
__device__ __forceinline__ void load_vec(float* ls, float* ds, const float* __restrict__ lse,
                                         const float* __restrict__ dvec, int r0, int n) {
  const int t = threadIdx.x;
  if (t < 2 * kRows / 4) {
    const int which = t / (kRows / 4), r = (t % (kRows / 4)) * 4;
    const bool ok = r0 + r < n;
    const float* src = (which == 0 ? lse : dvec) + (ok ? r0 + r : 0);
    cp_async16_zfill((which == 0 ? ls : ds) + r, src, ok);
  }
}

// acc[i][j] = sum over D of a[row ai(i)] . b[row bj(j)], rows of two tiles of
// stride LD in shared memory: thread rows ty + 16 i of a, tx + 16 j of b.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum over 64 columns j of w[row ty + 16 i][j] * y[row j][tx CPT + c]:
// w a 64 x 64 tile of stride kKeys + 4, y a 64-row tile of stride D + 4.
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* w, const float* y,
                                         int ty, int tx) {
  constexpr int LD = D + 4, LP = kKeys + 4, CPT = D / 16;
#pragma unroll 4
  for (int j = 0; j < kKeys; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * LP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float yy[CPT];
      const float* yrow = y + (j + jj) * LD + tx * CPT;
      if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CPT; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(yrow + c);
          yy[c] = t.x, yy[c + 1] = t.y, yy[c + 2] = t.z, yy[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) yy[c] = yrow[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wij = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(wij, yy[c], acc[i][c]);
      }
    }
  }
}

// One-dimensional grid of ceil(n / 64) * heads * groups blocks, row tiles
// fastest, as attn_f32_kernel's.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, int q_stride, const float* __restrict__ k, int k_stride,
          const float* __restrict__ v, int v_stride, const float* __restrict__ dout,
          int do_stride, const float* __restrict__ o, int o_stride,
          const float* __restrict__ lse, float* __restrict__ dvec, float* __restrict__ dq,
          int dq_stride, int n, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 4, LP = kKeys + 4, CPT = D / 16;
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kRows * LD;
  float* kv = dos + kRows * LD;    // stage s: K at kv + 2 s kKeys LD, V after it
  float* dss = kv + 4 * kKeys * LD;  // kRows x LP
  const int ntiles = (n + kKeys - 1) / kKeys;
  const int gh = blockIdx.x / ntiles;
  const int grp = gh / heads, head = gh - grp * heads;
  const size_t base = (size_t)grp * n;
  q += base * q_stride + head * D;
  k += base * k_stride + head * D;
  v += base * v_stride + head * D;
  dout += base * do_stride + head * D;
  o += base * o_stride + head * D;
  dq += base * dq_stride + head * D;
  lse += (size_t)gh * n;
  dvec += (size_t)gh * n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (blockIdx.x - gh * ntiles) * kRows;

  load_kv<D>(kv, kv + kKeys * LD, k, k_stride, v, v_stride, 0, n);
  for (int i = threadIdx.x; i < kRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y = x;
    if (q0 + r < n) {
      x = *reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * q_stride + c);
      y = *reinterpret_cast<const float4*>(dout + (size_t)(q0 + r) * do_stride + c);
    }
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * LD + c) = x;
    *reinterpret_cast<float4*>(dos + r * LD + c) = y;
  }
  // D and lse of this thread's rows: a row's D is summed over the 16 lanes
  // of its half-warp, each taking D / 16 columns
  float dd[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    float part = 0.0f;
    if (r < n) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        part = fmaf(dout[(size_t)r * do_stride + tx * CPT + c], o[(size_t)r * o_stride + tx * CPT + c],
                    part);
    }
#pragma unroll
    for (int x = 1; x <= 8; x <<= 1) part += __shfl_xor_sync(0xffffffffu, part, x);
    dd[i] = part;
    ls[i] = r < n ? lse[r] : 0.0f;
    if (r < n && tx == 0) dvec[r] = part;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      float* nx = kv + 2 * (st ^ 1) * kKeys * LD;
      load_kv<D>(nx, nx + kKeys * LD, k, k_stride, v, v_stride, (it + 1) * kKeys, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, the first time, Q and dO) is in place
    const float* ks = kv + 2 * st * kKeys * LD;
    const float* vs = ks + kKeys * LD;
    const int j0 = it * kKeys;
    float s[4][4], dp[4][4];
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = j0 + tx + 16 * j < n ? exp2f(fmaf(s[i][j], kLog2e, -ls[i])) : 0.0f;
        dss[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - dd[i]);
      }
    __syncwarp();  // a row's dS is written and read by its own half-warp
    tile_acc<D>(acc, dss, ks, ty, tx);
    __syncthreads();  // this stage and dS are refilled next
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < n) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) dq[(size_t)r * dq_stride + tx * CPT + c] = acc[i][c] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, int q_stride, const float* __restrict__ k, int k_stride,
            const float* __restrict__ v, int v_stride, const float* __restrict__ dout,
            int do_stride, const float* __restrict__ lse, const float* __restrict__ dvec,
            float* __restrict__ dk, int dk_stride, float* __restrict__ dv, int dv_stride, int n,
            int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 4, LP = kRows + 4, CPT = D / 16;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kKeys * LD;
  float* qd = vs + kKeys * LD;      // stage s: Q at qd + 2 s kRows LD, dO after it
  float* pt = qd + 4 * kRows * LD;  // kKeys x LP: P^T, then dS^T
  float* vec = pt + kKeys * LP;     // stage s: lse at vec + 2 s kRows, D after it
  const int ntiles = (n + kRows - 1) / kRows;
  const int gh = blockIdx.x / ntiles;
  const int grp = gh / heads, head = gh - grp * heads;
  const size_t base = (size_t)grp * n;
  q += base * q_stride + head * D;
  k += base * k_stride + head * D;
  v += base * v_stride + head * D;
  dout += base * do_stride + head * D;
  dk += base * dk_stride + head * D;
  dv += base * dv_stride + head * D;
  lse += (size_t)gh * n;
  dvec += (size_t)gh * n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = (blockIdx.x - gh * ntiles) * kKeys;

  // the block's K and V tiles, then the first stage, in one copy group
  for (int i = threadIdx.x; i < kKeys * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    const bool ok = k0 + r < n;
    const size_t row = ok ? k0 + r : 0;
    cp_async16_zfill(ks + r * LD + c, k + row * k_stride + c, ok);
    cp_async16_zfill(vs + r * LD + c, v + row * v_stride + c, ok);
  }
  load_vec(vec, vec + kRows, lse, dvec, 0, n);
  load_kv<D>(qd, qd + kRows * LD, q, q_stride, dout, do_stride, 0, n);  // commits the group

  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      float* nx = qd + 2 * (st ^ 1) * kRows * LD;
      float* nv = vec + 2 * (st ^ 1) * kRows;
      load_vec(nv, nv + kRows, lse, dvec, (it + 1) * kRows, n);
      load_kv<D>(nx, nx + kRows * LD, q, q_stride, dout, do_stride, (it + 1) * kRows, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, the first time, K and V) is in place
    const float* qs = qd + 2 * st * kRows * LD;
    const float* dos = qs + kRows * LD;
    const float* ls = vec + 2 * st * kRows;
    const float* dd = ls + kRows;
    const int i0 = it * kRows;
    float s[4][4], dp[4][4];  // transposed: key ty + 16 a, query row tx + 16 b
    tile_dot<D>(s, ks, qs, ty, tx);
    tile_dot<D>(dp, vs, dos, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = tx + 16 * b;
        const float p =
            i0 + r < n ? exp2f(fmaf(s[a][b] * scale, kLog2e, -ls[r])) : 0.0f;
        pt[(ty + 16 * a) * LP + r] = p;
        dp[a][b] = p * (dp[a][b] - dd[r]);  // dS^T
      }
    __syncwarp();  // a key's row of P^T is written and read by its own half-warp
    tile_acc<D>(acc_v, pt, dos, ty, tx);
    __syncwarp();  // read before it is overwritten with dS^T
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) pt[(ty + 16 * a) * LP + tx + 16 * b] = dp[a][b];
    __syncwarp();
    tile_acc<D>(acc_k, pt, qs, ty, tx);
    __syncthreads();  // this stage and the tile are refilled next
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = k0 + ty + 16 * a;
    if (r < n) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dk[(size_t)r * dk_stride + tx * CPT + c] = acc_k[a][c] * scale;
        dv[(size_t)r * dv_stride + tx * CPT + c] = acc_v[a][c];
      }
    }
  }
}

template <int D>
int launch(const float* q, int q_stride, const float* k, int k_stride, const float* v,
           int v_stride, const float* dout, int do_stride, const float* o, int o_stride,
           const float* lse, float* dvec, float* dq, int dq_stride, float* dk, int dk_stride,
           float* dv, int dv_stride, int g, int n, int heads, float scale, cudaStream_t s) {
  // once per instantiation: the blocks' shared memory does not depend on the call
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem_bytes(D));
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem_bytes(D));
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkdv != cudaSuccess) return (int)attr_dkdv;
  const long blocks = (long)((n + kRows - 1) / kRows) * heads * g;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  dq_kernel<D><<<grid, kThreads, dq_smem_bytes(D), s>>>(q, q_stride, k, k_stride, v, v_stride,
                                                         dout, do_stride, o, o_stride, lse, dvec,
                                                         dq, dq_stride, n, heads, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<D><<<grid, kThreads, dkdv_smem_bytes(D), s>>>(q, q_stride, k, k_stride, v,
                                                             v_stride, dout, do_stride, lse, dvec,
                                                             dk, dk_stride, dv, dv_stride, n,
                                                             heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32bwd

// dq, dk, dv of area attention for (g, n, heads * hd) f32 tensors with the
// given row strides (in floats): q, k, v, dout and the forward's output o;
// lse (g, heads, n) f32 from K3's f32 training route; dvec (g, heads, n) f32
// scratch (D). Bases and strides 16-byte aligned, n % 4 == 0 (the caller
// checks). Returns a cudaError_t (cudaErrorInvalidValue for a head width the
// kernels are not built for, or more than 2^31 - 1 blocks).
inline int attention_f32_bwd(const void* q, int q_stride, const void* k, int k_stride,
                             const void* v, int v_stride, const void* dout, int do_stride,
                             const void* o, int o_stride, const float* lse, float* dvec,
                             void* dq, int dq_stride, void* dk, int dk_stride, void* dv,
                             int dv_stride, int g, int n, int heads, int hd, float scale,
                             cudaStream_t s) {
  if (g <= 0 || n <= 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* of = static_cast<const float*>(o);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
#define KUZU_F32_BWD_CASE(D)                                                                  \
  case D:                                                                                     \
    return f32bwd::launch<D>(qf, q_stride, kf, k_stride, vf, v_stride, df, do_stride, of,     \
                             o_stride, lse, dvec, dqf, dq_stride, dkf, dk_stride, dvf,        \
                             dv_stride, g, n, heads, scale, s);
  switch (hd) {
    KUZU_F32_BWD_CASE(16)
    KUZU_F32_BWD_CASE(32)
    KUZU_F32_BWD_CASE(48)
    KUZU_F32_BWD_CASE(64)
    KUZU_F32_BWD_CASE(80)
    KUZU_F32_BWD_CASE(96)
    KUZU_F32_BWD_CASE(112)
    KUZU_F32_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KUZU_F32_BWD_CASE
}

}  // namespace
}  // namespace kuzu

// Backward of area attention in f32 on Hopper's tensor cores (K4's f32
// route), over (G, N, C) f32 tensors with heads packed along the channels
// (head h owns columns [h*D, (h+1)*D)), each input and output with its own
// row stride.
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
// Arithmetic: 3xTF32 for all five products, as attention_f32.cuh's note
// says (hi = x rounded to nearest, ties away, to TF32, as cvt.rna.tf32.f32
// gives it; lo = the same rounding of x - hi; per product A_lo B_hi, A_hi
// B_lo, then A_hi B_hi, accumulated in f32 by the tensor core; f32-accurate,
// whatever torch.backends.cuda.matmul.allow_tf32 says). P, dS and D are f32
// on the CUDA cores.
//
// Design: two kernels on attention_f32.cuh's pieces, each one block per 64
// fixed rows (one consumer warpgroup, the most blocks for the TrOCR
// training shape's 96 heads x groups) and a producer warpgroup that loads
// the streamed tiles with 16-byte loads (the next tile's in flight while
// this one is stored), splits them and stores them into a ring of kStages
// stages (mbarriers "full", one arrival a producer warp, and "empty"); the
// whole block stages the fixed tiles while the first streamed tile is in
// flight. A TF32 wgmma takes only K-major operands, so every tile that is
// contracted over its rows is also stored transposed (rows permuted within
// groups of 8, so that P and dS feed wgmma's register A operand as they lie
// in the accumulators). Independent products (S and dP; dV and dK) issue
// interleaved, so that the tensor cores have two chains to work on:
//   1. dq_kernel, one block per (64 query rows, head, group): its consumers
//      first sum D of their rows from dO and O (written out for kernel 2);
//      Q (scaled) and dO stay in shared memory as K-major tiles, K (K-major
//      and transposed) and V (K-major) stream in kT-key tiles: S = Q K^T and
//      dP = dO V^T on wgmma, P and dS = P o (dP - D) on the accumulator
//      registers, dQ += dS K with dS as the register A operand and K^T as B;
//   2. dkdv_kernel, one block per (64 keys, head, group): K and V stay as
//      K-major tiles, Q (scaled) and dO stream in kT-row tiles, both K-major
//      and transposed, with their lse and D: S^T = K Q^T and dP^T = V dO^T,
//      P^T and dS^T on the registers, dV += P^T dO and dK += dS^T Q with
//      dO^T and Q^T as B.
// Each product is computed once: 10 N^2 hd operations a head, the least.
// Every block writes only its own rows: no atomics, the result does not
// depend on the run. The tiles and stages follow the head width so that
// they fit the shared memory (Dq, Dkdv below). Rows past N are zero-filled;
// the ragged last tile masks its P to 0.
//
// What bounds it on this card: operations, five products of 2 N^2 hd per
// head as 3xTF32, three TF32 products each, on the 495 TFLOP/s of the
// tensor cores; the bytes (q, k, v, o, dO, lse read, dq, dk, dv written)
// come next: at the TrOCR training shape G=16, N=256, C=384 they take 0.015
// ms against 0.024 ms.
#pragma once

#include <math.h>

#include "attention_f32.cuh"

namespace kuzu {
namespace {
namespace f32bwd {

using f32attn::Cols;
using f32attn::fast_exp2;
using f32attn::fence_async_smem;
using f32attn::fence_regs;
using f32attn::Fixed;
using f32attn::kLog2e;
using f32attn::kProducer;
using f32attn::kProducerWarps;
using f32attn::mbar_arrive;
using f32attn::mbar_init;
using f32attn::mbar_wait;
using f32attn::product_rs;
using f32attn::product_rs2;
using f32attn::product_ss2;
using f32attn::publish;
using f32attn::Rows;
using f32attn::smem_addr;
using f32attn::stage_fixed;
using f32attn::Tile;
using f32attn::wgmma_commit;
using f32attn::wgmma_fence;
using f32attn::wgmma_wait_all;

constexpr int kRows = 64;       // fixed rows per block (queries, or keys)
constexpr int kThreads = 256;   // warpgroup 0 consumes, 1 produces

// dq_kernel: Q and dO fixed, K (both layouts) and V streamed.
template <int D>
struct Dq {
  static constexpr int kT = 32;
  static constexpr int kStages = D <= 80 ? 2 : 1;
  using Fixed = Tile<kRows, D>;
  using Rows = Tile<kT, D>;
  using Cols = Tile<D, kT>;
  static constexpr uint32_t kStageBytes = 4 * Rows::kBytes + 2 * Cols::kBytes;
};

// dkdv_kernel: K and V fixed, Q and dO streamed in both layouts with their
// lse and D.
template <int D>
struct Dkdv {
  static constexpr int kT = D <= 112 ? 32 : 16;
  static constexpr int kStages = D <= 64 ? 2 : 1;
  using Fixed = Tile<kRows, D>;
  using Rows = Tile<kT, D>;
  using Cols = Tile<D, kT>;
  static constexpr uint32_t kStageBytes = 4 * Rows::kBytes + 4 * Cols::kBytes;
  static constexpr uint32_t kVecBytes = 2 * kT * 4;
};

// Shared memory of a dq_kernel block: 1024 bytes of alignment, the hi and
// lo tiles of Q and dO, kStages stages of K (two layouts) and V, 64 bytes
// of barriers. Constant in N.
__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  return 1024 + (size_t)4 * kRows * d * 4 + (size_t)(d <= 80 ? 2 : 1) * 24 * 32 * d + 64;
}

// Shared memory of a dkdv_kernel block: 1024 bytes of alignment, the hi
// and lo tiles of K and V, kStages stages of Q and dO (two layouts each)
// and of their lse and D, 64 bytes of barriers. Constant in N.
__host__ __device__ constexpr size_t dkdv_smem_bytes(int d) {
  return 1024 + (size_t)4 * kRows * d * 4 +
         (size_t)(d <= 64 ? 2 : 1) * (32 * (d <= 112 ? 32 : 16) * d + 8 * (d <= 112 ? 32 : 16)) +
         64;
}

// (the caller's __syncthreads makes them visible)
__device__ __forceinline__ void init_barriers(uint32_t full0, uint32_t empty0, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, kProducerWarps);
      mbar_init(empty0 + 8 * s, 4);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// lse and D of rows [r0, r0 + T) (zeros past n) for one stage, in the
// producer's registers between load() and store()
template <int T>
struct Vec {
  float x;
  __device__ __forceinline__ void load(const float* __restrict__ lse,
                                       const float* __restrict__ dvec, int r0, int n, int t) {
    const int rr = r0 + t % T;
    x = t < 2 * T && rr < n ? (t < T ? lse[rr] : dvec[rr]) : 0.0f;
  }
  __device__ __forceinline__ void store(float* vs, int t) const {
    if (t < 2 * T) vs[t] = x;  // lse, then D
  }
};
static_assert(2 * 32 <= kProducer, "one value of a stage's lse and D per producer thread");

// rows row, row + 8 of out (row stride os) from the accumulator layout,
// times mul; rows past n are not written
template <int D>
__device__ __forceinline__ void store_rows(float* out, int os, int n, int row, int c,
                                           const float (&acc)[D / 2], float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < n)
      *reinterpret_cast<float2*>(out + (size_t)row * os + 8 * j + 2 * c) =
          make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row + 8 < n)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * os + 8 * j + 2 * c) =
          make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// One-dimensional grid of ceil(n / 64) * heads * groups blocks, row tiles
// fastest, as attn_f32_fwd_kernel's.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, int q_stride, const float* __restrict__ k, int k_stride,
          const float* __restrict__ v, int v_stride, const float* __restrict__ dout,
          int do_stride, const float* __restrict__ o, int o_stride,
          const float* __restrict__ lse, float* __restrict__ dvec, float* __restrict__ dq,
          int dq_stride, int n, int heads, float scale) {
  using C = Dq<D>;
  constexpr int T = C::kT, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qhi = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t qlo = qhi + C::Fixed::kBytes;
  const uint32_t dohi = qlo + C::Fixed::kBytes, dolo = dohi + C::Fixed::kBytes;
  const uint32_t st0 = dolo + C::Fixed::kBytes;  // stage s: K, V hi / lo, K^T hi / lo
  const uint32_t full0 = st0 + S * C::kStageBytes, empty0 = full0 + 8 * S;
  const int ntiles = (n + kRows - 1) / kRows;
  const int gh = blockIdx.x / ntiles;
  const int grp = gh / heads, head = gh - grp * heads;
  const int q0 = (blockIdx.x - gh * ntiles) * kRows;
  const int nk = (n + T - 1) / T;
  const size_t base = (size_t)grp * n;
  q += base * q_stride + head * D;
  k += base * k_stride + head * D;
  v += base * v_stride + head * D;
  dout += base * do_stride + head * D;
  o += base * o_stride + head * D;
  dq += base * dq_stride + head * D;
  lse += (size_t)gh * n;
  dvec += (size_t)gh * n;
  init_barriers(full0, empty0, S);
  // the producer's first K/V tile in flight while the whole block stages Q
  // (scaled) and dO
  const bool producer = threadIdx.x >= 128;
  const int t = threadIdx.x - 128;
  Cols<T, D, true> kx;
  Rows<T, D> vx;
  if (producer) {
    kx.load(k, k_stride, 0, n, 1.0f, t);
    vx.load(v, v_stride, 0, n, 1.0f, t);
  }
  stage_fixed<kRows, D, kThreads, 2>(
      {Fixed{qhi, qlo, q, q_stride, scale}, Fixed{dohi, dolo, dout, do_stride, 1.0f}}, q0, n,
      threadIdx.x);
  fence_async_smem();
  __syncthreads();

  if (producer) {
    // ------------------------------------------------------------ producer
    for (int it = 0; it < nk; ++it) {
      const int s = it % S;
      Cols<T, D, true> kn;  // the next tile's loads, in flight while this one is stored
      Rows<T, D> vn;
      if (it + 1 < nk) {
        kn.load(k, k_stride, (it + 1) * T, n, 1.0f, t);
        vn.load(v, v_stride, (it + 1) * T, n, 1.0f, t);
      }
      if (it >= S) mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
      const uint32_t kh = st0 + s * C::kStageBytes, kl = kh + C::Rows::kBytes;
      const uint32_t vh = kl + C::Rows::kBytes, vl = vh + C::Rows::kBytes;
      const uint32_t kth = vl + C::Rows::kBytes, ktl = kth + C::Cols::kBytes;
      kx.store(kh, kl, kth, ktl, t);
      vx.store(vh, vl, t);
      publish(full0 + 8 * s);
      kx = kn;
      vx = vn;
    }
  } else {
    // ------------------------------------------------------------ consumer
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 2, c = lane & 3;
    const int row = q0 + 16 * warp + r;  // this thread's rows: row, row + 8
    const float lse_lo = row < n ? lse[row] : 0.0f;
    const float lse_hi = row + 8 < n ? lse[row + 8] : 0.0f;
    // D = rowsum(dO o O) of this thread's rows, over its columns 8 j + 2 c,
    // + 1, then over the row's 4 lanes
    float d_lo = 0.0f, d_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row < n) {
        const float2 a = *reinterpret_cast<const float2*>(dout + (size_t)row * do_stride + 8 * j + 2 * c);
        const float2 b = *reinterpret_cast<const float2*>(o + (size_t)row * o_stride + 8 * j + 2 * c);
        d_lo = fmaf(a.x, b.x, fmaf(a.y, b.y, d_lo));
      }
      if (row + 8 < n) {
        const float2 a =
            *reinterpret_cast<const float2*>(dout + (size_t)(row + 8) * do_stride + 8 * j + 2 * c);
        const float2 b =
            *reinterpret_cast<const float2*>(o + (size_t)(row + 8) * o_stride + 8 * j + 2 * c);
        d_hi = fmaf(a.x, b.x, fmaf(a.y, b.y, d_hi));
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      d_lo += __shfl_xor_sync(0xffffffffu, d_lo, x);
      d_hi += __shfl_xor_sync(0xffffffffu, d_hi, x);
    }
    if (c == 0) {
      if (row < n) dvec[row] = d_lo;
      if (row + 8 < n) dvec[row + 8] = d_hi;
    }

    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const uint32_t kh = st0 + s * C::kStageBytes, kl = kh + C::Rows::kBytes;
      const uint32_t vh = kl + C::Rows::kBytes, vl = vh + C::Rows::kBytes;
      const uint32_t kth = vl + C::Rows::kBytes, ktl = kth + C::Cols::kBytes;
      float sc[T / 2], dp[T / 2];
#pragma unroll
      for (int x = 0; x < T / 2; ++x) sc[x] = dp[x] = 0.0f;
      wgmma_fence();
      // S = (scale Q) K^T, dP = dO V^T
      product_ss2<T, D>(sc, qhi, qlo, kh, kl, dp, dohi, dolo, vh, vl);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < T / 2; ++x)
        sc[x] = fast_exp2(fmaf(sc[x], kLog2e, -(x & 2 ? lse_hi : lse_lo)));  // P
      if (it == nk - 1 && n % T != 0) {  // keys past n (zero-filled rows): P = 0
#pragma unroll
        for (int x = 0; x < T / 2; ++x)
          if (it * T + 8 * (x >> 2) + 2 * c + (x & 1) >= n) sc[x] = 0.0f;
      }
#pragma unroll
      for (int x = 0; x < T / 2; ++x) dp[x] = sc[x] * (dp[x] - (x & 2 ? d_hi : d_lo));  // dS
      product_rs<T, D>(acc, dp, kth, ktl);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }
    store_rows<D>(dq, dq_stride, n, row, c, acc, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, int q_stride, const float* __restrict__ k, int k_stride,
            const float* __restrict__ v, int v_stride, const float* __restrict__ dout,
            int do_stride, const float* __restrict__ lse, const float* __restrict__ dvec,
            float* __restrict__ dk, int dk_stride, float* __restrict__ dv, int dv_stride, int n,
            int heads, float scale) {
  using C = Dkdv<D>;
  constexpr int T = C::kT, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t khi = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t klo = khi + C::Fixed::kBytes;
  const uint32_t vhi = klo + C::Fixed::kBytes, vlo = vhi + C::Fixed::kBytes;
  // stage s: Q, dO hi / lo, then Q^T, dO^T hi / lo; after the stages, each
  // stage's lse and D
  const uint32_t st0 = vlo + C::Fixed::kBytes;
  const uint32_t vec0 = st0 + S * C::kStageBytes;
  const uint32_t full0 = vec0 + S * C::kVecBytes, empty0 = full0 + 8 * S;
  float* vec_s = reinterpret_cast<float*>(smem_raw + (vec0 - smem_addr(smem_raw)));
  const int ntiles = (n + kRows - 1) / kRows;
  const int gh = blockIdx.x / ntiles;
  const int grp = gh / heads, head = gh - grp * heads;
  const int k0 = (blockIdx.x - gh * ntiles) * kRows;
  const int nq = (n + T - 1) / T;
  const size_t base = (size_t)grp * n;
  q += base * q_stride + head * D;
  k += base * k_stride + head * D;
  v += base * v_stride + head * D;
  dout += base * do_stride + head * D;
  dk += base * dk_stride + head * D;
  dv += base * dv_stride + head * D;
  lse += (size_t)gh * n;
  dvec += (size_t)gh * n;
  init_barriers(full0, empty0, S);
  // the producer's first Q/dO tile in flight while the whole block stages K
  // and V
  const bool producer = threadIdx.x >= 128;
  const int t = threadIdx.x - 128;
  Cols<T, D, true> qx, dx;
  Vec<T> lx;
  if (producer) {
    qx.load(q, q_stride, 0, n, scale, t);
    dx.load(dout, do_stride, 0, n, 1.0f, t);
    lx.load(lse, dvec, 0, n, t);
  }
  stage_fixed<kRows, D, kThreads, 2>(
      {Fixed{khi, klo, k, k_stride, 1.0f}, Fixed{vhi, vlo, v, v_stride, 1.0f}}, k0, n,
      threadIdx.x);
  fence_async_smem();
  __syncthreads();

  if (producer) {
    // ------------------------------------------------------------ producer
    for (int it = 0; it < nq; ++it) {
      const int s = it % S;
      Cols<T, D, true> qn, dn;  // the next tile's loads, in flight while this one is stored
      Vec<T> ln;
      if (it + 1 < nq) {
        qn.load(q, q_stride, (it + 1) * T, n, scale, t);
        dn.load(dout, do_stride, (it + 1) * T, n, 1.0f, t);
        ln.load(lse, dvec, (it + 1) * T, n, t);
      }
      if (it >= S) mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
      const uint32_t qh = st0 + s * C::kStageBytes, ql = qh + C::Rows::kBytes;
      const uint32_t doh = ql + C::Rows::kBytes, dol = doh + C::Rows::kBytes;
      const uint32_t qth = dol + C::Rows::kBytes, qtl = qth + C::Cols::kBytes;
      const uint32_t doth = qtl + C::Cols::kBytes, dotl = doth + C::Cols::kBytes;
      qx.store(qh, ql, qth, qtl, t);
      dx.store(doh, dol, doth, dotl, t);
      lx.store(vec_s + s * 2 * T, t);
      publish(full0 + 8 * s);
      qx = qn;
      dx = dn;
      lx = ln;
    }
  } else {
    // ------------------------------------------------------------ consumer
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = lane >> 2, c = lane & 3;
    const int key = k0 + 16 * warp + r;  // this thread's keys: key, key + 8
    float acc_dv[D / 2], acc_dk[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc_dv[x] = acc_dk[x] = 0.0f;
    for (int it = 0; it < nq; ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const uint32_t qh = st0 + s * C::kStageBytes, ql = qh + C::Rows::kBytes;
      const uint32_t doh = ql + C::Rows::kBytes, dol = doh + C::Rows::kBytes;
      const uint32_t qth = dol + C::Rows::kBytes, qtl = qth + C::Cols::kBytes;
      const uint32_t doth = qtl + C::Cols::kBytes, dotl = doth + C::Cols::kBytes;
      const float* lv = vec_s + s * 2 * T;
      const float* dd = lv + T;
      float st[T / 2], dpt[T / 2];
#pragma unroll
      for (int x = 0; x < T / 2; ++x) st[x] = dpt[x] = 0.0f;
      wgmma_fence();
      // S^T = K (scale Q)^T, dP^T = V dO^T
      product_ss2<T, D>(st, khi, klo, qh, ql, dpt, vhi, vlo, doh, dol);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);
#pragma unroll
      for (int jj = 0; jj < T / 8; ++jj) {  // this thread's queries: 8 jj + 2 c, + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * jj + 2 * c);
        const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * jj + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(st[4 * jj + e], kLog2e, -(e & 1 ? l2.y : l2.x)));  // P^T
          if (it * T + 8 * jj + 2 * c + (e & 1) >= n) p = 0.0f;  // queries past n
          st[4 * jj + e] = p;
          dpt[4 * jj + e] = p * (dpt[4 * jj + e] - (e & 1 ? d2.y : d2.x));  // dS^T
        }
      }
      // dV += P^T dO, dK += dS^T (scale Q)
      product_rs2<T, D>(acc_dv, st, doth, dotl, acc_dk, dpt, qth, qtl);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }
    store_rows<D>(dv, dv_stride, n, key, c, acc_dv, 1.0f);
    store_rows<D>(dk, dk_stride, n, key, c, acc_dk, 1.0f);
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
// scratch (D). Bases and strides 16-byte aligned (the caller checks).
// Returns a cudaError_t (cudaErrorInvalidValue for a head width the kernels
// are not built for, or more than 2^31 - 1 blocks).
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

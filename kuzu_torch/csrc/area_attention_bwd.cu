// Backward of area attention over head-packed (G, N, C) tensors.
//
// Replaces the TPU kernel kuzu/ops/flash_attention.py::area_attention_bwd
// (_area_attn_bwd_kernel): per group g and head h, with S = scale Q K^T and
// P = softmax(S),
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D = rowsum(dP o P),
//     dQ = scale dS K,  dK = scale dS^T Q.
//
// Design. On the TPU one grid step holds a whole group in VMEM. Here no
// block holds a group: two streamed kernels on wgmma and TMA, built on the
// skeleton of the forward (attention_fwd.cuh: a producer warpgroup feeding a
// ring of kStages 64-row tiles through mbarriers, two consumer warpgroups of
// 64 rows each, swizzled panels of W = 64, 32 or 16 columns). Nothing is
// recomputed from a maximum: the forward (K3's training route) saved each
// row's base-2 log-sum-exp and its output O in two bf16 parts (o + o_lo,
// P V with P in two parts), so P = exp2(scale log2(e) S - lse) on the MUFU
// unit, one FFMA and one ex2 per score, and D = rowsum(dP o P) =
// rowsum(dO o O) needs no pass over the keys.
//   1. attn_bwd_dq_kernel, one block per (128 query rows, head, group): each
//      thread first sums D for its two rows from dO, o and o_lo (written out
//      for kernel 2); Q_i and dO_i stay in shared memory, the key tiles K_j,
//      V_j stream: S and dP on wgmma, dS = P o (dP - D), dQ_i += dS K_j (dS
//      from registers as wgmma's A operand, K_j as its MN-major B, as P and
//      V in the forward);
//   2. attn_bwd_dkdv_kernel, one block per (128 keys, head, group): K_j and
//      V_j stay in shared memory, the query tiles Q_i, dO_i and their lse_i
//      and D_i stream; S^T = K_j Q_i^T and dP^T = V_j dO_i^T on wgmma (both
//      operands K-major), P^T and dS^T on the accumulator registers, then
//      dV_j += P^T dO_i and dK_j += dS^T Q_i with P^T, dS^T as register A
//      operands and dO_i, Q_i as MN-major B operands.
// Every block writes only its own rows, so no atomics are used and the
// result does not depend on the run. P and dS enter their products as two
// bf16 parts (hi + lo, about 16 significant bits): one part puts some
// outputs past the tolerance of 1e-2 |ref| + 1e-3 max|ref| (chip_smoke.py
// reports it), and so does D taken from the bf16 output o alone (without
// o_lo). Rows past N are zero-filled by TMA; the ragged last tile masks its
// P to 0. Shared memory does not depend on N (attn_bwd_smem_bytes): N = 16
// through 1440 run the same code.
// What bounds it on this card: at G=32, N=400, C=384 the five products take
// 19.7 GFLOP (0.020 ms at the bf16 peak) and the bytes 0.0205 ms; the
// kernels compute 10 product passes of 64 x 64 x hd (S and dP twice, the
// hi/lo parts) and 2 N^2 exponentials per head, with one block of two
// consumer warpgroups per SM. Measured on the H100 at hd=32 (PERF.md): the
// dK/dV kernel's 16 register-operand products per tile take the largest
// share, then its loads and stores, the elementwise work and S, dP.
//
// f32 route (kuzu_area_attention_bwd_f32): the TPU kernel takes any dtype
// and computes in f32; f32 inputs (the TrOCR encoder trained in f32) go to
// the 3xTF32 wgmma kernels of attention_f32_bwd.cuh (each operand x split
// into hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi), each of
// the five products taken as A_lo B_hi, A_hi B_lo, then A_hi B_hi,
// accumulated in f32 by the tensor core: f32-accurate, whatever
// torch.backends.cuda.matmul.allow_tf32 says), which read the f32 lse that
// K3's f32 training route writes and take D from its f32 output (there is
// no o_lo in f32).

#include "attention_f32_bwd.cuh"
#include "attention_fwd.cuh"

namespace kuzu {
namespace bwd {

using fwd::fast_exp2;
using fwd::fence_regs;
using fwd::kLog2e;
using fwd::mbar_arrive;
using fwd::mbar_expect_tx;
using fwd::mbar_init;
using fwd::mbar_wait;
using fwd::smem_addr;
using fwd::smem_desc;
using fwd::tma_load_3d;
using fwd::wgmma_commit;
using fwd::wgmma_fence;
using fwd::wgmma_rs;
using fwd::wgmma_ss_n64;
using fwd::wgmma_wait_all;

constexpr int kRows = 128;          // fixed rows per block (queries or keys)
constexpr int kTile = 64;           // rows per streamed tile
constexpr int kStages = 3;          // depth of the ring
constexpr int kThreads = 384;       // warpgroups 0, 1 consume, 2 produces
constexpr int kConsumerWarps = 8;   // arrivals on an "empty" barrier
constexpr int kProducerRegs = 24;   // one block per SM: 168 at entry
constexpr int kConsumerRegs = 240;
constexpr uint32_t kVecBytes = kTile * 4;  // one tile's lse or D (f32)

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head width 16..128, step 16");
  static constexpr int W = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);  // panel width
  static constexpr int kPanels = D / W;
  static constexpr uint32_t kRowBytes = W * 2;
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // the swizzle atom: 8 rows
  static constexpr uint32_t kFixedBytes = kRows * D * 2;
  static constexpr uint32_t kTileBytes = kTile * D * 2;
};

// Shared memory of a block of either kernel: 1024 bytes to align the
// swizzled panels, two fixed 128-row tiles, kStages pairs of 64-row tiles
// with their lse and D, then the barriers. Constant in N.
__host__ __device__ constexpr size_t attn_bwd_smem_bytes(int d) {
  return 1024 + (size_t)2 * kRows * d * 2 + (size_t)kStages * (2 * kTile * d * 2 + 2 * kVecBytes) +
         128;
}

__device__ __forceinline__ void init_barriers(uint32_t fixed_full, uint32_t full0,
                                              uint32_t empty0) {
  if (threadIdx.x == 0) {
    mbar_init(fixed_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Loads the two fixed tiles (rows r0.., box 128 rows, every panel of head
// column col) on barrier bar.
template <int D>
__device__ __forceinline__ void load_fixed(uint32_t dst0, uint32_t dst1, const CUtensorMap* t0,
                                           const CUtensorMap* t1, uint32_t bar, int col, int r0,
                                           int g) {
  using S = Shape<D>;
  mbar_expect_tx(bar, 2 * S::kFixedBytes);
#pragma unroll
  for (int a = 0; a < S::kPanels; ++a) {
    tma_load_3d(dst0 + a * kRows * S::kRowBytes, t0, bar, col + a * S::W, r0, g);
    tma_load_3d(dst1 + a * kRows * S::kRowBytes, t1, bar, col + a * S::W, r0, g);
  }
}

// Issues the two tiles of stream tile `tile` (box 64 rows) into dst0, dst1
// on barrier bar, with `extra` more bytes expected on it.
template <int D>
__device__ __forceinline__ void load_tiles(uint32_t dst0, uint32_t dst1, const CUtensorMap* t0,
                                           const CUtensorMap* t1, uint32_t bar, int col, int tile,
                                           int g, uint32_t extra) {
  using S = Shape<D>;
  mbar_expect_tx(bar, 2 * S::kTileBytes + extra);
#pragma unroll
  for (int a = 0; a < S::kPanels; ++a) {
    tma_load_3d(dst0 + a * kTile * S::kRowBytes, t0, bar, col + a * S::W, tile * kTile, g);
    tma_load_3d(dst1 + a * kTile * S::kRowBytes, t1, bar, col + a * S::W, tile * kTile, g);
  }
}

// acc = X Y^T over D for this warpgroup's 64 rows of a fixed tile (X at
// x_wg) and a 64-row stage (Y at y): both K-major, as S = Q K^T in the
// forward. Issues only; the caller commits and waits.
template <int D>
__device__ __forceinline__ void xyt(float (&acc)[32], uint32_t x_wg, uint32_t y) {
  using S = Shape<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk * 16 / S::W;
    const uint32_t off = (kk * 16 % S::W) * 2;
    wgmma_ss_n64(acc, smem_desc<S::W>(x_wg + a * kRows * S::kRowBytes + off, 16, S::kGroup),
                 smem_desc<S::W>(y + a * kTile * S::kRowBytes + off, 16, S::kGroup), kk > 0);
  }
}

// acc += X Y for X (64 x 64) in registers as two bf16 parts, in the
// accumulator layout (x[4 j + e] at row 16 w + r + 8 (e >> 1), column
// 8 j + 2 c + (e & 1)), and Y (64 x D) a stage read as wgmma's MN-major B.
// Fences and issues; the caller commits and waits.
template <int D>
__device__ __forceinline__ void xy_acc(float (&acc)[D / 2], const float (&x)[32], uint32_t y) {
  using S = Shape<D>;
  uint32_t hi[kTile / 16][4], lo[kTile / 16][4];
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = x[8 * kk + 2 * e], x1 = x[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      hi[kk][e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][e] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
    }
  }
  wgmma_fence();  // the A registers were written since the last fence
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint64_t db = smem_desc<S::W>(y + kk * 16 * S::kRowBytes, kTile * S::kRowBytes, S::kGroup);
    wgmma_rs(acc, hi[kk], db);
    wgmma_rs(acc, lo[kk], db);
  }
}

// rows row, row + 8 of out (row stride os, rows of group g from g * n) at
// head column col: bf16(acc * mul); rows past n are not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int os, int g, int n, int row, int col,
                                           int c, const float (&acc)[D / 2], float mul) {
  bf16* lo = out + ((size_t)g * n + row) * os + col + 2 * c;
  bf16* hi = lo + (size_t)8 * os;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < n)
      *reinterpret_cast<uint32_t*>(lo + 8 * j) =
          pack_bf16(__fmul_rn(acc[4 * j], mul), __fmul_rn(acc[4 * j + 1], mul));
    if (row + 8 < n)
      *reinterpret_cast<uint32_t*>(hi + 8 * j) =
          pack_bf16(__fmul_rn(acc[4 * j + 2], mul), __fmul_rn(acc[4 * j + 3], mul));
  }
}

// ------------------------------------------------------------------ kernel 1

// Grid (ceil(n / 128), heads, g). tq, tdo: maps with box (W, 128, 1); tk,
// tv: box (W, 64, 1). dout (row stride do_stride), o and o_lo (row stride
// o_stride): dO and the forward's output in two bf16 parts; lse: (g, heads,
// n) base-2 log-sum-exp of the forward; dvec: (g, heads, n) f32, D written
// here; dq at row stride dq_stride.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const bf16* __restrict__ dout, int do_stride, const bf16* __restrict__ o,
                   const bf16* __restrict__ o_lo, int o_stride, const float* __restrict__ lse,
                   float* __restrict__ dvec, bf16* __restrict__ dq, int dq_stride, int n,
                   float scale_log2, float scale) {
  using S = Shape<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + S::kFixedBytes;
  const uint32_t sk = sdo + S::kFixedBytes;  // stage s: K at sk + s kTileBytes
  const uint32_t sv = sk + kStages * S::kTileBytes;
  const uint32_t fixed_full = sv + kStages * S::kTileBytes + kStages * 2 * kVecBytes;
  const uint32_t full0 = fixed_full + 8, empty0 = full0 + 8 * kStages;
  const int h = blockIdx.y, g = blockIdx.z, m0 = blockIdx.x * kRows;
  const int ntiles = (n + kTile - 1) / kTile;
  init_barriers(fixed_full, full0, empty0);

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      const int col = h * D;
      load_fixed<D>(sq, sdo, &tq, &tdo, fixed_full, col, m0, g);
      for (int j = 0; j < ntiles; ++j) {  // the key tiles
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        load_tiles<D>(sk + s * S::kTileBytes, sv + s * S::kTileBytes, &tk, &tv, full0 + 8 * s,
                      col, j, g, 0);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = lane >> 2, c = lane & 3;
    const int row = m0 + 64 * wg + 16 * warp + r;  // this thread's rows: row, row + 8
    const bool active = m0 + 64 * wg < n;          // the warpgroup has rows to compute
    const size_t vrow = ((size_t)g * gridDim.y + h) * n;
    const float lse_lo = row < n ? lse[vrow + row] : 0.0f;
    const float lse_hi = row + 8 < n ? lse[vrow + row + 8] : 0.0f;
    const uint32_t q_wg = sq + 64 * wg * S::kRowBytes, do_wg = sdo + 64 * wg * S::kRowBytes;

    // D = rowsum(dO o (o + o_lo)) of this thread's rows, over its columns
    // 8 j + 2 c, + 1 of the head, then over the row's 4 lanes
    float d_lo = 0.0f, d_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = h * D + 8 * j + 2 * c;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = row + 8 * half;
        if (rr >= n) continue;
        const size_t ro = ((size_t)g * n + rr) * o_stride + col;
        const __nv_bfloat162 d2 =
            *reinterpret_cast<const __nv_bfloat162*>(dout + ((size_t)g * n + rr) * do_stride + col);
        const __nv_bfloat162 o2 = *reinterpret_cast<const __nv_bfloat162*>(o + ro);
        const __nv_bfloat162 l2 = *reinterpret_cast<const __nv_bfloat162*>(o_lo + ro);
        const float part = __low2float(d2) * (__low2float(o2) + __low2float(l2)) +
                           __high2float(d2) * (__high2float(o2) + __high2float(l2));
        if (half) d_hi += part;
        else d_lo += part;
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      d_lo += __shfl_xor_sync(0xffffffffu, d_lo, x);
      d_hi += __shfl_xor_sync(0xffffffffu, d_hi, x);
    }
    if (c == 0) {
      if (row < n) dvec[vrow + row] = d_lo;
      if (row + 8 < n) dvec[vrow + row + 8] = d_hi;
    }

    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;
    mbar_wait(fixed_full, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full0 + 8 * s, (j / kStages) & 1);
      if (active) {
        const uint32_t ks = sk + s * S::kTileBytes, vs = sv + s * S::kTileBytes;
        float sc[32], dp[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.0f;
        wgmma_fence();
        xyt<D>(sc, q_wg, ks);   // S = Q K^T (unscaled)
        xyt<D>(dp, do_wg, vs);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
#pragma unroll
        for (int x = 0; x < 32; ++x)
          sc[x] = fast_exp2(fmaf(sc[x], scale_log2, -(x & 2 ? lse_hi : lse_lo)));  // P
        if (j == ntiles - 1 && n % kTile != 0) {  // keys past n (zero-filled rows): P = 0
#pragma unroll
          for (int x = 0; x < 32; ++x)
            if (j * kTile + 8 * (x >> 2) + 2 * c + (x & 1) >= n) sc[x] = 0.0f;
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) dp[x] = sc[x] * (dp[x] - (x & 2 ? d_hi : d_lo));  // dS
        // dQ += dS K_j; K (keys x D, D contiguous) as the MN-major B
        xy_acc<D>(acc, dp, ks);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }
    if (active) store_rows<D>(dq, dq_stride, g, n, row, h * D, c, acc, scale);
  }
}

// ------------------------------------------------------------------ kernel 2

// Grid (ceil(n / 128), heads, g). tk, tv: maps with box (W, 128, 1); tq,
// tdo: box (W, 64, 1); tl, td: row maps of lse and D with box (64, 1, 1).
// dk, dv at row strides dk_stride, dv_stride.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tl,
                     const __grid_constant__ CUtensorMap td, bf16* __restrict__ dk,
                     int dk_stride, bf16* __restrict__ dv, int dv_stride, int n,
                     float scale_log2, float scale) {
  using S = Shape<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sv = sk + S::kFixedBytes;
  const uint32_t sq = sv + S::kFixedBytes;  // stage s: Q at sq + s kTileBytes
  const uint32_t sdo = sq + kStages * S::kTileBytes;
  const uint32_t sl = sdo + kStages * S::kTileBytes;  // stage s: lse at sl + s kVecBytes
  const uint32_t sd = sl + kStages * kVecBytes;
  const uint32_t fixed_full = sd + kStages * kVecBytes;
  const uint32_t full0 = fixed_full + 8, empty0 = full0 + 8 * kStages;
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sl - smem_addr(smem_raw)));
  const float* d_s = reinterpret_cast<const float*>(smem_raw + (sd - smem_addr(smem_raw)));
  const int h = blockIdx.y, g = blockIdx.z, n0 = blockIdx.x * kRows;
  const int ntiles = (n + kTile - 1) / kTile;
  init_barriers(fixed_full, full0, empty0);

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      const int col = h * D;
      load_fixed<D>(sk, sv, &tk, &tv, fixed_full, col, n0, g);
      for (int j = 0; j < ntiles; ++j) {  // the query tiles
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        load_tiles<D>(sq + s * S::kTileBytes, sdo + s * S::kTileBytes, &tq, &tdo, bar, col, j, g,
                      2 * kVecBytes);
        tma_load_3d(sl + s * kVecBytes, &tl, bar, j * kTile, h, g);
        tma_load_3d(sd + s * kVecBytes, &td, bar, j * kTile, h, g);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = lane >> 2, c = lane & 3;
    const int key = n0 + 64 * wg + 16 * warp + r;  // this thread's keys: key, key + 8
    const bool active = n0 + 64 * wg < n;
    const uint32_t k_wg = sk + 64 * wg * S::kRowBytes, v_wg = sv + 64 * wg * S::kRowBytes;

    float acc_dv[D / 2], acc_dk[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc_dv[x] = acc_dk[x] = 0.0f;
    mbar_wait(fixed_full, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full0 + 8 * s, (j / kStages) & 1);
      if (active) {
        const uint32_t qs = sq + s * S::kTileBytes, dos = sdo + s * S::kTileBytes;
        float sc[32], dp[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.0f;
        wgmma_fence();
        xyt<D>(sc, k_wg, qs);   // S^T = K Q^T: keys x queries
        xyt<D>(dp, v_wg, dos);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);
        const float* lv = lse_s + s * kTile;
        const float* dd = d_s + s * kTile;
#pragma unroll
        for (int jj = 0; jj < kTile / 8; ++jj) {  // this thread's queries: 8 jj + 2 c, + 1
          const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * jj + 2 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * jj + e] = fast_exp2(fmaf(sc[4 * jj + e], scale_log2, -(e & 1 ? l2.y : l2.x)));
        }
        if (j == ntiles - 1 && n % kTile != 0) {  // queries past n (zero-filled rows): P = 0
#pragma unroll
          for (int x = 0; x < 32; ++x)
            if (j * kTile + 8 * (x >> 2) + 2 * c + (x & 1) >= n) sc[x] = 0.0f;
        }
#pragma unroll
        for (int jj = 0; jj < kTile / 8; ++jj) {
          const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * jj + 2 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e)  // dS^T
            dp[4 * jj + e] = sc[4 * jj + e] * (dp[4 * jj + e] - (e & 1 ? d2.y : d2.x));
        }
        xy_acc<D>(acc_dv, sc, dos);  // dV += P^T dO
        if constexpr (D > 64) {
          // wide heads: P's parts die before dS's are made (registers)
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc_dv);
        }
        xy_acc<D>(acc_dk, dp, qs);   // dK += dS^T Q
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc_dv);
        fence_regs(acc_dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }
    if (active) {
      store_rows<D>(dv, dv_stride, g, n, key, h * D, c, acc_dv, 1.0f);
      store_rows<D>(dk, dk_stride, g, n, key, h * D, c, acc_dk, scale);
    }
  }
}

// ----------------------------------------------------------------------- host

template <int D>
int launch(const void* q, int q_stride, const void* k, int k_stride, const void* v, int v_stride,
           const void* dout, int do_stride, const void* o, const void* o_lo, int o_stride,
           const float* lse, float* dvec, void* dq, int dq_stride, void* dk, int dk_stride,
           void* dv, int dv_stride, int g, int n, int heads, float scale, cudaStream_t stream) {
  using S = Shape<D>;
  const int smem = (int)attn_bwd_smem_bytes(D);
  static const cudaError_t attr1 =
      cudaFuncSetAttribute(attn_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  const int c = heads * D;
  CUtensorMap q128, do128, k64, v64, k128, v128, q64, do64, ml, md;
  if (!fwd::make_map(&q128, q, c, q_stride, n, g, S::W, kRows) ||
      !fwd::make_map(&do128, dout, c, do_stride, n, g, S::W, kRows) ||
      !fwd::make_map(&k64, k, c, k_stride, n, g, S::W, kTile) ||
      !fwd::make_map(&v64, v, c, v_stride, n, g, S::W, kTile) ||
      !fwd::make_map(&k128, k, c, k_stride, n, g, S::W, kRows) ||
      !fwd::make_map(&v128, v, c, v_stride, n, g, S::W, kRows) ||
      !fwd::make_map(&q64, q, c, q_stride, n, g, S::W, kTile) ||
      !fwd::make_map(&do64, dout, c, do_stride, n, g, S::W, kTile) ||
      !fwd::make_row_map(&ml, lse, n, heads, g, kTile) ||
      !fwd::make_row_map(&md, dvec, n, heads, g, kTile))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, heads, g);
  const float scale_log2 = scale * kLog2e;
  attn_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      q128, do128, k64, v64, static_cast<const bf16*>(dout), do_stride,
      static_cast<const bf16*>(o), static_cast<const bf16*>(o_lo), o_stride, lse, dvec,
      static_cast<bf16*>(dq), dq_stride, n, scale_log2, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(
      k128, v128, q64, do64, ml, md, static_cast<bf16*>(dk), dk_stride, static_cast<bf16*>(dv),
      dv_stride, n, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace kuzu

extern "C" size_t kuzu_area_attention_bwd_smem(int hd) { return kuzu::bwd::attn_bwd_smem_bytes(hd); }

// q, k, v, dout: (g, n, heads * hd) bf16 with their own row strides (q and k
// may be column slices of one qk tensor); o, o_lo (row stride o_stride),
// lse: (g, heads, n) f32: the forward's output in two bf16 parts and its
// row statistics; dvec: (g, heads, n) f32 scratch (D); dq, dk, dv written
// at their own row strides (dq and dk may be the column halves of one
// tensor). All bases and row strides 16-byte aligned, n % 4 == 0. Returns a
// cudaError_t (cudaErrorInvalidValue for a head width other than 16..128 in
// steps of 16, or an unaligned base or stride).
extern "C" int kuzu_area_attention_bwd(const void* q, int q_stride, const void* k, int k_stride,
                                       const void* v, int v_stride, const void* dout,
                                       int do_stride, const void* o, const void* o_lo,
                                       int o_stride, const float* lse, float* dvec, void* dq,
                                       int dq_stride, void* dk, int dk_stride, void* dv,
                                       int dv_stride, int g, int n, int heads, int hd, float scale,
                                       void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KUZU_BWD_CASE(D)                                                                       \
  case D:                                                                                      \
    return kuzu::bwd::launch<D>(q, q_stride, k, k_stride, v, v_stride, dout, do_stride, o,    \
                                o_lo, o_stride, lse, dvec, dq, dq_stride, dk, dk_stride, dv,   \
                                dv_stride, g, n, heads, scale, s);
  switch (hd) {
    KUZU_BWD_CASE(16)
    KUZU_BWD_CASE(32)
    KUZU_BWD_CASE(48)
    KUZU_BWD_CASE(64)
    KUZU_BWD_CASE(80)
    KUZU_BWD_CASE(96)
    KUZU_BWD_CASE(112)
    KUZU_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KUZU_BWD_CASE
}

// Shared memory of one block of the f32 route's dQ (which == 0) or dK/dV
// kernel (constant in N).
extern "C" size_t kuzu_area_attention_bwd_f32_smem(int hd, int which) {
  return which == 0 ? kuzu::f32bwd::dq_smem_bytes(hd) : kuzu::f32bwd::dkdv_smem_bytes(hd);
}

// The f32 route: q, k, v, dout, o f32 (g, n, heads * hd) with their own row
// strides (in floats), lse (g, heads, n) f32 from K3's f32 training route,
// dvec (g, heads, n) f32 scratch (D); dq, dk, dv written at their own row
// strides. Bases and strides 16-byte aligned. Two launches (dQ, then
// dK/dV). Returns a cudaError_t.
extern "C" int kuzu_area_attention_bwd_f32(const void* q, int q_stride, const void* k,
                                           int k_stride, const void* v, int v_stride,
                                           const void* dout, int do_stride, const void* o,
                                           int o_stride, const float* lse, float* dvec, void* dq,
                                           int dq_stride, void* dk, int dk_stride, void* dv,
                                           int dv_stride, int g, int n, int heads, int hd,
                                           float scale, void* stream) {
  return kuzu::attention_f32_bwd(q, q_stride, k, k_stride, v, v_stride, dout, do_stride, o,
                                 o_stride, lse, dvec, dq, dq_stride, dk, dk_stride, dv,
                                 dv_stride, g, n, heads, hd, scale,
                                 static_cast<cudaStream_t>(stream));
}

// K2's four products on Hopper (sm_90a): one TMA-fed wgmma GEMM kernel,
//
//     out = epilogue(A W + bias)
//
// with A (m, k) bf16 row-major (activations), W (k, n) bf16 row-major (the
// BN-folded 1x1 conv weight as Cin x Cout), bias (n) f32, f32 accumulation.
// The epilogues sit at the reference kernel's rounding points
// (kuzu/ops/fused_ablock.py:52-85):
//   kQk:   out = bf16(acc + b)                    qk = x Wqk + bqk
//   kProj: out = res + bf16(acc + b) (bf16 add)   x1 = x + (o + pe) Wp + bp
//   kMlp1: out = bf16(silu(acc + b))              h = silu(x1 W1 + b1)
//   kMlp2: out = res + bf16(acc + b) (bf16 add)   out = x1 + h W2 + b2
// (kProj and kMlp2 are one epilogue; two names so that a profiler trace
// tells the four launches apart.)
//
// Design. Persistent blocks (as many as fit on the card at once) walk the
// (128 rows, BN columns) output tiles, three warpgroups each as in
// attention_fwd.cuh, whose descriptors, swizzled panels, tensor maps and
// mbarrier ring it reuses:
//   - warpgroup 2 produces: one thread streams the k dimension of tile after
//     tile in 64-wide slabs through a ring: A's 128 x 64 tile (one panel of
//     128-byte swizzled rows, K-major for wgmma) and W's 64 x BN tile (BN /
//     64 panels of 64 columns: wgmma's MN-major B operand, as V is in the
//     forward attention), both by TMA, which zero-fills past m, n and k. The
//     ring runs on across tiles, so the next tile's slabs load while the
//     consumers finish the last one's epilogue;
//   - warpgroups 0 and 1 consume: each owns 64 rows of the tile and runs
//     m64nBNk16 wgmma with both operands from shared memory, one slab's
//     products in flight while the next slab's are issued. The epilogue
//     writes bf16(acc + bias) (SiLU'd for kMlp1) from the accumulator
//     registers into a swizzled staging tile in shared memory, then each
//     thread moves whole 16-byte pieces of rows to global memory, adding the
//     residual read the same way: full lines both ways (the accumulator
//     layout alone gives 4-byte pieces of eight rows, which cost as much as
//     the products at these shapes).
// Tiles cover n as well as m, so the G=8 shape (m = 3200, 25 row tiles)
// still fills the card: BN = 128 where that gives at least two tiles per
// SM, else 64 (twice the tiles, two blocks per SM). The weights (0.3-0.4 MB)
// stay in L2; A's tile is read once per column tile. What bounds it on this
// card: operations (2 m k n per product), about 0.023 ms for the four at
// yolov12x@640 batch 8 (m = 12,800) at the bf16 peak, and next to them the
// slabs' traffic from L2 (A once per column tile: 115 MB for the qk product).
// Keeping W's column panel in shared memory (only A streaming) halved that
// traffic but was slower on the H100: the panel's load at each block's start
// is not hidden.
#pragma once

#include "attention_fwd.cuh"

namespace kuzu {
namespace gemm {

using fwd::fence_regs;
using fwd::mbar_arrive;
using fwd::mbar_expect_tx;
using fwd::mbar_init;
using fwd::mbar_wait;
using fwd::smem_addr;
using fwd::smem_desc;
using fwd::tma_load_3d;
using fwd::wgmma_commit;
using fwd::wgmma_fence;

enum Epilogue { kQk = 0, kProj = 1, kMlp1 = 2, kMlp2 = 3 };

constexpr int kBM = 128;         // rows per tile: two consumer warpgroups of 64
constexpr int kBK = 64;          // k per stage: one 128-byte swizzled panel
constexpr int kThreads = 384;    // warpgroups 0, 1 consume, 2 produces
constexpr int kConsumerWarps = 8;
constexpr uint32_t kRowBytes = kBK * 2;      // 128
constexpr uint32_t kGroup = 8 * kRowBytes;   // the swizzle atom: 8 rows
constexpr uint32_t kABytes = kBM * kRowBytes;

template <int BN>
struct Cfg {
  static_assert(BN == 64 || BN == 128, "column tile of 64 or 128");
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  static constexpr int kStages = BN == 64 ? 3 : 4;  // two blocks of 64 columns fit an SM
  static constexpr int kProducerRegs = 24;
  // registers at entry 80 (two blocks of 384 threads) or 168; the consumers
  // take what the producer gives back
  static constexpr int kConsumerRegs = BN == 64 ? 104 : 240;
  static constexpr uint32_t kWBytes = kBK * BN * 2;
  static constexpr uint32_t kStageBytes = kABytes + kWBytes;
  static constexpr uint32_t kOutBytes = kBM * BN * 2;  // the staging tile
};

// Shared memory of one block: 1024 bytes to align the panels, the ring, the
// staging tile, 128 bytes of barriers. Constant in m, n and k.
__host__ __device__ constexpr size_t gemm_smem_bytes(int bn) {
  return 1024 + (size_t)(bn == 64 ? 3 : 4) * (kABytes + (size_t)kBK * bn * 2) +
         (size_t)kBM * bn * 2 + 128;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// barrier `id` (1, 2: one per consumer warpgroup) over its 128 threads
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__host__ __device__ constexpr bool has_residual(int epi) { return epi == kProj || epi == kMlp2; }

// One output pair from its f32 sums (bias added), before any residual.
__device__ __forceinline__ uint32_t epilogue_pair(int epi, float v0, float v1) {
  if (epi == kMlp1) {  // silu on the f32 pre-activation (MUFU exp, fast divide), one rounding
    v0 = __fdividef(v0, 1.0f + __expf(-v0));
    v1 = __fdividef(v1, 1.0f + __expf(-v1));
  }
  return pack_bf16(v0, v1);
}

// Staging tile of a warpgroup: 64 rows of BN bf16, the 16-byte piece j of
// row r at piece j ^ (r & 7) (the eight rows a fragment store touches at
// once fall in different banks).
template <int BN>
__device__ __forceinline__ uint32_t staged(uint32_t base, int r, int piece) {
  return base + r * (BN * 2) + ((piece ^ (r & 7)) << 4);
}

// Grid: up to one block per tile slot (tile t is rows (t / ceil(n / BN)) *
// kBM, columns (t % ceil(n / BN)) * BN), kThreads threads,
// gemm_smem_bytes(BN) bytes. ta: (k, m) tensor map of A with box (64, 128);
// tw: (n, k) tensor map of W with box (64, 64). out and res are (m, n)
// row-major, n % 8 == 0, 16-byte aligned.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, Cfg<BN>::kMinBlocks)
ablock_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ bias, const bf16* __restrict__ res,
                   bf16* __restrict__ out, int m, int n, int k) {
  using C = Cfg<BN>;
  constexpr int kStages = C::kStages;
  constexpr int kPieces = BN / 8;                   // 16-byte pieces per row
  constexpr int kPerThread = 64 * kPieces / 128;    // pieces per thread per warpgroup tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // stage s at base + s * kStageBytes
  const uint32_t stage_out = base + kStages * C::kStageBytes;  // warpgroup w's 64 rows at + w * kOutBytes / 2
  const uint32_t full0 = stage_out + C::kOutBytes, empty0 = full0 + 8 * kStages;
  const int ntn = (n + BN - 1) / BN, ntiles = ((m + kBM - 1) / kBM) * ntn;
  const int ktiles = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;  // slabs issued by this block, over all its tiles
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int m0 = t / ntn * kBM, n0 = t % ntn * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t bar = full0 + 8 * s, st = base + s * C::kStageBytes;
          mbar_expect_tx(bar, C::kStageBytes);
          tma_load_3d(st, &ta, bar, kt * kBK, m0, 0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(st + kABytes + p * kBK * kRowBytes, &tw, bar, n0 + 64 * p, kt * kBK, 0);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = lane >> 2, c = lane & 3, tid = threadIdx.x & 127;
    const uint32_t my_out = stage_out + wg * (C::kOutBytes / 2);
    unsigned char* const out_ptr = smem_raw + (my_out - smem_addr(smem_raw));
    int it = 0;  // slabs consumed
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int m0 = t / ntn * kBM, n0 = t % ntn * BN;
      const int row0 = m0 + 64 * wg;  // this warpgroup's 64 rows
      // the bias pairs of this thread's fragment columns and the residual
      // pieces of its copy-out, loaded before the products so that their
      // latency hides behind them
      float2 bv[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * c;
        bv[j] = col < n ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
      }
      uint4 rv[has_residual(EPI) ? kPerThread : 1];
      if constexpr (has_residual(EPI)) {
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const int piece = tid + 128 * i, rr = row0 + piece / kPieces;
          const int col = n0 + piece % kPieces * 8;
          rv[i] = rr < m && col < n
                      ? *reinterpret_cast<const uint4*>(res + (size_t)rr * n + col)
                      : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        const uint32_t st = base + s * C::kStageBytes;
        const uint32_t a = st + 64 * wg * kRowBytes, w = st + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          // A: K-major, a k step is 32 bytes inside the swizzled row; W:
          // MN-major, a k step is 16 rows on, panels 64 rows apart
          wgmma_ss_mn(acc, smem_desc<64>(a + kk * 32, 16, kGroup),
                      smem_desc<64>(w + kk * 16 * kRowBytes, kBK * kRowBytes, kGroup), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's products are done: release its stage
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

      // 1. fragments to the staging tile; accumulator layout:
      //    acc[4 j + e] = D[16 warp + r + 8 (e >> 1)][8 j + 2 c + (e & 1)]
      const int lr = 16 * warp + r;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t lo = epilogue_pair(EPI, acc[4 * j] + bv[j].x, acc[4 * j + 1] + bv[j].y);
        const uint32_t hi =
            epilogue_pair(EPI, acc[4 * j + 2] + bv[j].x, acc[4 * j + 3] + bv[j].y);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(staged<BN>(my_out, lr, j) + 4 * c), "r"(lo)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(staged<BN>(my_out, lr + 8, j) + 4 * c),
                     "r"(hi)
                     : "memory");
      }
      wg_sync(1 + wg);
      // 2. whole 16-byte pieces of rows to global memory, plus the residual
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int piece = tid + 128 * i, lrow = piece / kPieces, pc = piece % kPieces;
        const int rr = row0 + lrow, col = n0 + pc * 8;
        uint4 v = *reinterpret_cast<const uint4*>(
            out_ptr + (staged<BN>(my_out, lrow, pc) - my_out));
        if constexpr (has_residual(EPI)) {
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&rv[i]);
          __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 y = v2[e];
            v2[e] = __halves2bfloat162(add_bf(a2[e].x, y.x), add_bf(a2[e].y, y.y));
          }
        }
        if (rr < m && col < n) *reinterpret_cast<uint4*>(out + (size_t)rr * n + col) = v;
      }
      wg_sync(1 + wg);  // the staging tile is free for the next tile
    }
  }
}

// ----------------------------------------------------------------------- host

inline int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return sms;
}

template <int BN, int EPI>
int launch(const void* a, const void* w, const float* bias, const void* res, void* out, int m,
           int n, int k, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(ablock_gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)gemm_smem_bytes(BN));
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap ma, mw;
  if (!fwd::make_map(&ma, a, k, k, m, 1, 64, kBM) || !fwd::make_map(&mw, w, n, n, k, 1, 64, kBK))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  const long slots = (long)sm_count() * Cfg<BN>::kMinBlocks;
  ablock_gemm_kernel<BN, EPI><<<(unsigned)(tiles < slots ? tiles : slots), kThreads,
                                gemm_smem_bytes(BN), stream>>>(
      ma, mw, bias, static_cast<const bf16*>(res), static_cast<bf16*>(out), m, n, k);
  return (int)cudaGetLastError();
}

// 128-column tiles where they give two tiles per SM, else 64
template <int EPI>
int run(const void* a, const void* w, const float* bias, const void* res, void* out, int m,
        int n, int k, cudaStream_t stream) {
  const long tiles128 = (long)((m + kBM - 1) / kBM) * ((n + 127) / 128);
  if (tiles128 >= 2L * sm_count()) return launch<128, EPI>(a, w, bias, res, out, m, n, k, stream);
  return launch<64, EPI>(a, w, bias, res, out, m, n, k, stream);
}

}  // namespace gemm
}  // namespace kuzu

// The port's 1x1 products on Hopper (sm_90a): one TMA-fed wgmma GEMM kernel
// for K2's four products (fused_ablock.cu) and K6's 1x1 convs
// (fused_c3k2.cu),
//
//     out[p, :n] = epilogue(sum_k A[p, k] W[k, :] + bias)
//
// with A (m, k) bf16, rows a_cs elements apart (A may be a channel slice of
// a wider NHWC buffer), W (k, n) bf16 row-major (a BN-folded 1x1 conv weight
// as Cin x Cout), bias (n) f32, f32 sums, and out (m, n) bf16, rows out_cs
// apart (a channel slice too). The epilogues sit at the reference kernels'
// rounding points (kuzu/ops/fused_ablock.py:52-85, the conv chain of
// kuzu/ops/fused_c3k2.py::_kernel):
//   kQk:                 out = bf16(acc + b)
//   kMlp1, kConv, kConvMerged:
//                        out = bf16(silu(acc + b))   (SiLU in f32: MUFU exp, fast divide)
//   kProj, kMlp2:        out = res + bf16(acc + b)   (one bf16 add)
// (one epilogue under several names so that a profiler trace tells the
// launches apart: K2's qk, proj, mlp1 and mlp2; K6's 1x1 convs, and a C3k's
// cv1 and bypass cv2 merged into one product with the weights side by side.)
//
// Design. Persistent blocks (as many as fit on the card at once) walk the
// (128 rows, BN columns) output tiles, BN = 64, 128 or 192, with three
// warpgroups each as in attention_fwd.cuh, whose descriptors, swizzled
// panels, tensor maps and mbarrier ring it reuses:
//   - warpgroup 2 produces: one thread streams the k dimension of tile after
//     tile in 64-wide slabs through a ring: A's 128 x 64 tile (one panel of
//     128-byte swizzled rows, K-major for wgmma) and W's 64 x BN tile (BN /
//     64 panels of 64 columns: wgmma's MN-major B operand, as V is in the
//     forward attention), both by TMA, which zero-fills past m, n and k (a
//     slab's columns past k add nothing, whatever W holds there). The ring
//     runs on across tiles, so the next tile's slabs load while the
//     consumers finish the last one's epilogue;
//   - warpgroups 0 and 1 consume: each owns 64 rows of the tile and runs
//     m64nBNk16 wgmma with both operands from shared memory, one slab's
//     products in flight while the next slab's are issued.
// The epilogue (struct Epilogue, shared with conv.cuh's 3x3 kernel) loads
// the tile's bias at the tile's start and has TMA bring the residual's tile
// into the staging rows while the products run; at the end it writes
// bf16(epilogue(acc + bias)) (plus the residual, a bf16 add in place) into
// a staging tile laid out as the TMA store's boxes (64-column panels,
// 128-byte swizzle: the fragment stores of eight rows fall in different
// banks), and one thread per warpgroup stores it with TMA, which clips the
// rows past m and the columns past n; the consumers go on to the next tile
// while the store drains (the accumulator layout alone gives 4-byte pieces
// of eight rows, which cost as much as the products at K2's shapes).
// Column tiles: the width of least work for the busiest SM (column_tile);
// BN = 64 runs two blocks to an SM. What bounds it on this
// card: operations (2 m k n), about 0.023 ms for K2's four at yolov12x@640
// batch 8 (m = 12,800) at the bf16 peak, and next to them the slabs'
// traffic from L2 (A once per column tile); K6's 1x1 convs, at k and n of
// 96-1536, the bytes of their input and output.
// Internal linkage (an anonymous namespace), as attention_fwd.cuh's, whose
// note says why.
#pragma once

#include "attention_fwd.cuh"

namespace kuzu {
namespace {
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

enum Epi { kQk = 0, kProj = 1, kMlp1 = 2, kMlp2 = 3, kConv = 4, kConvMerged = 5 };

__host__ __device__ constexpr bool has_silu(int epi) { return epi == kMlp1 || epi >= kConv; }
__host__ __device__ constexpr bool has_residual(int epi) { return epi == kProj || epi == kMlp2; }

constexpr int kBM = 128;         // rows per tile: two consumer warpgroups of 64
constexpr int kBK = 64;          // k per stage: one 128-byte swizzled panel
constexpr int kThreads = 384;    // warpgroups 0, 1 consume, 2 produces
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr uint32_t kRowBytes = kBK * 2;      // 128
constexpr uint32_t kGroup = 8 * kRowBytes;   // the swizzle atom: 8 rows
constexpr uint32_t kABytes = kBM * kRowBytes;
constexpr uint32_t kPanelBytes = kBK * kRowBytes;  // a W panel: 64 rows of 64 columns
constexpr size_t kSmemLimit = 232448;  // what a block can opt into
constexpr int kWidths[3] = {64, 128, 192};  // the column tiles built

__host__ __device__ constexpr uint32_t w_tile_bytes(int bn) { return bn * kRowBytes; }
// The epilogue's share of a block: the staging tile (both warpgroups' 64
// rows, as bn / 64 swizzled panels of 64 columns: the TMA store's boxes) and
// each warpgroup's copy of the tile's bias.
__host__ __device__ constexpr size_t epilogue_bytes(int bn) {
  return (size_t)kBM * bn * 2 + 2 * (size_t)bn * 4;
}
// Blocks to an SM and ring depth by column tile: two blocks of 64 columns
// share an SM (one's epilogue runs under the other's products).
__host__ __device__ constexpr int min_blocks(int bn) { return bn == 64 ? 2 : 1; }
__host__ __device__ constexpr int stages(int bn) { return bn == 64 ? 3 : bn == 128 ? 6 : 4; }

// Shared memory of one block: 1024 bytes to align the panels, the ring of
// (A, W) slabs, the epilogue's share, 128 bytes of barriers. Constant in m,
// n and k.
__host__ __device__ constexpr size_t gemm_smem_bytes(int bn) {
  return 1024 + (size_t)stages(bn) * (kABytes + w_tile_bytes(bn)) + epilogue_bytes(bn) + 128;
}
static_assert(gemm_smem_bytes(64) <= kSmemLimit && gemm_smem_bytes(128) <= kSmemLimit &&
                  gemm_smem_bytes(192) <= kSmemLimit,
              "every column tile fits a block");
static_assert(2 * (gemm_smem_bytes(64) + 1024) <= 233472, "two 64-column blocks fit an SM");

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// barrier `id` (1, 2: one per consumer warpgroup) over its 128 threads
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d (m64nN, f32) += A B, A K-major and B MN-major, both from shared memory.
// N = 2 x d's registers.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// shared -> global box stores, tracked as bulk groups of the issuing thread
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read their shared memory (.read) or are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void init_barriers(uint32_t full0, uint32_t empty0, int count) {
  for (int s = 0; s < count; ++s) {
    mbar_init(full0 + 8 * s, 1);
    mbar_init(empty0 + 8 * s, kConsumerWarps);
  }
}

// lane 0 of each consumer warp releases a stage
__device__ __forceinline__ void release(uint32_t empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// The block's dynamic shared memory, as a generic pointer.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw;
}

// One output pair from its f32 sums (bias added), before any residual:
// SiLU on the f32 pre-activation (MUFU exp, fast divide), one rounding.
template <bool SILU>
__device__ __forceinline__ uint32_t epilogue_pair(float v0, float v1) {
  if constexpr (SILU) {
    v0 = __fdividef(v0, 1.0f + __expf(-v0));
    v1 = __fdividef(v1, 1.0f + __expf(-v1));
  }
  return pack_bf16(v0, v1);
}

// A consumer warpgroup's epilogue: its 64 staging rows (BN / 64 panels of
// 64 rows x 128 bytes, 8 KB apart), its copy of the tile's bias and the
// barrier of its residual tile.
template <int BN, bool SILU>
struct Epilogue {
  uint32_t stg;
  float* bias;  // generic pointer into shared memory
  uint32_t rbar;
  float2 pre;   // this thread's bias values (columns tid, tid + 128), loaded at the tile's start

  // Tile start: once this warpgroup's last store has read the staging rows,
  // start this thread's bias loads (they land while the products run) and,
  // for a residual, have TMA bring its 64 x BN tile into the staging rows.
  template <typename LoadRes>
  __device__ __forceinline__ void begin(const float* __restrict__ b, int n, int n0, bool res,
                                        LoadRes load_res) {
    const int tid = threadIdx.x & 127;
    pre.x = tid < BN && n0 + tid < n ? b[n0 + tid] : 0.0f;
    pre.y = tid + 128 < BN && n0 + tid + 128 < n ? b[n0 + tid + 128] : 0.0f;
    if (tid == 0) {
      bulk_wait_read();
      if (res) {
        mbar_expect_tx(rbar, 64 * BN * 2);
        load_res();
      }
    }
  }

  // Tile end: bias, SiLU, bf16 (plus the residual in place) into the staging
  // rows, then one thread stores them. Accumulator layout:
  // acc[4 j + e] = D[16 warp + r + 8 (e >> 1)][8 j + 2 c + (e & 1)].
  template <typename Store>
  __device__ __forceinline__ void end(const float (&acc)[BN / 2], bool res, int& rphase,
                                      Store store) {
    const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7;
    const int warp = tid >> 5, lane = tid & 31, r = lane >> 2, c = lane & 3;
    // the last tile's outputs are read (the bias copy and, through the wait
    // in begin, the staging rows are free); the bias copy, then the residual
    wg_sync(1 + wg);
    if (tid < BN) bias[tid] = pre.x;
    if (tid + 128 < BN) bias[tid + 128] = pre.y;
    if (res) {
      mbar_wait(rbar, rphase & 1);
      ++rphase;
    }
    wg_sync(1 + wg);
    // All bias pairs first, then every output's SiLU (independent chains
    // the compiler interleaves), then the residual, then the stores.
    uint32_t* const st = reinterpret_cast<uint32_t*>(
        smem_base() + (stg - static_cast<uint32_t>(__cvta_generic_to_shared(smem_base()))));
    uint32_t v[2][BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[h][j] = epilogue_pair<SILU>(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
    }
    auto index = [&](int h, int j) {
      const int row = 16 * warp + r + 8 * h;
      return ((j >> 3) * kPanelBytes + row * kRowBytes + (((j & 7) ^ (row & 7)) << 4)) / 4 + c;
    };
    if (res) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const uint32_t old = st[index(h, j)];
          const __nv_bfloat162 o = *reinterpret_cast<const __nv_bfloat162*>(&old);
          const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&v[h][j]);
          v[h][j] = pack_bf16(add_bf(o.x, y.x), add_bf(o.y, y.y));
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) st[index(h, j)] = v[h][j];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA store
    wg_sync(1 + wg);
    if (tid == 0) {
      store();
      bulk_commit();
    }
  }
};

// Grid: up to min_blocks(BN) blocks per SM over the tiles (tile t: rows t /
// ntn * kBM, columns t % ntn * BN), kThreads threads, gemm_smem_bytes(BN)
// bytes. ta: (k, m) map of A, box (64, 128); tw: (n, k) map of W, box (64,
// 64); to, tr: (n, m) maps of the output and the residual, box (64, 64).
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tr,
            const float* __restrict__ bias, int m, int n, int k) {
  constexpr int kStages = stages(BN);
  constexpr uint32_t kStageBytes = kABytes + w_tile_bytes(BN);
  // registers at entry 80 (two blocks of 384 threads) or 168; the consumers
  // take what the producer gives back
  constexpr int kConsumerRegs = BN == 64 ? 104 : 240;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // stage s at base + s * kStageBytes
  const uint32_t stage_out = base + kStages * kStageBytes;  // warpgroup w's rows at + w * BN * 128
  const uint32_t bias0 = stage_out + kBM * BN * 2;
  const uint32_t full0 = bias0 + 2 * BN * 4, empty0 = full0 + 8 * kStages;
  const uint32_t rbar0 = empty0 + 8 * kStages;
  const int ntn = (n + BN - 1) / BN, ntiles = ((m + kBM - 1) / kBM) * ntn;
  const int ksteps = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    init_barriers(full0, empty0, kStages);
    mbar_init(rbar0, 1);
    mbar_init(rbar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;  // slabs issued by this block, over all its tiles
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int m0 = t / ntn * kBM, n0 = t % ntn * BN;
        for (int s = 0; s < ksteps; ++s, ++it) {
          const int si = it % kStages;
          if (it >= kStages) mbar_wait(empty0 + 8 * si, ((it / kStages) & 1) ^ 1);
          const uint32_t bar = full0 + 8 * si, st = base + si * kStageBytes;
          mbar_expect_tx(bar, kStageBytes);
          tma_load_3d(st, &ta, bar, s * kBK, m0, 0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(st + kABytes + p * kPanelBytes, &tw, bar, n0 + 64 * p, s * kBK, 0);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7;
    Epilogue<BN, has_silu(EPI)> epi{
        stage_out + wg * BN * kRowBytes,
        reinterpret_cast<float*>(smem_raw + (bias0 - smem_addr(smem_raw))) + wg * BN,
        rbar0 + 8 * wg};
    int it = 0, rphase = 0;  // slabs and residual tiles consumed
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int n0 = t % ntn * BN, row0 = t / ntn * kBM + 64 * wg;  // this warpgroup's 64 rows
      epi.begin(bias, n, n0, has_residual(EPI), [&] {
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_load_3d(epi.stg + p * kPanelBytes, &tr, epi.rbar, n0 + 64 * p, row0, 0);
      });
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int s = 0; s < ksteps; ++s, ++it) {
        const int si = it % kStages;
        mbar_wait(full0 + 8 * si, (it / kStages) & 1);
        const uint32_t st = base + si * kStageBytes;
        const uint32_t ap = st + 64 * wg * kRowBytes, wp = st + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          // A: K-major, a k step is 32 bytes inside the swizzled row; W:
          // MN-major, a k step is 16 rows on, panels 64 rows apart
          wgmma_ss(acc, smem_desc<64>(ap + kk * 32, 16, kGroup),
                   smem_desc<64>(wp + kk * 16 * kRowBytes, kPanelBytes, kGroup));
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's products are done: release its stage
        if (s > 0) release(empty0 + 8 * ((it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty0 + 8 * ((it - 1) % kStages));
      epi.end(acc, has_residual(EPI), rphase, [&] {
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_store_3d(&to, epi.stg + p * kPanelBytes, n0 + 64 * p, row0, 0);
      });
    }
    if ((threadIdx.x & 127) == 0) bulk_wait();  // the last stores are out before the block ends
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

// The column tile for n columns over row_tiles row tiles: the width whose
// busiest SM has the fewest columns to compute, counted as waves x blocks
// per SM x width (the padding past n counts); on ties the 128-column tile,
// then the wider. (A sweep of every launch of K2 and K6 at each width on
// the H100 found the 128-column tile fastest per column where the waves
// tie, and the 192-column tile worth it where it saves a wave.)
inline int column_tile(int n, long row_tiles) {
  int best = 0;
  long best_cost = -1;
  for (int bn : kWidths) {
    const long slots = (long)sm_count() * min_blocks(bn);
    const long tiles = row_tiles * ((n + bn - 1) / bn);
    const long cost = (tiles + slots - 1) / slots * min_blocks(bn) * bn;
    if (best_cost < 0 || cost < best_cost || (cost == best_cost && best != 128))
      best = bn, best_cost = cost;
  }
  return best;
}

// One product: A (m, k) with rows a_cs apart, W (k, n) row-major, bias (n),
// out (m, n) with rows out_cs apart and, for a residual epilogue, res (m, n)
// with rows res_cs apart (it may be out). Every base 16-byte aligned, every
// stride a multiple of 8.
struct Gemm {
  const void* a;
  int a_cs;
  const void* w;
  const float* bias;
  const void* res;
  int res_cs;
  void* out;
  int out_cs;
  int m, n, k;
};

template <int BN, int EPI>
int launch(const Gemm& g, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)gemm_smem_bytes(BN));
  if (attr != cudaSuccess) return (int)attr;
  const void* res = has_residual(EPI) ? g.res : g.out;
  const int res_cs = has_residual(EPI) ? g.res_cs : g.out_cs;
  CUtensorMap ma, mw, mo, mr;
  if (!fwd::make_map(&ma, g.a, g.k, g.a_cs, g.m, 1, kBK, kBM) ||
      !fwd::make_map(&mw, g.w, g.n, g.n, g.k, 1, kBK, kBK) ||
      !fwd::make_map(&mo, g.out, g.n, g.out_cs, g.m, 1, kBK, 64) ||
      !fwd::make_map(&mr, res, g.n, res_cs, g.m, 1, kBK, 64))
    return (int)cudaErrorInvalidValue;
  const long tiles = (long)((g.m + kBM - 1) / kBM) * ((g.n + BN - 1) / BN);
  const long slots = (long)sm_count() * min_blocks(BN);
  gemm_kernel<BN, EPI><<<(unsigned)(tiles < slots ? tiles : slots), kThreads,
                         gemm_smem_bytes(BN), stream>>>(ma, mw, mo, mr, g.bias, g.m, g.n, g.k);
  return (int)cudaGetLastError();
}

// out = epilogue(A W + bias) (+ res). Returns a cudaError_t.
template <int EPI>
int run(const Gemm& g, cudaStream_t stream) {
  if (g.m <= 0 || g.n <= 0) return 0;
  if (has_residual(EPI) != (g.res != nullptr)) return (int)cudaErrorInvalidValue;
  switch (column_tile(g.n, (g.m + kBM - 1) / kBM)) {
    case 64: return launch<64, EPI>(g, stream);
    case 128: return launch<128, EPI>(g, stream);
    default: return launch<192, EPI>(g, stream);
  }
}

}  // namespace gemm
}  // namespace
}  // namespace kuzu

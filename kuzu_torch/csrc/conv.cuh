// K6's 3x3 convs (fused_c3k2.cu) on Hopper (sm_90a): a TMA-fed wgmma
// implicit GEMM for a 3x3 conv (SAME, stride 1) of an NHWC bf16 block,
//
//     out[p, :n] = bf16(silu(sum_k A[p, k] W[k, :] + bias)) (+ res[p, :n], bf16 add)
//
// with A the conv's input pixels' nine shifted copies (k = tap * cin + ci,
// tap = dy * 3 + dx) and W the weight as the wrapper is given it, row-major
// (9 cin, n); f32 sums, the f32 bias, SiLU in f32 (MUFU exp, fast divide),
// one bf16 rounding, and the residual as one bf16 add: the rounding points
// of kuzu/ops/fused_c3k2.py::_kernel. The block's 1x1 convs run on
// gemm.cuh's GEMM (K2's too), whose mbarrier ring, swizzled panels, wgmma
// helpers and epilogue this kernel shares.
//
// The kernel is persistent (one block per SM) with three warpgroups:
// warpgroup 2 produces (one thread issuing TMA loads), warpgroups 0 and 1
// consume, 64 output pixels each, so a tile is 128 pixels x BN output
// channels (BN 64, 128 or 192). The output tile is a bx x (128 / bx)
// rectangle of one image. Per 64-channel slab the producer loads its halo
// once, the box (64 channels, bx + 2, 128 / bx + 2, 1 image) of a 4-D map
// (channels, W, H, B) at (c0, x0 - 1, y0 - 1, b): TMA fills the cells
// outside the image with zeros, which is SAME padding, so no thread computes
// a border mask, and channels of a slab past cin load as zeros too (they
// add nothing whatever W holds there). Each of the nine taps reads its A
// fragments from that halo with ldmatrix (a row address per lane: pixel
// (y + dy, x + dx), through the swizzle) into registers, and wgmma takes A
// from registers (m64nBNk16, B from shared memory): the input is read from
// L2 once per tile and slab, not nine times. W is read as it is stored, in
// panels of 64 columns x 64 rows with the 128-byte swizzle: wgmma's
// MN-major B operand (as V in attention_fwd.cuh), so the wrapper copies no
// weight; its nine (64 x BN) tiles per slab stay resident in shared memory
// for the whole launch where they fit (hid <= 128 at BN = 64: each block
// keeps one column tile), else they stream through a ring beside the
// halo's. The epilogue is gemm.cuh's: the residual brought by TMA into the
// staging tile while the products run, the tile stored by TMA, which clips
// the pixels past the image's edge and the columns past n. The output may
// be a channel slice of a wider buffer (a row stride of its own), and the
// residual may alias it: a tile reads and writes its own place only.
// What bounds it on this card: operations, 2 m k n per conv on the bf16
// tensor cores; in practice each tile's latencies: a clock64 probe build at
// yolov12x node 2 spent ~3400 cycles a tile on products whose wgmma work is
// ~2300 (each tap waits for its products before the next tap's fragments
// may load), and the epilogue's SiLU (two MUFU operations an output) runs
// while the tensor cores wait.
// Internal linkage (an anonymous namespace), as attention_fwd.cuh's, whose
// note says why.
#pragma once

#include "gemm.cuh"

namespace kuzu {
namespace {
namespace conv {

using fwd::fence_regs;
using fwd::mbar_expect_tx;
using fwd::mbar_init;
using fwd::mbar_wait;
using fwd::smem_addr;
using fwd::smem_desc;
using fwd::tma_load_3d;
using fwd::wgmma_commit;
using fwd::wgmma_fence;
using gemm::bulk_commit;
using gemm::bulk_wait;
using gemm::Epilogue;
using gemm::epilogue_bytes;
using gemm::init_barriers;
using gemm::kBK;
using gemm::kBM;
using gemm::kGroup;
using gemm::kPanelBytes;
using gemm::kProducerRegs;
using gemm::kRowBytes;
using gemm::kSmemLimit;
using gemm::kThreads;
using gemm::kWidths;
using gemm::release;
using gemm::w_tile_bytes;
using gemm::wgmma_wait;

constexpr int kConsumerRegs = 240;
constexpr uint32_t kHaloBytes = 26624;  // a halo, (bx + 2)(128 / bx + 2) <= 204 pixels, 1024-aligned
constexpr int kMaxWStages = 28;

// Two halo buffers, as many W tiles as the rest holds (at most 28), the
// epilogue's share, 512 bytes of barriers.
__host__ __device__ constexpr int w_stages(int bn) {
  const size_t rest = kSmemLimit - 1024 - 2 * (size_t)kHaloBytes - epilogue_bytes(bn) - 512;
  return rest / w_tile_bytes(bn) < (size_t)kMaxWStages ? (int)(rest / w_tile_bytes(bn)) : kMaxWStages;
}
__host__ __device__ constexpr size_t conv3x3_smem_bytes(int bn) {
  return 1024 + 2 * (size_t)kHaloBytes + (size_t)w_stages(bn) * w_tile_bytes(bn) +
         epilogue_bytes(bn) + 512;
}
static_assert(conv3x3_smem_bytes(64) <= kSmemLimit && conv3x3_smem_bytes(128) <= kSmemLimit &&
                  conv3x3_smem_bytes(192) <= kSmemLimit,
              "every column tile fits a block");

// d (m64nN, f32) += A B, A K-major in registers, B MN-major from shared
// memory. N = 2 x d's registers.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// One launch: the output, its bias and residual, the pixel grid and the
// tile's width bx (128 / bx rows).
struct Conv {
  const float* bias;
  bf16* out;
  int out_cs;        // output pixel p at out + p * out_cs
  const bf16* res;   // null: no residual; may equal out
  int res_cs;
  int n, cin;        // output channels; input channels (the reduction is 9 cin)
  int b, h, w, bx;
};

// The tile pt's image and corner.
__device__ __forceinline__ void tile_corner(const Conv& a, int pt, int& img, int& y0, int& x0) {
  const int by = kBM / a.bx, tx = (a.w + a.bx - 1) / a.bx, ty = (a.h + by - 1) / by;
  img = pt / (tx * ty);
  const int r = pt - img * tx * ty;
  y0 = r / tx * by;
  x0 = r % tx * a.bx;
}

// ------------------------------------------------------------------- 3x3

// Grid: ntn x k blocks (block i keeps column tile i % ntn and walks the
// pixel tiles i / ntn, + k, ...), kThreads threads, conv3x3_smem_bytes(BN)
// bytes. ta: (cin, w, h, b) map of the input, box (64, bx + 2, 128 / bx +
// 2, 1); tw: (n, 9 cin) map of W, box (64, 64); to, tr: (n, w, h, b) maps
// of the output and the residual, box (64, bx, 64 / bx, 1). W's (tap, slab)
// tile j = 9 slab + tap; resident: all 9 nslab tiles sit in the W buffer
// for the whole launch, else they stream through it as a ring.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tr,
               const Conv a, int npt) {
  constexpr int kWStages = w_stages(BN);
  constexpr uint32_t kWTile = w_tile_bytes(BN);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t wbuf = base + 2 * kHaloBytes;  // halo buffer h at base + h * kHaloBytes
  const uint32_t stage_out = wbuf + kWStages * kWTile;
  const uint32_t bias0 = stage_out + kBM * BN * 2;
  const uint32_t hfull0 = bias0 + 2 * BN * 4, hempty0 = hfull0 + 16, rbar0 = hempty0 + 16;
  const uint32_t wfull0 = rbar0 + 16, wempty0 = wfull0 + 8 * kWStages;
  const int ntn = (a.n + BN - 1) / BN, n0 = blockIdx.x % ntn * BN, step = gridDim.x / ntn;
  const int nslab = (a.cin + kBK - 1) / kBK, nw = 9 * nslab;
  const bool resident = nw <= kWStages;
  const int hx = a.bx + 2;
  const uint32_t halo_bytes = (uint32_t)hx * (kBM / a.bx + 2) * kRowBytes;

  if (threadIdx.x == 0) {
    init_barriers(hfull0, hempty0, 2);
    init_barriers(wfull0, wempty0, kWStages);
    mbar_init(rbar0, 1);
    mbar_init(rbar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      auto load_w = [&](int j, int slot) {
        const uint32_t bar = wfull0 + 8 * slot, dst = wbuf + slot * kWTile;
        const int tap = j % 9, slab = j / 9;
        mbar_expect_tx(bar, kWTile);
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_load_3d(dst + p * kPanelBytes, &tw, bar, n0 + 64 * p, tap * a.cin + slab * kBK, 0);
      };
      if (resident)
        for (int j = 0; j < nw; ++j) load_w(j, j);
      int hb = 0, wb = 0;  // halos and streamed W tiles issued
      for (int pt = blockIdx.x / ntn; pt < npt; pt += step) {
        int img, y0, x0;
        tile_corner(a, pt, img, y0, x0);
        for (int slab = 0; slab < nslab; ++slab, ++hb) {
          const int hs = hb & 1;
          if (hb >= 2) mbar_wait(hempty0 + 8 * hs, ((hb >> 1) & 1) ^ 1);
          mbar_expect_tx(hfull0 + 8 * hs, halo_bytes);
          tma_load_4d(base + hs * kHaloBytes, &ta, hfull0 + 8 * hs, slab * kBK, x0 - 1, y0 - 1,
                      img);
          if (!resident)
            for (int tap = 0; tap < 9; ++tap, ++wb) {
              const int slot = wb % kWStages;
              if (wb >= kWStages) mbar_wait(wempty0 + 8 * slot, ((wb / kWStages) & 1) ^ 1);
              load_w(9 * slab + tap, slot);
            }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    Epilogue<BN, true> epi{stage_out + wg * BN * kRowBytes,
                     reinterpret_cast<float*>(smem_raw + (bias0 - smem_addr(smem_raw))) + wg * BN,
                     rbar0 + 8 * wg};
    // the A row this lane addresses for ldmatrix: matrix lane / 8 of the
    // warp's m16 x k16 fragment (rows + 8 for matrices 1, 3; k + 8 for 2, 3)
    const int mi = lane >> 3, row = 64 * wg + 16 * warp + (lane & 7) + 8 * (mi & 1);
    const int oy = row / a.bx, ox = row % a.bx, khalf = mi >> 1;
    const int wrows = 64 / a.bx;  // image rows of this warpgroup's 64 pixels
    int hb = 0, wb = 0, rphase = 0;  // halos, streamed W tiles, residual tiles consumed
    for (int pt = blockIdx.x / ntn; pt < npt; pt += step) {
      int img, y0, x0;
      tile_corner(a, pt, img, y0, x0);
      const int wy0 = y0 + wrows * wg;
      epi.begin(a.bias, a.n, n0, a.res != nullptr, [&] {
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_load_4d(epi.stg + p * kPanelBytes, &tr, epi.rbar, n0 + 64 * p, x0, wy0, img);
      });
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int slab = 0; slab < nslab; ++slab, ++hb) {
        const int hs = hb & 1;
        mbar_wait(hfull0 + 8 * hs, (hb >> 1) & 1);
        const uint32_t halo = base + hs * kHaloBytes;
        // tap t's A fragments: this lane's halo pixel for the tap, its
        // 16-byte k pieces through the 128-byte swizzle (piece j of pixel q
        // at j ^ (q & 7))
        uint32_t af[2][4][4];
        auto load_a = [&](uint32_t (&f)[4][4], int tap) {
          const int q = (oy + tap / 3) * hx + ox + tap % 3;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldsm_x4(f[kk], halo + q * kRowBytes + (((2 * kk + khalf) ^ (q & 7)) << 4));
        };
        load_a(af[0], 0);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          // the next tap's fragments load before this tap's products start:
          // no register of a wgmma in flight is written (ptxas would
          // serialise every wgmma otherwise)
          if (tap < 8)
            load_a(af[(tap + 1) & 1], tap + 1);
          else
            release(hempty0 + 8 * hs);  // the halo is all in registers
          int slot;
          if (resident) {
            slot = 9 * slab + tap;
            mbar_wait(wfull0 + 8 * slot, 0);
          } else {
            slot = wb % kWStages;
            mbar_wait(wfull0 + 8 * slot, (wb / kWStages) & 1);
            ++wb;
          }
          const uint32_t wp = wbuf + slot * kWTile;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs(acc, af[tap & 1][kk],
                     smem_desc<64>(wp + kk * 16 * kRowBytes, kPanelBytes, kGroup));
          wgmma_commit();
          wgmma_wait<0>();
          if (!resident) release(wempty0 + 8 * slot);
        }
      }
      fence_regs(acc);
      epi.end(acc, a.res != nullptr, rphase, [&] {
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_store_4d(&to, epi.stg + p * kPanelBytes, n0 + 64 * p, x0, wy0, img);
      });
    }
    if ((threadIdx.x & 127) == 0) bulk_wait();  // the last stores are out before the block ends
  }
}

// ----------------------------------------------------------------------- host

// Tensor map of a bf16 NHWC (b, h, w, c) channel slice with pixels `stride`
// elements apart, box (64, bw, bh, 1), 128-byte swizzle. Loads fill the
// cells outside the tensor (SAME padding, channels past c) with zeros;
// stores leave them out.
inline bool make_map_4d(CUtensorMap* map, const void* ptr, int c, int stride, int w, int h, int b,
                        int bw, int bh) {
  fwd::bind_context();
  const fwd::EncodeTiled enc = fwd::encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || stride % 8 != 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)stride * 2, (cuuint64_t)w * stride * 2,
                                 (cuuint64_t)h * w * stride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBK, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3x3 tile's width: the fewest padded pixels over the image, 16 on ties.
inline int tile_width(int h, int w) {
  constexpr int kTry[3] = {16, 8, 32};
  int best = 16;
  long best_px = -1;
  for (int bx : kTry) {
    const int by = kBM / bx;
    const long px = (long)((w + bx - 1) / bx * bx) * ((h + by - 1) / by * by);
    if (best_px < 0 || px < best_px) best = bx, best_px = px;
  }
  return best;
}

// The column tile where W does not stay resident, for n output channels
// over npt pixel tiles: the fewest tiles of at most 192 columns, each the
// narrowest width built that covers its share; narrower while the launch's
// tiles would not fill the card (one block per SM).
inline int conv3x3_column_tile(int n, long npt) {
  const int ntn = (n + 191) / 192, share = (n + ntn - 1) / ntn;
  int i = 0;
  while (i < 2 && kWidths[i] < share) ++i;
  while (i > 0 && npt * ((n + kWidths[i] - 1) / kWidths[i]) < gemm::sm_count()) --i;
  return kWidths[i];
}

template <int BN>
int launch3x3(const void* in, int in_cs, const void* wt, const Conv& a, int npt,
              cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)conv3x3_smem_bytes(BN));
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap ma, mw, mo, mr;
  const int wrows = 64 / a.bx;
  if (!make_map_4d(&ma, in, a.cin, in_cs, a.w, a.h, a.b, a.bx + 2, kBM / a.bx + 2) ||
      !fwd::make_map(&mw, wt, a.n, a.n, 9 * a.cin, 1, kBK, kBK) ||
      !make_map_4d(&mo, a.out, a.n, a.out_cs, a.w, a.h, a.b, a.bx, wrows) ||
      !make_map_4d(&mr, a.res != nullptr ? a.res : a.out, a.n,
                   a.res != nullptr ? a.res_cs : a.out_cs, a.w, a.h, a.b, a.bx, wrows))
    return (int)cudaErrorInvalidValue;
  const int ntn = (a.n + BN - 1) / BN;
  long per = gemm::sm_count() / ntn;  // blocks per column tile
  if (per > npt) per = npt;
  if (per < 1) per = 1;
  conv3x3_kernel<BN><<<(unsigned)(per * ntn), kThreads, conv3x3_smem_bytes(BN), stream>>>(
      ma, mw, mo, mr, a, npt);
  return (int)cudaGetLastError();
}

// out[p] = silu(conv3x3(in)[p] + bias) (+ res[p] if a.res), SAME padding,
// stride 1, for the pixels of a (b, h, w) grid; in: pixel p's cin channels
// at in + p * in_cs; wt: (9 cin, n) bf16 row-major, row tap * cin + ci. W
// stays resident at BN = 64 where its 9 ceil(cin / 64) tiles fit the block.
// Returns a cudaError_t.
inline int run3x3(const void* in, int in_cs, const void* wt, Conv a, cudaStream_t stream) {
  if (a.b * a.h * a.w <= 0 || a.n <= 0) return 0;
  a.bx = tile_width(a.h, a.w);
  const int by = kBM / a.bx;
  const long npt = (long)a.b * ((a.w + a.bx - 1) / a.bx) * ((a.h + by - 1) / by);
  const int bn =
      9 * ((a.cin + kBK - 1) / kBK) <= w_stages(64) ? 64 : conv3x3_column_tile(a.n, npt);
  switch (bn) {
    case 64: return launch3x3<64>(in, in_cs, wt, a, (int)npt, stream);
    case 128: return launch3x3<128>(in, in_cs, wt, a, (int)npt, stream);
    default: return launch3x3<192>(in, in_cs, wt, a, (int)npt, stream);
  }
}

}  // namespace conv
}  // namespace
}  // namespace kuzu

// f32 attention on Hopper's tensor cores, shared by flash_attention.cu (K5's
// f32 path) and area_attention.cu (K3's f32 route):
//
//     o[g, :, h] = softmax(scale * q[g, :, h] k[g, :, h]^T) v[g, :, h]
//
// over (G, N, C) f32 tensors with heads packed along the channels (head h
// owns columns [h*D, (h+1)*D)), each of q, k, v and o with its own row
// stride: K3's head-packed layout is stride C, head offset h*D; K5's
// (BH, N, D) is the case heads = 1, stride = D. attention_f32_bwd.cuh (K4's
// f32 route) builds on the pieces here.
//
// Replaces, in f32, the TPU kernels kuzu/ops/flash_attention.py::
// flash_attention (_flash_kernel: 128-key tiles with the online softmax)
// and ::area_attention (_area_attn_kernel: one group's N x N f32 scores in
// VMEM, q scaled first, exact max / exp / divide by the sum, the output in
// the input's dtype). The recurrence is the TPU flash kernel's, per key
// tile: m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l alpha + rowsum(p), acc = acc alpha + p v, o = acc / max(l, 1e-30),
// m from -1e30, here in base 2 (s log2(e), exp2 on the MUFU unit); for K3
// the exact two-pass maximum becomes this online one, a difference of
// f32-rounding size. K3's f32 training route also asks for each row's
// base-2 log-sum-exp of the scaled scores, m + log2(l), which the f32
// backward reads in place of recomputing the softmax statistics.
//
// Arithmetic: 3xTF32, as accurate as f32 products. Every operand x of a
// product is split into hi, x rounded to nearest (ties away) to TF32's 10
// mantissa bits, the result cvt.rna.tf32.f32 gives (computed with two
// integer operations, (bits + 0x1000) & ~0x1fff), and lo, the same rounding
// of x - hi (exact in f32). A product A B is three TF32 wgmma products
// accumulated in f32 by the tensor core into one set of registers, in this
// order: A_lo B_hi, A_hi B_lo (the two small cross terms, over the whole
// contraction), then A_hi B_hi; A_lo B_lo, below 2^-22 of the product, is
// dropped. The kernels ignore torch.backends.cuda.matmul.allow_tf32: they
// are f32-accurate whatever it says (models/layers.py's f32_products still
// switches TF32 off for cuBLAS and cuDNN).
//
// Design. One block per (128 query rows, head, group), four warpgroups:
//   - warpgroups 2 and 3 produce. One thread brings the block's Q rows and
//     each tile of kT keys of K and V into shared memory with TMA (3-D
//     tensor maps, swizzled panels, rows past N zero-filled) on "loaded"
//     mbarriers; the 256 threads then split K in place into its hi and lo
//     tiles (K-major: head width contiguous, as wgmma reads it) and V,
//     through their registers, into V^T's hi and lo tiles (keys
//     contiguous: a TF32 wgmma takes only K-major operands), and publish
//     the stage on its "full" mbarrier (a proxy fence, one arrival a warp).
//     A stage is free again when the 8 consumer warps arrive on its
//     "empty" mbarrier. Loads by TMA keep many tiles in flight where
//     16-byte loads of a warpgroup stalled on the SM's outstanding misses.
//   - warpgroups 0 and 1 consume, 64 query rows each. They first split Q
//     (scaled) in place, then, up to D = 64, keep its hi and lo fragments
//     in registers: S = Q K^T reads only K from shared memory, and Q's tiles
//     then serve as a third stage. Per key tile: S (3xTF32), the online
//     softmax on the accumulator registers (keys past N masked to -inf),
//     then O += P V with P from registers as wgmma's A operand (split into
//     hi and lo there) and V^T from shared memory. The A fragment holds,
//     per 8-key step, keys {c, c + 4} of lane c of a quad where S's
//     accumulator holds keys {2c, 2c + 1}: V^T's keys are stored permuted
//     within each group of 8 (key 2i at slot i, key 2i + 1 at slot 4 + i),
//     so P feeds the product as it lies, with no shuffle. The two
//     warpgroups take turns at the tensor cores (named barriers), so that
//     one's softmax runs under the other's products.
// The key tile and the stages follow the head width so that Q, the stages
// and the barriers fit the shared memory (Fwd below): kT = 64 keys up to
// D = 64, 32 above; two stages of their own up to D = 112, one at D = 128.
//
// What bounds it on this card: operations, 4 N^2 D per head as 3xTF32,
// three TF32 products each, on the 495 TFLOP/s of the tensor cores (the
// bytes, each input read once, are far below that: at K3's TrOCR shape
// G=1024, N=256, C=384 they are 0.48 GB, 0.14 ms, against 3 x 1.03e11
// operations, 0.625 ms). In practice the shared memory's bandwidth,
// shared by the products' operand reads and the producers' splits, and
// the producers' pass over each tile hold it at about half of that (the
// times in PERF.md).
//
// Everything here has internal linkage: each library that includes it keeps
// its own kernels and its own once-per-instantiation attribute guards (a
// shared guard would leave the second library's kernels without their
// shared-memory attribute).
#pragma once

#include <math.h>

#include "attention_fwd.cuh"

namespace kuzu {
namespace {
namespace f32attn {

using fwd::fast_exp2;
using fwd::fence_regs;
using fwd::mbar_arrive;
using fwd::mbar_init;
using fwd::mbar_expect_tx;
using fwd::mbar_wait;
using fwd::smem_addr;
using fwd::tma_load_3d;
using fwd::wgmma_commit;
using fwd::wgmma_fence;
using fwd::wgmma_wait_all;

constexpr int kProducer = 128;  // threads of a producer warpgroup (the backward kernels')
constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ 3xTF32 operands

// x rounded to nearest, ties away from zero, to TF32's 10 mantissa bits:
// what cvt.rna.tf32.f32 gives for every finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 22 significant bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// An operand tile in shared memory in wgmma's K-major layout: R rows of L
// floats along the contraction, as L / W panels of R rows x W floats (W =
// 32: 128-byte rows and swizzle; W = 16: 64-byte rows and swizzle). Tiles
// start at 1024-byte boundaries and their sizes are multiples of it.
template <int R, int L>
struct Tile {
  static_assert(R % 16 == 0 && L % 16 == 0, "rows and contraction in steps of 16");
  static constexpr int W = L % 32 == 0 ? 32 : 16;
  static constexpr uint32_t kRowBytes = W * 4;
  static constexpr uint32_t kPanelBytes = R * kRowBytes;
  static constexpr uint32_t kBytes = R * L * 4;
  // byte offset of floats [k, k + 4) of row `row` (k % 4 == 0)
  __device__ static __forceinline__ uint32_t at(int row, int k) {
    uint32_t o = row * kRowBytes + (k % W) * 4;
    o ^= ((o >> 7) & (W == 32 ? 7u : 3u)) << 4;  // the swizzle: 16-byte chunk ^= row bits
    return (k / W) * kPanelBytes + o;
  }
  // descriptor of 8-float step kk of the rows from row0 (the M or N rows of
  // a product) of the tile at `base`
  __device__ static __forceinline__ uint64_t desc(uint32_t base, int row0, int kk) {
    constexpr uint64_t layout = W == 32 ? 1 : 2;
    const uint32_t addr = base + (kk * 8 / W) * kPanelBytes + row0 * kRowBytes + (kk * 8 % W) * 4;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(8 * kRowBytes >> 4) << 32) | (layout << 62);
  }
};

// component c of x
__device__ __forceinline__ float comp(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

__device__ __forceinline__ void st4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                    uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d));
}

// x split, hi at tile hi + off, lo at tile lo + off
__device__ __forceinline__ void st_split(uint32_t hi, uint32_t lo, uint32_t off, float4 x) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split(x.x, h0, l0);
  split(x.y, h1, l1);
  split(x.z, h2, l2);
  split(x.w, h3, l3);
  st4(hi + off, h0, h1, h2, h3);
  st4(lo + off, l0, l1, l2, l3);
}

// The producer's stores are generic-proxy writes that wgmma reads through
// the async proxy: each producer thread fences, then its warp arrives once
// on `bar` (128 arrivals on one barrier word would serialize).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void publish(uint32_t bar) {
  fence_async_smem();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
constexpr int kProducerWarps = kProducer / 32;  // arrivals on a producer-filled barrier

// floats [col, col + 4) of row `row` of src times mul, zeros past n
__device__ __forceinline__ float4 ld4(const float* __restrict__ src, int stride, int row, int n,
                                      int col, float mul) {
  if (row >= n) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 x = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * stride + col));
  x.x *= mul;
  x.y *= mul;
  x.z *= mul;
  x.w *= mul;
  return x;
}

// Named barrier `id` of `threads` threads: wait on it, or arrive without
// waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr));
  return x;
}

// Column 4 quad + cc of rows row0 + 2 i (row0 = 8 (gp / 2) + gp % 2, i < 4)
// of a T-row tile, x[i] holding those rows' floats [4 quad, 4 quad + 4):
// split into slots 4 gp + i of row 4 quad + cc of the transposed tiles thi,
// tlo (Tile<D, T>: row j of the tile at slot 8 (j / 8) + 4 (j % 2) +
// (j % 8) / 2, the order in which an accumulator feeds wgmma's A operand).
// The order of cc turns with quad, so the 8 lanes of one store phase write
// 8 different 16-byte bank groups.
template <int T, int D>
__device__ __forceinline__ void store_cols(const float4 (&x)[4], int quad, int gp, uint32_t thi,
                                           uint32_t tlo) {
  const int rot = (quad >> 1) & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = (j + rot) & 3;
    st_split(thi, tlo, Tile<D, T>::at(4 * quad + cc, 4 * gp),
             make_float4(comp(x[0], cc), comp(x[1], cc), comp(x[2], cc), comp(x[3], cc)));
  }
}

// A tile a block loads once: rows [r0, r0 + R) of src (D floats each, row
// stride `stride`, zeros past n) times mul, for the K-major tiles hi and lo
// (Tile<R, D>).
struct Fixed {
  uint32_t hi, lo;
  const float* src;
  int stride;
  float mul;
};

// The kN fixed tiles of a block, staged by kThreads threads together (t:
// the thread's index among them): every load first, in one batch, then
// the splits and stores.
template <int R, int D, int kThreads, int kN>
__device__ __forceinline__ void stage_fixed(const Fixed (&f)[kN], int r0, int n, int t) {
  constexpr int kQuads = D / 4, kTotal = R * kQuads;
  constexpr int kPer = (kTotal + kThreads - 1) / kThreads;
  float4 x[kN][kPer];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      const int e = t + b * kThreads, row = e / kQuads;
      if (e < kTotal) x[i][b] = ld4(f[i].src, f[i].stride, r0 + row, n, (e - row * kQuads) * 4, f[i].mul);
    }
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      const int e = t + b * kThreads, row = e / kQuads;
      if (e < kTotal) st_split(f[i].hi, f[i].lo, Tile<R, D>::at(row, (e - row * kQuads) * 4), x[i][b]);
    }
}

// A streamed tile of T rows of D floats in the producer's registers: load()
// issues every load of the tile, store() splits and stores them, so that the
// loads of all tiles of a stage are in flight together.
//   Rows: into the K-major tiles hi, lo (Tile<T, D>).
//   Cols: transposed into the tiles thi, tlo (Tile<D, T>: row d holds
//   column d of the T rows, row j at slot 8 (j / 8) + 4 (j % 2) + (j % 8) /
//   2), and with kRowsToo also into K-major tiles. A unit of work is 4 rows
//   of one parity in a group of 8 by 4 columns: 4 loads, whose columns
//   become 4 contiguous slots of 4 transposed rows.
template <int T, int D>
struct Rows {
  static constexpr int kQuads = D / 4, kTotal = T * kQuads;
  static constexpr int kN = (kTotal + kProducer - 1) / kProducer;
  float4 x[kN];
  __device__ __forceinline__ void load(const float* __restrict__ src, int stride, int r0, int n,
                                       float mul, int t) {
#pragma unroll
    for (int b = 0; b < kN; ++b) {
      const int e = t + b * kProducer, row = e / kQuads;
      if (e < kTotal) x[b] = ld4(src, stride, r0 + row, n, (e - row * kQuads) * 4, mul);
    }
  }
  __device__ __forceinline__ void store(uint32_t hi, uint32_t lo, int t) const {
#pragma unroll
    for (int b = 0; b < kN; ++b) {
      const int e = t + b * kProducer, row = e / kQuads;
      if (e < kTotal) st_split(hi, lo, Tile<T, D>::at(row, (e - row * kQuads) * 4), x[b]);
    }
  }
};

template <int T, int D, bool kRowsToo>
struct Cols {
  static constexpr int kQuads = D / 4, kUnits = T * D / 16;
  static constexpr int kN = (kUnits + kProducer - 1) / kProducer;
  float4 x[kN][4];
  __device__ __forceinline__ void load(const float* __restrict__ src, int stride, int r0, int n,
                                       float mul, int t) {
#pragma unroll
    for (int b = 0; b < kN; ++b) {
      const int u = t + b * kProducer, quad = u % kQuads, gp = u / kQuads;
      const int row0 = 8 * (gp >> 1) + (gp & 1);  // the unit's rows: row0 + 2 i
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (u < kUnits) x[b][i] = ld4(src, stride, r0 + row0 + 2 * i, n, 4 * quad, mul);
    }
  }
  __device__ __forceinline__ void store(uint32_t hi, uint32_t lo, uint32_t thi, uint32_t tlo,
                                        int t) const {
#pragma unroll
    for (int b = 0; b < kN; ++b) {
      const int u = t + b * kProducer, quad = u % kQuads, gp = u / kQuads;
      if (u >= kUnits) continue;
      if constexpr (kRowsToo) {
        const int row0 = 8 * (gp >> 1) + (gp & 1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st_split(hi, lo, Tile<T, D>::at(row0 + 2 * i, 4 * quad), x[b][i]);
      }
      store_cols<T, D>(x[b], quad, gp, thi, tlo);
    }
  }
};

// A tile of T rows of D floats in shared memory, as TMA leaves it (the
// K-major layout of Tile<T, D>), split into its transposed tiles by
// kThreads producer threads (t: the thread's index among them), a unit as
// Cols takes it: load() reads this thread's units into registers, store()
// splits them into the transposed tiles, which may overlap the raw tile
// once every thread has loaded.
template <int T, int D, int kThreads>
struct ColsS {
  static constexpr int kQuads = D / 4, kUnits = T * D / 16;
  static constexpr int kN = (kUnits + kThreads - 1) / kThreads;
  float4 x[kN][4];
  __device__ __forceinline__ void load(uint32_t raw, int t) {
#pragma unroll
    for (int b = 0; b < kN; ++b) {
      const int u = t + b * kThreads, quad = u % kQuads, gp = u / kQuads;
      const int row0 = 8 * (gp >> 1) + (gp & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (u < kUnits) x[b][i] = ld_shared4(raw + Tile<T, D>::at(row0 + 2 * i, 4 * quad));
    }
  }
  __device__ __forceinline__ void store(uint32_t thi, uint32_t tlo, int t) const {
#pragma unroll
    for (int b = 0; b < kN; ++b) {
      const int u = t + b * kThreads;
      if (u < kUnits) store_cols<T, D>(x[b], u % kQuads, u / kQuads, thi, tlo);
    }
  }
};

// The K-major tile pair (hi, lo) of R rows by D floats whose hi holds the
// raw values (as TMA leaves them): each value times mul, split in place.
// kThreads threads share the work (t: the thread's index among them).
template <int R, int D, int kThreads>
__device__ __forceinline__ void split_in_place(uint32_t hi, uint32_t lo, float mul, int t) {
  constexpr int kQuads = D / 4, kTotal = R * kQuads;
#pragma unroll 4
  for (int e = t; e < kTotal; e += kThreads) {
    const int row = e / kQuads;
    const uint32_t off = Tile<R, D>::at(row, (e - row * kQuads) * 4);
    float4 x = ld_shared4(hi + off);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    st_split(hi, lo, off, x);
  }
}

// --------------------------------------------------------------- TF32 wgmma

// Accumulator layout of an m64nN product (thread 32 w + 4 r + c of the
// warpgroup): d[4 j + e] = D[16 w + r + 8 (e >> 1)][8 j + 2 c + (e & 1)].
// The register A operand of an m64k8 TF32 product: a[0..3] = A[16 w + r][c],
// A[16 w + r + 8][c], A[16 w + r][c + 4], A[16 w + r + 8][c + 4].
// tf32_ss: d (m64nN) = A B^T (+ d if accumulate), A and B K-major in shared
// memory; tf32_rs: d += A B^T with A from registers.
__device__ __forceinline__ void tf32_ss(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tf32_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tf32_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tf32_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 x N) = A B^T over D in 3xTF32: A rows [a0, a0 + 64) of the tile
// pair (ahi, alo) (Tile<RA, D>), B the tile pair (bhi, blo) (Tile<N, D>);
// the cross terms first. Issues only: the caller fences, commits and waits.
template <int RA, int N, int D>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], uint32_t ahi, uint32_t alo,
                                           int a0, uint32_t bhi, uint32_t blo) {
  using A = Tile<RA, D>;
  using B = Tile<N, D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) tf32_ss(acc, A::desc(alo, a0, kk), B::desc(bhi, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) tf32_ss(acc, A::desc(ahi, a0, kk), B::desc(blo, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) tf32_ss(acc, A::desc(ahi, a0, kk), B::desc(bhi, 0, kk), 1);
}

// The A fragments of X (64 x L, in the accumulator layout of an m64nL
// product) for an L-deep product, split into hi and lo. Per 8-column step
// the fragment takes X's columns 2c and 2c + 1, which sit at slots c and
// c + 4 of the B operand's transposed tile.
template <int L>
__device__ __forceinline__ void split_a(const float (&x)[L / 2], uint32_t (&hi)[L / 8][4],
                                        uint32_t (&lo)[L / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < L / 8; ++kk) {
    split(x[4 * kk], hi[kk][0], lo[kk][0]);      // row r, column 2c: slot c
    split(x[4 * kk + 2], hi[kk][1], lo[kk][1]);  // row r + 8, column 2c
    split(x[4 * kk + 1], hi[kk][2], lo[kk][2]);  // row r, column 2c + 1: slot c + 4
    split(x[4 * kk + 3], hi[kk][3], lo[kk][3]);  // row r + 8, column 2c + 1
  }
}

// acc (64 x N) = A B^T over D in 3xTF32 as product_ss, A from registers: its
// fragments (hi and lo) for each 8-float step kk (a[kk] = A[r][8 kk + c],
// A[r + 8][8 kk + c], A[r][8 kk + c + 4], A[r + 8][8 kk + c + 4]). acc is
// accumulated into: the caller zeroes it. Fences and issues; the caller
// commits and waits.
template <int N, int D>
__device__ __forceinline__ void product_rs_a(float (&acc)[N / 2], const uint32_t (&ahi)[D / 8][4],
                                             const uint32_t (&alo)[D / 8][4], uint32_t bhi,
                                             uint32_t blo) {
  using B = Tile<N, D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) tf32_rs(acc, alo[kk], B::desc(bhi, 0, kk));
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) tf32_rs(acc, ahi[kk], B::desc(blo, 0, kk));
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) tf32_rs(acc, ahi[kk], B::desc(bhi, 0, kk));
}

// acc (64 x D) += X Y in 3xTF32: X (64 x L) in registers in the accumulator
// layout of an m64nL product, split into hi and lo here (split_a); Y (L x
// D) as its transposed tile pair (bhi, blo) (Tile<D, L>, the L rows in slot
// order). Fences and issues; the caller commits and waits.
template <int L, int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const float (&x)[L / 2],
                                           uint32_t bhi, uint32_t blo) {
  uint32_t hi[L / 8][4], lo[L / 8][4];
  split_a<L>(x, hi, lo);
  product_rs_a<D, L>(acc, hi, lo, bhi, blo);
}

// Two independent products of product_ss's kind over 64-row A tiles, x =
// XA XB^T and y = YA YB^T, their instructions interleaved: one warpgroup's
// chain of small dependent products would leave the tensor cores idle
// between steps, two chains fill them.
template <int N, int D>
__device__ __forceinline__ void product_ss2(float (&x)[N / 2], uint32_t xahi, uint32_t xalo,
                                            uint32_t xbhi, uint32_t xblo, float (&y)[N / 2],
                                            uint32_t yahi, uint32_t yalo, uint32_t ybhi,
                                            uint32_t yblo) {
  using A = Tile<64, D>;
  using B = Tile<N, D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    tf32_ss(x, A::desc(xalo, 0, kk), B::desc(xbhi, 0, kk), kk > 0);
    tf32_ss(y, A::desc(yalo, 0, kk), B::desc(ybhi, 0, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    tf32_ss(x, A::desc(xahi, 0, kk), B::desc(xblo, 0, kk), 1);
    tf32_ss(y, A::desc(yahi, 0, kk), B::desc(yblo, 0, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    tf32_ss(x, A::desc(xahi, 0, kk), B::desc(xbhi, 0, kk), 1);
    tf32_ss(y, A::desc(yahi, 0, kk), B::desc(ybhi, 0, kk), 1);
  }
}

// Two independent products of product_rs's kind, accx += X XB and accy += Y
// YB, their instructions interleaved (as product_ss2).
template <int L, int D>
__device__ __forceinline__ void product_rs2(float (&accx)[D / 2], const float (&x)[L / 2],
                                            uint32_t xbhi, uint32_t xblo, float (&accy)[D / 2],
                                            const float (&y)[L / 2], uint32_t ybhi,
                                            uint32_t yblo) {
  using B = Tile<D, L>;
  uint32_t xh[L / 8][4], xl[L / 8][4], yh[L / 8][4], yl[L / 8][4];
  split_a<L>(x, xh, xl);
  split_a<L>(y, yh, yl);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L / 8; ++kk) {
    tf32_rs(accx, xl[kk], B::desc(xbhi, 0, kk));
    tf32_rs(accy, yl[kk], B::desc(ybhi, 0, kk));
  }
#pragma unroll
  for (int kk = 0; kk < L / 8; ++kk) {
    tf32_rs(accx, xh[kk], B::desc(xblo, 0, kk));
    tf32_rs(accy, yh[kk], B::desc(yblo, 0, kk));
  }
#pragma unroll
  for (int kk = 0; kk < L / 8; ++kk) {
    tf32_rs(accx, xh[kk], B::desc(xbhi, 0, kk));
    tf32_rs(accy, yh[kk], B::desc(ybhi, 0, kk));
  }
}

// --------------------------------------------------------------------- kernel

constexpr int kFwdRows = 128;    // query rows per block: two consumer warpgroups
constexpr int kFwdThreads = 512; // warpgroups 0, 1 consume, 2 and 3 produce
constexpr int kFwdProducer = 256;
// registers: 128 a thread at entry (one block of 512 threads an SM); the
// producers, which hold no tile in registers, give most of their share to
// the consumers' accumulators and A operands (setmaxnreg)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 216;
static_assert(kFwdProducer * kProducerRegs + 256 * kConsumerRegs <= kFwdThreads * 128,
              "the block's registers");

// Key tile and stages of head width D. A stage holds K's pair (TMA writes
// the raw K tile into its hi part, the producer splits it in place) and
// V^T's pair (TMA writes the raw V tile into its lo part, the producer
// transposes it out through its registers). kRing stages of their own fit
// beside Q's pair; where the consumers keep Q's fragments in registers, Q's
// pair, the size of a stage, serves as one stage more once they hold them.
template <int D>
struct Fwd {
  static constexpr int kT = D <= 64 ? 64 : 32;
  static constexpr int kRing = D <= 112 ? 2 : 1;
  static constexpr int W = D % 32 == 0 ? 32 : 16;  // TMA box width, floats: the panel width
  // Q's fragments in the consumers' registers (S = Q K^T then reads only K
  // from shared memory, whose bandwidth the products share with the
  // producer), where they fit beside the accumulators
  static constexpr bool kQRegs = D <= 64;
  static constexpr int kStages = kRing + (kQRegs ? 1 : 0);
  using Q = Tile<kFwdRows, D>;
  using K = Tile<kT, D>;
  using Vt = Tile<D, kT>;
  static constexpr uint32_t kStageBytes = 2 * K::kBytes + 2 * Vt::kBytes;
  static_assert(!kQRegs || 2 * Q::kBytes == kStageBytes, "Q's pair holds a stage");
};

// Shared memory of one block: 1024 bytes to align the tiles, Q's hi and lo,
// kRing stages of 4 tiles of kT keys by d floats, 128 bytes of barriers.
// Constant in N.
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return 1024 + (size_t)2 * kFwdRows * d * 4 +
         (size_t)(d <= 112 ? 2 : 1) * 16 * (d <= 64 ? 64 : 32) * d + 128;
}

// One-dimensional grid of ceil(n / 128) * heads * groups blocks, row tiles
// fastest: blockIdx.x = (group * heads + head) * ceil(n / 128) + tile (a
// grid's y and z stop at 65535, which a batch of crops outgrows). tq, tk, tv:
// (C, N, G) f32 tensor maps of q, k, v with box (W, 128 or kT, 1).
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_f32_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int o_stride,
                    float* __restrict__ lse, int n, int heads, float scale) {
  using F = Fwd<D>;
  constexpr int T = F::kT, S = F::kStages, W = F::W;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qhi = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t qlo = qhi + F::Q::kBytes;
  const uint32_t st0 = qlo + F::Q::kBytes;  // stage s < kRing: K hi, K lo, V^T hi, V^T lo
  const uint32_t q_loaded = st0 + F::kRing * F::kStageBytes, q_free = q_loaded + 8;
  const uint32_t loaded0 = q_free + 8, full0 = loaded0 + 8 * S, empty0 = full0 + 8 * S;
  const int nq = (n + kFwdRows - 1) / kFwdRows;
  const int gh = blockIdx.x / nq;
  const int grp = gh / heads, head = gh - grp * heads;
  const int q0 = (blockIdx.x - gh * nq) * kFwdRows;
  const int ntiles = (n + T - 1) / T;
  o += (size_t)grp * n * o_stride + head * D;

  auto stage = [&](int s) -> uint32_t { return s < F::kRing ? st0 + s * F::kStageBytes : qhi; };
  // tile j's raw K (into K hi) and V (into V^T lo) of stage j % S,
  // completing on its "loaded" barrier
  auto issue_tile = [&](int j) {
    const int s = j % S;
    const uint32_t kh = stage(s), vl = kh + 2 * F::K::kBytes + F::Vt::kBytes;
    const uint32_t bar = loaded0 + 8 * s;
    mbar_expect_tx(bar, 2 * F::K::kBytes);
#pragma unroll
    for (int a = 0; a < D / W; ++a) {
      tma_load_3d(kh + a * F::K::kPanelBytes, &tk, bar, head * D + a * W, j * T, grp);
      tma_load_3d(vl + a * F::K::kPanelBytes, &tv, bar, head * D + a * W, j * T, grp);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_loaded, 1);
    mbar_init(q_free, 8);  // the consumer warps, holding Q's fragments
    for (int s = 0; s < S; ++s) {
      mbar_init(loaded0 + 8 * s, 1);
      mbar_init(full0 + 8 * s, kFwdProducer / 32);  // the producer warps
      mbar_init(empty0 + 8 * s, 8);                 // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = threadIdx.x - 256;
    if (t == 0) {  // Q's raw rows (TMA zero-fills rows past n), then the first tiles
      mbar_expect_tx(q_loaded, F::Q::kBytes);
#pragma unroll
      for (int a = 0; a < D / W; ++a)
        tma_load_3d(qhi + a * F::Q::kPanelBytes, &tq, q_loaded, head * D + a * W, q0, grp);
      for (int j = 0; j < F::kRing && j < ntiles; ++j) issue_tile(j);
    }
    // tile j (past the first kRing) into its stage once that is free: the
    // first use of Q's pair waits for the consumers' fragments, later uses
    // for every consumer warp's release of tile j - S. With a third stage
    // the next tile is issued before this one is processed, else after.
    auto refill = [&](int j) {
      if (t != 0 || j < F::kRing || j >= ntiles) return;
      if (j < S) mbar_wait(q_free, 0);
      else mbar_wait(empty0 + 8 * (j % S), ((j - S) / S) & 1);
      issue_tile(j);
    };
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % S;
      const uint32_t kh = stage(s), kl = kh + F::K::kBytes;
      const uint32_t vh = kl + F::K::kBytes, vl = vh + F::Vt::kBytes;
      if (S >= 3) refill(it + 1);
      mbar_wait(loaded0 + 8 * s, (it / S) & 1);
      ColsS<T, D, kFwdProducer> vx;
      vx.load(vl, t);  // V's raw rows
      split_in_place<T, D, kFwdProducer>(kh, kl, 1.0f, t);
      named_sync(4, kFwdProducer);  // every raw V value read before V^T's lo overwrites it
      vx.store(vh, vl, t);
      publish(full0 + 8 * s);
      if (S < 3) refill(it + 1);
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = lane >> 2, c = lane & 3;
    const int row = q0 + 64 * wg + 16 * warp + r;  // this thread's rows: row, row + 8
    // Q (scaled) split in place by the consumers while the producer prepares
    // the first tile
    mbar_wait(q_loaded, 0);
    split_in_place<kFwdRows, D, 256>(qhi, qlo, scale, threadIdx.x);
    fence_async_smem();
    named_sync(3, 256);
    uint32_t qfh[F::kQRegs ? D / 8 : 1][4], qfl[F::kQRegs ? D / 8 : 1][4];
    if constexpr (F::kQRegs) {
      const int qr = 64 * wg + 16 * warp + r;  // the fragments' rows qr, qr + 8 of the tile
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = qr + 8 * (e & 1), col = 8 * kk + c + 4 * (e >> 1);
          const uint32_t off = F::Q::at(rr, col & ~3) + (col & 3) * 4;
          qfh[kk][e] = ld_shared_u32(qhi + off);
          qfl[kk][e] = ld_shared_u32(qlo + off);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_free);  // Q's pair may take a tile now
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m_lo = kNegInit, m_hi = kNegInit;  // running maxima of log2(e) s
    float l_lo = 0.0f, l_hi = 0.0f;          // this thread's part of the running sums
    // The two warpgroups take turns at the tensor cores, S of one while the
    // other's softmax runs: named barrier 1 + w opens warpgroup w's next
    // product, the other warpgroup arrives on it once it has issued its own
    // (warpgroup 0 goes first; warpgroup 1's arrival after its last product
    // is taken up after the loop). A warpgroup whose rows all lie past n
    // computes on zeros and stores nothing.
    const int mine = 1 + wg, other = 2 - wg;
    if (wg == 1) named_arrive(1, 256);

    for (int it = 0; it < ntiles; ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      {
        const uint32_t kh = stage(s), kl = kh + F::K::kBytes;
        const uint32_t vh = kl + F::K::kBytes, vl = vh + F::Vt::kBytes;
        float sc[T / 2];
#pragma unroll
        for (int i = 0; i < T / 2; ++i) sc[i] = 0.0f;
        named_sync(mine, 256);
        if constexpr (F::kQRegs) {
          product_rs_a<T, D>(sc, qfh, qfl, kh, kl);  // S = (scale Q) K^T
        } else {
          wgmma_fence();
          product_ss<kFwdRows, T, D>(sc, qhi, qlo, 64 * wg, kh, kl);
        }
        wgmma_commit();
        named_arrive(other, 256);
        wgmma_wait_all();
        fence_regs(sc);

        // keys past n (the ragged last tile) score -inf, so exp2 gives 0
        if (it == ntiles - 1 && n % T != 0) {
#pragma unroll
          for (int i = 0; i < T / 2; ++i)
            if (it * T + 8 * (i >> 2) + 2 * c + (i & 1) >= n) sc[i] = -INFINITY;
        }
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {  // a row's keys lie in its 4 lanes
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo * kLog2e), mn_hi = fmaxf(m_hi, mx_hi * kLog2e);
        const float al_lo = fast_exp2(m_lo - mn_lo), al_hi = fast_exp2(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float ps_lo = 0.0f, ps_hi = 0.0f;
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          sc[4 * j] = fast_exp2(fmaf(sc[4 * j], kLog2e, -mn_lo));
          sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], kLog2e, -mn_lo));
          sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], kLog2e, -mn_hi));
          sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], kLog2e, -mn_hi));
          ps_lo += sc[4 * j] + sc[4 * j + 1];
          ps_hi += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l_lo = l_lo * al_lo + ps_lo;
        l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= al_lo;
          acc[4 * j + 1] *= al_lo;
          acc[4 * j + 2] *= al_hi;
          acc[4 * j + 3] *= al_hi;
        }
        uint32_t ph[T / 8][4], pl[T / 8][4];
        split_a<T>(sc, ph, pl);
        named_sync(mine, 256);
        product_rs_a<D, T>(acc, ph, pl, vh, vl);  // O += P V
        wgmma_commit();
        named_arrive(other, 256);
        wgmma_wait_all();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }
    if (wg == 0) named_sync(1, 256);
    {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
      }
      const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
      const float inv_lo = 1.0f / den_lo, inv_hi = 1.0f / den_hi;
      if (lse != nullptr && c == 0) {
        float* lrow = lse + (size_t)gh * n;
        if (row < n) lrow[row] = m_lo + log2f(den_lo);
        if (row + 8 < n) lrow[row + 8] = m_hi + log2f(den_hi);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (row < n)
          *reinterpret_cast<float2*>(o + (size_t)row * o_stride + 8 * j + 2 * c) =
              make_float2(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
        if (row + 8 < n)
          *reinterpret_cast<float2*>(o + (size_t)(row + 8) * o_stride + 8 * j + 2 * c) =
              make_float2(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
      }
    }
  }
}

// Tensor map of an f32 (g, n, cols) tensor with rows `stride` floats apart
// (groups n * stride apart), box (w, rows, 1), swizzled to the panel width
// (w = 32: 128 bytes, w = 16: 64 bytes). TMA wants a 16-byte aligned base
// and row stride.
inline bool make_map_f32(CUtensorMap* map, const void* ptr, int cols, int stride, int n, int g,
                         int w, int rows) {
  fwd::bind_context();
  const fwd::EncodeTiled enc = fwd::encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || stride % 4 != 0)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n, (cuuint64_t)g};
  const cuuint64_t strides[2] = {(cuuint64_t)stride * 4, (cuuint64_t)n * stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             w == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const float* q, int q_stride, const float* k, int k_stride, const float* v,
           int v_stride, float* o, int o_stride, float* lse, int g, int n, int heads,
           float scale, cudaStream_t s) {
  using F = Fwd<D>;
  const size_t smem = smem_bytes(D);
  // once per instantiation: the block's shared memory does not depend on the call
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_f32_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long blocks = (long)((n + kFwdRows - 1) / kFwdRows) * heads * g;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  const int c = heads * D;
  if (!make_map_f32(&mq, q, c, q_stride, n, g, F::W, kFwdRows) ||
      !make_map_f32(&mk, k, c, k_stride, n, g, F::W, F::kT) ||
      !make_map_f32(&mv, v, c, v_stride, n, g, F::W, F::kT))
    return (int)cudaErrorInvalidValue;
  attn_f32_fwd_kernel<D><<<(unsigned)blocks, kFwdThreads, smem, s>>>(mq, mk, mv, o, o_stride,
                                                                      lse, n, heads, scale);
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

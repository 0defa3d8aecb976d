// One forward-attention kernel for Hopper (sm_90a), shared by
// area_attention.cu (K3), fused_ablock.cu (K2's attention step) and
// flash_attention.cu (K5, bf16):
//
//     o[g, :, h] = softmax(scale * q[g, :, h] k[g, :, h]^T) v[g, :, h]
//
// over (G, N, C) tensors with heads packed along the channels (head h owns
// columns [h*D, (h+1)*D)); each of q, k, v and o has its own row stride, so
// q and k may be column slices of one qk tensor (K3's training route, K2),
// and K5's (BH, N, D) is the case heads = 1, stride = D. bf16 in and out,
// f32 softmax and accumulation, head width D = 16..128 in steps of 16.
//
// Three modes (the caller picks one; each is its own instantiation, so the
// others pay nothing for it):
//   - kPlain: o alone (K3's inference route, K5);
//   - kStats: also lse, each row's log-sum-exp in the kernel's base-2 units
//     (m + log2(l) with m the maximum of scale * log2(e) * s), f32 per
//     (group, head, row), and o_lo, the bf16 rounding of o's remainder (o's
//     value is o + o_lo to about 16 significant bits), for which P enters
//     P V as two bf16 parts: K3's training route, whose backward
//     (area_attention_bwd.cu) takes P from lse and D = rowsum(dO o O) from
//     o + o_lo;
//   - kAdd: a bf16 addend of o's shape and row stride, loaded before the
//     key loop: o is rounded to bf16, then add is added in bf16 (K2's
//     o + pe).
//
// Replaces the TPU kernels kuzu/ops/flash_attention.py::area_attention
// (_area_attn_kernel: one group's N x N scores in VMEM) and ::flash_attention
// (_flash_kernel: 128-key tiles with the online softmax), and K2's attention
// step (kuzu/ops/fused_ablock.py::_kernel). The recurrence is the TPU flash
// kernel's (m from -1e30, alpha = exp(m - m_new), o = acc / max(l, 1e-30)),
// per 64-key tile; for K3 the exact two-pass maximum becomes this online one,
// a difference of f32-rounding size.
//
// Design. One block per (128 query rows, head, group), three warpgroups:
//   - warpgroup 2 produces: one thread loads Q once and streams 64-key K and
//     V tiles through a ring of kStages (3) with TMA (3-D tensor maps (C, N, G),
//     box (W, rows, 1) at (h*D + panel*W, row0, g)); mbarriers carry "full"
//     (bytes arrived) and "empty" (the 8 consumer warps are done) per stage.
//     TMA zero-fills rows past N, so the ragged last tile needs no copy and
//     only its scores are masked to -inf. It gives its registers back
//     (setmaxnreg) to
//   - warpgroups 0 and 1, which consume: each owns 64 query rows and shares
//     every K/V stage with the other. S = Q K^T is one wgmma chain with Q and
//     K read from swizzled shared memory (K-major); the softmax runs on the
//     accumulator registers (one MUFU ex2 per score, scale * log2(e) folded
//     into one FFMA with the running maximum); P goes from those registers,
//     as one bf16 part, straight into O += P V as wgmma's register A operand, and V is
//     the B operand in MN-major layout through its descriptor (no transpose
//     copy, no ldmatrix). Each warpgroup runs S, softmax, P V in turn and
//     waits for each product. Two schedules ran slower on the H100: P V of
//     one tile issued with S of the next as one group (ptxas then injects
//     waits for P's registers into the products), and the tensor cores
//     passed between the two warpgroups by named barriers (FA3's
//     ping-pong), which idles them while both warpgroups run a softmax.
// Tiles are stored as panels of W = 64, 32 or 16 columns (128-, 64- or
// 32-byte rows, the TMA and wgmma swizzle of that width); D = 48, 80, 112
// take three, five and seven 16-wide panels. The block's shared memory does
// not depend on N (attn_fwd_smem_bytes).
//
// What bounds it on this card. K5 at N = 8192: operations (4 N^2 D per head
// on the bf16 tensor cores, 0.278 ms at BH=16, D=64) and, next to them, the
// exponentials (N^2 per head on the 16-per-clock MUFU units, about as long):
// the two consumer warpgroups of each of two blocks per SM (D <= 64)
// overlap one warpgroup's softmax with another's wgmma. K3 and K2 at N=400:
// the bytes (each input read once: 0.0117 ms at G=32, C=384) and, in
// practice, latency: 128-row blocks give 256 (C=64) to 1536 (C=384) blocks,
// two resident per SM, each streaming its 7 key tiles while the previous
// tile is computed on.
//
// Everything here has internal linkage (an anonymous namespace): several
// kernel libraries include this header, and a template's static attribute
// guard with external linkage is one object across every library loaded in
// the process, so the first library to launch an instantiation would leave
// the others' copies of it without their shared-memory attribute (their
// launches then fail with cudaErrorInvalidValue).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is taken from the driver at run time
#include <dlfcn.h>
#include <math.h>

#include "attention.cuh"

namespace kuzu {
namespace {
namespace fwd {

constexpr int kRowsQ = 128;          // query rows per block
constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kStages = 3;           // depth of the K/V ring
constexpr int kThreads = 384;        // warpgroups 0, 1 consume, 2 produces
constexpr int kConsumerWarps = 8;    // arrivals on an "empty" barrier
constexpr float kNegInit = -1e30f;   // the running maximum's start, as the TPU kernel's
constexpr float kLog2e = 1.4426950408889634f;

enum Mode { kPlain = 0, kStats = 1, kAdd = 2 };

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head width 16..128, step 16");
  static constexpr int W = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);  // panel width
  static constexpr int kPanels = D / W;
  // two blocks per SM where the accumulators allow it
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  // registers at entry: 65536 / (kMinBlocks * 384) rounded down to 8 (80 or
  // 168); the producer keeps 24 and the consumers take the rest
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = D <= 64 ? 104 : 240;
  static constexpr uint32_t kQBytes = kRowsQ * D * 2;
  static constexpr uint32_t kTileBytes = kKeys * D * 2;
};

// Shared memory of one block: 1024 bytes to align the swizzled panels, Q,
// kStages K and V tiles, then the barriers. Constant in N.
__host__ __device__ constexpr size_t attn_fwd_smem_bytes(int d) {
  return 1024 + (size_t)kRowsQ * d * 2 + (size_t)kStages * 2 * kKeys * d * 2 + 128;
}

// ----------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// this thread's arrival, announcing `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box of `map` at coordinates (c0, c1, c2) into shared memory at dst,
// completing its bytes on barrier bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 2^x on the MUFU unit (x <= 0 here; results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across a wgmma
// wait: each register is an operand of an ordered (volatile) statement.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle of the panel width W (1: 128 B,
// 2: 64 B, 3: 32 B).
template <int W>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = W == 64 ? 1 : (W == 32 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// Accumulator layout of an m64nN wgmma (thread 32 w + 4 r + c of the
// warpgroup): d[4 j + e] = D[16 w + r + 8 (e >> 1)][8 j + 2 c + (e & 1)].
// The A operand from registers has, per 16-column k step, the same layout
// as two neighbouring 8-column blocks of it, so S's registers become P's.
// d (m64n64, f32) = A B (+ d if accumulate): A and B from shared memory
// through descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
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

// --------------------------------------------------------------------- kernel

// o[at], o[at + 1] = bf16(x0), bf16(x1); kStats: o_lo[at], o_lo[at + 1] =
// the bf16 remainders x - o; kAdd: plus the addend pair add2 in bf16 (each
// sum rounded once more, as a bf16 add does)
template <int kMode>
__device__ __forceinline__ void store_o(bf16* o, bf16* o_lo, size_t at, float x0, float x1,
                                        uint32_t add2) {
  uint32_t out = pack_bf16(x0, x1);
  if constexpr (kMode == kStats) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&out);
    *reinterpret_cast<uint32_t*>(o_lo + at) = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
  if constexpr (kMode == kAdd) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&add2);
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&out);
    out = pack_bf16(add_bf(r.x, a.x), add_bf(r.y, a.y));
  }
  *reinterpret_cast<uint32_t*>(o + at) = out;
}

// Grid (ceil(n / 128), heads, g), kThreads threads, attn_fwd_smem_bytes(D)
// bytes. tq, tk, tv: (C, N, G) tensor maps of q, k, v with box (W, 128 or
// 64, 1); o (and o_lo, add): token j of group g at o + (g * n + j) *
// o_stride, head h at column h * D; lse: row j of head h, group g at
// lse[(g * heads + h) * n + j]. scale_log2 = scale * log2(e).
template <int D, int kMode>
__global__ void __launch_bounds__(kThreads, Shape<D>::kMinBlocks)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                     bf16* __restrict__ o_lo, const bf16* __restrict__ add, int o_stride,
                     float* __restrict__ lse, int n, float scale_log2) {
  using S = Shape<D>;
  constexpr int W = S::W;
  constexpr uint32_t kRowBytes = W * 2;                // one panel row
  constexpr uint32_t kGroup = 8 * kRowBytes;           // 8 rows: the swizzle atom
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;  // Q: kPanels x (128 x W)
  const uint32_t sk = sq + S::kQBytes;                 // stage s: kPanels x (64 x W)
  const uint32_t sv = sk + kStages * S::kTileBytes;
  const uint32_t q_full = sv + kStages * S::kTileBytes;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;
  const int h = blockIdx.y, g = blockIdx.z, m0 = blockIdx.x * kRowsQ;
  const int ntiles = (n + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x == 256) {
      const int col = h * D;
      mbar_expect_tx(q_full, S::kQBytes);
#pragma unroll
      for (int a = 0; a < S::kPanels; ++a)
        tma_load_3d(sq + a * kRowsQ * kRowBytes, &tq, q_full, col + a * W, m0, g);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        // the stage's previous tile (it - kStages) released by every consumer warp
        if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * S::kTileBytes);
#pragma unroll
        for (int a = 0; a < S::kPanels; ++a) {
          const uint32_t off = s * S::kTileBytes + a * kKeys * kRowBytes;
          tma_load_3d(sk + off, &tk, bar, col + a * W, it * kKeys, g);
          tma_load_3d(sv + off, &tv, bar, col + a * W, it * kKeys, g);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = lane >> 2, c = lane & 3;
    const int row = m0 + 64 * wg + 16 * warp + r;  // this thread's rows: row, row + 8
    const uint32_t q_wg = sq + 64 * wg * kRowBytes;

    const size_t at = ((size_t)g * n + row) * o_stride + h * D + 2 * c;  // o[row][h D + 2 c]
    // kAdd: the addend of this thread's outputs, loaded before the key loop
    // so that its latency hides behind it
    uint32_t addv[kMode == kAdd ? D / 8 : 1][2];
    if constexpr (kMode == kAdd) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        addv[j][0] = row < n ? *reinterpret_cast<const uint32_t*>(add + at + 8 * j) : 0u;
        addv[j][1] = row + 8 < n
                         ? *reinterpret_cast<const uint32_t*>(add + at + (size_t)8 * o_stride + 8 * j)
                         : 0u;
      }
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m_lo = kNegInit, m_hi = kNegInit;  // running maxima of scale * log2(e) * s
    float l_lo = 0.0f, l_hi = 0.0f;          // this thread's part of the running sums
    mbar_wait(q_full, 0);

    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint32_t ks = sk + s * S::kTileBytes, vs = sv + s * S::kTileBytes;

      // S = Q K^T over D in 16-column steps; both operands K-major
      float sc[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // panel kk * 16 / W, 32-byte step kk * 16 % W inside its swizzled rows
        const int a = kk * 16 / W;
        const uint32_t off = (kk * 16 % W) * 2;
        wgmma_ss_n64(sc, smem_desc<W>(q_wg + a * kRowsQ * kRowBytes + off, 16, kGroup),
                     smem_desc<W>(ks + a * kKeys * kRowBytes + off, 16, kGroup), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // keys past n (the ragged last tile) score -inf, so exp2 gives 0
      if (it == ntiles - 1 && n % kKeys != 0) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i)
          if (it * kKeys + 8 * (i >> 2) + 2 * c + (i & 1) >= n) sc[i] = -INFINITY;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {  // a row's 64 keys lie in its 4 lanes
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
      const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
      const float al_lo = fast_exp2(m_lo - mn_lo), al_hi = fast_exp2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float ps_lo = 0.0f, ps_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -mn_lo));
        sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mn_lo));
        sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mn_hi));
        sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mn_hi));
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
      // P as one bf16 part (kStats: two, hi and lo), in the A layout: k step
      // kk is keys [16 kk, + 16)
      uint32_t pf[kKeys / 16][4], pl[kMode == kStats ? kKeys / 16 : 1][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
          pf[kk][e] = pack_bf16(x0, x1);
          if constexpr (kMode == kStats) {
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&pf[kk][e]);
            pl[kk][e] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
          }
        }
      }
      // O += P V; V (keys x D, D contiguous) is MN-major: a k step is 16
      // rows on, panels are kKeys rows apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t dv = smem_desc<W>(vs + kk * 16 * kRowBytes, kKeys * kRowBytes, kGroup);
        wgmma_rs(acc, pf[kk], dv);
        if constexpr (kMode == kStats) wgmma_rs(acc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
    }
    const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
    if (kMode == kStats && c == 0) {
      float* lrow = lse + ((size_t)g * gridDim.y + h) * n;
      if (row < n) lrow[row] = m_lo + log2f(den_lo);
      if (row + 8 < n) lrow[row + 8] = m_hi + log2f(den_hi);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t a0 = 0u, a1 = 0u;
      if constexpr (kMode == kAdd) {
        a0 = addv[j][0];
        a1 = addv[j][1];
      }
      if (row < n)
        store_o<kMode>(o, o_lo, at + 8 * j, __fdiv_rn(acc[4 * j], den_lo),
                       __fdiv_rn(acc[4 * j + 1], den_lo), a0);
      if (row + 8 < n)
        store_o<kMode>(o, o_lo, at + (size_t)8 * o_stride + 8 * j,
                       __fdiv_rn(acc[4 * j + 2], den_hi), __fdiv_rn(acc[4 * j + 3], den_hi), a1);
    }
  }
}

// ----------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process has loaded
// (the kernels link only the CUDA runtime).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The encoder is a driver call and wants a current context in the calling
// thread. A thread that has only inherited the default device (PyTorch's
// autograd thread, which runs the backward kernels) has none until a runtime
// call binds the device's primary context: cudaSetDevice does, once per
// thread.
inline void bind_context() {
  thread_local const bool bound = [] {
    int dev = 0;
    return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
  }();
  (void)bound;
}

// Tensor map of a bf16 (g, n, cols) tensor with rows `stride` elements apart
// (groups n * stride apart), box (w, rows, 1), swizzled to the panel width.
// TMA wants a 16-byte aligned base and strides that are multiples of 16 bytes.
inline bool make_map(CUtensorMap* map, const void* ptr, int cols, int stride, int n, int g, int w,
                     int rows) {
  bind_context();
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || stride % 8 != 0)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n, (cuuint64_t)g};
  const cuuint64_t strides[2] = {(cuuint64_t)stride * 2, (cuuint64_t)n * stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of an f32 (g, heads, n) tensor of per-row values (lse, K4's D),
// box (rows, 1, 1), no swizzle; TMA wants n % 4 == 0 (16-byte strides).
inline bool make_row_map(CUtensorMap* map, const float* ptr, int n, int heads, int g,
                         int rows) {
  bind_context();
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || n % 4 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)heads, (cuuint64_t)g};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 4, (cuuint64_t)heads * n * 4};
  const cuuint32_t box[3] = {(cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int kMode>
int launch(const void* q, int q_stride, const void* k, int k_stride, const void* v, int v_stride,
           void* o, void* o_lo, const void* add, int o_stride, float* lse, int g, int n,
           int heads, float scale, cudaStream_t stream) {
  using S = Shape<D>;
  // once per instantiation: the block's shared memory does not depend on the call
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_kernel<D, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_fwd_smem_bytes(D));
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv;
  const int c = heads * D;
  if (!make_map(&mq, q, c, q_stride, n, g, S::W, kRowsQ) ||
      !make_map(&mk, k, c, k_stride, n, g, S::W, kKeys) ||
      !make_map(&mv, v, c, v_stride, n, g, S::W, kKeys))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRowsQ - 1) / kRowsQ, heads, g);
  attention_fwd_kernel<D, kMode><<<grid, kThreads, attn_fwd_smem_bytes(D), stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<bf16*>(o_lo),
      static_cast<const bf16*>(add), o_stride, lse, n, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// o = softmax(scale q_h k_h^T) v_h for every head h and group of (g, n,
// heads * hd) bf16 tensors, in mode kMode (fwd::Mode): kStats also writes
// each row's base-2 log-sum-exp into lse (g, heads, n) f32 and o's bf16
// remainder into o_lo (o's row stride), kAdd adds add (o's row stride).
// Returns a cudaError_t (cudaErrorInvalidValue for a head width the kernel
// is not built for, an unaligned base or stride, or no driver entry point
// for the tensor maps).
template <int kMode>
int attention_fwd(const void* q, int q_stride, const void* k, int k_stride, const void* v,
                  int v_stride, void* o, void* o_lo, const void* add, int o_stride, float* lse,
                  int g, int n, int heads, int hd, float scale, cudaStream_t stream) {
  if (g <= 0 || n <= 0) return 0;
#define KUZU_FWD_CASE(D)                                                                     \
  case D:                                                                                    \
    return fwd::launch<D, kMode>(q, q_stride, k, k_stride, v, v_stride, o, o_lo, add,      \
                                 o_stride, lse, g, n, heads, scale, stream);
  switch (hd) {
    KUZU_FWD_CASE(16)
    KUZU_FWD_CASE(32)
    KUZU_FWD_CASE(48)
    KUZU_FWD_CASE(64)
    KUZU_FWD_CASE(80)
    KUZU_FWD_CASE(96)
    KUZU_FWD_CASE(112)
    KUZU_FWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KUZU_FWD_CASE
}

}  // namespace
}  // namespace kuzu

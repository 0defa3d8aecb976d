// Greedy NMS keep-mask for score-sorted boxes, one image per batch row.
//
// Replaces the TPU kernel kuzu/ops/pallas_nms.py::pallas_suppress (its
// _nms_kernel / _nms_kernel_chunked / _nms_kernel_batched variants). Same
// rule: box j is suppressed by an earlier *kept* box i when
//     inter / (area_i + area_j - inter + 1e-7) > thr      (f32)
// and a box is kept iff it is valid and not suppressed.
//
// Design: the TPU kernel's chunked structure (a 128-box chunk resolved
// serially against a register row, then all later chunks suppressed in one
// vector pass), laid out for this card in 64-box chunks, two launches:
//   1. nms_mask_kernel: every pair (i, j > i) of an image is tested once, in
//      parallel over the card, into bit words: word w of row i holds the
//      pairs (i, 64 w .. 64 w + 63). Only the W (W + 1) / 2 blocks of
//      (row chunk c, word w >= c) are launched (a triangular grid, one
//      block of 64 rows per word): the words below the diagonal are never
//      written nor read. Layout (nms_mask_words): chunk c's words sit
//      together, word-major, w - c = 0 .. W - c - 1, 64 rows each, so a
//      block stores its 64 words in one 512-byte line and the sweep loads a
//      whole chunk as one contiguous run.
//   2. nms_sweep_kernel: one block per image walks the chunks in order.
//      While chunk c is resolved, chunk c + 1 is already on its way into
//      shared memory (cp.async, double-buffered), so no step waits on L2:
//        - the serial part stays in registers: one thread takes the chunk's
//          64 diagonal words, its 64 valid bits and its "removed" word, and
//          for r = 0..63 keeps row r when it is valid and not removed,
//          ORing row r's diagonal word into the removed word: 64 dependent
//          steps of a bit test and a predicated OR on 32-bit registers, no
//          memory access on the chain;
//        - the parallel part uses the whole block: each later word w > c
//          gets removed[w] |= OR over the kept rows r of mask[64 c + r][w],
//          one warp per word (a lane per two rows, a warp OR-reduce).
//      Valid bits are read once, as 64-bit words (warp ballots), at the
//      start. Words past the shared-memory window (W - c > kCap, K > 8192)
//      are read from L2 by the same pass.
// What bounds it on this card: the mask kernel's pair tests (14 f32
// operations with one correctly rounded divide for each pair that
// overlaps: 0.0029 ms of the f32 peak at B=8, K=2048); the sweep is a serial chain of W chunks of 64 register steps
// plus one barrier-separated OR pass each, latency rather than bytes or
// operations.
//
// Exactness: the IoU uses round-to-nearest intrinsics in the reference's
// operation order, and the file is built with --fmad=false, so no
// multiply-add is contracted into an FMA. K needs no padding: the ragged
// tail is masked here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kWord = 64;
constexpr int kSweepThreads = 256;  // 8 warps
constexpr int kCap = 128;           // words per row of a chunk kept in shared memory

__host__ __device__ inline long tri(int c, int w) {  // words of chunks 0..c-1, per row
  return (long)c * w - (long)c * (c - 1) / 2;
}

// The bit words of one image: 64 rows x W (W + 1) / 2 words.
__host__ __device__ inline long mask_words(int w) { return (long)kWord * tri(w, w); }

__host__ __device__ inline size_t sweep_smem_bytes(int w) {
  const int cap = w < kCap ? w : kCap;
  return (size_t)2 * cap * kWord * sizeof(u64) + (size_t)2 * w * sizeof(u64);
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// Grid (W (W + 1) / 2, B), 64 threads: block t is (row chunk c, word w >= c),
// thread r tests row 64 c + r against the 64 boxes of word w.
__global__ void nms_mask_kernel(const float* __restrict__ boxes,    // (B, K, 4)
                                const uint8_t* __restrict__ valid,  // (B, K)
                                u64* __restrict__ mask,             // (B, mask_words(W))
                                int K, int W, float thr) {
  const int b = blockIdx.y;
  const long t = blockIdx.x;
  // the row chunk c with tri(c) <= t < tri(c + 1): the root of the quadratic,
  // then a step either way for its rounding
  const double q = 2.0 * W + 1.0;
  int c = (int)((q - sqrt(q * q - 8.0 * (double)t)) * 0.5);
  c = c < 0 ? 0 : (c >= W ? W - 1 : c);
  while (c > 0 && tri(c, W) > t) --c;
  while (c + 1 < W && tri(c + 1, W) <= t) ++c;
  const int w = c + (int)(t - tri(c, W));
  const int r = threadIdx.x;
  const float* bx = boxes + (size_t)b * K * 4;
  const uint8_t* va = valid + (size_t)b * K;

  __shared__ float cx1[kWord], cy1[kWord], cx2[kWord], cy2[kWord], carea[kWord];
  __shared__ uint8_t cvalid[kWord];
  {
    const int j = w * kWord + r;
    if (j < K) {
      const float4 p = reinterpret_cast<const float4*>(bx)[j];
      cx1[r] = p.x; cy1[r] = p.y; cx2[r] = p.z; cy2[r] = p.w;
      carea[r] = box_area(p.x, p.y, p.z, p.w);
      cvalid[r] = va[j];
    } else {
      cvalid[r] = 0;
    }
  }
  __syncthreads();

  const int i = c * kWord + r;
  u64 bits = 0;
  if (i < K && va[i]) {
    const float4 p = reinterpret_cast<const float4*>(bx)[i];
    const float parea = box_area(p.x, p.y, p.z, p.w);
    const int jstart = w == c ? r + 1 : 0;  // only j > i
    for (int jj = jstart; jj < kWord; ++jj) {
      if (!cvalid[jj]) continue;  // also covers j >= K
      const float iw = fmaxf(__fsub_rn(fminf(p.z, cx2[jj]), fmaxf(p.x, cx1[jj])), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(p.w, cy2[jj]), fmaxf(p.y, cy1[jj])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      // disjoint boxes (most pairs) skip the divide: their IoU is 0 / (a
      // positive denominator), exactly +0
      float iou = 0.0f;
      if (inter != 0.0f)
        iou = __fdiv_rn(inter, __fadd_rn(__fsub_rn(__fadd_rn(parea, carea[jj]), inter), 1e-7f));
      if (iou > thr) bits |= 1ull << jj;
    }
  }
  mask[(size_t)b * mask_words(W) + kWord * (tri(c, W) + (w - c)) + r] = bits;
}

// One block of kSweepThreads per image, sweep_smem_bytes(W) bytes.
__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep,  // (B, K)
                 int K, int W) {
  extern __shared__ __align__(16) u64 sm[];
  const int cap = W < kCap ? W : kCap;
  u64* buf = sm;                        // two chunk windows of cap x 64 words
  u64* removed = sm + 2 * cap * kWord;  // W words
  u64* vwords = removed + W;            // W words
  __shared__ u64 kept_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kSweepThreads / 32;
  const int b = blockIdx.x;
  const u64* m = mask + (size_t)b * mask_words(W);
  const uint8_t* va = valid + (size_t)b * K;
  uint8_t* kp = keep + (size_t)b * K;

  // chunk c's first min(W - c, cap) words of 64 rows into window c & 1
  auto fetch = [&](int c) {
    const int cols = W - c < cap ? W - c : cap;
    const char* src = reinterpret_cast<const char*>(m + kWord * tri(c, W));
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(buf + (c & 1) * cap * kWord));
    for (int p = tid; p < cols * kWord / 2; p += kSweepThreads)  // 16-byte pieces
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * p),
                   "l"(src + 16 * p)
                   : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  fetch(0);
  for (int w = warp; w < W; w += kWarps) {
    const int j = w * kWord + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, j < K && va[j]);
    const unsigned hi = __ballot_sync(0xffffffffu, j + 32 < K && va[j + 32]);
    if (lane == 0) {
      vwords[w] = (u64)lo | ((u64)hi << 32);
      removed[w] = 0ull;
    }
  }

  for (int c = 0; c < W; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk c is in; chunk c - 1's OR pass is done
    if (c + 1 < W) fetch(c + 1);  // into the window chunk c - 1 used
    const u64* win = buf + (c & 1) * cap * kWord;
    if (tid == 0) {
      // the serial part. Row r's diagonal word (column 0 of the chunk) has
      // only bits of later rows, so bit r of "removed" is final when row r
      // is reached, and the rows kept are the bits still clear at the end;
      // invalid rows start removed. Rows 0..31 touch the low half alone
      // (their high halves are ORed in after, off the chain), rows 32..63
      // have no low half: two chains of 32 steps on 32-bit words.
      // The diagonal words go to registers first, so no load sits on the
      // chain: each step is a bit test and a predicated OR.
      uint32_t dlo[32], dhi[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const u64 d = win[r];
        if (r < 32) dlo[r] = (uint32_t)d;
        dhi[r] = (uint32_t)(d >> 32);
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) {  // keep the compiler from sinking the loads into the chain
        if (r < 32) asm volatile("" : "+r"(dlo[r]));
        asm volatile("" : "+r"(dhi[r]));
      }
      const u64 start = removed[c] | ~vwords[c];
      uint32_t lo = (uint32_t)start, hi = (uint32_t)(start >> 32), hi_add = 0;
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!(lo & (1u << r))) lo |= dlo[r];
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!(lo & (1u << r))) hi_add |= dhi[r];
      hi |= hi_add;
#pragma unroll
      for (int r = 32; r < 64; ++r)
        if (!(hi & (1u << (r - 32)))) hi |= dhi[r];
      kept_s = ~(((u64)hi << 32) | lo);
    }
    __syncthreads();
    const u64 kept = kept_s;
    if (tid < kWord && c * kWord + tid < K) kp[c * kWord + tid] = (kept >> tid) & 1ull;
    if (kept == 0ull) continue;
    // the parallel part: one warp per later word, lane l reduces rows l, l + 32
    const u64* far = m + kWord * tri(c, W);
    for (int j = 1 + warp; j < W - c; j += kWarps) {
      const u64* col = (j < cap ? win : far) + (size_t)j * kWord;
      u64 x = (((kept >> lane) & 1ull) ? col[lane] : 0ull) |
              (((kept >> (lane + 32)) & 1ull) ? col[lane + 32] : 0ull);
      const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)x);
      const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(x >> 32));
      if (lane == 0) removed[c + j] |= (u64)lo | ((u64)hi << 32);
    }
  }
}

}  // namespace

// Words of the mask scratch per image, and the sweep's shared memory (the
// Python gate's twins: nms_kernel.mask_words, nms_kernel.sweep_smem_bytes).
extern "C" long kuzu_nms_mask_words(int K) { return mask_words((K + kWord - 1) / kWord); }
extern "C" size_t kuzu_nms_sweep_smem(int K) { return sweep_smem_bytes((K + kWord - 1) / kWord); }

// boxes (B, K, 4) f32, valid (B, K) u8, mask (B, kuzu_nms_mask_words(K))
// int64 scratch, keep (B, K) u8; all contiguous, 16-byte aligned.
extern "C" int kuzu_nms(const void* boxes, const void* valid, void* mask, void* keep,
                        int B, int K, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int W = (K + kWord - 1) / kWord;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3((unsigned)tri(W, W), B), kWord, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<u64*>(mask), K, W, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sweep_smem_bytes(W);
  err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<B, kSweepThreads, smem, s>>>(static_cast<const u64*>(mask),
                                                  static_cast<const uint8_t*>(valid),
                                                  static_cast<uint8_t*>(keep), K, W);
  return (int)cudaGetLastError();
}

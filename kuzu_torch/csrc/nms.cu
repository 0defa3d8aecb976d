// Greedy NMS keep-mask for score-sorted boxes, one image per batch row.
//
// Replaces the TPU kernel kuzu/ops/pallas_nms.py::pallas_suppress (its
// _nms_kernel / _nms_kernel_chunked / _nms_kernel_batched variants). Same
// rule: box j is suppressed by an earlier *kept* box i when
//     inter / (area_i + area_j - inter + 1e-7) > thr      (f32)
// and a box is kept iff it is valid and not suppressed.
//
// Design. The work splits into a parallel part and a serial part:
//   1. nms_mask_kernel: every (i, j > i) pair of an image is tested once, in
//      parallel over the card, and the result is stored as a bitmask of
//      ceil(K/64) 64-bit words per row (K x ceil(K/64) words: 512 KB per
//      image at K = 2048, which stays in L2 for the sweep).
//   2. nms_sweep_kernel: one warp per image walks the rows in score order.
//      The "removed" bits live in shared memory; a kept row ORs its mask
//      words into them, 32 words per warp step.
// What bounds it on this card: the sweep is a serial chain of K dependent
// steps per image, so the kernel is latency-bound (one L2 read of a mask row
// per kept box), far above both the byte and the operation bound.
//
// Exactness: the IoU uses round-to-nearest intrinsics in the reference's
// operation order, and the file is built with --fmad=false, so no
// multiply-add is contracted into an FMA. K needs no padding: the ragged
// tail is masked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,  // (B, K, 4)
                                const uint8_t* __restrict__ valid,  // (B, K)
                                unsigned long long* __restrict__ mask,  // (B, K, W)
                                int K, int W, float thr) {
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kWord;
  const int col0 = blockIdx.x * kWord;
  const int t = threadIdx.x;
  const float* bx = boxes + (size_t)b * K * 4;
  const uint8_t* va = valid + (size_t)b * K;

  __shared__ float cx1[kWord], cy1[kWord], cx2[kWord], cy2[kWord], carea[kWord];
  __shared__ uint8_t cvalid[kWord];
  {
    const int j = col0 + t;
    if (j < K) {
      const float4 c = reinterpret_cast<const float4*>(bx)[j];
      cx1[t] = c.x; cy1[t] = c.y; cx2[t] = c.z; cy2[t] = c.w;
      carea[t] = box_area(c.x, c.y, c.z, c.w);
      cvalid[t] = va[j];
    } else {
      cvalid[t] = 0;
    }
  }
  __syncthreads();

  const int i = row0 + t;
  if (i >= K) return;
  unsigned long long bits = 0;
  if (va[i] && col0 + kWord > i + 1) {
    const float4 p = reinterpret_cast<const float4*>(bx)[i];
    const float parea = box_area(p.x, p.y, p.z, p.w);
    const int jstart = max(0, i + 1 - col0);
    for (int jj = jstart; jj < kWord; ++jj) {
      if (!cvalid[jj]) continue;  // also covers j >= K
      const float iw = fmaxf(__fsub_rn(fminf(p.z, cx2[jj]), fmaxf(p.x, cx1[jj])), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(p.w, cy2[jj]), fmaxf(p.y, cy1[jj])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float denom = __fadd_rn(__fsub_rn(__fadd_rn(parea, carea[jj]), inter), 1e-7f);
      const float iou = __fdiv_rn(inter, denom);
      if (iou > thr) bits |= 1ull << jj;
    }
  }
  mask[((size_t)b * K + i) * W + blockIdx.x] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ keep,  // (B, K)
                                 int K, int W) {
  extern __shared__ unsigned long long removed[];  // W words
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)b * K * W;
  const uint8_t* va = valid + (size_t)b * K;
  uint8_t* kp = keep + (size_t)b * K;
  for (int w = lane; w < W; w += 32) removed[w] = 0ull;
  __syncwarp();
  for (int i = 0; i < K; ++i) {
    const int wi = i / kWord;
    const bool kept = va[i] && !((removed[wi] >> (i % kWord)) & 1ull);
    if (lane == 0) kp[i] = kept ? 1 : 0;
    if (kept) {
      const unsigned long long* row = m + (size_t)i * W;
      for (int w = wi + lane; w < W; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int kuzu_nms(const void* boxes, const void* valid, void* mask, void* keep,
                        int B, int K, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int W = (K + kWord - 1) / kWord;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(W, W, B);
  nms_mask_kernel<<<grid, kWord, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<unsigned long long*>(mask), K, W, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)W * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<B, 32, smem, s>>>(static_cast<const unsigned long long*>(mask),
                                       static_cast<const uint8_t*>(valid),
                                       static_cast<uint8_t*>(keep), K, W);
  return (int)cudaGetLastError();
}

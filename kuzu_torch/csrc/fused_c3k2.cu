// Fused C3k2 block (c3k=True, n=2, shortcut), BN folded, NHWC bf16.
//
// Replaces the TPU kernel kuzu/ops/fused_c3k2.py::fused_c3k2 (_kernel):
//     cv1(1x1) -> split(a, b) -> m0 = C3k(b) -> m1 = C3k(m0)
//     -> cv2(1x1) over concat(a, b, m0, m1)
//     C3k: cv3(1x1)(concat(bottleneck(bottleneck(cv1(x))), cv2(x)))
//     bottleneck: x + conv3x3(conv3x3(x))            (every conv + SiLU)
// Every conv sums in f32, adds the f32 bias, applies SiLU in f32 and rounds
// to bf16; the residual adds two bf16 values with one rounding.
//
// Design. The TPU block is a full-width band of T + 16 rows with every
// intermediate in VMEM: at 160 x 160 x 192 (yolov12x node 2) the input band
// alone is 2.16 MB, ten times a Hopper block's shared memory. Here the block
// is 14 launches of TMA-fed wgmma products: cv1, per C3k its cv1 and
// bypass cv2 as one product (both read m_j; their weights side by side) and
// cv3, then cv2, on gemm.cuh's GEMM (K2's), and the four 3x3 convs of each
// C3k on conv.cuh's implicit GEMM (halo tiles, A from registers). The
// intermediates pass
// through global memory in buffers laid out so that no concatenation is
// ever copied:
//     z  (B, H, W, 4c):   [a | b | m0 | m1], cv1 writes a and b, C3k j reads
//                         its input from z and writes m_j into z, the final
//                         cv2 reads all of z;
//     u  (B, H, W, 2hid): [bottleneck stream | bypass], written whole by the
//                         merged product, what cv3 reads; the bottleneck's
//                         second conv adds its residual in place (each
//                         output element reads and writes its own place);
//     v1 (B, H, W, hid):  the bottleneck's middle activation.
// SAME borders: TMA fills a 3x3 tap's cells outside the image with zeros, so
// every conv reads true zeros there, which is what the TPU kernel's masks
// give (no conv ever sees silu(bias) of a pixel outside the image).
// What bounds it on this card: operations (2 K N per pixel and conv, about
// 0.16 TFLOP at node 2, batch 8) against the bytes of x and the output; the
// intermediates' round trips (about 30 passes of (B, H, W, <=4c) bf16) are
// the price of the split.

#include "conv.cuh"

namespace {

constexpr int kConvs = 14;  // launches: cv1, 6 per C3k, cv2

}  // namespace

// Shared memory of the 1x1 (k3 = 0: gemm.cuh) and the 3x3 (k3 = 1:
// conv.cuh) blocks at column tile bn (the Python gate's twin:
// fused_c3k2_smem_bytes).
extern "C" size_t kuzu_fused_c3k2_smem(int bn, int k3) {
  return k3 ? kuzu::conv::conv3x3_smem_bytes(bn) : kuzu::gemm::gemm_smem_bytes(bn);
}

// x (b, h, w, cin) bf16; weights: 28 device pointers, the (W bf16 row-major
// (taps * cin, n), bias f32 (n)) pairs of the 14 launches in order (cv1; per
// C3k the merged cv1 | cv2, m0.cv1, m0.cv2, m1.cv1, m1.cv2, cv3; cv2), as
// ops/fused_c3k2.py::kernel_weights lays them out; z (b, h, w, 4c), u (b, h,
// w, 2 hid), v1 (b, h, w, hid) scratch; out (b, h, w, c2). All contiguous and
// 16-byte aligned; every width a multiple of 8. Returns a cudaError_t.
extern "C" int kuzu_fused_c3k2(const void* x, const void* const* weights, void* z, void* u,
                               void* v1, void* out, int b, int h, int w, int cin, int c,
                               int hid, int c2, void* stream) {
  using kuzu::bf16;
  using kuzu::conv::Conv;
  using kuzu::conv::run3x3;
  using kuzu::gemm::Gemm;
  using kuzu::gemm::kConv;
  using kuzu::gemm::kConvMerged;
  using kuzu::gemm::run;
  const int m = b * h * w;
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto bias = [&](int i) { return static_cast<const float*>(weights[2 * i + 1]); };
  // launch i as a 1x1 conv: in (m, k) with rows in_cs apart -> o (m, n), rows o_cs apart
  auto conv1x1 = [&](int i, const void* in, int in_cs, bf16* o, int o_cs, int n, int k) {
    return Gemm{in, in_cs, weights[2 * i], bias(i), nullptr, 0, o, o_cs, m, n, k};
  };
  // launch i as a 3x3 conv with k input channels
  auto conv3x3 = [&](int i, bf16* o, int o_cs, int n, int k) {
    return Conv{bias(i), o, o_cs, nullptr, 0, n, k, b, h, w, 0};
  };
  bf16* zp = static_cast<bf16*>(z);
  bf16* up = static_cast<bf16*>(u);
  bf16* vp = static_cast<bf16*>(v1);
  const int zc = 4 * c, uc = 2 * hid;
  int err;
  // cv1: x -> z[:, :2c]  (a, b)
  if ((err = run<kConv>(conv1x1(0, x, cin, zp, zc, 2 * c, cin), s))) return err;
  for (int j = 0; j < 2; ++j) {
    const int i0 = 1 + 6 * j;
    const bf16* mj = zp + (1 + j) * c;  // b, then m0
    // C3k cv1 | cv2 (bypass): m -> u whole
    if ((err = run<kConvMerged>(conv1x1(i0, mj, zc, up, uc, uc, c), s))) return err;
    for (int bt = 0; bt < 2; ++bt) {  // bottlenecks: u[:, :hid] += conv3x3(conv3x3(u[:, :hid]))
      const int i1 = i0 + 1 + 2 * bt;
      if ((err = run3x3(up, uc, weights[2 * i1], conv3x3(i1, vp, hid, hid, hid), s))) return err;
      Conv second = conv3x3(i1 + 1, up, uc, hid, hid);
      second.res = up;
      second.res_cs = uc;
      if ((err = run3x3(vp, hid, weights[2 * (i1 + 1)], second, s))) return err;
    }
    // C3k cv3: u -> z[:, (2 + j) c : (3 + j) c]
    if ((err = run<kConv>(conv1x1(i0 + 5, up, uc, zp + (2 + j) * c, zc, c, uc), s))) return err;
  }
  // cv2: z -> out
  return run<kConv>(conv1x1(kConvs - 1, zp, zc, static_cast<bf16*>(out), c2, c2, zc), s);
}

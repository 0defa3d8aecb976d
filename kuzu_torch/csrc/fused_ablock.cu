// Fused ABlock (area-attention block with its MLP), BN folded into the weights.
//
// Replaces the TPU kernel kuzu/ops/fused_ablock.py::fused_ablock (_kernel).
// For each chunk g of na tokens (one image-area) and C channels:
//     qk  = bf16(x Wqk + bqk)                              (C -> 2C)
//     o_h = bf16(softmax(scale q_h k_h^T) v_h)           per head
//     x1  = x + bf16((o + pe) Wp + bp)                     (bf16 adds)
//     out = x1 + bf16(bf16(silu(x1 W1 + b1)) W2 + b2)
// v and its 5x5 depthwise pe are computed outside and come in as inputs.
//
// Design. On the TPU one grid step holds a whole chunk; here a chunk at
// x-scale (400 x 384 bf16 = 307 KB for x alone) does not fit a block's 227 KB,
// and the attention needs every key of its chunk before any query row can go
// on, so the block is five launches over all chunks at once:
//   1. qk = x Wqk + bqk: the GEMM of gemm.cuh (TMA-fed wgmma, epilogue kQk);
//   2. attention_fwd_kernel (attention_fwd.cuh, shared with K3 and K5): o for
//      every (128 query rows, head, chunk), with pe added in its epilogue
//      (o rounded to bf16, then o + pe in bf16, the reference's arithmetic);
//   3. x1 = x + (o + pe) Wp + bp (kProj), 4. h = silu(x1 W1 + b1) (kMlp1),
//   5. out = x1 + h W2 + b2 (kMlp2): the same GEMM kernel, each epilogue at
//      the reference's rounding points (fused_ablock.py:52-85).
// qk, o + pe, x1 and h pass through global memory (9.8-19.7 MB each at
// yolov12x@640 batch 8, microseconds of the card's bandwidth). Every product
// is this repository's own wgmma code. What bounds it on this card:
// operations, 2 (2C^2 + C^2 + 2 C h) FLOPs per token for the GEMMs plus
// 4 na C per token of attention.

#include "gemm.cuh"

namespace {

// The largest of the attention block's and the GEMM block's shared memory
// (neither depends on na; the GEMM's not on c or hidden either).
inline size_t ablock_smem_bytes(int hd) {
  size_t m = kuzu::fwd::attn_fwd_smem_bytes(hd);
  for (int bn : kuzu::gemm::kWidths) {
    const size_t g = kuzu::gemm::gemm_smem_bytes(bn);
    m = g > m ? g : m;
  }
  return m;
}

}  // namespace

extern "C" size_t kuzu_fused_ablock_smem(int c, int heads) { return ablock_smem_bytes(c / heads); }

// x, v, pe, out: (g * na, c) bf16; weights (cin, cout) bf16 row-major, biases
// f32; qk (g * na, 2c), a (o + pe) and x1 (g * na, c), h (g * na, hidden):
// bf16 scratch the caller allocates. All 16-byte aligned (TMA).
extern "C" int kuzu_fused_ablock(const void* x, const void* v, const void* pe, const void* wqk,
                                 const void* bqk, const void* wp, const void* bp, const void* w1,
                                 const void* b1, const void* w2, const void* b2, void* qk, void* a,
                                 void* x1, void* h, void* out, int g, int na, int c, int heads,
                                 int hidden, float scale, void* stream) {
  using namespace kuzu::gemm;
  if (g <= 0 || na <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = g * na;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  int err = run<kQk>(Gemm{x, c, wqk, f32(bqk), nullptr, 0, qk, 2 * c, m, 2 * c, c}, s);
  if (err != 0) return err;
  const kuzu::bf16* qkp = static_cast<const kuzu::bf16*>(qk);
  err = kuzu::attention_fwd<kuzu::fwd::kAdd>(qkp, 2 * c, qkp + c, 2 * c, v, c, a, nullptr, pe,
                                             c, nullptr, g, na, heads, c / heads, scale, s);
  if (err != 0) return err;
  err = run<kProj>(Gemm{a, c, wp, f32(bp), x, c, x1, c, m, c, c}, s);
  if (err != 0) return err;
  err = run<kMlp1>(Gemm{x1, c, w1, f32(b1), nullptr, 0, h, hidden, m, hidden, c}, s);
  if (err != 0) return err;
  return run<kMlp2>(Gemm{h, hidden, w2, f32(b2), x1, c, out, c, m, c, hidden}, s);
}

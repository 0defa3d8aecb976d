// Flash attention over (BH, N, D): o = softmax(scale q k^T) v, non-causal,
// with no N x N tensor anywhere.
//
// Replaces the TPU kernel kuzu/ops/flash_attention.py::flash_attention
// (_flash_kernel). The TPU runs a grid (BH, N / 128) in order, holds K and V
// of one head whole in VMEM and walks 128-key tiles with the online softmax:
//     m_new = max(m, rowmax(s)),  p = exp(s - m_new),  alpha = exp(m - m_new),
//     l = l alpha + rowsum(p),    acc = acc alpha + p v,
//     o = acc / max(l, 1e-30),
// m starting at -1e30. Its short regime (N <= 1024, N % 16 == 0, not a
// multiple of 128) is one tile of all N keys. D is padded to 128 in HBM.
//
// Design. K and V of one head at N = 8192, D = 64 are 2 MB, ten times a
// block's shared memory, so blocks stream them in key tiles with the TPU
// kernel's recurrence. The last tile of a ragged N is zero-filled and its
// scores are masked to -inf (so exp gives exactly 0); query rows past N
// compute on zeros and are not stored. D is a template parameter (16 to
// 128 in steps of 16): nothing is padded in memory.
//
// bf16: the shared forward-attention kernel of attention_fwd.cuh with one
// head of stride D (wgmma, TMA, single-pass online softmax; its note says
// what bounds it).
// f32: the 3xTF32 wgmma kernel of attention_f32.cuh (shared with K3's f32
// route) with one head of stride D: each operand x split into hi =
// cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi), each product taken
// as A_lo B_hi, A_hi B_lo, then A_hi B_hi, accumulated in f32 by the tensor
// core: f32-accurate products (whatever torch.backends.cuda.matmul.
// allow_tf32 says), so the f32 tolerance is 2e-5.
//
// What bounds it on this card: operations, 4 N^2 D per head (two products)
// on the bf16 tensor cores (f32: three TF32 products each, at 495 TFLOP/s);
// the bytes (q, k, v read once, o written once) are far below that at
// N = 8192.

#include "attention_f32.cuh"
#include "attention_fwd.cuh"

// Shared memory of one block: f32, attention_f32.cuh's; bf16, the
// forward-attention kernel's.
extern "C" size_t kuzu_flash_attention_smem(int d, int f32) {
  return f32 != 0 ? kuzu::f32attn::smem_bytes(d) : kuzu::fwd::attn_fwd_smem_bytes(d);
}

// q, k, v, o: contiguous (bh, n, d), bf16 (f32 == 0) or f32; d in 16..128,
// a multiple of 16. Returns a cudaError_t (cudaErrorInvalidValue for other d).
extern "C" int kuzu_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int bh, int n, int d, int f32, float scale, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32 == 0)
    return kuzu::attention_fwd<kuzu::fwd::kPlain>(q, d, k, d, v, d, o, nullptr, nullptr, d,
                                                  nullptr, bh, n, 1, d, scale, s);
  return kuzu::attention_f32(q, d, k, d, v, d, o, d, nullptr, bh, n, 1, d, scale, s);
}

// Area attention over head-packed (G, N, C) tensors.
//
// Replaces the TPU kernel kuzu/ops/flash_attention.py::area_attention
// (_area_attn_kernel): per group g and head h,
//     o[g, :, h] = softmax(scale * q[g, :, h] k[g, :, h]^T) v[g, :, h]
// with heads packed along the channels (head h owns columns [h*hd, (h+1)*hd)).
//
// Design: the shared forward-attention kernel of attention_fwd.cuh (wgmma,
// TMA, single-pass online softmax), one block per (128 query rows, head,
// group). On the TPU one grid step holds a whole group with its N x N scores
// in VMEM; here K and V stream through a ring of 64-key tiles and no score
// matrix exists anywhere. q and k may be column slices of a wider tensor
// (the qk conv output), so each input carries its own row stride. The
// training route also asks for each row's log-sum-exp (lse) and o's bf16
// remainder (o_lo), which the backward kernels (area_attention_bwd.cu) read
// in place of recomputing the softmax statistics and D. What bounds it on
// this card at N=400: the bytes (each input read once) and the latency of a
// block's seven tiles; see attention_fwd.cuh.
//
// f32 route (kuzu_area_attention_f32): the TPU kernel takes any dtype and
// computes in f32, writing the output in the input's dtype; the port's f32
// inputs (the TrOCR encoder's self-attention, built in f32) go to the
// 3xTF32 wgmma kernel of attention_f32.cuh, shared with K5's f32 path, with
// K3's head-packed addressing (row stride C, head offset h*hd), one block
// per (128 query rows, head, group). Its products are f32-accurate: each
// operand x split into hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(
// x - hi), each product taken as A_lo B_hi, A_hi B_lo, then A_hi B_hi,
// accumulated in f32 by the tensor core, whatever
// torch.backends.cuda.matmul.allow_tf32 says. Its training route writes
// each row's base-2 log-sum-exp as the bf16 one does (there is no o_lo in
// f32: the output is exact to f32 already).
// What bounds it: operations, 4 G heads N^2 hd as three TF32 products each
// on the tensor cores.

#include "attention_f32.cuh"
#include "attention_fwd.cuh"

// Shared memory of one block (constant in N).
extern "C" size_t kuzu_area_attention_smem(int hd) { return kuzu::fwd::attn_fwd_smem_bytes(hd); }

// lse, o_lo: null, or (g, heads, n) f32 for each row's base-2 log-sum-exp
// and (g, n, c) bf16 for o's remainder (the training route asks for both;
// o_lo selects the mode).
extern "C" int kuzu_area_attention(const void* q, int q_stride, const void* k, int k_stride,
                                   const void* v, int v_stride, void* o, void* o_lo, float* lse,
                                   int g, int n, int c, int heads, float scale, void* stream) {
  using kuzu::fwd::kPlain;
  using kuzu::fwd::kStats;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o_lo != nullptr)
    return kuzu::attention_fwd<kStats>(q, q_stride, k, k_stride, v, v_stride, o, o_lo, nullptr, c,
                                       lse, g, n, heads, c / heads, scale, s);
  return kuzu::attention_fwd<kPlain>(q, q_stride, k, k_stride, v, v_stride, o, nullptr, nullptr,
                                     c, nullptr, g, n, heads, c / heads, scale, s);
}

// The f32 route: q, k, v, o f32 (g, n, c) with the given row strides (in
// floats; 16-byte aligned bases and strides), o = softmax(scale q_h k_h^T) v_h;
// lse null, or (g, heads, n) f32 for each row's base-2 log-sum-exp (the
// training route: the f32 backward of area_attention_bwd.cu reads it).
extern "C" int kuzu_area_attention_f32(const void* q, int q_stride, const void* k,
                                       int k_stride, const void* v, int v_stride, void* o,
                                       int o_stride, float* lse, int g, int n, int c, int heads,
                                       float scale, void* stream) {
  return kuzu::attention_f32(q, q_stride, k, k_stride, v, v_stride, o, o_stride, lse, g, n,
                             heads, c / heads, scale, static_cast<cudaStream_t>(stream));
}

// Shared memory of one block of the f32 route (constant in N).
extern "C" size_t kuzu_area_attention_f32_smem(int hd) { return kuzu::f32attn::smem_bytes(hd); }

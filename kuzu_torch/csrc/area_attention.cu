// Area attention over head-packed (G, N, C) tensors.
//
// Replaces the TPU kernel kuzu/ops/flash_attention.py::area_attention
// (_area_attn_kernel): per group g and head h,
//     o[g, :, h] = softmax(scale * q[g, :, h] k[g, :, h]^T) v[g, :, h]
// with heads packed along the channels (head h owns columns [h*hd, (h+1)*hd)).
//
// Design (attention_kernel in attention.cuh). On the TPU one grid step holds
// a whole group with its N x N scores in VMEM. Here one block of 4 warps
// takes 64 query rows of one (group, head): K_h and V_h (N x hd bf16, 32 KB
// each at N=400, hd=32) go to shared memory once, and each warp keeps the
// scores of its 16 rows in registers, so no score matrix exists anywhere.
// q and k may be column slices of a wider tensor (the qk conv output), so
// each input carries its own row stride.
// What bounds it on this card: at N=400, C=64 the bytes (each input read
// once); the kernel reads K_h / V_h once per 64-row block and computes Q K^T
// twice (the two passes), which stays small next to the launch and the
// latency of the K_h / V_h copy.

#include "attention.cuh"

extern "C" size_t kuzu_area_attention_smem(int n, int hd) { return kuzu::attn_smem_bytes(n, hd); }

extern "C" int kuzu_area_attention(const void* q, int q_stride, const void* k, int k_stride,
                                   const void* v, int v_stride, void* o, int g, int n,
                                   int c, int heads, float scale, void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int hd = c / heads;
  const size_t smem = kuzu::attn_smem_bytes(n, hd);
  cudaError_t err = cudaFuncSetAttribute(
      kuzu::attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kuzu::kAttnRows - 1) / kuzu::kAttnRows, heads, g);
  kuzu::attention_kernel<<<grid, 32 * kuzu::kAttnWarps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const kuzu::bf16*>(q), q_stride, static_cast<const kuzu::bf16*>(k),
      k_stride, static_cast<const kuzu::bf16*>(v), v_stride, static_cast<kuzu::bf16*>(o), c,
      n, hd, scale);
  return (int)cudaGetLastError();
}

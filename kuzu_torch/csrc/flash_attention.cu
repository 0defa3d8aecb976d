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
// f32: the same recurrence on the CUDA cores, register-tiled (4 x 4 scores
// and 4 x D/16 outputs per thread from 16-byte shared loads, K/V through a
// two-stage cp.async ring), the products in f32 FMAs with no TF32: the f32
// tolerance is 2e-5.
//
// What bounds it on this card: operations, 4 N^2 D per head (two products)
// on the bf16 tensor cores (f32: the 67 TFLOP/s of the CUDA cores); the
// bytes (q, k, v read once, o written once) are far below that at N = 8192.

#include <math.h>

#include "attention_fwd.cuh"

namespace {

using kuzu::cp_async16_zfill;

constexpr int kRows = 64;       // f32 kernel: query rows per block
constexpr int kKeys = 64;       // keys per tile
constexpr int kThreadsF = 256;  // f32 kernel: 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;

// f32 row stride in shared memory: D + 4 floats keeps rows 16-byte aligned
// and puts the 8 rows of a quarter-warp's 16-byte loads in different banks.
__host__ __device__ inline int ld_f(int d) { return d + 4; }

// f32: the scaled Q tile, two cp.async stages of a K and a V tile, the
// 64 x 64 tile of P. bf16: the forward-attention kernel's.
__host__ __device__ inline size_t flash_smem_bytes(int d, bool f32) {
  if (f32) return ((size_t)5 * kRows * ld_f(d) + (size_t)kRows * ld_f(kKeys)) * 4;
  return kuzu::fwd::attn_fwd_smem_bytes(d);
}

// K and V rows [j0, j0 + kKeys) of one head into a stage, 16 bytes per copy;
// rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv_f32(float* ks, float* vs, const float* __restrict__ k,
                                            const float* __restrict__ v, int j0, int n) {
  constexpr int kPer = D / 4, LD = D + 4;
  for (int i = threadIdx.x; i < kKeys * kPer; i += kThreadsF) {
    const int r = i / kPer, c = (i - r * kPer) * 4;
    const bool ok = j0 + r < n;
    const size_t src = (size_t)(ok ? j0 + r : 0) * D + c;
    cp_async16_zfill(ks + r * LD + c, k + src, ok);
    cp_async16_zfill(vs + r * LD + c, v + src, ok);
  }
  kuzu::cp_async_commit();
}

// Grid (ceil(n / 64), BH), 256 threads, flash_smem_bytes(D, true) bytes.
// Register tiles on the CUDA cores, f32 FMAs only (no TF32): thread (ty, tx)
// of a 16 x 16 layout owns query rows ty + 16 i (i < 4) and, of each 64-key
// tile, keys tx + 16 j (j < 4): a 4 x 4 tile of S, built from 16-byte loads
// of Q and K rows along D (8 loads per 64 FMAs); then output columns
// [tx * D / 16, + D / 16) of the same rows, P V read as 16-byte loads of P
// rows and V rows. A row's 64 keys lie in the 16 lanes of one half-warp, so
// row maxima and sums are shuffles, and P passes through shared memory
// within that half-warp only. K and V tiles stream through two cp.async stages.
template <int D>
__global__ void __launch_bounds__(kThreadsF)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 4, LP = kKeys + 4, CPT = D / 16;
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = qs + kRows * LD;            // stage s: K at kv + 2 s kKeys LD, V after it
  float* ps = kv + 4 * kKeys * LD;        // kRows x LP
  const size_t base = (size_t)blockIdx.y * n * D;
  q += base;
  k += base;
  v += base;
  o += base;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (n + kKeys - 1) / kKeys;

  load_kv_f32<D>(kv, kv + kKeys * LD, k, v, 0, n);
  for (int i = threadIdx.x; i < kRows * D / 4; i += kThreadsF) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < n) x = *reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * D + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * LD + c) = x;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      float* nx = kv + 2 * (st ^ 1) * kKeys * LD;
      load_kv_f32<D>(nx, nx + kKeys * LD, k, v, (it + 1) * kKeys, n);
      kuzu::cp_async_wait<1>();
    } else {
      kuzu::cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, the first time, Q) is in place
    const float* ks = kv + 2 * st * kKeys * LD;
    const float* vs = ks + kKeys * LD;
    const int j0 = it * kKeys;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + tx + 16 * j >= n) s[i][j] = -INFINITY;  // keys past n
        tm = fmaxf(tm, s[i][j]);
      }
#pragma unroll
      for (int x = 1; x <= 8; x <<= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, x));
      const float mn = fmaxf(m[i], tm), al = expf(m[i] - mn);
      m[i] = mn;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * al + psum;  // this thread's part; rows sum over tx at the end
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= al;
    }
    __syncwarp();  // a row's P is written and read by its own half-warp

#pragma unroll 4
    for (int j = 0; j < kKeys; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
        const float* vrow = vs + (j + jj) * LD + tx * CPT;
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CPT; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = x.x, vv[c + 1] = x.y, vv[c + 2] = x.z, vv[c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pij, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // this stage and P are refilled next
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int x = 1; x <= 8; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    const int r = q0 + ty + 16 * i;
    if (r < n) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[(size_t)r * D + tx * CPT + c] = acc[i][c] / den;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int n, float scale,
               cudaStream_t s) {
  const size_t smem = flash_smem_bytes(D, true);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + kRows - 1) / kRows, bh);
  flash_f32_kernel<D><<<grid, kThreadsF, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), n, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t kuzu_flash_attention_smem(int d, int f32) { return flash_smem_bytes(d, f32 != 0); }

// q, k, v, o: contiguous (bh, n, d), bf16 (f32 == 0) or f32; d in 16..128,
// a multiple of 16. Returns a cudaError_t (cudaErrorInvalidValue for other d).
extern "C" int kuzu_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int bh, int n, int d, int f32, float scale, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32 == 0)
    return kuzu::attention_fwd<kuzu::fwd::kPlain>(q, d, k, d, v, d, o, nullptr, nullptr, d,
                                                  nullptr, bh, n, 1, d, scale, s);
  switch (d) {
    case 16: return launch_f32<16>(q, k, v, o, bh, n, scale, s);
    case 32: return launch_f32<32>(q, k, v, o, bh, n, scale, s);
    case 48: return launch_f32<48>(q, k, v, o, bh, n, scale, s);
    case 64: return launch_f32<64>(q, k, v, o, bh, n, scale, s);
    case 80: return launch_f32<80>(q, k, v, o, bh, n, scale, s);
    case 96: return launch_f32<96>(q, k, v, o, bh, n, scale, s);
    case 112: return launch_f32<112>(q, k, v, o, bh, n, scale, s);
    case 128: return launch_f32<128>(q, k, v, o, bh, n, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

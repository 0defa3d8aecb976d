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
// block's shared memory, so blocks stream them: one block per (64 query
// rows, head), 4 warps of 16 query rows each, looping over 64-key tiles of K
// and V that a two-stage cp.async pipeline brings into shared memory while
// the tensor cores work on the previous tile. The recurrence is the TPU
// kernel's, per tile of 64 keys. The last tile of a ragged N is zero-filled
// and its scores are masked to -inf (so exp gives exactly 0); query rows past
// N compute on zeros and are not stored. D is a template parameter (16 to
// 128 in steps of 16): nothing is padded in memory.
//
// bf16: S = Q K^T on the tensor cores (mma.sync m16n8k16, bf16 products
// exact in f32), the scale applied to the f32 product, the softmax in f32 in
// registers (FlashAttention-2's layout: a thread holds two query rows' scores
// for its columns, row maxima and sums through shuffles), and P entering P V
// as two bf16 parts (hi + lo, about 16 significant bits), so the result stays
// within one bf16 rounding of the f32 reference. Fragments come from shared
// memory through ldmatrix (transposed for V).
// f32: the same recurrence on the CUDA cores (4 threads per query row), the
// products in f32 FMAs; a first version, not tuned.
//
// What bounds it on this card: operations, 4 N^2 D per head (two products)
// on the bf16 tensor cores; the bytes (q, k, v read once, o written once)
// are far below that at N = 8192.

#include <math.h>

#include "attention.cuh"

namespace {

using kuzu::bf16;
using kuzu::cp_async16_zfill;
using kuzu::ldsm_x4;
using kuzu::ldsm_x4_trans;

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kWarps = 4;      // bf16 kernel: 16 query rows per warp
constexpr int kThreadsF = 256; // f32 kernel: 4 threads per query row
constexpr float kNegInf = -1e30f;

__host__ __device__ inline int ld_bf(int d) { return d + 8; }  // bf16 row stride
__host__ __device__ inline int ld_f(int d) { return d + 1; }   // f32 row stride

__host__ __device__ inline size_t flash_smem_bytes(int d, bool f32) {
  if (f32) return ((size_t)3 * kRows * ld_f(d) + (size_t)kRows * (kKeys + 1)) * 4;
  return (size_t)2 * 2 * kKeys * ld_bf(d) * 2;  // 2 stages x (K, V)
}

// K and V rows [j0, j0 + kKeys) of one head into a stage; rows past n are 0.
template <int D>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v, int j0, int n) {
  constexpr int kPer = D / 8;
  for (int i = threadIdx.x; i < kKeys * kPer; i += 32 * kWarps) {
    const int r = i / kPer, c = (i - r * kPer) * 8;
    const bool ok = j0 + r < n;
    const size_t src = (size_t)(ok ? j0 + r : 0) * D + c;
    cp_async16_zfill(ks + r * ld_bf(D) + c, k + src, ok);
    cp_async16_zfill(vs + r * ld_bf(D) + c, v + src, ok);
  }
  kuzu::cp_async_commit();
}

// Grid (ceil(n / 64), BH), 128 threads, flash_smem_bytes(D, false) bytes.
template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 8, KT = D / 16, DT = D / 8;
  constexpr int kTile = kKeys * LD;  // elements of one K or V tile
  const size_t base = (size_t)blockIdx.y * n * D;
  q += base;
  k += base;
  v += base;
  o += base;
  bf16* sm = reinterpret_cast<bf16*>(smem);  // stage s: K at 2s, V at 2s + 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16;
  const int ntiles = (n + kKeys - 1) / kKeys;

  load_kv<D>(sm, sm + kTile, k, v, 0, n);

  // this warp's 16 query rows as A fragments (rows past n are zero)
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = kk * 16 + 2 * t + 8 * (e >> 1);
      qa[kk][e] = r < n ? *reinterpret_cast<const uint32_t*>(q + (size_t)r * D + c) : 0u;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;  // running maxima of rows g and g + 8
  float l0 = 0.0f, l1 = 0.0f;        // this thread's part of the running sums
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      bf16* nx = sm + (size_t)(2 * (st ^ 1)) * kTile;
      load_kv<D>(nx, nx + kTile, k, v, (it + 1) * kKeys, n);
      kuzu::cp_async_wait<1>();
    } else {
      kuzu::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = sm + (size_t)(2 * st) * kTile;
    const bf16* vs = ks + kTile;
    const int j0 = it * kKeys;

    // S = Q K^T for the 64 keys: tile jt holds rows g, g + 8 x keys 8 jt + 2t, +1
    float s[kKeys / 8][4];
#pragma unroll
    for (int jt = 0; jt < kKeys / 8; ++jt) s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.0f;
#pragma unroll
    for (int jp = 0; jp < kKeys / 16; ++jp) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, ks + (jp * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        kuzu::mma16816(s[2 * jp], qa[kk], b[0], b[1]);
        kuzu::mma16816(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }
    // scale, mask keys past n, tile maxima
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int jt = 0; jt < kKeys / 8; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + jt * 8 + 2 * t + (e & 1);
        s[jt][e] = key < n ? __fmul_rn(s[jt][e], scale) : -INFINITY;
      }
      tm0 = fmaxf(tm0, fmaxf(s[jt][0], s[jt][1]));
      tm1 = fmaxf(tm1, fmaxf(s[jt][2], s[jt][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, x));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, x));
    }
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int jt = 0; jt < kKeys / 8; ++jt) {
      s[jt][0] = expf(s[jt][0] - mn0);
      s[jt][1] = expf(s[jt][1] - mn0);
      s[jt][2] = expf(s[jt][2] - mn1);
      s[jt][3] = expf(s[jt][3] - mn1);
      ps0 += s[jt][0] + s[jt][1];
      ps1 += s[jt][2] + s[jt][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }
    // acc += P V over 16-key blocks; two score tiles form P's A fragment
#pragma unroll
    for (int jb = 0; jb < kKeys / 16; ++jb) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = s[2 * jb + (e >> 1)][2 * (e & 1)];
        const float x1 = s[2 * jb + (e >> 1)][2 * (e & 1) + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        ahi[e] = *reinterpret_cast<const uint32_t*>(&hi);
        alo[e] = kuzu::pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (jb * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8);
        kuzu::mma16816(acc[2 * dp], ahi, b[0], b[1]);
        kuzu::mma16816(acc[2 * dp], alo, b[0], b[1]);
        kuzu::mma16816(acc[2 * dp + 1], ahi, b[2], b[3]);
        kuzu::mma16816(acc[2 * dp + 1], alo, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled on the next iteration
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 + g < n)
      *reinterpret_cast<uint32_t*>(o + (size_t)(r0 + g) * D + c) =
          kuzu::pack_bf16(__fdiv_rn(acc[dt][0], den0), __fdiv_rn(acc[dt][1], den0));
    if (r0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(o + (size_t)(r0 + g + 8) * D + c) =
          kuzu::pack_bf16(__fdiv_rn(acc[dt][2], den1), __fdiv_rn(acc[dt][3], den1));
  }
}

// Grid (ceil(n / 64), BH), 256 threads, flash_smem_bytes(D, true) bytes.
// Thread (row, u), u = 0..3, scores keys u, u + 4, ... of each tile and owns
// output columns u, u + 4, ...; a row's four threads are neighbouring lanes.
template <int D>
__global__ void __launch_bounds__(kThreadsF)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 1, KPT = kKeys / 4, CPT = D / 4;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kRows * LD;
  float* vs = ks + kKeys * LD;
  float* ps = vs + kKeys * LD;  // kRows x (kKeys + 1)
  const size_t base = (size_t)blockIdx.y * n * D;
  q += base;
  k += base;
  v += base;
  o += base;
  const int row = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int q0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * D; i += kThreadsF) {
    const int r = i / D, c = i - r * D;
    qs[r * LD + c] = q0 + r < n ? q[(size_t)(q0 + r) * D + c] * scale : 0.0f;
  }
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.0f;
  float m = kNegInf, l = 0.0f;
  const float* qrow = qs + row * LD;
  float* prow = ps + row * (kKeys + 1);

  for (int j0 = 0; j0 < n; j0 += kKeys) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kKeys * D; i += kThreadsF) {
      const int r = i / D, c = i - r * D;
      const bool ok = j0 + r < n;
      ks[r * LD + c] = ok ? k[(size_t)(j0 + r) * D + c] : 0.0f;
      vs[r * LD + c] = ok ? v[(size_t)(j0 + r) * D + c] : 0.0f;
    }
    __syncthreads();
    float s[KPT];
    float tm = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = u + 4 * i;
      const float* krow = ks + j * LD;
      float dot = 0.0f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], krow[c], dot);
      s[i] = j0 + j < n ? dot : -INFINITY;
      tm = fmaxf(tm, s[i]);
    }
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
    const float mn = fmaxf(m, tm), al = expf(m - mn);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - mn);
      prow[u + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * al + psum;
    m = mn;
    __syncwarp();  // the row's P is written by its own four lanes
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = u + 4 * i;
      float pv = 0.0f;
#pragma unroll 16
      for (int j = 0; j < kKeys; ++j) pv = fmaf(prow[j], vs[j * LD + c], pv);
      acc[i] = acc[i] * al + pv;
    }
  }
  if (q0 + row < n) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < CPT; ++i) o[(size_t)(q0 + row) * D + u + 4 * i] = acc[i] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n, bool f32,
           float scale, cudaStream_t s) {
  const size_t smem = flash_smem_bytes(D, f32);
  const dim3 grid((n + kRows - 1) / kRows, bh);
  cudaError_t err;
  if (f32) {
    err = cudaFuncSetAttribute(flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<D><<<grid, kThreadsF, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), n, scale);
  } else {
    err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<D><<<grid, 32 * kWarps, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), n, scale);
  }
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
  const bool f = f32 != 0;
  switch (d) {
    case 16: return launch<16>(q, k, v, o, bh, n, f, scale, s);
    case 32: return launch<32>(q, k, v, o, bh, n, f, scale, s);
    case 48: return launch<48>(q, k, v, o, bh, n, f, scale, s);
    case 64: return launch<64>(q, k, v, o, bh, n, f, scale, s);
    case 80: return launch<80>(q, k, v, o, bh, n, f, scale, s);
    case 96: return launch<96>(q, k, v, o, bh, n, f, scale, s);
    case 112: return launch<112>(q, k, v, o, bh, n, f, scale, s);
    case 128: return launch<128>(q, k, v, o, bh, n, f, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// is cut into its 16 convolutions, one launch each, all of one kernel: an
// implicit GEMM (pixels x output channels, reduced over input channels and,
// for a 3x3 conv, its nine taps) on the tensor cores with a three-stage
// cp.async pipeline and the bias, SiLU and residual in the epilogue. The
// intermediates pass through global memory in buffers laid out so that no
// concatenation is ever copied:
//     z  (B, H, W, 4c):   [a | b | m0 | m1], cv1 writes a and b, C3k j reads
//                         its input from z and writes m_j into z, the final
//                         cv2 reads all of z;
//     u  (B, H, W, 2hid): [bottleneck stream | bypass], what cv3 reads; the
//                         bottleneck's second conv adds its residual in place
//                         (each output element reads and writes its own
//                         position only);
//     v1 (B, H, W, hid):  the bottleneck's middle activation.
// SAME borders: a 3x3 tap that falls outside the image is a zero-filled
// copy, so every conv reads true zeros there, which is what the TPU kernel's
// masks give (no conv ever sees silu(bias) of a pixel outside the image).
// What bounds it on this card: operations (2 K N per pixel and conv, about
// 0.16 TFLOP at node 2, batch 8) against the bytes of x and the output; the
// intermediates' round trips (about 30 passes of (B, H, W, <=4c) bf16) are the
// price of the split.

#include "attention.cuh"

namespace {

using kuzu::bf16;
using kuzu::cp_async16_zfill;
using kuzu::ldsm_x4;
using kuzu::ldsm_x4_trans;

constexpr int kBM = 64, kBN = 64, kBK = 32, kStages = 3, kThreads = 128;
constexpr int kLdA = kBK + 8;  // bf16 row stride of a pixel tile (80 bytes)
constexpr int kLdB = kBN + 8;  // bf16 row stride of a weight tile (144 bytes)
constexpr int kStageElems = kBM * kLdA + kBK * kLdB;
constexpr int kConvs = 16;

__host__ __device__ inline size_t conv_smem_bytes() { return (size_t)kStages * kStageElems * 2; }
// The same for every shape; launched without the opt-in above 48 KB.
static_assert(kStages * kStageElems * 2 <= 48 * 1024, "conv block's shared memory");

// One conv: out[p, :n] = silu(sum_k A[p, k] w[k, :] + bias) (+ res[p, :n]),
// for pixels p of a (B, H, W) grid. Pixel p's input channels are at
// in + p * in_cs (cin of them; a channel slice of a wider buffer), its output
// at out + p * out_cs, its residual at res + p * res_cs.
struct Conv {
  const bf16* in;
  int in_cs, cin;
  const bf16* w;  // (taps * cin, n) row-major, tap = dy * 3 + dx
  const float* bias;
  int n;
  bf16* out;
  int out_cs;
  const bf16* res;  // null: no residual; may equal out
  int res_cs;
};

// Grid (ceil(m / 64), ceil(n / 64)), 128 threads (2 x 2 warps of 32 x 32
// outputs), conv_smem_bytes(). K = taps * cin is walked in steps of 32; a
// 16-byte piece of 8 channels never straddles a tap (cin % 8 == 0).
template <int kTaps>
__global__ void __launch_bounds__(kThreads) conv_kernel(Conv a, int m, int h, int wd) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kdim = kTaps * a.cin;
  const int ktiles = (kdim + kBK - 1) / kBK;

  // the two pixel rows and the piece this thread copies, and their coordinates
  const int apiece = tid & 3;
  int ap[2], ay[2], ax[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ap[i] = m0 + (tid >> 2) + 32 * i;
    const int yx = ap[i] % (h * wd);
    ay[i] = yx / wd;
    ax[i] = yx - ay[i] * wd;
  }

  auto load = [&](int kt, int slot) {
    bf16* as = sm + (size_t)slot * kStageElems;
    bf16* bs = as + kBM * kLdA;
    const int k = kt * kBK + apiece * 8;
    int tap = 0, ci = k;
    if (kTaps > 1) {
      tap = k / a.cin;
      ci = k - tap * a.cin;
    }
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool ok = ap[i] < m && k < kdim;
      long off = 0;
      if (kTaps > 1) {
        const int sy = ay[i] + dy, sx = ax[i] + dx;
        ok = ok && sy >= 0 && sy < h && sx >= 0 && sx < wd;
        off = (long)dy * wd + dx;
      }
      const bf16* src = ok ? a.in + (size_t)(ap[i] + off) * a.in_cs + ci : a.in;
      cp_async16_zfill(as + ((tid >> 2) + 32 * i) * kLdA + apiece * 8, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx >> 3, col = n0 + (idx & 7) * 8, kr = kt * kBK + r;
      const bool ok = kr < kdim && col < a.n;
      const bf16* src = ok ? a.w + (size_t)kr * a.n + col : a.w;
      cp_async16_zfill(bs + r * kLdB + (idx & 7) * 8, src, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    kuzu::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    kuzu::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in; the slot of tile kt - 1 is free
    if (kt + kStages - 1 < ktiles) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    kuzu::cp_async_commit();
    const bf16* as = sm + (size_t)(kt % kStages) * kStageElems;
    const bf16* bs = as + kBM * kLdA;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], as + (wm * 32 + i * 16 + (lane & 15)) * kLdA + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_trans(bfr[j], bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdB +
                                  wn * 32 + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kuzu::mma16816(acc[i][j], af[i], bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
    }
  }
  kuzu::cp_async_wait<0>();

  // epilogue: bias, SiLU, bf16, the residual's bf16 add
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      if (col >= a.n) continue;
      const float b0 = a.bias[col], b1 = a.bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + wm * 32 + i * 16 + g + 8 * half;
        if (p >= m) continue;
        float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
        v0 = v0 * (1.0f / (1.0f + expf(-v0)));
        v1 = v1 * (1.0f / (1.0f + expf(-v1)));
        __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
        if (a.res != nullptr) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(a.res + (size_t)p * a.res_cs + col);
          y = __floats2bfloat162_rn(__low2float(r) + __low2float(y),
                                    __high2float(r) + __high2float(y));
        }
        *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)p * a.out_cs + col) = y;
      }
    }
  }
}

template <int kTaps>
int run(const Conv& c, int m, int h, int wd, cudaStream_t s) {
  const size_t smem = conv_smem_bytes();
  const dim3 grid((m + kBM - 1) / kBM, (c.n + kBN - 1) / kBN);
  conv_kernel<kTaps><<<grid, kThreads, smem, s>>>(c, m, h, wd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t kuzu_fused_c3k2_smem() { return conv_smem_bytes(); }

// x (b, h, w, cin) bf16; weights: 32 device pointers, the (W bf16, b f32)
// pairs of c3k2_weights in its order; z (b, h, w, 4c), u (b, h, w, 2 hid),
// v1 (b, h, w, hid) scratch; out (b, h, w, c2). All contiguous; every width a
// multiple of 8. Returns a cudaError_t.
extern "C" int kuzu_fused_c3k2(const void* x, const void* const* weights, void* z, void* u,
                               void* v1, void* out, int b, int h, int w, int cin, int c,
                               int hid, int c2, void* stream) {
  const int m = b * h * w;
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto wt = [&](int i) { return static_cast<const bf16*>(weights[2 * i]); };
  auto bs = [&](int i) { return static_cast<const float*>(weights[2 * i + 1]); };
  bf16* zp = static_cast<bf16*>(z);
  bf16* up = static_cast<bf16*>(u);
  bf16* vp = static_cast<bf16*>(v1);
  const int zc = 4 * c, uc = 2 * hid;
  int err;
  // cv1: x -> z[:, :2c]  (a, b)
  if ((err = run<1>({static_cast<const bf16*>(x), cin, cin, wt(0), bs(0), 2 * c, zp, zc,
                     nullptr, 0}, m, h, w, s)))
    return err;
  for (int j = 0; j < 2; ++j) {
    const int i0 = 1 + 7 * j;
    const bf16* mj = zp + (1 + j) * c;  // b, then m0
    // C3k cv1: m -> u[:, :hid]
    if ((err = run<1>({mj, zc, c, wt(i0), bs(i0), hid, up, uc, nullptr, 0}, m, h, w, s)))
      return err;
    for (int bt = 0; bt < 2; ++bt) {  // bottlenecks: u += conv3x3(conv3x3(u))
      const int i1 = i0 + 1 + 2 * bt;
      if ((err = run<9>({up, uc, hid, wt(i1), bs(i1), hid, vp, hid, nullptr, 0}, m, h, w, s)))
        return err;
      if ((err = run<9>({vp, hid, hid, wt(i1 + 1), bs(i1 + 1), hid, up, uc, up, uc}, m, h, w,
                        s)))
        return err;
    }
    // C3k cv2 (bypass): m -> u[:, hid:]
    if ((err = run<1>({mj, zc, c, wt(i0 + 5), bs(i0 + 5), hid, up + hid, uc, nullptr, 0}, m, h,
                      w, s)))
      return err;
    // C3k cv3: u -> z[:, (2 + j) c : (3 + j) c]
    if ((err = run<1>({up, uc, uc, wt(i0 + 6), bs(i0 + 6), c, zp + (2 + j) * c, zc, nullptr,
                       0}, m, h, w, s)))
      return err;
  }
  // cv2: z -> out
  return run<1>({zp, zc, zc, wt(kConvs - 1), bs(kConvs - 1), c2, static_cast<bf16*>(out), c2,
                 nullptr, 0}, m, h, w, s);
}

// ResNet stem: maxpool3x3/s2/pad1(relu(conv7x7/s2/pad3(x) * scale + bias)),
// 3 -> 64 channels, NHWC in and out.
//
// Replaces rmem_tpu/kernels/stem.py:pallas_stem (through
// pallas_stem_trainable's forward).
//
// What bounds it on an H100: bytes, in principle. At 481 x 849 the kernel
// must read the f32 image (4.9 MB) and write the pooled bf16 map (3.3 MB),
// ~2.4 us at 3.35 TB/s, against 1.9 GFLOP of convolution (~2 us on the
// tensor cores). This first kernel does the convolution on the CUDA cores
// in f32, so its arithmetic, not its traffic, sets its time. Design: the
// TPU kernel assembled patch matrices in VMEM to feed a 128-wide MXU with a
// Cin = 3 contraction. Here a block owns an 8 x 8 tile of pooled outputs:
// it stages the 39 x 39 input window (rounded to bf16, as the JAX chain
// casts x) and all 9,408 weights in shared memory, computes the 17 x 17
// conv outputs the tile's pool windows cover (147 MACs each, f32 sums), and
// pools them there, so no conv activation goes to device memory.
// Numerics follow the JAX chain xla_stem_chain: conv result rounded to
// bf16, then the affine and relu in bf16. Conv positions outside the image
// are left out of the max (torch's MaxPool2d padding), not taken as
// relu(bias).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rmem {

using bf16 = __nv_bfloat16;

constexpr int kStemThreads = 256;
constexpr int PT = 8;               // pooled outputs per tile side
constexpr int CT = 2 * PT + 1;      // conv outputs per tile side
constexpr int IT = 2 * CT + 5;      // input pixels per tile side
constexpr int COUT = 64;
constexpr int TAPS = 3 * 7 * 7;
constexpr int XS = (3 * IT * IT + 3) / 4 * 4;  // keeps sW 16-byte aligned
constexpr int kStemSmem = XS * 4 + TAPS * COUT * 4 + CT * CT * COUT * 2;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kStemThreads)
stem_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
            const bf16* __restrict__ scale, const bf16* __restrict__ bias,
            bf16* __restrict__ out, int H, int W, int ho, int wo, int ph,
            int pw) {
  extern __shared__ __align__(16) char smem[];
  float* sX = reinterpret_cast<float*>(smem);             // [3][IT][IT]
  float* sW = sX + XS;                                    // [TAPS][COUT]
  bf16* sC = reinterpret_cast<bf16*>(sW + TAPS * COUT);   // [CT*CT][COUT]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * PT, px0 = blockIdx.x * PT;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;         // first conv row/col
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;         // first input row/col

  for (int i = threadIdx.x; i < 3 * IT * IT; i += kStemThreads) {
    const int c = i % 3, p = i / 3;
    const int iy = iy0 + p / IT, ix = ix0 + p % IT;
    float val = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      val = round_bf16(x[(((size_t)b * H + iy) * W + ix) * 3 + c]);
    sX[c * IT * IT + p] = val;
  }
  for (int i = threadIdx.x; i < TAPS * COUT; i += kStemThreads) {
    const int o = i / TAPS, tap = i % TAPS;   // w is [COUT][3][7][7]
    sW[tap * COUT + o] = __bfloat162float(w[i]);
  }
  __syncthreads();

  // conv: thread -> 16 output channels of every 64th conv position
  const int og = (threadIdx.x & 3) * 16;
  for (int p = threadIdx.x >> 2; p < CT * CT; p += kStemThreads / 4) {
    const int ly = p / CT, lx = p % CT;
    const int cy = cy0 + ly, cx = cx0 + lx;
    bf16* dst = sC + p * COUT + og;
    if (cy < 0 || cy >= ho || cx < 0 || cx >= wo) {
      // outside the conv grid: below every relu output, never the max
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = __float2bfloat16_rn(-1.f);
      continue;
    }
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    for (int c = 0; c < 3; ++c) {
      for (int dy = 0; dy < 7; ++dy) {
        const float* xrow = sX + c * IT * IT + (2 * ly + dy) * IT + 2 * lx;
        const float* wrow = sW + ((c * 7 + dy) * 7) * COUT + og;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const float xv = xrow[dx];
          const float4* w4 = reinterpret_cast<const float4*>(wrow + dx * COUT);
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            const float4 ww = w4[j4];
            acc[4 * j4 + 0] += xv * ww.x;
            acc[4 * j4 + 1] += xv * ww.y;
            acc[4 * j4 + 2] += xv * ww.z;
            acc[4 * j4 + 3] += xv * ww.w;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int o = og + j;
      float y = round_bf16(acc[j]);
      y = round_bf16(y * __bfloat162float(scale[o]));
      y = round_bf16(y + __bfloat162float(bias[o]));
      dst[j] = __float2bfloat16_rn(fmaxf(y, 0.f));
    }
  }
  __syncthreads();

  // pool: thread -> channel o of every 4th pooled position
  const int o = threadIdx.x & (COUT - 1);
  for (int p = threadIdx.x >> 6; p < PT * PT; p += kStemThreads / COUT) {
    const int ly = p / PT, lx = p % PT;
    const int py = py0 + ly, px = px0 + lx;
    if (py >= ph || px >= pw) continue;
    float mx = -1.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        mx = fmaxf(mx, __bfloat162float(
                           sC[((2 * ly + dy) * CT + 2 * lx + dx) * COUT + o]));
    out[(((size_t)b * ph + py) * pw + px) * COUT + o] = __float2bfloat16_rn(mx);
  }
}

}  // namespace rmem

// x [B, H, W, 3] f32; w [64, 3, 7, 7] bf16; scale, bias [64] bf16;
// out [B, ph, pw, 64] bf16. Returns the cudaError_t of the launch.
extern "C" int rmem_stem(const void* x, const void* w, const void* scale,
                         const void* bias, void* out, int B, int H, int W,
                         void* stream) {
  const int ho = (H - 1) / 2 + 1, wo = (W - 1) / 2 + 1;
  const int ph = (ho - 1) / 2 + 1, pw = (wo - 1) / 2 + 1;
  cudaError_t err = cudaFuncSetAttribute(
      rmem::stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rmem::kStemSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((pw + rmem::PT - 1) / rmem::PT, (ph + rmem::PT - 1) / rmem::PT, B);
  rmem::stem_kernel<<<grid, rmem::kStemThreads, rmem::kStemSmem,
                      (cudaStream_t)stream>>>(
      (const float*)x, (const rmem::bf16*)w, (const rmem::bf16*)scale,
      (const rmem::bf16*)bias, (rmem::bf16*)out, H, W, ho, wo, ph, pw);
  return (int)cudaGetLastError();
}

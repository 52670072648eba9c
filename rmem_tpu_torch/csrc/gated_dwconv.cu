// Gated depthwise 5x5 convolution for inference: out = dwconv5x5(x * gate),
// zero-padded, on the [B, H*W, C] sequence layout of the GPM's gated tails
// (channels last, so no NCHW round trip). The 1x1 projection after it stays
// a cuBLAS matmul.
//
// Replaces rmem_tpu/kernels/dwconv.py:pallas_gated_dwconv (_kernel), and
// keeps its arithmetic: the product x * gate is rounded to bf16, each tap's
// product with its weight is rounded to bf16, the 25 taps are summed in f32
// in the order dy, then dx, and the sum is rounded to bf16. The plain
// version (kernels/dwconv.py:gated_dwconv_plain) does the same in the same
// order, so the two should agree bit for bit (chip_smoke.py allows one bf16
// ulp).
//
// What bounds it on an H100: bytes. At the main path's shape
// ([1, 31*54, 1024] bf16) it reads x and gate and writes out, 3 * 1674 *
// 1024 * 2 B = 10.3 MB, ~3.1 us at 3.35 TB/s, against 2 * 25 * 1.7e6 ~ 86
// MFLOP on the CUDA cores (~1 us at the non-tensor-core rate). The TPU
// kernel forms the product and the 25 shifted multiply-adds in VMEM so that
// the map is read once; here that is shared memory.
//
// Design. A block owns R = 2 output rows of one image and a slice of CB = 64
// channels. It loads the R + 4 rows it needs (a 2-pixel halo on each side,
// zeros outside the image) of x and gate with 16-byte vector loads along C
// (8 threads cover one pixel's 64 channels, 128 contiguous bytes), forms the
// gated product once and stores it in shared memory, (R + 4) x (W + 4) x 64
// bf16: 44.5 KB at W = 54, 56.8 KB at W = 70 (the 1.3x scale's grid). Each
// thread then owns one channel pair, keeps its 25 weight pairs in
// registers, and computes its outputs from 25 shared-memory taps read as
// bf16x2; the 32 threads of a warp read one pixel's 64 channels, 128
// consecutive bytes, with no bank conflict. Grid: ceil(H / R) x C / 64 x B.
// At the main path that is 16 x 16 = 256 blocks; a block needs 44.5 KB and
// 256 threads, so all 256 are resident at once on the 132 SMs (two on most
// SMs), where 4-row blocks would give 128 blocks, one wave that leaves 4 SMs
// idle and overlaps no block's loads with another's arithmetic. The halo
// makes each block read 3x the rows it writes; the neighbours' reads of the
// same rows come from the 50 MB L2, not from device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmem_dw {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
constexpr int R = 2;                      // output rows per block
constexpr int CB = 64;                    // channels per block
constexpr int kThreads = 256;
constexpr int PAIRS = CB / 2;             // threads across a pixel's channels
constexpr int LANES = kThreads / PAIRS;   // pixels in flight per block
constexpr int VEC = CB / 8;               // 16-byte vectors per pixel
constexpr int kMaxSmem = 232448;

__global__ void __launch_bounds__(kThreads)
gated_dwconv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gate,
                    const bf16* __restrict__ w, bf16* __restrict__ out, int H,
                    int W, int C) {
  extern __shared__ __align__(16) char smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem);   // [R + 4][W + 4][CB]
  const int WP = W + 4;
  const int y0 = blockIdx.x * R;
  const int c0 = blockIdx.y * CB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // ---- the gated product of rows y0-2 .. y0+R+1, zero outside the image --
  const int n = (R + 4) * WP * VEC;
  for (int i = tid; i < n; i += kThreads) {
    const int vv = i % VEC, p = i / VEC;
    const int yy = y0 + p / WP - 2, xx = p % WP - 2;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const size_t off = (((size_t)b * H + yy) * W + xx) * C + c0 + vv * 8;
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + off));
      const uint4 g = __ldg(reinterpret_cast<const uint4*>(gate + off));
      const bf162* a2 = reinterpret_cast<const bf162*>(&a);
      const bf162* g2 = reinterpret_cast<const bf162*>(&g);
      bf162* r2 = reinterpret_cast<bf162*>(&r);
#pragma unroll
      for (int e = 0; e < 4; ++e) r2[e] = __hmul2(a2[e], g2[e]);
    }
    *reinterpret_cast<uint4*>(tile + (size_t)p * CB + vv * 8) = r;
  }

  // ---- this thread's channel pair: its 25 weight pairs in registers ----
  const int cp = tid % PAIRS, lane = tid / PAIRS;
  const int c = c0 + 2 * cp;
  bf162 wr[25];
#pragma unroll
  for (int k = 0; k < 25; ++k)
    wr[k] = __halves2bfloat162(w[(size_t)c * 25 + k],
                               w[(size_t)(c + 1) * 25 + k]);
  __syncthreads();

  const int rows = H - y0 < R ? H - y0 : R;
  for (int p = lane; p < rows * W; p += LANES) {
    const int oy = p / W, ox = p % W;
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const bf162 xv = *reinterpret_cast<const bf162*>(
            tile + ((size_t)(oy + dy) * WP + ox + dx) * CB + 2 * cp);
        const float2 f = __bfloat1622float2(__hmul2(xv, wr[dy * 5 + dx]));
        ax += f.x;
        ay += f.y;
      }
    }
    *reinterpret_cast<bf162*>(out + (((size_t)b * H + y0 + oy) * W + ox) * C +
                              c) = __floats2bfloat162_rn(ax, ay);
  }
}

}  // namespace rmem_dw

// x, gate, out [B, H*W, C] bf16, 16-byte aligned; w [C, 25] bf16 (the
// [C, 1, 5, 5] depthwise weight). Returns the cudaError_t of the launch (0
// on success); -1 when C is not a multiple of 64 or the row does not fit in
// shared memory.
extern "C" int rmem_gated_dwconv(const void* x, const void* gate,
                                 const void* w, void* out, int B, int H,
                                 int W, int C, void* stream) {
  using namespace rmem_dw;
  if (C % CB != 0 || B < 1 || H < 1 || W < 1) return -1;
  const size_t smem = (size_t)(R + 4) * (W + 4) * CB * sizeof(bf16);
  if (smem > (size_t)kMaxSmem) return -1;
  // once per process, before any launch (so also outside a graph capture)
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gated_dwconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((H + R - 1) / R, C / CB, B);
  gated_dwconv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)gate, (const bf16*)w, (bf16*)out, H, W, C);
  return (int)cudaGetLastError();
}

// ResNet stem: maxpool3x3/s2/pad1(relu(bf16(bf16(conv7x7/s2/pad3(bf16(x)))
// * scale) + bias)), 3 -> 64 channels, NHWC in and out. One kernel template,
// instantiated twice:
//   - K6, serving: the pooled map only. Replaces
//     rmem_tpu/kernels/stem.py:pallas_stem;
//   - K7's forward, training: the pooled map, the bf16 conv map before the
//     affine, [B, ho, wo, 64], and each pooled value's argmax in the conv
//     grid (int64, the index torch's max pool returns), which the backward
//     (kernels/stem.py:stem_bwd) reads instead of recomputing the conv and
//     the pool. Replaces the forward of pallas_stem_trainable.
//
// What bounds it on an H100: bytes. At 481 x 849 the kernel must read the
// f32 image (4.9 MB) and write the pooled bf16 map (3.3 MB), 2.4 us at
// 3.35 TB/s, against 1.9 GFLOP of convolution, 2.0 us at the tensor cores'
// bf16 rate; training's conv map and argmax (417 + 420 MB at 60 frames of
// 465 x 465) make the bytes dominate there too. At N = 64 and K = 160 the
// product is small beside the loads, so mma.sync is enough; wgmma would
// not move the bound.
//
// Design. The TPU kernel assembled a patch matrix in VMEM so that one MXU
// contraction took K = 147 taps instead of Cin = 3. Here the conv is an
// implicit GEMM on the tensor cores: M is a tile's conv positions, N the 64
// output channels, K the 147 taps in the order (dy, dx, c), each 21-tap row
// padded to 22 and the whole to 160 (13 pad taps, zero weights), so 10
// k-steps of mma.sync m16n8k16 (bf16 in, f32 sums). A block owns PH x PW
// pooled outputs, the (2 PH + 1) x (2 PW + 1) conv positions their windows
// cover, and the input window under those:
//   - the window is read once from HBM as f32 in aligned 16-byte loads,
//     rounded to bf16 (as the chain rounds x) into shared memory, pixels
//     interleaved ([row][col][c]) with each row padded to an even length.
//     A tap pair (k, k + 1) then is one aligned 32-bit word at a fixed
//     offset from a position's base, so an A fragment is four 32-bit
//     shared-memory reads gathered through the per-tap offsets;
//   - the weights are staged once per block as [64 x 160] bf16 (rows padded
//     for conflict-free ldmatrix), the B fragments;
//   - the conv sums are rounded to bf16 into a [position x 64] map in shared
//     memory. The pool then reads each window's 9 positions 8 channels at a
//     time and runs the affine, relu and max in bf16x2 (one rounding each,
//     as the chain's f32-then-round; the _rn forms keep the compiler from
//     contracting the multiply and add into one rounding), writing 8
//     channels as one 16-byte
//     store. Conv positions outside the conv grid never win the max: one
//     computed from zero padding holds relu(bias) and more, not 0.
// Blocks overlap by one conv row and column (17 x 17 conv positions for an
// 8 x 8 pooled tile is 1.13x the work); the training instantiation writes
// each conv position once, from the block that owns it, and each window's
// first position holding its max, as torch's max pool picks it (where the
// max is 0 the relu's backward zeroes the gradient, and the window's centre
// stands in). The tile was chosen by a sweep of 4 x 8, 8 x 8, 8 x 16 and
// 16 x 16 (PERF.md): 8 x 8 is the fastest or within 7 % at every shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace rmem_stemk {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using namespace rmem_mma;

constexpr int kThreads = 256;
constexpr int COUT = 64;
constexpr int ROWK = 22;           // taps of one kernel row: 7 x 3 + 1 pad
constexpr int KP = 160;            // 7 rows of 22, then 6 pad taps
constexpr int WS = KP + 8;         // sW row stride (bf16): 21 x 16 bytes
constexpr int ZS = COUT + 8;       // sZ row stride (bf16): 36 words

template <int PH, int PW>
struct Tile {
  static constexpr int CH = 2 * PH + 1, CW = 2 * PW + 1;   // conv positions
  static constexpr int IH = 2 * CH + 5, IW = 2 * CW + 5;   // input pixels
  // IW is odd, so 3 IW + 1 is even: every tap pair is 4-byte aligned, and
  // the last element of a row (the pad tap of the last column) is a zero
  static constexpr int RS = 3 * IW + 1;
  static constexpr int NPOS = CH * CW;
  static constexpr int X_BYTES = (IH * RS * 2 + 15) / 16 * 16;
  static constexpr int W_BYTES = COUT * WS * 2;
  static constexpr int SMEM = X_BYTES + W_BYTES + NPOS * ZS * 2;
};

// The 32-bit word offset of tap pair (k, k + 1), k even, from a conv
// position's first word; the pad pairs past the 7 kernel rows read word 0.
template <int RS>
__device__ __forceinline__ int pair_word(int k) {
  const int dy = k / ROWK, j = k - dy * ROWK;
  return k < 7 * ROWK ? (dy * RS + j) >> 1 : 0;
}

template <int PH, int PW, bool kSave>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
            const bf16* __restrict__ scale, const bf16* __restrict__ bias,
            bf16* __restrict__ out, bf16* __restrict__ conv,
            long long* __restrict__ argmax, int H, int W, int ho, int wo,
            int ph, int pw) {
  using T = Tile<PH, PW>;
  extern __shared__ __align__(16) char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);                 // [IH][RS]
  bf16* sW = reinterpret_cast<bf16*>(smem + T::X_BYTES);    // [64][WS]
  bf16* sZ = reinterpret_cast<bf16*>(smem + T::X_BYTES + T::W_BYTES);

  const int b = blockIdx.z, tid = threadIdx.x;
  const int py0 = blockIdx.y * PH, px0 = blockIdx.x * PW;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;   // first conv row / col
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;   // first input row / col

  // ---- weights [64][3][7][7] -> sW[o][dy * 22 + dx * 3 + c] ----
  for (int i = tid; i < COUT * KP; i += kThreads) {
    const int o = i / KP, k = i - o * KP, dy = k / ROWK, j = k - dy * ROWK;
    const bool pad = k >= 7 * ROWK || j == ROWK - 1;
    sW[o * WS + k] = pad ? __float2bfloat16_rn(0.f)
                         : w[((o * 3 + j % 3) * 7 + dy) * 7 + j / 3];
  }

  // ---- the input window, rounded to bf16; zeros outside the image ----
  const bool inside = iy0 >= 0 && ix0 >= 0 && iy0 + T::IH <= H &&
                      ix0 + T::IW <= W;
  if (!inside) {
    uint32_t* sXw = reinterpret_cast<uint32_t*>(sX);
    for (int i = tid; i < T::IH * T::RS / 2; i += kThreads) sXw[i] = 0u;
    __syncthreads();
  } else {
    for (int r = tid; r < T::IH; r += kThreads)
      sX[r * T::RS + T::RS - 1] = __float2bfloat16_rn(0.f);
  }
  {
    // 16-byte loads from the aligned chunk at or below x: float i of x is
    // float i + shift of the chunk
    const float4* x4 = reinterpret_cast<const float4*>(
        reinterpret_cast<uintptr_t>(x) & ~uintptr_t(15));
    const int shift = (int)((reinterpret_cast<uintptr_t>(x) & 15) >> 2);
    const int xa = ix0 > 0 ? ix0 : 0;
    const int xb = ix0 + T::IW < W ? ix0 + T::IW : W;
    constexpr int NF = (3 * T::IW + 6) / 4 + 1;   // 16-byte loads a row
    for (int i = tid; i < T::IH * NF; i += kThreads) {
      const int r = i / NF, iy = iy0 + r;
      if (iy < 0 || iy >= H || xa >= xb) continue;
      const long long row = ((long long)b * H + iy) * W * 3;
      const long long g0 = row + 3 * xa + shift, g1 = row + 3 * xb + shift;
      const long long f = (g0 >> 2) + (i - r * NF);
      if (f * 4 >= g1) continue;
      // an aligned 16-byte chunk holding at least one of the row's floats
      const float4 v = __ldg(x4 + f);
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long gi = f * 4 + e;
        if (gi < g0 || gi >= g1) continue;
        const int rel = (int)(gi - row - shift), ix = rel / 3;
        const int c = rel - 3 * ix;
        sX[r * T::RS + (ix - ix0) * 3 + c] = __float2bfloat16_rn(vals[e]);
      }
    }
  }
  __syncthreads();

  // ---- conv: each warp takes 16 positions x 64 channels at a time ----
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t* sXw = reinterpret_cast<const uint32_t*>(sX);
  for (int mt = warp; mt * 16 < T::NPOS; mt += kThreads / 32) {
    const int p0 = mt * 16 + g, p1 = p0 + 8;
    const int base0 = p0 < T::NPOS ? (p0 / T::CW) * T::RS + 3 * (p0 % T::CW)
                                   : 0;
    const int base1 = p1 < T::NPOS ? (p1 / T::CW) * T::RS + 3 * (p1 % T::CW)
                                   : 0;
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KP / 16; ++ks) {
      const int oa = pair_word<T::RS>(ks * 16 + 2 * t4);
      const int ob = pair_word<T::RS>(ks * 16 + 2 * t4 + 8);
      const unsigned a[4] = {sXw[base0 + oa], sXw[base1 + oa],
                             sXw[base0 + ob], sXw[base1 + ob]};
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bw[4];
        ldsm_x4(bw, sW + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * WS +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(acc[2 * np], a, bw[0], bw[1]);
        mma16816(acc[2 * np + 1], a, bw[2], bw[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (p0 < T::NPOS)
        *reinterpret_cast<unsigned*>(sZ + p0 * ZS + col) =
            pack_bf16(acc[nt][0], acc[nt][1]);
      if (p1 < T::NPOS)
        *reinterpret_cast<unsigned*>(sZ + p1 * ZS + col) =
            pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();

  // ---- affine, relu and pool: thread -> 8 channels of a pooled output ----
  const int cg = tid & 7;
  bf162 s2[4], b2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = cg * 8 + 2 * j;
    s2[j] = __halves2bfloat162(scale[c], scale[c + 1]);
    b2[j] = __halves2bfloat162(bias[c], bias[c + 1]);
  }
  for (int item = tid >> 3; item < PH * PW; item += kThreads / 8) {
    const int ly = item / PW, lx = item - ly * PW;
    const int py = py0 + ly, px = px0 + lx;
    if (py >= ph || px >= pw) continue;
    // relu's outputs are >= 0 and every window holds its in-grid centre,
    // so a max started at 0 is the max of the relu outputs
    bf162 mx[4];
    float best[8];                   // training: each channel's max so far
    int arg[8];                      // and where, in the conv grid
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[j] = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      best[j] = 0.f;
      arg[j] = (2 * py) * wo + 2 * px;
    }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int cy = cy0 + 2 * ly + dy, cx = cx0 + 2 * lx + dx;
        const bool in_grid = cy >= 0 && cy < ho && cx >= 0 && cx < wo;
        if (!in_grid) continue;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            sZ + ((2 * ly + dy) * T::CW + 2 * lx + dx) * ZS + cg * 8);
        const bf162* z2 = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf162 u = __hadd2_rn(__hmul2_rn(z2[j], s2[j]), b2[j]);
          mx[j] = __hmax2(mx[j], u);
          if (kSave) {
            const float2 f = __bfloat1622float2(u);
            if (f.x > best[2 * j]) {
              best[2 * j] = f.x;
              arg[2 * j] = cy * wo + cx;
            }
            if (f.y > best[2 * j + 1]) {
              best[2 * j + 1] = f.y;
              arg[2 * j + 1] = cy * wo + cx;
            }
          }
        }
      }
    }
    uint4 packed;
    packed.x = *reinterpret_cast<const unsigned*>(&mx[0]);
    packed.y = *reinterpret_cast<const unsigned*>(&mx[1]);
    packed.z = *reinterpret_cast<const unsigned*>(&mx[2]);
    packed.w = *reinterpret_cast<const unsigned*>(&mx[3]);
    const size_t o = (((size_t)b * ph + py) * pw + px) * COUT + cg * 8;
    *reinterpret_cast<uint4*>(out + o) = packed;
    if (kSave) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<longlong2*>(argmax + o + 2 * j) =
            make_longlong2(arg[2 * j], arg[2 * j + 1]);
    }
  }

  // ---- training: the conv map of the positions this block owns (all but
  // the first row and column, which the tile above or left owns) ----
  if (kSave) {
    for (int i = tid; i < 4 * PH * PW * 8; i += kThreads) {
      const int c8 = i & 7, pos = i >> 3;
      const int ly = 1 + pos / (2 * PW), lx = 1 + pos % (2 * PW);
      const int cy = cy0 + ly, cx = cx0 + lx;
      if (cy >= ho || cx >= wo) continue;
      *reinterpret_cast<uint4*>(conv + (((size_t)b * ho + cy) * wo + cx) *
                                           COUT + c8 * 8) =
          *reinterpret_cast<const uint4*>(sZ + (ly * T::CW + lx) * ZS +
                                          c8 * 8);
    }
  }
}

template <int PH, int PW, bool kSave>
static int launch(const void* x, const void* w, const void* scale,
                  const void* bias, void* out, void* conv, void* argmax,
                  int B, int H, int W, cudaStream_t stream) {
  const int ho = (H - 1) / 2 + 1, wo = (W - 1) / 2 + 1;
  const int ph = (ho - 1) / 2 + 1, pw = (wo - 1) / 2 + 1;
  auto kern = stem_kernel<PH, PW, kSave>;
  static bool configured = false;     // once per process and instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<PH, PW>::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((pw + PW - 1) / PW, (ph + PH - 1) / PH, B);
  kern<<<grid, kThreads, Tile<PH, PW>::SMEM, stream>>>(
      (const float*)x, (const bf16*)w, (const bf16*)scale, (const bf16*)bias,
      (bf16*)out, (bf16*)conv, (long long*)argmax, H, W, ho, wo, ph, pw);
  return (int)cudaGetLastError();
}

}  // namespace rmem_stemk

// x [B, H, W, 3] f32 (read in aligned 16-byte chunks, which may reach up
// to 12 bytes before its first or past its last element, never past the
// chunk); w [64, 3, 7, 7] bf16; scale, bias [64] bf16; out [B, ph, pw, 64]
// bf16; conv [B, ho, wo, 64] bf16 and argmax [B, ph, pw, 64] int64, both
// null or both given: with them, the training instantiation also writes
// the conv map before the affine and each pooled value's argmax (cy * wo +
// cx). Returns the cudaError_t of the launch.
extern "C" int rmem_stem(const void* x, const void* w, const void* scale,
                         const void* bias, void* out, void* conv,
                         void* argmax, int B, int H, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (conv != nullptr && argmax != nullptr)
    return rmem_stemk::launch<8, 8, true>(x, w, scale, bias, out, conv,
                                          argmax, B, H, W, st);
  if (conv != nullptr || argmax != nullptr) return -1;
  return rmem_stemk::launch<8, 8, false>(x, w, scale, bias, out, nullptr,
                                         nullptr, B, H, W, st);
}

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
// What bounds it on an H100: bytes, with the arithmetic close behind. It
// reads x and gate once and writes out: 3 * 1674 * 1024 * 2 B = 10.3 MB at
// batch 1 on the 31 x 54 grid, ~3.1 us at 3.35 TB/s; 20.6 and 34.4 MB at
// phase 7's calls (batch 2 on 31 x 54 and 40 x 70). Each tap of a channel
// pair is a bf16x2 multiply, two converts and two f32 adds, ~125
// instructions an output pair: ~3.6 us at batch 1 on 132 SMs x 4
// schedulers. So the loads must overlap the arithmetic, and the arithmetic
// must not pay for loads from shared memory.
//
// Design: a band of rows streamed through a ring, with a vertical window of
// accumulators in registers.
//   - A block owns RB output rows of one image (a band), CB channels, and a
//     tile of the row's columns (the whole row up to MAX_GROUPS * NCOL
//     columns). It streams the band's RB + 4 input rows, top to bottom,
//     through a ring of NS rows in shared memory: x and gate by 16-byte
//     cp.async (columns outside the image zero-filled; rows outside it are
//     neither loaded nor read), NS - 1 rows in flight while a row is used.
//     Halo reads are (RB + 4) / RB of the rows written, from L2 where a
//     neighbouring band read them first.
//   - When a row lands, each thread forms the gated product of the vectors
//     it copied, in place over x: once per input row.
//   - A thread owns one channel pair and NCOL adjacent output columns, holds
//     its 25 weight pairs and the f32 sums of the five output rows that an
//     input row feeds in registers (a window of 5 x NCOL pairs, its slots
//     fixed by unrolling the row loop). Per input row it reads the
//     NCOL + 4 taps of its columns from shared memory once and adds them into
//     those rows in dx order; the output row whose fifth input row this was
//     is rounded, written and its slot zeroed. Rows arrive in order, so each
//     output sums dy = 0..4, then dx = 0..4, as the plain version does; rows
//     outside the image are skipped, which leaves the bits unchanged (their
//     taps are zeros, and an f32 sum that starts at +0 never becomes -0).
//     A warp reads a pixel's channels as consecutive 4-byte words.
// Grid: (bands x column tiles, C / CB, B); a block has CB / 2 x (column
// groups) threads, at most 256, with at most 128 registers each so that two
// blocks share an SM. The constants are the fastest of a sweep of RB, CB,
// NCOL, NS and the register cap on phase 7's two calls (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace rmem_dw {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using rmem_mma::cp_async16;
using rmem_mma::cp_commit;
using rmem_mma::cp_wait;

constexpr int RB = 8;                     // output rows a block (a band)
constexpr int CB = 32;                    // channels a block
constexpr int NCOL = 4;                   // adjacent output columns a thread
constexpr int NS = 4;                     // input rows in the ring
constexpr int NIN = RB + 4;               // input rows a band reads
constexpr int PAIRS = CB / 2;             // threads across a pixel's channels
constexpr int VEC = CB / 8;               // 16-byte vectors a pixel
constexpr int kMaxThreads = 256;
// blocks an SM the registers must allow: at most 65536 / (256 x 2) = 128 a
// thread, so that two blocks' warps fit each scheduler's quarter of the
// register file
constexpr int kMinBlocks = 2;
constexpr int MAX_GROUPS = kMaxThreads / PAIRS;   // column groups a block
constexpr int kMaxSmem = 232448;
static_assert((NS & (NS - 1)) == 0 && NS >= 2, "a ring of 2, 4, 8 rows");

// The column tiling of a W-wide row: `tiles` tiles of `groups` groups of
// NCOL columns each, as even as the groups allow.
__host__ __device__ inline void tiling(int W, int* groups, int* tiles) {
  const int need = (W + NCOL - 1) / NCOL;
  *tiles = (need + MAX_GROUPS - 1) / MAX_GROUPS;
  *groups = (need + *tiles - 1) / *tiles;
}

// shared memory of a block whose tile has `groups` column groups: the x
// (then product) ring and the gate ring, [NS][cols + 4][CB] bf16 each
__host__ __device__ inline size_t smem_bytes(int groups) {
  return (size_t)2 * NS * (groups * NCOL + 4) * CB * sizeof(bf16);
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
gated_dwconv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gate,
                    const bf16* __restrict__ w, bf16* __restrict__ out, int H,
                    int W, int C, int groups, int tiles) {
  extern __shared__ __align__(16) char smem[];
  const int cols = groups * NCOL;         // the tile's output columns
  const int WP = cols + 4;                // its input columns
  bf16* xr = reinterpret_cast<bf16*>(smem);          // x, then x * gate
  bf16* gr = xr + (size_t)NS * WP * CB;
  const int band = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int y0 = band * RB, x0 = tile * cols;
  const int c0 = blockIdx.y * CB, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nvec = WP * VEC;

  // input row i of the band (image row y0 - 2 + i) into its ring slot; one
  // commit group a row, empty for rows outside the band or the image
  auto load_row = [&](int i) {
    const int yy = y0 - 2 + i;
    if (i < NIN && yy >= 0 && yy < H) {
      bf16* xs = xr + (size_t)(i & (NS - 1)) * WP * CB;
      bf16* gs = gr + (size_t)(i & (NS - 1)) * WP * CB;
      const size_t row = ((size_t)b * H + yy) * W;
      for (int v = tid; v < nvec; v += nthr) {
        const int p = v / VEC, e = (v % VEC) * 8;
        const int xx = x0 - 2 + p;
        const bool ok = xx >= 0 && xx < W;
        const size_t off = (row + (ok ? xx : 0)) * C + c0 + e;
        cp_async16(xs + p * CB + e, x + off, ok);
        cp_async16(gs + p * CB + e, gate + off, ok);
      }
    }
    cp_commit();
  };

  // this thread's channel pair and columns, its 25 weight pairs
  const int cp = tid % PAIRS, col0 = (tid / PAIRS) * NCOL;
  const int c = c0 + 2 * cp;
  bf162 wr[25];
#pragma unroll
  for (int k = 0; k < 25; ++k)
    wr[k] = __halves2bfloat162(w[(size_t)c * 25 + k],
                               w[(size_t)(c + 1) * 25 + k]);
  // the window: f32 sums of output rows j = 5t + s in slot s
  float acc[5][NCOL][2];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int k = 0; k < NCOL; ++k) acc[s][k][0] = acc[s][k][1] = 0.f;

  for (int i = 0; i < NS - 1; ++i) load_row(i);
#pragma unroll
  for (int i = 0; i < NIN; ++i) {   // unrolled: the window's slots fixed
    const int u = i % 5;
    const int yy = y0 - 2 + i;
    const bool inside = yy >= 0 && yy < H;
    bf16* xs = xr + (size_t)(i & (NS - 1)) * WP * CB;
    cp_wait<NS - 2>();     // this thread's copies of row i have landed
    if (inside) {          // the gated product of those vectors, in place
      const bf16* gs = gr + (size_t)(i & (NS - 1)) * WP * CB;
      for (int v = tid; v < nvec; v += nthr) {
        const int off = (v / VEC) * CB + (v % VEC) * 8;
        uint4 a = *reinterpret_cast<const uint4*>(xs + off);
        const uint4 g = *reinterpret_cast<const uint4*>(gs + off);
        bf162* a2 = reinterpret_cast<bf162*>(&a);
        const bf162* g2 = reinterpret_cast<const bf162*>(&g);
#pragma unroll
        for (int e = 0; e < 4; ++e) a2[e] = __hmul2_rn(a2[e], g2[e]);
        *reinterpret_cast<uint4*>(xs + off) = a;
      }
    }
    __syncthreads();       // row i's products visible; row i - 1 done with
    load_row(i + NS - 1);  // into row i - 1's slot
    if (inside) {
      const bf162* row = reinterpret_cast<const bf162*>(xs) +
                         (size_t)col0 * PAIRS + cp;
      bf162 t[NCOL + 4];
#pragma unroll
      for (int k = 0; k < NCOL + 4; ++k) t[k] = row[k * PAIRS];
      // input row i is tap row dy of output row j = i - dy
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        const int j = i - dy;
        if (j < 0 || j >= RB) continue;
        float(*a)[2] = acc[(u - dy + 5) % 5];
#pragma unroll
        for (int k = 0; k < NCOL; ++k) {
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) {
            // a bf16 widens to f32 exactly by its bits: the low channel
            // shifted up, the high one masked (two integer ops a pair,
            // where the library's conversion takes three)
            const bf162 pr = __hmul2_rn(t[k + dx], wr[dy * 5 + dx]);
            const uint32_t bits = *reinterpret_cast<const uint32_t*>(&pr);
            a[k][0] += __uint_as_float(bits << 16);
            a[k][1] += __uint_as_float(bits & 0xffff0000u);
          }
        }
      }
    }
    // output row i - 4 has had its fifth input row
    const int j = i - 4;
    if (j >= 0 && j < RB) {
      float(*a)[2] = acc[(u + 1) % 5];
      if (y0 + j < H) {
        bf16* orow = out + (((size_t)b * H + y0 + j) * W + x0) * C + c;
#pragma unroll
        for (int k = 0; k < NCOL; ++k)
          if (x0 + col0 + k < W)
            *reinterpret_cast<bf162*>(orow + (size_t)(col0 + k) * C) =
                __floats2bfloat162_rn(a[k][0], a[k][1]);
      }
#pragma unroll
      for (int k = 0; k < NCOL; ++k) a[k][0] = a[k][1] = 0.f;
    }
  }
}

}  // namespace rmem_dw

// x, gate, out [B, H*W, C] bf16, 16-byte aligned; w [C, 25] bf16 (the
// [C, 1, 5, 5] depthwise weight). Returns the cudaError_t of the launch (0
// on success); -1 when C is not a multiple of the channels a block takes
// (rmem_gated_dwconv_channels) or a shape is empty.
extern "C" int rmem_gated_dwconv(const void* x, const void* gate,
                                 const void* w, void* out, int B, int H,
                                 int W, int C, void* stream) {
  using namespace rmem_dw;
  if (C % CB != 0 || B < 1 || H < 1 || W < 1) return -1;
  int groups, tiles;
  tiling(W, &groups, &tiles);
  const size_t smem = smem_bytes(groups);
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
  dim3 grid(((H + RB - 1) / RB) * tiles, C / CB, B);
  gated_dwconv_kernel<<<grid, PAIRS * groups, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)gate, (const bf16*)w, (bf16*)out, H, W, C,
      groups, tiles);
  return (int)cudaGetLastError();
}

// The channels a block takes: C must be a multiple of it.
extern "C" int rmem_gated_dwconv_channels() { return rmem_dw::CB; }

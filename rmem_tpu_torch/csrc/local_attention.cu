// Local (windowed) attention for DeAOT's short-term memory: each query of
// the H x W token grid attends to the (2m+1)^2 keys around it (m = 7, a
// 15 x 15 window), with the learned relative bias rel[q, dy, dx] added to
// the logits and keys outside the image masked out.
//
// Replaces rmem_tpu/kernels/local_attention.py:pallas_local_attention.
//
// What bounds it on an H100: bytes. At the main path's shapes (31 x 54
// grid, dh = 128, dv = 1024, bf16) a layer needs ~0.9 GFLOP but moves
// ~8.5 MB (q, k, v and the 225-wide bias read once, the output written
// once), ~2.5 us at 3.35 TB/s against ~1 us of tensor-core time; at the
// training shapes (B 4, 30 x 30) 18.2 MB, ~5.4 us. What a kernel pays on
// top is latency: many small blocks, each waiting on its loads and on its
// products in turn.
//
// Design: a block owns an 8 x 8 tile of queries and a DVB-wide slice of dv
// (FWD_DVB, FWD_SPLIT below). Its keys are the tile's halo, the
// (8 + 2m)^2 = 484 grid cells around it, in 8 chunks of 64, so each key
// and value row is read once per tile and slice rather than once per
// query; the products run densely on the tensor cores and the window mask,
// the image mask and the bias are applied per logit. The TPU kernel's
// scatter of the bias into halo space and its 8-aligned halo width were
// layout tricks for the TPU and are gone: the bias is read in its own
// [q, 225] layout. Grids smaller than the window need no special case: the
// window is always the full 15 x 15 and the image mask removes what lies
// beyond the grid, which is what the cropped relative table of the JAX
// version computes.
//   - One online-softmax pass over the chunks, FlashAttention-2 style: each
//     warp owns 16 query rows (two tile rows) and a share of the slice's
//     columns; S = Q K^T (mma.sync m16n8k16, ldmatrix operands, Q held in
//     registers) stays in registers, the maximum and sum of each row are
//     kept by its four threads, O is rescaled when a row's maximum grows,
//     and the S accumulator, in bf16, is the A operand of O += P V.
//   - A chunk can lie wholly outside a row's window (halo rows 0-2 for a
//     query on tile row 7), and a row past a ragged grid edge has no key at
//     all, so a maximum may stay -inf: the rescale is guarded.
//   - A warp skips the chunks that hold no key of its rows' windows inside
//     the image (about a quarter of them), and no warp loads a chunk that
//     none needs.
//   - K and V chunks arrive by cp.async in two buffers, the next in flight
//     while this one computes; keys outside the image are zero-filled.
//   - The tile's bias rows (8 spans of 8 x 225 bf16) are copied into shared
//     memory once a block, with Q and the first chunk; the logits read them
//     there.
// The wider slice (256 against 128) computes Q K^T a quarter as often per
// tile; the grid then has fewer blocks (28 tiles x 4 slices = 112 at the
// main path, under one wave of 132 SMs).
//   - Heads (1 or 2 of 128: DeAOT's, and its no_memory_gap): the grid's
//     third axis is (image, head), as rmem_tpu/kernels/local_attention.py:
//     to_bh folds them. q, k, v and out keep their [.., H x d] token rows
//     and a block reads its head's columns in place. The bias comes
//     head-major, [B, H, HW, 225] (the wrapper's copy at two heads), so a
//     tile row's 8 x 225 values stay one span: in the caller's [B, HW,
//     H x 225] rows head 1's spans would start 450 bytes into a token's 900,
//     only 2-byte aligned for the 4-byte copies.
//
// The backward (K5's gradient), rmem_local_attention_bwd. Replaces the
// gradient of rmem_tpu/kernels/local_attention.py:
// pallas_local_attention_trainable, which has no Pallas backward: its rule
// (_trainable_bwd) is the XLA VJP of tiled_local_attention. Per query i and
// window key j, with s = scale q.k + rel[w(i,j)] and p = softmax_j(s):
//   dp = g_i.v_j, delta_i = sum_j p dp (f32, from p and dp, never from the
//   bf16 output), ds = p (dp - delta), drel[i, w] = ds (0 where the window
//   leaves the image), dq = scale sum_j ds k_j, dk = scale sum_i ds q_i,
//   dv = sum_i p g_i.
// What bounds it on an H100: bytes. At the training shapes (B 4, 30 x 30,
// dh 128, dv 1024) the work is 2 pairs (3 dh + 2 dv) ~ 3 GFLOP (~3 us at
// 989 TFLOP/s) against q, k, v, rel and g read once and dq, dk, dv and
// drel written once, ~31 MB (~9 us at 3.35 TB/s). Design: two kernels,
// no atomics, so the result does not depend on the order of blocks.
//   (a) The query side: a block owns an 8 x 8 query tile and its 22 x 22
//       key halo, in 64-key chunks, as the forward. A first pass recomputes
//       each row's max and softmax sum; a second forms p, and dp = G V^T on
//       the tensor cores (dv in 128-wide slices), takes delta in f32 and
//       writes p and dp to [B, HW, 225] f32 in window layout (p to a
//       scratch, dp into drel); a third turns dp into ds in place (drel is
//       ds) and sums dq = scale ds K on the tensor cores, ds entering as a
//       bf16 hi/lo pair (~16 bits: dq is a small difference of large terms,
//       the trap of the bank-attention backward).
//   (b) The key side: a block owns an 8 x 8 key tile and the 22 x 22 halo
//       of queries that see it, and one 128-wide slice of dv (dv = P^T G)
//       or dk (dk = scale ds^T Q, the hi/lo pair again). It gathers p and ds
//       from (a)'s window layout at the mirrored offset: the query sits at
//       offset w' from the key, the key at 224 - w' from the query, and the
//       image mask is the query's own.
// The recomputed logits and the dense halo (484 keys, ~1/3 of them in a
// query's window) cost ~3x the pairs' operations on the tensor cores; the
// scratch (3.2 MB) and the re-read G slices stay in L2.
//   Heads (1 or 2 of 128, as the forward): both kernels' grids fold (image,
// head) into one axis, (a)'s 64 blocks at the training shape becoming 128
// at two heads; q, k, v, g, dq, dk and dv keep their [.., H x d] token rows
// and a block reads and writes its head's columns in place. The bias comes
// head-major, [B, H, HW, 225], as the forward takes it, and drel and the p
// scratch are head-major too, [B, H, HW, 225] (the wrapper gives drel back
// in the caller's [B, HW, H x 225] layout).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace rmem {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using namespace rmem_mma;

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int TILE = 8;  // TILE * TILE == BQ query rows per block

// The pitches of the backward's query and key rows and logits, as qk_tile
// reads and writes them.
template <int D>
struct TileSmem {
  static constexpr int LQ = D + 8;      // bf16 row pitch of Q and K
  static constexpr int LS = BK + 4;     // f32 row pitch of the logits
  static_assert(D % 16 == 0, "tile shapes");
};

// Copy `rows` rows of `width` bf16 into shared memory (pitch `pitch`), 16
// bytes a thread; a row whose pointer is null is zero-filled.
template <int width, class RowFn>
__device__ __forceinline__ void load_rows(bf16* dst, int pitch, int rows,
                                          RowFn row_ptr) {
  constexpr int segs = width / 8;
  for (int i = threadIdx.x; i < rows * segs; i += kThreads) {
    const int r = i / segs, s = i % segs;
    const bf16* src = row_ptr(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + s * 8);
    *reinterpret_cast<uint4*>(dst + r * pitch + s * 8) = val;
  }
}

// S[64 x 64] = Q[64 x D] K[64 x D]^T; warp w computes row tile w/2 and
// column tiles 2*(w%2) + {0, 1}.
template <int D>
__device__ __forceinline__ void qk_tile(const bf16* sQ, const bf16* sK,
                                        float* sS) {
  using T = TileSmem<D>;
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1, ct = (warp & 1) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + rt * 16 * T::LQ + k0, T::LQ);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sK + (ct + t) * 16 * T::LQ + k0, T::LQ);
      wmma::mma_sync(c[t], a, b, c[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
    wmma::store_matrix_sync(sS + rt * 16 * T::LS + (ct + t) * 16, c[t],
                            T::LS, wmma::mem_row_major);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The block's queries, keys and values, and its logit rule.
template <int D>
struct LocalPolicy {
  const bf16* q;     // [B, HW, H*D]
  const bf16* k;     // [B, HW, H*D]
  const bf16* v;     // [B, HW, H*dv]
  const bf16* rel;   // head-major [B, H, HW, win*win]
  bf16* out;         // [B, HW, H*dv]
  int Hg, Wg, H, dv, m, win, halo;
  float scale;
  int b, h, y0, x0, c0;

  __device__ int num_chunks() const { return (halo * halo + BK - 1) / BK; }
  __device__ bool query(int r, int& qi, int& qy, int& qx) const {
    qy = y0 + r / TILE;
    qx = x0 + r % TILE;
    qi = qy * Wg + qx;
    return qy < Hg && qx < Wg;
  }
  __device__ bool key(int ch, int j, int& ky, int& kx) const {
    const int hj = ch * BK + j;
    ky = y0 - m + hj / halo;
    kx = x0 - m + hj % halo;
    return hj < halo * halo && ky >= 0 && ky < Hg && kx >= 0 && kx < Wg;
  }
  // null: a padding row (zero-filled) or an output row not written
  __device__ const bf16* q_row(int r) const {
    int qi, qy, qx;
    return query(r, qi, qy, qx)
               ? q + ((size_t)b * Hg * Wg + qi) * H * D + h * D
               : nullptr;
  }
  __device__ const bf16* k_row(int ch, int j) const {
    int ky, kx;
    return key(ch, j, ky, kx)
               ? k + ((size_t)b * Hg * Wg + ky * Wg + kx) * H * D + h * D
               : nullptr;
  }
  __device__ const bf16* v_row(int ch, int j) const {
    int ky, kx;
    return key(ch, j, ky, kx) ? v + ((size_t)b * Hg * Wg + ky * Wg + kx) *
                                        H * dv + h * dv + c0
                              : nullptr;
  }
  __device__ bf16* out_row(int r) const {
    int qi, qy, qx;
    return query(r, qi, qy, qx)
               ? out + ((size_t)b * Hg * Wg + qi) * H * dv + h * dv + c0
               : nullptr;
  }
  // 16 logits of one row from their dot products; -INFINITY = masked
  __device__ void logits(int ch, int row, int col0, const float* dots,
                         float* x) const {
    int qi, qy, qx;
    const bool qok = query(row, qi, qy, qx);
    const bf16* rrow =
        rel + (((size_t)b * H + h) * Hg * Wg + qi) * win * win;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int ky, kx;
      const bool kok = key(ch, col0 + j, ky, kx);
      const int dy = ky - qy, dx = kx - qx;
      const bool ok = qok && kok && dy >= -m && dy <= m && dx >= -m &&
                      dx <= m;
      x[j] = ok ? dots[j] * scale +
                      __bfloat162float(rrow[(dy + m) * win + (dx + m)])
                : -INFINITY;
    }
  }
};

// ---- the forward (K4) ---------------------------------------------------

constexpr int M = 7;                                 // max_dis
constexpr int WIN = 2 * M + 1;                       // the window's side
constexpr int WIN2 = WIN * WIN;
constexpr int HALO = TILE + 2 * M;                   // the key halo's side
constexpr int NCH = (HALO * HALO + BK - 1) / BK;     // 64-key chunks (8)
constexpr int FD = 128;                              // head width
constexpr int LQF = FD + 8;                          // bf16 pitch of Q, K
// a tile row's bias: 8 queries x 225 bf16, one span in rel, copied in
// 4-byte words from the word that holds its first value
constexpr int BIAS_WORDS = (TILE * WIN2 * 2 + 2 + 3) / 4;
constexpr int BIAS_ROW = BIAS_WORDS * 4;             // bytes
constexpr float LOG2E = 1.4426950408889634f;
// a halo entry outside every window: row 1023, column 31
constexpr short NO_KEY = 0x7FFF;
// The dv slice of a block and the warps that split its columns, fixed at
// compile time (PERF.md has the sweep that chose them).
constexpr int FWD_DVB = 256;
constexpr int FWD_SPLIT = 2;

template <int DVB>
struct FwdSmem {
  static constexpr int LV = DVB + 8;                 // bf16 pitch of V
  static constexpr int k_off = 0;                    // two K buffers
  static constexpr int v_off = k_off + 2 * BK * LQF * 2;   // two V buffers
  static constexpr int b_off = v_off + 2 * BK * LV * 2;    // the bias rows
  static constexpr int h_off = b_off + TILE * BIAS_ROW;    // halo keys
  static constexpr int bytes = h_off + NCH * BK * 2;
  // Q lands in V's second buffer and leaves it for registers before the
  // second chunk is loaded there
  static_assert(BQ * LQF <= BK * LV, "Q fits in a V buffer");
  static_assert(v_off % 16 == 0 && b_off % 16 == 0, "16-byte copies");
};

// The bias of window offset (wy, wx) from a query's row of 225, in log2
// units.
__device__ __forceinline__ float bias_at(const bf16* row, int wy, int wx) {
  return __bfloat162float(row[wy * WIN + wx]) * LOG2E;
}

// One 8 x 8 query tile of image b, head h (blockIdx.z = b H + h) and one
// DVB-wide slice of the head's dv. Warp w owns query rows 16 (w % 4) .. +16
// (tile rows 2 (w % 4) and +1) and columns (w / 4) DVB / SPLIT .. of the
// slice. q, k [B, HW, H x 128], v [B, HW, H x dv], rel head-major
// [B, H, HW, 225]; out [B, HW, H x dv] bf16.
template <int DVB, int SPLIT>
__global__ void __launch_bounds__(128 * SPLIT, DVB == 128 ? 2 : 1)
local_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ rel,
                 bf16* __restrict__ out, int Hg, int Wg, int H, int dv,
                 float scale_log2) {
  using L = FwdSmem<DVB>;
  constexpr int NT = 128 * SPLIT;         // threads
  constexpr int CW = DVB / SPLIT;         // output columns of a warp
  constexpr int NF = CW / 8;              // its n8 tiles
  static_assert(NF % 2 == 0, "ldmatrix.x4 feeds two n8 tiles");
  extern __shared__ __align__(128) char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sQ = sV + BK * L::LV;
  char* sB = smem + L::b_off;
  // each halo key's row and column in the halo (hy << 5 | hx), or NO_KEY
  // outside the image and past the halo
  short* sH = reinterpret_cast<short*>(smem + L::h_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp & 3, cs = warp >> 2;
  const int tiles_x = (Wg + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_x) * TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int c0 = blockIdx.y * DVB;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const size_t base = (size_t)b * Hg * Wg;     // the image's first token
  // head h's bias rows of image b
  const size_t rbase = ((size_t)b * H + h) * Hg * Wg;
  // token strides, and the head's columns within a token's row
  const size_t qs = (size_t)H * FD, vs = (size_t)H * dv;
  q += (size_t)h * FD;
  k += (size_t)h * FD;
  v += (size_t)h * dv;
  out += (size_t)h * dv;
  const int ty0 = 2 * rt, ty1 = ty0 + 1;   // this thread's rows: (ty, g)

  // ---- which chunks each warp needs: halo rows inside the image and the
  // window of one of its queries ----
  const int hy_lo = M - y0 > 0 ? M - y0 : 0;
  const int hy_hi = min(HALO - 1, Hg - 1 - y0 + M);
  unsigned any = 0, mine = 0;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int c_lo = c * BK / HALO;
    const int c_hi = min(c * BK + BK - 1, HALO * HALO - 1) / HALO;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (y0 + 2 * w >= Hg) continue;
      const int last = y0 + 2 * w + 1 < Hg ? 2 * w + 1 : 2 * w;
      const int lo = max(max(2 * w, hy_lo), c_lo);
      const int hi = min(min(last + 2 * M, hy_hi), c_hi);
      if (lo <= hi) {
        any |= 1u << c;
        if (w == rt) mine |= 1u << c;
      }
    }
  }

  for (int i = tid; i < NCH * BK; i += NT) {
    const int hy = i / HALO, hx = i - hy * HALO;
    const int ky = y0 - M + hy, kx = x0 - M + hx;
    sH[i] = i < HALO * HALO && ky >= 0 && ky < Hg && kx >= 0 && kx < Wg
                ? (short)(hy << 5 | hx)
                : NO_KEY;
  }
  __syncthreads();  // sH is read by every thread's copies
  // halo key hj: whether it is a key, and its token index in the image
  auto key_at = [&](int hj, int& idx) {
    const int hk = sH[hj];
    idx = (y0 - M + (hk >> 5)) * Wg + x0 - M + (hk & 31);
    if (hk == NO_KEY) idx = 0;
    return hk != NO_KEY;
  };
  // keys outside the image (and past the halo) are zero-filled
  auto load_chunk = [&](int c, int buf) {
    bf16* dK = sK + buf * BK * LQF;
    bf16* dV = sV + buf * BK * L::LV;
    for (int i = tid; i < BK * (FD / 8); i += NT) {
      const int j = i / (FD / 8), s8 = i % (FD / 8);
      int idx;
      const bool ok = key_at(c * BK + j, idx);
      cp_async16(dK + j * LQF + s8 * 8, k + (base + idx) * qs + s8 * 8, ok);
    }
    for (int i = tid; i < BK * (DVB / 8); i += NT) {
      const int j = i / (DVB / 8), s8 = i % (DVB / 8);
      int idx;
      const bool ok = key_at(c * BK + j, idx);
      cp_async16(dV + j * L::LV + s8 * 8,
                 v + (base + idx) * vs + c0 + s8 * 8, ok);
    }
  };

  // ---- one group: Q, the tile's bias rows, the first chunk ----
  for (int i = tid; i < BQ * (FD / 8); i += NT) {
    const int r = i / (FD / 8), s8 = i % (FD / 8);
    const int qy = y0 + r / TILE, qx = x0 + r % TILE;
    const bool ok = qy < Hg && qx < Wg;
    cp_async16(sQ + r * LQF + s8 * 8,
               q + (base + (ok ? qy * Wg + qx : 0)) * qs + s8 * 8, ok);
  }
  const int nx = min(TILE, Wg - x0);
  const char* relb = reinterpret_cast<const char*>(rel);
  auto bias_span = [&](int ty, size_t& start) {   // the row's byte span
    start = (rbase + (size_t)(y0 + ty) * Wg + x0) * WIN2 * 2;
    return start + (size_t)nx * WIN2 * 2;
  };
  for (int i = tid; i < TILE * BIAS_WORDS; i += NT) {
    const int ty = i / BIAS_WORDS, wd = i - ty * BIAS_WORDS;
    if (y0 + ty >= Hg) continue;
    size_t start;
    const size_t end = bias_span(ty, start);
    const size_t at = (start & ~(size_t)3) + 4 * (size_t)wd;
    if (at >= end) continue;
    cp_async4(sB + ty * BIAS_ROW + 4 * wd, relb + at,
              end - at < 4 ? (int)(end - at) : 4);
  }
  int c = any ? __ffs(any) - 1 : NCH;
  if (c < NCH) load_chunk(c, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  unsigned qf[FD / 16][4];
#pragma unroll
  for (int ks = 0; ks < FD / 16; ++ks)
    ldsm_x4(qf[ks], sQ + (rt * 16 + (lane & 15)) * LQF + ks * 16 +
                        (lane >> 4) * 8);
  __syncthreads();  // Q's buffer is free for the second chunk

  // this thread's two queries and their bias rows in shared memory
  const bool q0ok = y0 + ty0 < Hg && x0 + g < Wg;
  const bool q1ok = y0 + ty1 < Hg && x0 + g < Wg;
  size_t s0b, s1b;
  bias_span(ty0, s0b);
  bias_span(ty1, s1b);
  const bf16* brow0 =
      reinterpret_cast<const bf16*>(sB + ty0 * BIAS_ROW + (s0b & 3)) +
      g * WIN2;
  const bf16* brow1 =
      reinterpret_cast<const bf16*>(sB + ty1 * BIAS_ROW + (s1b & 3)) +
      g * WIN2;

  float o[NF][4];
#pragma unroll
  for (int i = 0; i < NF; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int buf = 0;
  while (c < NCH) {
    const unsigned rest = any & ~((2u << c) - 1u);
    const int next = rest ? __ffs(rest) - 1 : NCH;
    if (next < NCH) load_chunk(next, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // chunk c is in buffer buf
    if (mine >> c & 1u) {
      const bf16* cK = sK + buf * BK * LQF;
      const bf16* cV = sV + buf * BK * L::LV;

      // ---- S = Q K^T, 16 rows x 64 keys, in registers ----
      float sc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
#pragma unroll
        for (int ks = 0; ks < FD / 16; ++ks) {
          unsigned kb[4];
          ldsm_x4(kb, cK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LQF +
                          ks * 16 + ((lane >> 3) & 1) * 8);
          mma16816(sc[2 * np], qf[ks], kb[0], kb[1]);
          mma16816(sc[2 * np + 1], qf[ks], kb[2], kb[3]);
        }
      }

      // ---- window and image masks, bias (log2 units) ----
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int hk = sH[c * BK + nt * 8 + 2 * t + e];
          const int wx = (hk & 31) - g, wy0 = (hk >> 5) - ty0, wy1 = wy0 - 1;
          const bool okx = (unsigned)wx < WIN;
          const bool ok0 = q0ok && okx && (unsigned)wy0 < WIN;
          const bool ok1 = q1ok && okx && (unsigned)wy1 < WIN;
          sc[nt][e] = ok0 ? sc[nt][e] * scale_log2 + bias_at(brow0, wy0, wx)
                          : -INFINITY;
          sc[nt][e + 2] = ok1 ? sc[nt][e + 2] * scale_log2 +
                                    bias_at(brow1, wy1, wx)
                              : -INFINITY;
          mx0 = fmaxf(mx0, sc[nt][e]);
          mx1 = fmaxf(mx1, sc[nt][e + 2]);
        }
      }

      // ---- online softmax: a chunk may hold no key of a row's window, and
      // a row past the grid's edge has none, so a maximum may stay -inf;
      // exp2 is taken against a finite stand-in then (exp2(-inf) = 0), never
      // of -inf - -inf ----
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float ms0 = mn0 != -INFINITY ? mn0 : 0.f;
      const float ms1 = mn1 != -INFINITY ? mn1 : 0.f;
      const float a0 = exp2f(m0 - ms0), a1 = exp2f(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][e] = exp2f(sc[nt][e] - ms0);
          sc[nt][e + 2] = exp2f(sc[nt][e + 2] - ms1);
          ps0 += sc[nt][e];
          ps1 += sc[nt][e + 2];
        }
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        o[i][0] *= a0; o[i][1] *= a0; o[i][2] *= a1; o[i][3] *= a1;
      }

      // ---- O += P V: P from S's registers as the A operand ----
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pa[4];
        pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < NF / 2; ++np) {
          unsigned vb[4];
          ldsm_x4_t(vb, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 L::LV + cs * CW + np * 16 + (lane >> 4) * 8);
          mma16816(o[2 * np], pa, vb[0], vb[1]);
          mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // buffer buf is free for the chunk after next
    c = next;
    buf ^= 1;
  }

  // ---- epilogue: normalise, write the valid rows in bf16 ----
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float il0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float il1 = l1 > 0.f ? 1.f / l1 : 0.f;
  bf16* oa = out + (base + (size_t)(y0 + ty0) * Wg + x0 + g) * vs + c0 +
             cs * CW + 2 * t;
  bf16* ob = out + (base + (size_t)(y0 + ty1) * Wg + x0 + g) * vs + c0 +
             cs * CW + 2 * t;
#pragma unroll
  for (int nt = 0; nt < NF; ++nt) {
    if (q0ok)
      *reinterpret_cast<unsigned*>(oa + nt * 8) =
          pack_bf16(o[nt][0] * il0, o[nt][1] * il0);
    if (q1ok)
      *reinterpret_cast<unsigned*>(ob + nt * 8) =
          pack_bf16(o[nt][2] * il1, o[nt][3] * il1);
  }
}

template <int DVB, int SPLIT>
static int launch_fwd(const void* q, const void* k, const void* v,
                      const void* rel, void* out, int B, int Hg, int Wg,
                      int H, int dv, float scale, cudaStream_t stream) {
  constexpr int smem = FwdSmem<DVB>::bytes;
  auto kern = local_fwd_kernel<DVB, SPLIT>;
  static bool configured = false;     // once per process and instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles = ((Hg + TILE - 1) / TILE) * ((Wg + TILE - 1) / TILE);
  kern<<<dim3(tiles, dv / DVB, B * H), 128 * SPLIT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rel,
      (bf16*)out, Hg, Wg, H, dv, scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---- the backward -------------------------------------------------------

template <int D>
struct BwdSmem {
  static constexpr int LQ = D + 8;    // bf16 pitch of Q, K and the G, V slices
  static constexpr int LS = BK + 4;   // f32 pitch of the logits, dp and p
  static constexpr int LP = BK + 8;   // bf16 pitch of the ds hi / lo pair
  static constexpr int LO = D + 4;    // f32 pitch of the output stage
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * LQ * 2;
  static constexpr int s_off = k_off + BK * LQ * 2;
  static constexpr int p_off = s_off + BQ * LS * 4;
  static constexpr int g_off = p_off + BQ * LS * 4;
  static constexpr int v_off = g_off + BQ * LQ * 2;
  static constexpr int hi_off = v_off + BK * LQ * 2;
  static constexpr int lo_off = hi_off + BQ * LP * 2;
  static constexpr int end = lo_off + BQ * LP * 2;
  static constexpr int stage = BQ * LO * 4;    // over Q and K at the end
  static constexpr int bytes = end;
  static_assert(stage <= s_off, "the output stage overlays Q and K");
  static_assert(LQ == TileSmem<D>::LQ && LS == TileSmem<D>::LS,
                "qk_tile's pitches");
  static_assert(k_off % 32 == 0 && s_off % 32 == 0 && p_off % 32 == 0 &&
                g_off % 32 == 0 && v_off % 32 == 0 && hi_off % 32 == 0 &&
                lo_off % 32 == 0, "WMMA needs 32-byte aligned tiles");
};

// The key side's tiles: P^T or the ds pair [keys x queries], the query
// rows of G or Q, and the output stage over all of them at the end.
template <int D>
struct KeySmem {
  static constexpr int LQ = D + 8;
  static constexpr int LP = BK + 8;
  static constexpr int LO = D + 4;
  static constexpr int hi_off = 0;
  static constexpr int lo_off = hi_off + BQ * LP * 2;
  static constexpr int b_off = lo_off + BQ * LP * 2;
  static constexpr int end = b_off + BK * LQ * 2;
  static constexpr int stage = BQ * LO * 4;
  static constexpr int bytes = end > stage ? end : stage;
};

__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// Write a [64 x D] f32 tile of accumulators, times `mul`, as bf16 rows;
// row_ptr(r) null skips the row. Ends with the stage consumed.
template <int D, int NF, class RowFn>
__device__ __forceinline__ void store_rows(
    char* smem, wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
    int rt, int cb, float mul, RowFn row_ptr) {
  constexpr int LO = D + 4;
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < NF; ++t)
    wmma::store_matrix_sync(stage + rt * 16 * LO + (cb + t) * 16, acc[t], LO,
                            wmma::mem_row_major);
  __syncthreads();
  constexpr int segs = D / 8;
  for (int i = threadIdx.x; i < BQ * segs; i += kThreads) {
    const int r = i / segs, s = i % segs;
    bf16* dst = row_ptr(r);
    if (dst == nullptr) continue;
    const float* src = stage + r * LO + s * 8;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(src[j] * mul);
    *reinterpret_cast<uint4*>(dst + s * 8) = *reinterpret_cast<uint4*>(o);
  }
}

// (a) One 8 x 8 query tile of image b, head h (blockIdx.y = b H + h): p to
// p_out and ds to drel ([B, H, HW, win^2] f32, window layout), dq
// [B, HW, H x D] bf16.
template <int D>
__global__ void __launch_bounds__(kThreads)
local_bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ rel,
                       const bf16* __restrict__ g, float* __restrict__ p_out,
                       float* __restrict__ drel, bf16* __restrict__ dq,
                       int Hg, int Wg, int H, int dv, int m, float scale) {
  using T = BwdSmem<D>;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + T::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + T::k_off);
  float* sS = reinterpret_cast<float*>(smem + T::s_off);
  float* sP = reinterpret_cast<float*>(smem + T::p_off);
  bf16* sG = reinterpret_cast<bf16*>(smem + T::g_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::v_off);
  bf16* sHi = reinterpret_cast<bf16*>(smem + T::hi_off);
  bf16* sLo = reinterpret_cast<bf16*>(smem + T::lo_off);

  const int tiles_x = (Wg + TILE - 1) / TILE;
  LocalPolicy<D> pol;
  pol.q = q; pol.k = k; pol.v = v; pol.rel = rel; pol.out = nullptr;
  pol.Hg = Hg; pol.Wg = Wg; pol.H = H; pol.dv = dv; pol.m = m;
  pol.win = 2 * m + 1; pol.halo = TILE + 2 * m;
  pol.scale = scale;
  pol.b = blockIdx.y / H; pol.h = blockIdx.y % H;
  pol.y0 = (blockIdx.x / tiles_x) * TILE;
  pol.x0 = (blockIdx.x % tiles_x) * TILE;
  pol.c0 = 0;
  const int win = pol.win, win2 = win * win;
  const size_t HW = (size_t)Hg * Wg;
  // token strides over the heads, this head's columns within a token
  const size_t ks = (size_t)H * D, vs = (size_t)H * dv;
  const size_t kh = (size_t)pol.h * D, vh = (size_t)pol.h * dv;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int col0 = part * 16;
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1;
  const int nch = pol.num_chunks();
  int qi, qy, qx;
  const bool qok = pol.query(row, qi, qy, qx);
  float* prow = p_out + (((size_t)pol.b * H + pol.h) * HW + (qok ? qi : 0)) *
                            win2;
  float* drow = drel + (((size_t)pol.b * H + pol.h) * HW + (qok ? qi : 0)) *
                           win2;
  // this thread's 16 keys of a chunk: their window offset, -1 outside
  auto offsets = [&](int ch, int* w) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int ky, kx;
      const bool kok = pol.key(ch, col0 + j, ky, kx);
      const int dy = ky - qy, dx = kx - qx;
      w[j] = (qok && kok && dy >= -m && dy <= m && dx >= -m && dx <= m)
                 ? (dy + m) * win + (dx + m)
                 : -1;
    }
  };

  load_rows<D>(sQ, T::LQ, BQ, [&](int r) { return pol.q_row(r); });

  // ---- pass 1: row max and softmax denominator, as the forward ----
  float mrow = -INFINITY, l = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    __syncthreads();
    qk_tile<D>(sQ, sK, sS);
    __syncthreads();
    float x[16];
    pol.logits(ch, row, col0, sS + row * T::LS + col0, x);
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) cmax = fmaxf(cmax, x[j]);
    const float mn = fmaxf(mrow, quad_max(cmax));
    float s = 0.f;
    if (mn != -INFINITY) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s += (x[j] == -INFINITY) ? 0.f : __expf(x[j] - mn);
    }
    s = quad_sum(s);
    l = (mrow == -INFINITY ? 0.f : l * __expf(mrow - mn)) + s;
    mrow = mn;
  }
  const float inv_l = l > 0.f ? 1.f / l : 0.f;

  // ---- pass 2: p, dp = G V^T, delta; p and dp out in window layout ----
  float delta = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sK, sS, sP free again
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    __syncthreads();
    qk_tile<D>(sQ, sK, sS);
    __syncthreads();
    float x[16];
    int w[16];
    pol.logits(ch, row, col0, sS + row * T::LS + col0, x);
    offsets(ch, w);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = (x[j] == -INFINITY) ? 0.f : __expf(x[j] - mrow) * inv_l;
      sP[row * T::LS + col0 + j] = p;
      if (w[j] >= 0) prow[w[j]] = p;
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    const int ct = (warp & 1) * 2;
    for (int c0 = 0; c0 < dv; c0 += D) {
      __syncthreads();  // sG, sV free; in the first slice, sS read
      load_rows<D>(sG, T::LQ, BQ, [&](int r) -> const bf16* {
        int i, y, xx;
        return pol.query(r, i, y, xx)
                   ? g + ((size_t)pol.b * HW + i) * vs + vh + c0
                   : nullptr;
      });
      load_rows<D>(sV, T::LQ, BK, [&](int j) -> const bf16* {
        int ky, kx;
        return pol.key(ch, j, ky, kx)
                   ? v + ((size_t)pol.b * HW + ky * Wg + kx) * vs + vh + c0
                   : nullptr;
      });
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sG + rt * 16 * T::LQ + k0, T::LQ);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              b;
          wmma::load_matrix_sync(b, sV + (ct + t) * 16 * T::LQ + k0, T::LQ);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
      wmma::store_matrix_sync(sS + rt * 16 * T::LS + (ct + t) * 16, acc[t],
                              T::LS, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float dp = sS[row * T::LS + col0 + j];
      delta += sP[row * T::LS + col0 + j] * dp;
      if (w[j] >= 0) drow[w[j]] = dp;
    }
  }
  delta = quad_sum(delta);

  // ---- pass 3: ds = p (dp - delta) into drel, dq = scale ds K ----
  if (qok)
    for (int wi = part; wi < win2; wi += 4) {
      const int ky = qy + wi / win - m, kx = qx + wi % win - m;
      if (ky < 0 || ky >= Hg || kx < 0 || kx >= Wg) drow[wi] = 0.f;
    }
  constexpr int NF = D / 32;      // 16-wide column tiles of dq per warp
  const int cb = (warp & 1) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[NF];
#pragma unroll
  for (int t = 0; t < NF; ++t) wmma::fill_fragment(dacc[t], 0.f);
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sK, sHi, sLo free again
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    int w[16];
    offsets(ch, w);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bf16 hi = __float2bfloat16_rn(0.f), lo = hi;
      if (w[j] >= 0) {
        // this thread wrote p and dp of these entries in pass 2
        const float ds = prow[w[j]] * (drow[w[j]] - delta);
        drow[w[j]] = ds;
        split_bf16(ds, hi, lo);
      }
      sHi[row * T::LP + col0 + j] = hi;
      sLo[row * T::LP + col0 + j] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ah,
          al;
      wmma::load_matrix_sync(ah, sHi + rt * 16 * T::LP + kk, T::LP);
      wmma::load_matrix_sync(al, sLo + rt * 16 * T::LP + kk, T::LP);
#pragma unroll
      for (int t = 0; t < NF; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sK + kk * T::LQ + (cb + t) * 16, T::LQ);
        wmma::mma_sync(dacc[t], ah, b, dacc[t]);
        wmma::mma_sync(dacc[t], al, b, dacc[t]);
      }
    }
  }
  store_rows<D, NF>(smem, dacc, rt, cb, scale, [&](int r) -> bf16* {
    int i, y, xx;
    return pol.query(r, i, y, xx) ? dq + ((size_t)pol.b * HW + i) * ks + kh
                                  : nullptr;
  });
}

// (b) One 8 x 8 key tile of image b, head h (blockIdx.z = b H + h) and one
// 128-wide column slice of the head's: dv = P^T G for slice blockIdx.y <
// dv / D, dk = scale ds^T Q for the last.
template <int D>
__global__ void __launch_bounds__(kThreads)
local_bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ g,
                     const float* __restrict__ p_in,
                     const float* __restrict__ ds_in, bf16* __restrict__ dk,
                     bf16* __restrict__ dvo, int Hg, int Wg, int H, int dv,
                     int m, float scale) {
  using T = KeySmem<D>;
  extern __shared__ __align__(128) char smem[];
  bf16* sHi = reinterpret_cast<bf16*>(smem + T::hi_off);
  bf16* sLo = reinterpret_cast<bf16*>(smem + T::lo_off);
  bf16* sB = reinterpret_cast<bf16*>(smem + T::b_off);

  const int tiles_x = (Wg + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_x) * TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const bool is_dk = (int)blockIdx.y == dv / D;
  const int c0 = blockIdx.y * D;
  const int win = 2 * m + 1, win2 = win * win, halo = TILE + 2 * m;
  const size_t HW = (size_t)Hg * Wg;
  const size_t qs = (size_t)H * D, vs = (size_t)H * dv;
  // this head's rows of the window-layout p and ds
  const size_t wbase = ((size_t)b * H + h) * HW;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int col0 = part * 16;
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1;
  constexpr int NF = D / 32;
  const int cb = (warp & 1) * NF;
  const int ky = y0 + row / TILE, kx = x0 + row % TILE;
  const bool kok = ky < Hg && kx < Wg;
  const int nch = (halo * halo + BK - 1) / BK;
  const float* src = is_dk ? ds_in : p_in;
  auto query = [&](int ch, int c, int& qi) {
    const int hj = ch * BK + c;
    const int qy = y0 - m + hj / halo, qx = x0 - m + hj % halo;
    qi = qy * Wg + qx;
    return hj < halo * halo && qy >= 0 && qy < Hg && qx >= 0 && qx < Wg;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int t = 0; t < NF; ++t) wmma::fill_fragment(acc[t], 0.f);
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sHi, sLo, sB free again
    load_rows<D>(sB, T::LQ, BK, [&](int c) -> const bf16* {
      int qi;
      if (!query(ch, c, qi)) return nullptr;
      return is_dk ? q + ((size_t)b * HW + qi) * qs + (size_t)h * D
                   : g + ((size_t)b * HW + qi) * vs + (size_t)h * dv + c0;
    });
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int qi;
      const bool qok = query(ch, col0 + j, qi);
      const int qy = qi / Wg, qx = qi - qy * Wg;
      const int dy = qy - ky, dx = qx - kx;
      float val = 0.f;
      if (qok && kok && dy >= -m && dy <= m && dx >= -m && dx <= m) {
        // the query at offset wk from the key sees the key at win2-1-wk
        const int wk = (dy + m) * win + (dx + m);
        val = src[(wbase + qi) * win2 + (win2 - 1 - wk)];
      }
      bf16 hi, lo;
      split_bf16(val, hi, lo);
      sHi[row * T::LP + col0 + j] = hi;
      sLo[row * T::LP + col0 + j] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ah,
          al;
      wmma::load_matrix_sync(ah, sHi + rt * 16 * T::LP + kk, T::LP);
      if (is_dk) wmma::load_matrix_sync(al, sLo + rt * 16 * T::LP + kk, T::LP);
#pragma unroll
      for (int t = 0; t < NF; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, sB + kk * T::LQ + (cb + t) * 16, T::LQ);
        wmma::mma_sync(acc[t], ah, bm, acc[t]);
        if (is_dk) wmma::mma_sync(acc[t], al, bm, acc[t]);
      }
    }
  }
  store_rows<D, NF>(smem, acc, rt, cb, is_dk ? scale : 1.f,
                    [&](int r) -> bf16* {
    const int y = y0 + r / TILE, x = x0 + r % TILE;
    if (y >= Hg || x >= Wg) return nullptr;
    const size_t ki = (size_t)b * HW + y * Wg + x;
    return is_dk ? dk + ki * qs + (size_t)h * D
                 : dvo + ki * vs + (size_t)h * dv + c0;
  });
}

template <int D>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* rel, const void* g, void* dq, void* dk,
                      void* dv_out, void* drel, void* p_scratch, int B,
                      int Hg, int Wg, int H, int dv, int m, float scale,
                      cudaStream_t stream) {
  constexpr int smem_q = BwdSmem<D>::bytes, smem_k = KeySmem<D>::bytes;
  auto kq = local_bwd_query_kernel<D>;
  auto kk = local_bwd_key_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_k);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hg + TILE - 1) / TILE) * ((Wg + TILE - 1) / TILE);
  kq<<<dim3(tiles, B * H), kThreads, smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rel,
      (const bf16*)g, (float*)p_scratch, (float*)drel, (bf16*)dq, Hg, Wg, H,
      dv, m, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kk<<<dim3(tiles, dv / D + 1, B * H), kThreads, smem_k, stream>>>(
      (const bf16*)q, (const bf16*)g, (const float*)p_scratch,
      (const float*)drel, (bf16*)dk, (bf16*)dv_out, Hg, Wg, H, dv, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace rmem

// The backward: q, k, dq, dk [B, HW, H x 128] and v, g, dv [B, HW, H x dv]
// bf16, rel head-major [B, H, HW, (2m+1)^2] bf16, drel and the p scratch
// head-major [B, H, HW, (2m+1)^2] f32. Returns the cudaError_t of the
// launches (0 on success); -1 for anything but 1 or 2 heads of 128 and dv
// (a head's values) a multiple of 128.
extern "C" int rmem_local_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* rel,
                                        const void* g, void* dq, void* dk,
                                        void* dv_out, void* drel,
                                        void* p_scratch, int B, int Hg,
                                        int Wg, int H, int dh, int dv,
                                        int max_dis, float scale,
                                        void* stream) {
  if ((H != 1 && H != 2) || dh != 128 || dv % 128 != 0) return -1;
  return rmem::launch_bwd<128>(q, k, v, rel, g, dq, dk, dv_out, drel,
                               p_scratch, B, Hg, Wg, H, dv, max_dis, scale,
                               (cudaStream_t)stream);
}

// The forward: q, k [B, HW, H x 128], v [B, HW, H x dv], rel head-major
// [B, H, HW, (2m+1)^2]; out [B, HW, H x dv] bf16. Returns the cudaError_t
// of the launch (0 on success); -1 for anything but 1 or 2 heads of 128, a
// 15 x 15 window (max_dis 7) and dv (a head's values) a multiple of the
// slice width.
extern "C" int rmem_local_attention(const void* q, const void* k,
                                    const void* v, const void* rel, void* out,
                                    int B, int Hg, int Wg, int H, int dh,
                                    int dv, int max_dis, float scale,
                                    void* stream) {
  if ((H != 1 && H != 2) || dh != rmem::FD || max_dis != rmem::M ||
      dv % rmem::FWD_DVB != 0)
    return -1;
  return rmem::launch_fwd<rmem::FWD_DVB, rmem::FWD_SPLIT>(
      q, k, v, rel, out, B, Hg, Wg, H, dv, scale, (cudaStream_t)stream);
}

// The forward's dv slice width.
extern "C" int rmem_local_attention_slice() { return rmem::FWD_DVB; }

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
// What bounds it on an H100: bytes. At the training shapes (B 4, 30 x 30, dh
// 128, dv 1024) q, k, v, rel and g are read once and dq, dk, dv and drel
// written once, ~31 MB (~9 us at 3.35 TB/s), against ~3.3 GFLOP of window
// pairs (~3.4 us at 989 TFLOP/s). It replaces two kernels that took 0.475 ms
// on an H100 at that shape: a query kernel of 64 blocks on 132 SMs that loaded
// and then computed with nothing in flight, reloaded K in three passes and G
// for each key chunk, and round-tripped p and dp through f32 scratch in window
// layout with 4-byte scattered stores; a key kernel that gathered them back
// value by value. This design computes dense halos (the cells within 7 of a
// tile, packed to those inside the image: 8 chunks of 64 for an inner 8 x 8
// tile, 4 at a corner) and recomputes S on the key side: 8.5-10 GFLOP of
// mma.sync products at the training shapes, each halo row read from L2 about 5
// times. The measurements that chose it are in PERF.md.
//   (a) The query side, bwd_query_kernel: one block a query tile of 8 columns
//       and ROWS / 8 rows, and (image, head), 8 warps. ROWS is 64, or 32 for
//       one head's 1024 values: 8 x 8 tiles would give 64 blocks at the
//       training shape, half of the card's SMs, and 4 x 8 tiles run in about
//       two thirds of their time. Every K chunk of the halo is requested at
//       once; S = Q K^T, chunk by chunk as each lands, scatters each logit
//       into the tile's window rows in shared memory ([ROWS x 225] f32); one
//       pass over those rows (a warp a row) adds the bias, read in the
//       caller's [B, HW, H x 225] layout, takes each row's lse (written out,
//       f32 [B, H, HW]: all the key side needs of p) and turns the row into p
//       in place. dp = G V^T then takes all the halo keys at once, warp w
//       holding keys 64 w .. +63 of every query in registers (2 ROWS f32 a
//       thread), while G's and V's value columns stream through a ring of
//       BWD_STAGES slices BWD_SW wide by cp.async (XOR-swizzled rows, keys
//       outside the image zero-filled), so G and V are each read once a tile.
//       delta is summed per warp, then over the warps in a fixed order; ds = p
//       (dp - delta) goes back into the window rows, written out once as drel
//       rows, and into a bf16 hi/lo pair [ROWS x 512] for dq = scale ds K (K
//       streamed again through three buffers): dq is a small difference of
//       large terms, the trap of the bank-attention backward. The per-entry
//       passes (the scatter, delta, ds) run without branches, so a warp's
//       shared-memory loads go out together. The products stay on mma.sync
//       m16n8k16 with register accumulators (K4's idiom): dp on wgmma
//       (m64n256k16, V K-major from the swizzled ring) made dp faster but the
//       kernel no faster, since its accumulator layout gives a thread 64 keys
//       of 2 queries where mma.sync gives 16 keys of 8, and the per-entry
//       passes index by key.
//   (b) The key side, bwd_key_kernel: one block an 8 x 8 key tile, (image,
//       head) and a role: dv over BWD_NVK value columns (dv / BWD_NVK blocks a
//       tile), or dk. The tile's halo queries stream by 64-query chunks
//       through a ring of BWD_KSTAGES. The dv role recomputes S^T = K Q^T and
//       P^T from the query side's lse and the bias; dv = P^T G. The dk role
//       re-indexes ds (drel) into the [keys x queries] ds^T tile as the hi/lo
//       pair; dk = scale ds^T Q. The bias and drel are read at the mirrored
//       offset (the key sits at 224 - w from a query that sits at w from it),
//       and only the 8 values of each tile row that a query's window holds:
//       its sub-row, as the 16-byte words that span it, re-indexed in shared
//       memory. This kernel's time moved with the bytes it reads (whole
//       900-byte rows were slower). No p or dp scratch: p lives only in the
//       query block's window rows and the key block's P^T tile.
// No atomics: every output element has one writer, and delta's partial sums
// are added in a fixed order, so two calls give the same bits. Heads (1 or 2
// of 128): both grids fold (image, head) into one axis; every tensor keeps its
// caller's [.., H x d] token rows, and a block reads and writes its head's
// columns in place (rel and drel too: no head-major copies).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stddef.h>

#include "mma_sync.cuh"

namespace rmem {

using bf16 = __nv_bfloat16;
using namespace rmem_mma;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int TILE = 8;  // TILE * TILE == BQ query rows per block

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

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

constexpr int kThreads = 256;                        // both backward kernels
constexpr float LN2 = 0.6931471805599453f;
// The query side's ring: value columns a slice, slices in flight; the key
// side's value columns a dv block (PERF.md has the sweep that chose them).
constexpr int BWD_SW = 64;
constexpr int BWD_STAGES = 2;
constexpr int BWD_NVK = 512;
constexpr int BWD_KSTAGES = 2;                       // the key side's ring

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// 16 bytes global -> shared, of which the first `bytes` (0 to 16) are read
// and the rest zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16n(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// Element offset of row r's 16-byte segment s in a ring slice of SW bf16 a
// row: the segments are XOR-swizzled so that ldmatrix's 8 rows of one
// segment fall in 8 distinct bank groups.
template <int SW>
__device__ __forceinline__ int swz(int r, int s) {
  constexpr int P = SW / 8;                          // segments a row
  return r * SW + 8 * (s ^ ((r / (8 / P)) % P));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned split_pair(float x0, float x1,
                                               unsigned& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
  __nv_bfloat162 hi;
  hi.x = h0;
  hi.y = h1;
  return *reinterpret_cast<unsigned*>(&hi);
}

// The halo cells of the th x 8 tile at (y0, x0) that lie inside the image,
// packed: cell i < n holds its row and column in the halo (hy << 5 | hx),
// the rest NO_KEY. Returns n, the cells of the halo's rectangle inside the
// image: a tile at the image's edge has fewer 64-cell chunks.
__device__ __forceinline__ int fill_halo(short* sH, int y0, int x0, int Hg,
                                         int Wg, int th) {
  const int hy0 = max(0, M - y0), hy1 = min(th + 2 * M - 1, Hg - 1 - y0 + M);
  const int hx0 = max(0, M - x0), hx1 = min(HALO - 1, Wg - 1 - x0 + M);
  const int nx = hx1 - hx0 + 1, n = (hy1 - hy0 + 1) * nx;
  for (int i = threadIdx.x; i < NCH * BK; i += kThreads)
    sH[i] = i < n ? (short)((hy0 + i / nx) << 5 | (hx0 + i % nx)) : NO_KEY;
  return n;
}

// cp_wait with a run-time count of groups left in flight (0 to NCH)
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    case 7: cp_wait<7>(); break;
    default: cp_wait<8>(); break;
  }
}

template <int SW, int STAGES, int ROWS>
struct QuerySmem {
  static constexpr int LW = 228;                     // f32 pitch, window rows
  static constexpr int LP = NCH * BK + 8;            // bf16 pitch, ds pair
  static constexpr int KBUF = BK * LQF * 2;          // one K chunk
  static constexpr int STAGE = (ROWS + NCH * BK) * SW * 2;   // G + V slices
  static constexpr int w_off = 0;         // window rows (Q before them)
  static constexpr int r_off = w_off + ROWS * LW * 4;  // the region below:
  static constexpr int k_off = r_off;     // S's K chunks, all of them; then
  static constexpr int ring_off = r_off;  // the ring; then the ds pair
  static constexpr int pair = 2 * ROWS * LP * 2;
  // dq's three K buffers: over the window rows where they fit, else after
  // the ds pair
  static constexpr int kd_off = 3 * KBUF <= ROWS * LW * 4 ? w_off
                                                           : r_off + pair;
  static constexpr int r_bytes =
      cmax(cmax(NCH * KBUF, STAGES * STAGE),
           kd_off == w_off ? pair : pair + 3 * KBUF);
  static constexpr int h_off = r_off + r_bytes;      // halo table
  static constexpr int red_off = h_off + NCH * BK * 2;   // [8 warps][ROWS] f32
  static constexpr int bytes = red_off + 8 * ROWS * 4;
  static_assert(ROWS == 32 || ROWS == 64, "tiles of 4 or 8 rows");
  static_assert(ROWS * LQF * 2 <= ROWS * LW * 4, "Q fits in the window rows");
  static_assert(SW == 16 || SW == 32 || SW == 64, "swizzled slice widths");
  static_assert(r_off % 16 == 0 && ring_off % 16 == 0 && STAGE % 16 == 0 &&
                pair % 16 == 0 && h_off % 16 == 0, "16-byte rows");
  static_assert(bytes <= 232448, "shared memory of one block");
};

// (a) The query side of one tile of ROWS / 8 rows x 8 of image b, head h
// (blockIdx.y = b H + h): lse [B, H, HW] f32, drel [B, HW, H x 225] f32
// (ds), dq [B, HW, H x 128] bf16. q, k [B, HW, H x 128], v, g [B, HW,
// H x DV], rel [B, HW, H x 225] bf16.
template <int DV, int SW, int STAGES, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ rel,
                 const bf16* __restrict__ g, bf16* __restrict__ dq,
                 float* __restrict__ drel, float* __restrict__ lse_out,
                 int Hg, int Wg, int H, float scale) {
  using L = QuerySmem<SW, STAGES, ROWS>;
  constexpr int LW = L::LW, LP = L::LP;
  constexpr int RT = ROWS / 16;                      // 16-row tiles
  constexpr int KW = 8 * RT;                         // S's keys of a warp
  constexpr int CQ = 16 * RT;                        // dq's columns of a warp
  constexpr int NST = DV / SW;                       // value slices
  constexpr int SLICE = L::STAGE / 2;                // bf16 a ring slot
  static_assert(DV % SW == 0 && NST >= STAGES - 1, "the ring's slices");
  extern __shared__ __align__(128) char smem[];
  float* sW = reinterpret_cast<float*>(smem + L::w_off);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::w_off);
  bf16* sKd = reinterpret_cast<bf16*>(smem + L::kd_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sRing = reinterpret_cast<bf16*>(smem + L::ring_off);
  bf16* sHi = reinterpret_cast<bf16*>(smem + L::r_off);
  bf16* sLo = sHi + ROWS * LP;
  short* sH = reinterpret_cast<short*>(smem + L::h_off);
  float* sRed = reinterpret_cast<float*>(smem + L::red_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int tiles_x = (Wg + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_x) * (ROWS / TILE);
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int h = blockIdx.y % H;
  const size_t base = (size_t)(blockIdx.y / H) * Hg * Wg;  // image's token 0
  // token strides, and the head's columns within a token's row
  const size_t qs = (size_t)H * FD, vs = (size_t)H * DV, rs = (size_t)H * WIN2;
  q += (size_t)h * FD;
  k += (size_t)h * FD;
  dq += (size_t)h * FD;
  v += (size_t)h * DV;
  g += (size_t)h * DV;
  rel += (size_t)h * WIN2;
  drel += (size_t)h * WIN2;  // ds out
  lse_out += (size_t)blockIdx.y * Hg * Wg;
  const float scale_log2 = scale * LOG2E;

  const int nch = (fill_halo(sH, y0, x0, Hg, Wg, ROWS / TILE) + BK - 1) / BK;
  __syncthreads();  // sH is read by every thread's copies
  auto key_at = [&](int hj, int& idx) {
    const int hk = sH[hj];
    idx = (y0 - M + (hk >> 5)) * Wg + x0 - M + (hk & 31);
    if (hk == NO_KEY) idx = 0;
    return hk != NO_KEY;
  };
  auto load_k = [&](int c, bf16* dst) {              // K chunk c, pitch LQF
    for (int i = tid; i < BK * (FD / 8); i += kThreads) {
      const int j = i / (FD / 8), s8 = i % (FD / 8);
      int idx;
      const bool ok = key_at(c * BK + j, idx);
      cp_async16(dst + j * LQF + s8 * 8, k + (base + idx) * qs + s8 * 8, ok);
    }
  };
  // value columns st SW .. +SW of the tile's G rows and the halo's V rows
  auto load_slice = [&](int st, int slot) {
    constexpr int P = SW / 8;
    bf16* dG = sRing + slot * SLICE;
    bf16* dV = dG + ROWS * SW;
    const int c0 = st * SW;
    for (int i = tid; i < ROWS * P; i += kThreads) {
      const int r = i / P, s = i % P;
      const int qy = y0 + r / TILE, qx = x0 + r % TILE;
      const bool ok = qy < Hg && qx < Wg;
      cp_async16(dG + swz<SW>(r, s),
                 g + (base + (ok ? qy * Wg + qx : 0)) * vs + c0 + s * 8, ok);
    }
    for (int i = tid; i < nch * BK * P; i += kThreads) {
      const int j = i / P, s = i % P;
      int idx;
      const bool ok = key_at(j, idx);
      cp_async16(dV + swz<SW>(j, s), v + (base + idx) * vs + c0 + s * 8, ok);
    }
  };

  // ---- Q, then every K chunk of the halo, each its own group ----
  for (int i = tid; i < ROWS * (FD / 8); i += kThreads) {
    const int r = i / (FD / 8), s8 = i % (FD / 8);
    const int qy = y0 + r / TILE, qx = x0 + r % TILE;
    const bool ok = qy < Hg && qx < Wg;
    cp_async16(sQ + r * LQF + s8 * 8,
               q + (base + (ok ? qy * Wg + qx : 0)) * qs + s8 * 8, ok);
  }
  cp_commit();
  for (int c = 0; c < NCH; ++c) {
    if (c < nch) load_k(c, sK + c * BK * LQF);
    cp_commit();
  }
  cp_wait<NCH>();
  __syncthreads();  // Q is in
  // S's warps: row tile rt (queries 16 rt .. +16: tile rows 2 rt and 2 rt +
  // 1, column gq) and keys KW kh .. +KW of each chunk
  const int rt = warp % RT, kh = warp / RT;
  unsigned qf[FD / 16][4];
#pragma unroll
  for (int ks = 0; ks < FD / 16; ++ks)
    ldsm_x4(qf[ks], sQ + (rt * 16 + (lane & 15)) * LQF + ks * 16 +
                        (lane >> 4) * 8);
  __syncthreads();  // Q's rows become the window rows
  for (int i = tid; i < ROWS * LW; i += kThreads) sW[i] = -INFINITY;

  // ---- S = Q K^T by chunks, each logit (log2 units, no bias yet) into its
  // query's window row; keys outside the image keep -inf ----
  for (int c = 0; c < nch; ++c) {
    cp_wait_upto(NCH - 1 - c);
    __syncthreads();  // chunk c is in; the window rows are initialised
    const bf16* cK = sK + c * BK * LQF;
    float sc[KW / 8][4];
#pragma unroll
    for (int i = 0; i < KW / 8; ++i)
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < FD / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < KW / 16; ++np) {
        unsigned kb[4];
        ldsm_x4(kb, cK + (kh * KW + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                             LQF + ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(sc[2 * np], qf[ks], kb[0], kb[1]);
        mma16816(sc[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hk = sH[c * BK + kh * KW + nt * 8 + 2 * t + e];
        const int wx = (hk & 31) - gq, wy0 = (hk >> 5) - 2 * rt;
        if ((unsigned)wx >= WIN) continue;           // also NO_KEY
        if ((unsigned)wy0 < WIN)
          sW[(rt * 16 + gq) * LW + wy0 * WIN + wx] = sc[nt][e] * scale_log2;
        if ((unsigned)(wy0 - 1) < WIN)
          sW[(rt * 16 + gq + 8) * LW + (wy0 - 1) * WIN + wx] =
              sc[nt][e + 2] * scale_log2;
      }
    }
  }
  __syncthreads();  // the K chunks' region takes the ring
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_slice(s, s);
    cp_commit();
  }

  // ---- each window row: + bias, its lse, p in place (a warp a row). A
  // query inside the image always has its own key; a row past the image's
  // edge is all zeros ----
  bf16 bias[ROWS / 8][8];  // this warp's rows' bias, all loads in flight
#pragma unroll
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp + 8 * rr;
    const int qy = y0 + r / TILE, qx = x0 + r % TILE;
    const bf16* brow = rel + (base + (qy < Hg && qx < Wg ? qy * Wg + qx : 0)) *
                                 rs;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < WIN2) bias[rr][i] = brow[lane + 32 * i];
  }
#pragma unroll
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp + 8 * rr;
    float* row = sW + r * LW;
    const int qy = y0 + r / TILE, qx = x0 + r % TILE;
    if (qy >= Hg || qx >= Wg) {
      for (int w = lane; w < WIN2; w += 32) row[w] = 0.f;
      continue;
    }
    float x[8];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int w = lane + 32 * i;
      x[i] = w < WIN2 ? row[w] + __bfloat162float(bias[rr][i]) * LOG2E
                      : -INFINITY;
      mx = fmaxf(mx, x[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += exp2f(x[i] - mx);
    const float lse2 = mx + log2f(warp_sum(sum));
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < WIN2) row[lane + 32 * i] = exp2f(x[i] - lse2);
    if (lane == 0) lse_out[qy * Wg + qx] = lse2 * LN2;
  }

  // ---- dp = G V^T: warp w holds keys 64 w .. +64 of all ROWS queries; the
  // value columns stream through the ring ----
  float acc[RT][8][4];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[a][nt][0] = acc[a][nt][1] = acc[a][nt][2] = acc[a][nt][3] = 0.f;
#pragma unroll 1
  for (int st = 0; st < NST; ++st) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // slice st is in; slot (st - 1) % STAGES is free
    if (st + STAGES - 1 < NST)
      load_slice(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_commit();
    const bf16* cG = sRing + (st % STAGES) * SLICE;
    const bf16* cV = cG + ROWS * SW;
    if (warp >= nch) continue;  // this warp's keys all lie outside the image
#pragma unroll
    for (int ks = 0; ks < SW / 16; ++ks) {
      unsigned vb[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4(vb[np], cV + swz<SW>(warp * 64 + np * 16 + (lane & 7) +
                                         (lane >> 4) * 8,
                                     2 * ks + ((lane >> 3) & 1)));
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        unsigned ga[4];
        ldsm_x4(ga, cG + swz<SW>(a * 16 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma16816(acc[a][2 * np], ga, vb[np][0], vb[np][1]);
          mma16816(acc[a][2 * np + 1], ga, vb[np][2], vb[np][3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the ds pair goes over it

  // this thread's entries: query 16 a + gq + 8 (e >> 1) (tile row 2 a +
  // (e >> 1), column gq) and key 64 warp + 8 nt + 2 t + (e & 1). The loops
  // take a key pair (nt) outermost, so only its halo cells stay live
  // besides the accumulators. An entry's place in the window rows, and
  // whether it is a window key inside the image (else the row's first
  // place, read and ignored: no branch, so a warp's loads go out together)
  auto entry = [&](int hk, int a, int e, float*& at) {
    const int wy = (hk >> 5) - 2 * a - (e >> 1), wx = (hk & 31) - gq;
    const bool ok = (unsigned)wy < WIN && (unsigned)wx < WIN;
    at = sW + (a * 16 + gq + 8 * (e >> 1)) * LW + (ok ? wy * WIN + wx : 0);
    return ok;
  };
  // ---- delta: each warp's share of each row, then the warps' shares in a
  // fixed order ----
  float dl[RT][2];
#pragma unroll
  for (int a = 0; a < RT; ++a) dl[a][0] = dl[a][1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int hk0 = sH[warp * 64 + nt * 8 + 2 * t];
    const int hk1 = sH[warp * 64 + nt * 8 + 2 * t + 1];
#pragma unroll
    for (int a = 0; a < RT; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* at;
        const bool ok = entry(e & 1 ? hk1 : hk0, a, e, at);
        const float p = *at;
        dl[a][e >> 1] += ok ? p * acc[a][nt][e] : 0.f;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const float pd0 = quad_sum(dl[a][0]), pd1 = quad_sum(dl[a][1]);
    if (t == 0) {
      sRed[warp * ROWS + a * 16 + gq] = pd0;
      sRed[warp * ROWS + a * 16 + gq + 8] = pd1;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < RT; ++a) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += sRed[w * ROWS + a * 16 + gq + 8 * e];
      dl[a][e] = s;
    }
  }

  // ---- ds = p (dp - delta): into the window rows (drel) and the hi / lo
  // pair [query x halo key] ----
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int hk0 = sH[warp * 64 + nt * 8 + 2 * t];
    const int hk1 = sH[warp * 64 + nt * 8 + 2 * t + 1];
    const int col = warp * 64 + nt * 8 + 2 * t;
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* at;
        const bool ok = entry(e & 1 ? hk1 : hk0, a, e, at);
        const float p = *at;
        ds[e] = ok ? p * (acc[a][nt][e] - dl[a][e >> 1]) : 0.f;
        if (ok) *at = ds[e];
      }
      unsigned lo0, lo1;
      const unsigned hi0 = split_pair(ds[0], ds[1], lo0);
      const unsigned hi1 = split_pair(ds[2], ds[3], lo1);
      *reinterpret_cast<unsigned*>(sHi + (a * 16 + gq) * LP + col) = hi0;
      *reinterpret_cast<unsigned*>(sLo + (a * 16 + gq) * LP + col) = lo0;
      *reinterpret_cast<unsigned*>(sHi + (a * 16 + gq + 8) * LP + col) = hi1;
      *reinterpret_cast<unsigned*>(sLo + (a * 16 + gq + 8) * LP + col) = lo1;
    }
  }
  __syncthreads();

  // ---- drel: the window rows, once, in the caller's layout ----
  for (int r = warp; r < ROWS; r += 8) {
    const int qy = y0 + r / TILE, qx = x0 + r % TILE;
    if (qy >= Hg || qx >= Wg) continue;
    float* dst = drel + (base + qy * Wg + qx) * rs;
    for (int w = lane; w < WIN2; w += 32) dst[w] = sW[r * LW + w];
  }
  __syncthreads();  // the window rows are free for dq's K chunks

  // ---- dq = scale ds K: warp rows 16 rt .. +16, columns CQ kh .. +CQ ----
  float dacc[CQ / 8][4];
#pragma unroll
  for (int nt = 0; nt < CQ / 8; ++nt)
    dacc[nt][0] = dacc[nt][1] = dacc[nt][2] = dacc[nt][3] = 0.f;
  for (int c = 0; c < 2; ++c) {
    if (c < nch) load_k(c, sKd + c * BK * LQF);
    cp_commit();
  }
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    cp_wait<1>();
    __syncthreads();  // chunk c is in; chunk c - 1's slot is free
    if (c + 2 < nch) load_k(c + 2, sKd + ((c + 2) % 3) * BK * LQF);
    cp_commit();
    const bf16* cK = sKd + (c % 3) * BK * LQF;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ah[4], al[4];
      const int off = (rt * 16 + (lane & 15)) * LP + c * BK + kk * 16 +
                      (lane >> 4) * 8;
      ldsm_x4(ah, sHi + off);
      ldsm_x4(al, sLo + off);
#pragma unroll
      for (int np = 0; np < CQ / 16; ++np) {
        unsigned kb[4];
        ldsm_x4_t(kb, cK + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LQF + kh * CQ + np * 16 + (lane >> 4) * 8);
        mma16816(dacc[2 * np], ah, kb[0], kb[1]);
        mma16816(dacc[2 * np], al, kb[0], kb[1]);
        mma16816(dacc[2 * np + 1], ah, kb[2], kb[3]);
        mma16816(dacc[2 * np + 1], al, kb[2], kb[3]);
      }
    }
  }
  const float dq_mul = scale;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qy = y0 + 2 * rt + e, qx = x0 + gq;
    if (qy >= Hg || qx >= Wg) continue;
    bf16* dst = dq + (base + qy * Wg + qx) * qs + kh * CQ + 2 * t;
#pragma unroll
    for (int nt = 0; nt < CQ / 8; ++nt)
      *reinterpret_cast<unsigned*>(dst + nt * 8) = pack_bf16(
          dacc[nt][2 * e] * dq_mul, dacc[nt][2 * e + 1] * dq_mul);
  }
}

template <int NVK, int KS>
struct KeySmem {
  static constexpr int LG = NVK + 8;                 // bf16 pitch of G
  static constexpr int LPT = BK + 8;             // bf16 pitch, [key x query]
  // a sub-row (8 values of one tile row at the mirrored offsets) as the
  // 16-byte words that span it: bf16 bias 2, f32 drel 3
  static constexpr int BSUB = 32, DSUB = 48;
  static constexpr int QB = BK * LQF * 2;            // a chunk of Q rows
  static constexpr int OB = BK * TILE * 4;           // [64 x 8] sub-row starts
  static constexpr int PT = BQ * LPT * 2;            // a [key x query] tile
  // the dv role: a ring of (Q, G, the bias sub-rows, their starts, lse)
  // (the K tile in its last slot before the first chunks), P^T
  static constexpr int GB = BK * LG * 2, BB = BK * TILE * BSUB;
  static constexpr int dv_stage = QB + GB + BB + OB + BK * 4;
  static constexpr int dv_pt = KS * dv_stage;
  // the dk role: a ring of (Q, the drel sub-rows, their starts), the ds^T
  // pair
  static constexpr int dk_stage = QB + BK * TILE * DSUB + OB;
  static constexpr int dk_hi = KS * dk_stage, dk_lo = dk_hi + PT;
  static constexpr int h_off = cmax(dv_pt + PT, dk_lo + PT);
  static constexpr int bytes = h_off + NCH * BK * 2;
  static_assert(dv_stage % 16 == 0 && dk_stage % 16 == 0 && GB % 16 == 0,
                "16-byte rows");
  static_assert(KS >= 2 && QB <= dv_stage, "the K tile fits in a slot");
  static_assert(bytes <= 232448, "shared memory of one block");
};

// (b) The key side of one 8 x 8 key tile of image b, head h (blockIdx.z =
// b H + h): dv [B, HW, H x DV] for value columns blockIdx.y NVK .. +NVK
// while blockIdx.y < DV / NVK, dk [B, HW, H x 128] for the last. lse
// [B, H, HW] and drel [B, HW, H x 225] f32 from the query side.
template <int DV, int NVK, int KS>
__global__ void __launch_bounds__(kThreads, 1)
bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ rel, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ drel,
               bf16* __restrict__ dk, bf16* __restrict__ dvo, int Hg, int Wg,
               int H, float scale) {
  using L = KeySmem<NVK, KS>;
  constexpr int LPT = L::LPT, LG = L::LG;
  constexpr int CW = NVK / 4;                        // dv columns of a warp
  static_assert(DV % NVK == 0 && CW % 16 == 0, "dv blocks");
  extern __shared__ __align__(128) char smem[];
  short* sH = reinterpret_cast<short*>(smem + L::h_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int tiles_x = (Wg + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_x) * TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int h = blockIdx.z % H;
  const size_t HW = (size_t)Hg * Wg;
  const size_t base = (size_t)(blockIdx.z / H) * HW;
  const size_t qs = (size_t)H * FD, vs = (size_t)H * DV, rs = (size_t)H * WIN2;
  // the ends of rel and drel: a sub-row's aligned span may reach past them
  const char* rel_lo = reinterpret_cast<const char*>(rel);
  const char* drel_lo = reinterpret_cast<const char*>(drel);
  const char* rel_hi = rel_lo + (size_t)gridDim.z * HW * WIN2 * 2;
  const char* drel_hi = drel_lo + (size_t)gridDim.z * HW * WIN2 * 4;
  q += (size_t)h * FD;
  k += (size_t)h * FD;
  dk += (size_t)h * FD;
  g += (size_t)h * DV;
  dvo += (size_t)h * DV;
  rel += (size_t)h * WIN2;
  drel += (size_t)h * WIN2;  // ds in
  lse += (size_t)blockIdx.z * HW;
  const bool is_dk = (int)blockIdx.y == DV / NVK;

  const int nch = (fill_halo(sH, y0, x0, Hg, Wg, TILE) + BK - 1) / BK;
  __syncthreads();
  auto query_at = [&](int hj, int& idx) {
    const int hq = sH[hj];
    idx = (y0 - M + (hq >> 5)) * Wg + x0 - M + (hq & 31);
    if (hq == NO_KEY) idx = 0;
    return hq != NO_KEY;
  };
  // Q rows of chunk c (pitch LQF)
  auto load_q = [&](int c, bf16* dst) {
    for (int i = tid; i < BK * (FD / 8); i += kThreads) {
      const int j = i / (FD / 8), s8 = i % (FD / 8);
      int idx;
      const bool ok = query_at(c * BK + j, idx);
      cp_async16(dst + j * LQF + s8 * 8, q + (base + idx) * qs + s8 * 8, ok);
    }
  };
  // The mirrored offsets: the query at halo cell hq sits at w from key
  // (ty, tx) when the key sits at w' = 224 - w from the query, that is at
  // window row ty - hy + 14 and column tx - hx + 14. row_at: w' of key
  // (ty, 0), the first of the 8 keys of tile row ty, consecutive in the
  // query's row of 225 (it may lie outside the window: those keys are
  // masked); in_window: whether key (ty, tx) is in the query's window and
  // inside the image.
  auto row_at = [&](int ty, int hq) {
    return (ty - (hq >> 5) + 2 * M) * WIN + 2 * M - (hq & 31);
  };
  auto in_window = [&](int ty, int tx, int hq) {
    const int wy = ty - (hq >> 5) + 2 * M, wx = tx - (hq & 31) + 2 * M;
    return y0 + ty < Hg && x0 + tx < Wg && (unsigned)wy < WIN &&
           (unsigned)wx < WIN;
  };
  // chunk c's sub-rows of a [B, HW, H x 225] tensor of `elem`-byte values
  // [lo, hi): for query j and tile row ty, the 8 values at row_at(ty) ..
  // +8 of the query's row, as the `words` 16-byte words that span them
  // (none where the tile row lies outside the query's window, or the
  // query outside the image); offs[8 j + ty] = where the first value
  // starts in them
  auto load_sub = [&](int c, const char* src, const char* lo,
                      const char* hi, int elem, int words, char* dst,
                      int* offs) {
    for (int i = tid; i < BK * TILE * words; i += kThreads) {
      const int jt = i / words, wd = i - jt * words;
      const int hq = sH[c * BK + (jt >> 3)], ty = jt & 7;
      const int idx = (y0 - M + (hq >> 5)) * Wg + x0 - M + (hq & 31);
      const bool ok = hq != NO_KEY && (unsigned)(ty - (hq >> 5) + 2 * M) < WIN;
      const char* p0 =
          src + ((ptrdiff_t)((base + (ok ? idx : 0)) * rs) + row_at(ty, hq)) *
                    elem;
      const char* at = reinterpret_cast<const char*>(
          (reinterpret_cast<uintptr_t>(p0) & ~(uintptr_t)15) + 16 * wd);
      const ptrdiff_t left = hi - at;
      const int n = !ok || at < lo || left <= 0 ? 0 : left < 16 ? (int)left
                                                                 : 16;
      cp_async16n(dst + jt * 16 * words + 16 * wd, n > 0 ? at : lo, n);
      if (wd == 0) offs[jt] = (int)(reinterpret_cast<uintptr_t>(p0) & 15);
    }
  };
  // this thread's keys in the [key x query] tiles: rows 16 kr + gq and + 8
  // (tile rows 2 kr, 2 kr + 1, column gq)
  const int kr = warp & 3, qh = warp >> 2;

  if (!is_dk) {
    // ---- the dv role: P^T = exp(S^T + bias - lse) by chunks, dv = P^T G
    bf16* sK = reinterpret_cast<bf16*>(smem + (KS - 1) * L::dv_stage);
    bf16* sPT = reinterpret_cast<bf16*>(smem + L::dv_pt);
    const int c0 = blockIdx.y * NVK;
    auto stage = [&](int s) { return smem + s * L::dv_stage; };
    auto load_chunk = [&](int c, int s) {
      char* st = stage(s);
      load_q(c, reinterpret_cast<bf16*>(st));
      bf16* dG = reinterpret_cast<bf16*>(st + L::QB);
      for (int i = tid; i < BK * (NVK / 8); i += kThreads) {
        const int j = i / (NVK / 8), s8 = i % (NVK / 8);
        int idx;
        const bool ok = query_at(c * BK + j, idx);
        cp_async16(dG + j * LG + s8 * 8, g + (base + idx) * vs + c0 + s8 * 8,
                   ok);
      }
      char* dB = st + L::QB + L::GB;
      load_sub(c, reinterpret_cast<const char*>(rel), rel_lo, rel_hi, 2,
               L::BSUB / 16, dB, reinterpret_cast<int*>(dB + L::BB));
      float* dL = reinterpret_cast<float*>(dB + L::BB + L::OB);
      for (int j = tid; j < BK; j += kThreads) {
        int idx;
        const bool ok = query_at(c * BK + j, idx);
        cp_async4(dL + j, lse + idx, ok ? 4 : 0);
      }
    };
    for (int i = tid; i < BQ * (FD / 8); i += kThreads) {
      const int r = i / (FD / 8), s8 = i % (FD / 8);
      const int ky = y0 + r / TILE, kx = x0 + r % TILE;
      const bool ok = ky < Hg && kx < Wg;
      cp_async16(sK + r * LQF + s8 * 8,
                 k + (base + (ok ? ky * Wg + kx : 0)) * qs + s8 * 8, ok);
    }
    cp_commit();
    for (int s = 0; s < KS - 1; ++s) {
      if (s < nch) load_chunk(s, s);
      cp_commit();
    }
    cp_wait<KS - 1>();
    __syncthreads();  // the K tile is in (its slot is refilled after the
                      // first chunk's barrier)
    unsigned kf[FD / 16][4];
#pragma unroll
    for (int ks = 0; ks < FD / 16; ++ks)
      ldsm_x4(kf[ks], sK + (kr * 16 + (lane & 15)) * LQF + ks * 16 +
                          (lane >> 4) * 8);
    const float scale_log2 = scale * LOG2E;
    // dv's warps: keys 32 (warp & 1) .. +32, columns CW (warp >> 1) .. +CW
    const int km = warp & 1, cn = (warp >> 1) * CW;
    float acc[2][CW / 8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt)
        acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      cp_wait<KS - 2>();
      __syncthreads();  // chunk c is in; P^T and chunk c - 1's slot are free
      if (c + KS - 1 < nch) load_chunk(c + KS - 1, (c + KS - 1) % KS);
      cp_commit();
      const char* st = stage(c % KS);
      const bf16* cQ = reinterpret_cast<const bf16*>(st);
      const bf16* cG = reinterpret_cast<const bf16*>(st + L::QB);
      const char* cB = st + L::QB + L::GB;
      const int* cO = reinterpret_cast<const int*>(cB + L::BB);
      const float* cL = reinterpret_cast<const float*>(cB + L::BB + L::OB);
      // S^T: keys 16 kr .. +16, queries 32 qh .. +32 of the chunk
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < FD / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned qb[4];
          ldsm_x4(qb, cQ + (qh * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                               LQF + ks * 16 + ((lane >> 3) & 1) * 8);
          mma16816(sc[2 * np], kf[ks], qb[0], qb[1]);
          mma16816(sc[2 * np + 1], kf[ks], qb[2], qb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // every sub-row's start and lse are set (zeros past the image),
          // so the reads need no branch
          const int j = qh * 32 + nt * 8 + 2 * t + (e & 1);
          const int ty = 2 * kr + (e >> 1), jt = j * TILE + ty;
          const float bias = __bfloat162float(*reinterpret_cast<const bf16*>(
              cB + jt * L::BSUB + cO[jt] + 2 * gq));
          const float x = exp2f(sc[nt][e] * scale_log2 +
                                (bias - cL[j]) * LOG2E);
          p[e] = in_window(ty, gq, sH[c * BK + j]) ? x : 0.f;
        }
        const int col = qh * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<unsigned*>(sPT + (kr * 16 + gq) * LPT + col) =
            pack_bf16(p[0], p[1]);
        *reinterpret_cast<unsigned*>(sPT + (kr * 16 + gq + 8) * LPT + col) =
            pack_bf16(p[2], p[3]);
      }
      __syncthreads();  // P^T is whole
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pa[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldsm_x4(pa[m], sPT + (km * 32 + m * 16 + (lane & 15)) * LPT +
                             kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < CW / 16; ++np) {
          unsigned gb[4];
          ldsm_x4_t(gb, cG + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LG + cn + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma16816(acc[m][2 * np], pa[m], gb[0], gb[1]);
            mma16816(acc[m][2 * np + 1], pa[m], gb[2], gb[3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = km * 32 + m * 16 + gq + 8 * e;
        const int ky = y0 + r / TILE, kx = x0 + r % TILE;
        if (ky >= Hg || kx >= Wg) continue;
        bf16* dst = dvo + (base + ky * Wg + kx) * vs + c0 + cn + 2 * t;
#pragma unroll
        for (int nt = 0; nt < CW / 8; ++nt)
          *reinterpret_cast<unsigned*>(dst + nt * 8) =
              pack_bf16(acc[m][nt][2 * e], acc[m][nt][2 * e + 1]);
      }
    }
    return;
  }

  // ---- the dk role: ds^T from the drel rows by chunks, dk = scale ds^T Q
  bf16* sHi = reinterpret_cast<bf16*>(smem + L::dk_hi);
  bf16* sLo = reinterpret_cast<bf16*>(smem + L::dk_lo);
  auto stage = [&](int s) { return smem + s * L::dk_stage; };
  auto load_chunk = [&](int c, int s) {
    char* st = stage(s);
    load_q(c, reinterpret_cast<bf16*>(st));
    load_sub(c, reinterpret_cast<const char*>(drel), drel_lo, drel_hi, 4,
             L::DSUB / 16, st + L::QB,
             reinterpret_cast<int*>(st + L::QB + BK * TILE * L::DSUB));
  };
  // the re-indexing: key r = tid / 4 (tile row r / 8, column r % 8),
  // queries 16 (tid % 4) .. +16 of the chunk
  const int rk = tid >> 2, jq = (tid & 3) * 16;
  // dk's warps: keys 32 (warp & 1) .. +32, columns 32 (warp >> 1) .. +32
  const int km = warp & 1, cn = (warp >> 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;
  for (int s = 0; s < KS - 1; ++s) {
    if (s < nch) load_chunk(s, s);
    cp_commit();
  }
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    cp_wait<KS - 2>();
    __syncthreads();  // chunk c is in; the ds^T pair and chunk c - 1's slot
                      // are free
    if (c + KS - 1 < nch) load_chunk(c + KS - 1, (c + KS - 1) % KS);
    cp_commit();
    const char* st = stage(c % KS);
    const bf16* cQ = reinterpret_cast<const bf16*>(st);
    const char* cD = st + L::QB;
    const int* cO = reinterpret_cast<const int*>(cD + BK * TILE * L::DSUB);
    __align__(16) unsigned hi[8], lo[8];
#pragma unroll
    for (int jj = 0; jj < 16; jj += 2) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = jq + jj + e, jt = j * TILE + rk / TILE;
        const float x = *reinterpret_cast<const float*>(
            cD + jt * L::DSUB + cO[jt] + 4 * (rk % TILE));
        ds[e] = in_window(rk / TILE, rk % TILE, sH[c * BK + j]) ? x : 0.f;
      }
      hi[jj / 2] = split_pair(ds[0], ds[1], lo[jj / 2]);
    }
    uint4* dh = reinterpret_cast<uint4*>(sHi + rk * LPT + jq);
    uint4* dl = reinterpret_cast<uint4*>(sLo + rk * LPT + jq);
    dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    __syncthreads();  // the ds^T pair is whole
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int off = (km * 32 + m * 16 + (lane & 15)) * LPT + kk * 16 +
                        (lane >> 4) * 8;
        ldsm_x4(ah[m], sHi + off);
        ldsm_x4(al[m], sLo + off);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned qb[4];
        ldsm_x4_t(qb, cQ + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LQF + cn + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma16816(acc[m][2 * np], ah[m], qb[0], qb[1]);
          mma16816(acc[m][2 * np], al[m], qb[0], qb[1]);
          mma16816(acc[m][2 * np + 1], ah[m], qb[2], qb[3]);
          mma16816(acc[m][2 * np + 1], al[m], qb[2], qb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = km * 32 + m * 16 + gq + 8 * e;
      const int ky = y0 + r / TILE, kx = x0 + r % TILE;
      if (ky >= Hg || kx >= Wg) continue;
      bf16* dst = dk + (base + ky * Wg + kx) * qs + cn + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<unsigned*>(dst + nt * 8) = pack_bf16(
            acc[m][nt][2 * e] * scale, acc[m][nt][2 * e + 1] * scale);
    }
  }
}

template <int DV>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* rel, const void* g, void* dq, void* dk,
                      void* dv_out, void* drel, void* lse, int B, int Hg,
                      int Wg, int H, float scale, cudaStream_t stream) {
  // one head's values (1024) in 8-row tiles give the query side a block per
  // 8 x 8 tile and image, half of the card's SMs at the training shape:
  // 4-row tiles double the blocks, each reading its V halo once more
  constexpr int rows = DV >= 1024 ? 32 : 64;
  constexpr int smem_q = QuerySmem<BWD_SW, BWD_STAGES, rows>::bytes;
  constexpr int smem_k = KeySmem<BWD_NVK, BWD_KSTAGES>::bytes;
  auto kq = bwd_query_kernel<DV, BWD_SW, BWD_STAGES, rows>;
  auto kk = bwd_key_kernel<DV, BWD_NVK, BWD_KSTAGES>;
  static bool configured = false;     // once per process and instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_k);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int th = rows / TILE;
  const int tiles = ((Hg + TILE - 1) / TILE) * ((Wg + TILE - 1) / TILE);
  kq<<<dim3(((Hg + th - 1) / th) * ((Wg + TILE - 1) / TILE), B * H), kThreads,
         smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rel,
      (const bf16*)g, (bf16*)dq, (float*)drel, (float*)lse, Hg, Wg, H, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kk<<<dim3(tiles, DV / BWD_NVK + 1, B * H), kThreads, smem_k, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)rel, (const bf16*)g,
      (const float*)lse, (const float*)drel, (bf16*)dk, (bf16*)dv_out, Hg,
      Wg, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace rmem

// The backward: q, k, dq, dk [B, HW, H x 128] and v, g, dv [B, HW, H x dv]
// bf16, rel [B, HW, H x (2m+1)^2] bf16; drel [B, HW, H x (2m+1)^2] and lse
// [B, H, HW] f32. Returns the cudaError_t of the launches (0 on success);
// -1 for anything but 1 or 2 heads of 128, a 15 x 15 window (max_dis 7) and
// dv (a head's values) 512 or 1024.
extern "C" int rmem_local_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* rel,
                                        const void* g, void* dq, void* dk,
                                        void* dv_out, void* drel, void* lse,
                                        int B, int Hg, int Wg, int H, int dh,
                                        int dv, int max_dis, float scale,
                                        void* stream) {
  if ((H != 1 && H != 2) || dh != rmem::FD || max_dis != rmem::M) return -1;
  if (dv == 1024)
    return rmem::launch_bwd<1024>(q, k, v, rel, g, dq, dk, dv_out, drel, lse,
                                  B, Hg, Wg, H, scale, (cudaStream_t)stream);
  if (dv == 512)
    return rmem::launch_bwd<512>(q, k, v, rel, g, dq, dk, dv_out, drel, lse,
                                 B, Hg, Wg, H, scale, (cudaStream_t)stream);
  return -1;
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

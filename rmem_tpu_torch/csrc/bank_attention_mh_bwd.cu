// The bank attention's backward at 8 heads of 32 (kernel K2h): dq, dk and
// dv of AOT's long-term attention in training, with the gradient of the
// slot mass.
//
// Replaces rmem_tpu/kernels/bank_attention.py:_bank_attention_bwd (its
// pallas_calls _dq_kernel and _dkv_kernel) at num_heads = 8: the Pallas
// kernels fold the heads into the grid (_layout), and since the record
// the forward returns is the head mean of the slot mass, each head takes
// drec / 8. Per head h (columns 32h .. 32h + 31), query i, valid slot
// s < count and key j < Lk, with the forward's lse_h:
//   p = exp(q.k * scale - lse_h[i]),
//   ds = p * (dout_h . v + drec[i, s] / 8 - delta_h[i]),
//   dq = scale sum ds k,  dk = scale sum_i ds q,  dv = sum_i p dout_h,
// delta_h = rowsum over the head's columns of dout.out + rowsum_s(drec / 8
// rec_h), from the forward's f32 output and each head's slot mass. dk and
// dv are written as exact zeros in slots >= count (read on the device):
// training adds the slot PE to the keys, so autograd sums dk over every
// slot into the PE's gradient.
//
// What bounds it on an H100: operations. At the training call (B 4, Lq =
// Lk = 900, 4 valid slots) the products the backward needs (S = Q K^T and
// G = dO V^T once, then dq, dk and dv) come to 2 Lq (4 Lk) 32 x 5 x 8 x B
// = 3.3e10 FLOP, 34 us at 989 TFLOP/s, against ~30 MB moved. p's 1.04e8
// exponentials take 25 us a pass on the special-function units, and with
// heads this narrow the elementwise work per product is 4x that of a head
// of 128.
//
// Design. The first port ran the JAX kernels' split on mma.sync: a 4-warp
// block per head, each fetching its head's 64-byte slice of every row by
// cp.async with two __syncthreads a tile, exp2f, and the row term in ~8
// PyTorch launches before it. This one keeps the split (two kernels, each
// recomputing p from the lse: one pass cannot give dq without summing it
// over 15 x count key tiles, by atomics, which would not be deterministic,
// or through 15 x count f32 partial planes, 221 MB at 4 slots) and moves it
// onto K2x2v128's building blocks (csrc/hopper.cuh):
//   - A block takes a pair of heads, one warpgroup each, so every TMA box
//     is a [64 x 64] bf16 tile of 128-byte rows (the two heads' columns
//     side by side, the 128-byte swizzle) and one barrier covers both
//     heads' products. S and G are wgmma m64n64k16 from shared memory over
//     the head's half of each row (K-major, the second head's start 64
//     bytes in); dV, dK and dQ are register-A wgmma m64n32k16 with the tile
//     read MN-major from the head's 32 columns. Thread 0 keeps the walked
//     tiles in flight by TMA in a ring of STAGES with full and empty
//     mbarriers, refilling a stage once all 8 warps have released it (with
//     a producer warp of its own the consumers' registers fell short and
//     spilled). 256 threads, <= 128 registers and ~85 KB a block: two
//     blocks an SM.
//   - The softmax element is one fma and one ex2.approx (log2 units: the
//     row arrays below carry the lse times log2(e)); the products of each
//     16 columns are issued as soon as their p and ds are packed, so they
//     run while the next 16 are computed.
//   - rows_kernel computes each head's row terms once a call, on the card:
//     lse2 = lse_h log2(e) [B, 8, LqP] (+inf past Lq, so a padded query's p
//     is 0) and rterm = drec / 8 - delta_h [B, 8, S, LqP] (0 past Lq), with
//     delta_h from dout, out and rec_h; LqP = Lq rounded up to 64. The
//     dkv kernel brings each query tile's rows in by bulk copy.
//   - dkv_kernel: a block owns 64 keys of one slot and batch row for a head
//     pair, K and V resident; per 64-query tile S^T = K Q^T and G^T = V
//     dO^T, p^T and ds^T in registers, dV += p^T dO and dK += ds_hi^T Q +
//     ds_lo^T Q. Blocks of slots >= count write zeros and end.
//   - dq_kernel: a block owns 64 queries of a head pair and batch row, Q
//     and dO resident, and walks the 64-key chunks of a group of G valid
//     slots: S, G, ds, dQ += ds_hi K + ds_lo K, an f32 partial [NG, B, Lq,
//     256] per group; dq_sum_kernel adds the valid groups' partials in group
//     order (deterministic), scales and rounds to bf16. Groups past count
//     return before any barrier or copy.
// A sweep of G (1, 2, 4) and STAGES (2, 4) moved the whole call by under
// 2 % (PERF.md). ds enters the dq and dk products as a bf16 hi/lo pair, hi = ds truncated to bf16 (a byte permute in place
// of a conversion) and lo = bf16(ds - hi), together within 2^-16 of ds: a
// row of ds sums to the slot-mass term, so ds k is a small difference of
// large terms that one bf16 rounding would lose. Keys past Lk
// and queries past Lq arrive as zeros from TMA; their p is masked to 0
// (keys) or made 0 by lse2 (queries), and they are never written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rmem_mhb {

using namespace rmem_hopper;
using bf16 = __nv_bfloat16;

constexpr int H = 8;              // heads
constexpr int D = 32;             // width of a head's q, k, v
constexpr int C = H * D;          // row width of q, k, v, dout and grads
constexpr int PAIR = 2;           // heads a block takes, a consumer each
constexpr int NPAIRS = H / PAIR;
constexpr int BR = 64;            // rows a block owns: keys or queries
constexpr int BW = 64;            // rows of a walked tile
constexpr int STAGES = 4;         // walked tiles in flight
constexpr int G = 2;              // slots a dq block walks (the
                                  // wrapper's MH_BWD_DQ_SLOTS)
constexpr int kThreads = 128 * PAIR;
constexpr int TILE = 64 * 128;    // [64 rows x 64 columns] bf16: one box
constexpr int ROW_BYTES = BW * 4;
// shared memory: the resident tiles, then the stages' tiles (each 1024-byte
// aligned, the 128-byte swizzle's period), then (dkv) the stages' row
// arrays, lse2 and rterm of each head, then the barriers
constexpr int RES_BYTES = 2 * TILE;
constexpr int STAGE_BYTES = 2 * TILE;
constexpr int ROWS_FLOATS = 2 * PAIR * BW;  // a stage's row arrays
constexpr int ROWS_OFF = RES_BYTES + STAGES * STAGE_BYTES;
constexpr int BAR_OFF = ROWS_OFF + STAGES * ROWS_FLOATS * 4;
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
constexpr int kRowThreads = 256;
constexpr float LOG2E = 1.4426950408889634f;

// acc[64 x 64] = A_h B_h^T over one head's 32 columns of two [64 x 64]
// pair tiles, K-major; `hoff` is the head's byte offset in a row (0, 64).
__device__ __forceinline__ void mul_abt(float* acc, const char* a,
                                        const char* b, int hoff) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n64(acc, desc_sw128(a + hoff + kk * 32, 16, 1024),
                    desc_sw128(b + hoff + kk * 32, 16, 1024), kk > 0);
}

// acc[64 x 32] += X[64 x 16] T_h[16 x 32]: one k16 step kk of X (from
// registers) times rows 16 kk .. 16 kk + 15 of a pair tile, the head's 32
// columns read MN-major.
__device__ __forceinline__ void mul_ab(float* acc, const uint32_t* x,
                                       const char* t, int kk, int hoff) {
  wgmma_rs_m64n32(acc, x, desc_sw128(t + kk * 2048 + hoff, 8192, 1024));
}

// Elements 8 kk .. 8 kk + 7 of an m64n64 accumulator (16 columns, this
// thread's two rows) as one k16 A operand: ds as the hi/lo pair, hi the
// bf16 truncation (a byte permute) and lo = bf16(ds - hi), so |ds - hi -
// lo| <= 2^-16 |ds|, with one conversion per two values.
__device__ __forceinline__ void pack_hi_lo(const float* x, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t ua = __float_as_uint(x[2 * j]);
    const uint32_t ub = __float_as_uint(x[2 * j + 1]);
    hi[j] = __byte_perm(ua, ub, 0x7632);
    lo[j] = pack_bf16(x[2 * j] - __uint_as_float(ua & 0xffff0000u),
                      x[2 * j + 1] - __uint_as_float(ub & 0xffff0000u));
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* resbar) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kThreads / 32);   // lane 0 of each warp
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One thread a (batch, head, padded query): the row arrays lse2 [B, 8, LqP]
// and rterm [B, 8, S, LqP] (see the note above), delta_h from dout [B, Lq,
// 256] bf16, out [B, Lq, 256] f32 and rec_h [B, 8, Lq, S] f32; lse_h [B, 8,
// Lq], drec [B, Lq, S] f32.
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const bf16* __restrict__ dout, const float* __restrict__ out,
            const float* __restrict__ rec_h, const float* __restrict__ lse_h,
            const float* __restrict__ drec, float* __restrict__ lse2,
            float* __restrict__ rterm, int B, int Lq, int LqP, int S) {
  const int idx = blockIdx.x * kRowThreads + threadIdx.x;
  if (idx >= B * H * LqP) return;
  const int bh = idx / LqP, i = idx % LqP, b = bh / H, h = bh % H;
  float* rt = rterm + (size_t)bh * S * LqP + i;
  if (i >= Lq) {
    lse2[idx] = INFINITY;
    for (int s = 0; s < S; ++s) rt[(size_t)s * LqP] = 0.f;
    return;
  }
  const float* dr = drec + ((size_t)b * Lq + i) * S;
  const size_t row = ((size_t)b * Lq + i) * C + h * D;
  const uint4* dp = reinterpret_cast<const uint4*>(dout + row);
  const float4* op = reinterpret_cast<const float4*>(out + row);
  float delta = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 raw = dp[c];
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 o0 = op[2 * c], o1 = op[2 * c + 1];
    delta += __low2float(d2[0]) * o0.x + __high2float(d2[0]) * o0.y +
             __low2float(d2[1]) * o0.z + __high2float(d2[1]) * o0.w +
             __low2float(d2[2]) * o1.x + __high2float(d2[2]) * o1.y +
             __low2float(d2[3]) * o1.z + __high2float(d2[3]) * o1.w;
  }
  const float* rc = rec_h + ((size_t)bh * Lq + i) * S;
  for (int s = 0; s < S; ++s) delta += dr[s] * (1.f / H) * rc[s];
  lse2[idx] = lse_h[(size_t)bh * Lq + i] * LOG2E;
  for (int s = 0; s < S; ++s) rt[(size_t)s * LqP] = dr[s] * (1.f / H) - delta;
}

// dk, dv [S, B, Lk, 256] bf16. Block (64 keys, slot, batch x head pair).
__global__ void __launch_bounds__(kThreads, 2)
dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_do,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const float* __restrict__ lse2, const float* __restrict__ rterm,
           const int* __restrict__ count_ptr, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int B, int Lq, int LqP, int S, int Lk,
           float scale, float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  float* rows = reinterpret_cast<float*>(smem + ROWS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int s = blockIdx.y, b = blockIdx.z / NPAIRS, hp = blockIdx.z % NPAIRS;
  const int key0 = blockIdx.x * BR;
  const size_t kv_row0 = ((size_t)s * B + b) * Lk;
  if (s >= clamp_count(count_ptr, S)) {   // an invalid slot: exact zeros
    for (int e = threadIdx.x; e < BR * (PAIR * D / 8); e += kThreads) {
      const int j = e / (PAIR * D / 8), seg = e % (PAIR * D / 8);
      if (key0 + j >= Lk) continue;
      const size_t off = (kv_row0 + key0 + j) * C + hp * PAIR * D + seg * 8;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int nq = (Lq + BW - 1) / BW;
  init_ring(full, empty, kvbar);

  // thread 0: query tile i's Q, dO and row arrays into its stage
  auto issue = [&](int i) {
    const int st = i % STAGES;
    char* sq = smem + RES_BYTES + st * STAGE_BYTES;
    float* rl = rows + st * ROWS_FLOATS;
    mbar_expect_tx(&full[st], STAGE_BYTES + ROWS_FLOATS * 4);
    tma_load(sq, &tm_q, &full[st], 0, hp, i * BW, b);
    tma_load(sq + TILE, &tm_do, &full[st], 0, hp, i * BW, b);
    for (int c = 0; c < PAIR; ++c) {
      const size_t bh = (size_t)b * H + hp * PAIR + c;
      bulk_load(rl + c * BW, lse2 + bh * LqP + i * BW, ROW_BYTES, &full[st]);
      bulk_load(rl + (PAIR + c) * BW, rterm + (bh * S + s) * LqP + i * BW,
                ROW_BYTES, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, RES_BYTES);
    tma_load(smem, &tm_k, kvbar, 0, hp, key0, s * B + b);
    tma_load(smem + TILE, &tm_v, kvbar, 0, hp, key0, s * B + b);
    for (int i = 0; i < STAGES && i < nq; ++i) issue(i);
  }

  // a warpgroup a head of the pair
  const int cw = threadIdx.x / 128, h = hp * PAIR + cw, hoff = cw * 2 * D;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  // this thread's two keys, and whether each is a real key
  const int ka = key0 + warp * 16 + (lane >> 2), kb = ka + 8;
  const bool ok_a = ka < Lk, ok_b = kb < Lk;
  float dka[16], dva[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < nq; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const char* sq = smem + RES_BYTES + st * STAGE_BYTES;
    const char* so = sq + TILE;
    const float* rl = rows + st * ROWS_FLOATS + cw * BW;
    const float* rr = rows + st * ROWS_FLOATS + (PAIR + cw) * BW;

    // ---- S^T = K Q^T, G^T = V dO^T: rows this block's keys ----
    float sc[32], gg[32];
    wgmma_fence();
    mul_abt(sc, smem, sq, hoff);
    mul_abt(gg, smem + TILE, so, hoff);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(gg);

    // ---- 16 queries at a time: p^T and ds^T, then dV += p^T dO and dK +=
    // ds_hi^T Q + ds_lo^T Q for them, issued while the next 16 are
    // computed ----
    uint32_t pa[4][4], ha[4][4], la[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
        const int col = 8 * j + 2 * t4;
        const float2 l = *reinterpret_cast<const float2*>(rl + col);
        const float2 r = *reinterpret_cast<const float2*>(rr + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float le = e ? l.y : l.x, re = e ? r.y : r.x;
          const float p0 =
              ok_a ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -le)) : 0.f;
          const float p1 =
              ok_b ? exp2_approx(fmaf(sc[4 * j + 2 + e], scale_log2, -le))
                   : 0.f;
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
          gg[4 * j + e] = p0 * (gg[4 * j + e] + re);
          gg[4 * j + 2 + e] = p1 * (gg[4 * j + 2 + e] + re);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      pack_hi_lo(gg + 8 * kk, ha[kk], la[kk]);
      wgmma_fence();
      mul_ab(dva, pa[kk], so, kk, hoff);
      mul_ab(dka, ha[kk], sq, kk, hoff);
      mul_ab(dka, la[kk], sq, kk, hoff);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<16>(dva);
    fence_regs<16>(dka);
    fence_operand<16>(&pa[0][0]);
    fence_operand<16>(&ha[0][0]);
    fence_operand<16>(&la[0][0]);
    // ---- release the stage; thread 0 refills it once every warp has ----
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && i + STAGES < nq) {
      mbar_wait(&empty[st], (i / STAGES) & 1);
      issue(i + STAGES);
    }
  }

  bf16* dkr = dk + kv_row0 * C + h * D;
  bf16* dvr = dv + kv_row0 * C + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 8 * i + 2 * t4;
    if (ok_a) {
      *reinterpret_cast<uint32_t*>(dkr + (size_t)ka * C + col) =
          pack_bf16(dka[4 * i] * scale, dka[4 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + (size_t)ka * C + col) =
          pack_bf16(dva[4 * i], dva[4 * i + 1]);
    }
    if (ok_b) {
      *reinterpret_cast<uint32_t*>(dkr + (size_t)kb * C + col) =
          pack_bf16(dka[4 * i + 2] * scale, dka[4 * i + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvr + (size_t)kb * C + col) =
          pack_bf16(dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
}

// part [NG, B, Lq, 256] f32, each group's dq / scale. Block (64 queries,
// batch x head pair, slot group).
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ lse2, const float* __restrict__ rterm,
          const int* __restrict__ count_ptr, float* __restrict__ part, int B,
          int Lq, int LqP, int S, int Lk, float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int b = blockIdx.y / NPAIRS, hp = blockIdx.y % NPAIRS;
  const int grp = blockIdx.z;
  const int count = clamp_count(count_ptr, S);
  const int s0 = grp * G;
  if (s0 >= count) return;   // the whole block, before any barrier or copy
  const int ns = count - s0 < G ? count - s0 : G;
  const int cps = (Lk + BW - 1) / BW;
  const int nch = ns * cps;
  const int q0 = blockIdx.x * BR;
  init_ring(full, empty, qbar);

  // thread 0: chunk ch's K and V into its stage
  auto issue = [&](int ch) {
    const int st = ch % STAGES;
    char* sk = smem + RES_BYTES + st * STAGE_BYTES;
    const int z = (s0 + ch / cps) * B + b, key0 = (ch % cps) * BW;
    mbar_expect_tx(&full[st], STAGE_BYTES);
    tma_load(sk, &tm_k, &full[st], 0, hp, key0, z);
    tma_load(sk + TILE, &tm_v, &full[st], 0, hp, key0, z);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, RES_BYTES);
    tma_load(smem, &tm_q, qbar, 0, hp, q0, b);
    tma_load(smem + TILE, &tm_do, qbar, 0, hp, q0, b);
    for (int ch = 0; ch < STAGES && ch < nch; ++ch) issue(ch);
  }

  const int cw = threadIdx.x / 128, h = hp * PAIR + cw, hoff = cw * 2 * D;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  // this thread's two queries and their lse2 (+inf past Lq: LqP holds
  // every query of the tile)
  const int qa = q0 + warp * 16 + (lane >> 2), qb = qa + 8;
  const size_t bh = (size_t)b * H + h;
  const float lsa = lse2[bh * LqP + qa], lsb = lse2[bh * LqP + qb];
  float ra = 0.f, rb = 0.f;     // the current slot's rterm of each row
  float dqa[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dqa[i] = 0.f;
  const char* sq = smem;
  const char* so = smem + TILE;
  mbar_wait(qbar, 0);

  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch % STAGES;
    const int c = ch % cps, key0 = c * BW;
    if (c == 0) {
      const float* rs = rterm + (bh * S + s0 + ch / cps) * LqP;
      ra = rs[qa];
      rb = rs[qb];
    }
    mbar_wait(&full[st], (ch / STAGES) & 1);
    const char* sk = smem + RES_BYTES + st * STAGE_BYTES;
    const char* sv = sk + TILE;

    // ---- S = Q K^T, G = dO V^T ----
    float sc[32], gg[32];
    wgmma_fence();
    mul_abt(sc, sq, sk, hoff);
    mul_abt(gg, so, sv, hoff);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(gg);

    // ---- 16 keys at a time: ds (only a slot's last chunk holds keys past
    // Lk), then dQ += ds_hi K + ds_lo K for them, issued while the next 16
    // are computed ----
    const bool tail = key0 + BW > Lk;
    uint32_t ha[4][4], la[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = !tail || key0 + 8 * j + 2 * t4 + e < Lk;
          const float p0 =
              ok ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lsa)) : 0.f;
          const float p1 =
              ok ? exp2_approx(fmaf(sc[4 * j + 2 + e], scale_log2, -lsb)) : 0.f;
          gg[4 * j + e] = p0 * (gg[4 * j + e] + ra);
          gg[4 * j + 2 + e] = p1 * (gg[4 * j + 2 + e] + rb);
        }
      }
      pack_hi_lo(gg + 8 * kk, ha[kk], la[kk]);
      wgmma_fence();
      mul_ab(dqa, ha[kk], sk, kk, hoff);
      mul_ab(dqa, la[kk], sk, kk, hoff);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<16>(dqa);
    fence_operand<16>(&ha[0][0]);
    fence_operand<16>(&la[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && ch + STAGES < nch) {
      mbar_wait(&empty[st], (ch / STAGES) & 1);
      issue(ch + STAGES);
    }
  }

  float* prow = part + ((size_t)grp * B + b) * Lq * C + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 8 * i + 2 * t4;
    if (qa < Lq)
      *reinterpret_cast<float2*>(prow + (size_t)qa * C + col) =
          make_float2(dqa[4 * i], dqa[4 * i + 1]);
    if (qb < Lq)
      *reinterpret_cast<float2*>(prow + (size_t)qb * C + col) =
          make_float2(dqa[4 * i + 2], dqa[4 * i + 3]);
  }
}

// dq [B, Lq, 256] bf16 = scale x the sum of the valid groups' partials, in
// group order. One thread a run of 8 values.
__global__ void __launch_bounds__(256)
dq_sum_kernel(const float* __restrict__ part,
              const int* __restrict__ count_ptr, bf16* __restrict__ dq,
              int n8, int S, float scale) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n8) return;
  const int ng = (clamp_count(count_ptr, S) + G - 1) / G;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int g = 0; g < ng; ++g) {
    const float4* p =
        reinterpret_cast<const float4*>(part + ((size_t)g * n8 + idx) * 8);
    const float4 a = p[0], c = p[1];
    acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
    acc[4] += c.x; acc[5] += c.y; acc[6] += c.z; acc[7] += c.w;
  }
  uint4 o;
  o.x = pack_bf16(acc[0] * scale, acc[1] * scale);
  o.y = pack_bf16(acc[2] * scale, acc[3] * scale);
  o.z = pack_bf16(acc[4] * scale, acc[5] * scale);
  o.w = pack_bf16(acc[6] * scale, acc[7] * scale);
  *reinterpret_cast<uint4*>(dq + (size_t)idx * 8) = o;
}

}  // namespace rmem_mhb

// K2h: dq, dk and dv at 8 heads of 32, any batch, 0 < Lk, S <= 128.
// Layouts (contiguous, 16-byte aligned): q, dout [B, Lq, 256] and k, v
// [S, B, Lk, 256] bf16; out [B, Lq, 256], rec_h [B, 8, Lq, S], lse_h
// [B, 8, Lq], drec [B, Lq, S] f32; count an int32 on the card. Scratch,
// with LqP = Lq rounded up to 64 and G = 2 (the wrapper's
// MH_BWD_DQ_SLOTS, which sizes it): lse2 [B, 8, LqP], rterm [B, 8, S, LqP]
// and part [ceil(S / G), B, Lq, 256] f32. dq [B, Lq, 256],
// dk, dv [S, B, Lk, 256] bf16, dk and dv zero in slots >= count. Returns the
// cudaError_t of the launches (0 on success), -1 for a shape it does not
// take, -2 or -3 if a tensor map cannot be made.
extern "C" int rmem_bank_attention_mh_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* rec_h, const void* lse_h,
    const void* drec, const void* count, void* lse2,
    void* rterm, void* part, void* dq, void* dk, void* dv, int B, int H,
    int Lq, int S, int Lk, float scale, void* stream) {
  using namespace rmem_mhb;
  if (H != rmem_mhb::H || S < 1 || S > 128 || Lk < 1 || B < 1 || Lq < 1)
    return -1;
  const int LqP = (Lq + BW - 1) / BW * BW;
  // q, dout [B, Lq, 4 pairs x 64] and k, v [S x B, Lk, 4 pairs x 64], read
  // in [64 x 64] boxes of one head pair
  CUtensorMap tq, tdo, tk, tv;
  int e = map4d(&tq, q, PAIR * D, NPAIRS, Lq, B);
  if (e == 0) e = map4d(&tdo, dout, PAIR * D, NPAIRS, Lq, B);
  if (e == 0) e = map4d(&tk, k, PAIR * D, NPAIRS, Lk, (uint64_t)S * B);
  if (e == 0) e = map4d(&tv, v, PAIR * D, NPAIRS, Lk, (uint64_t)S * B);
  if (e != 0) return e;
  static bool configured = false;     // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int nrows = B * rmem_mhb::H * LqP;
  rows_kernel<<<(nrows + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                st>>>((const bf16*)dout, (const float*)out,
                      (const float*)rec_h, (const float*)lse_h,
                      (const float*)drec,
                      (float*)lse2, (float*)rterm, B, Lq, LqP, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = scale * LOG2E;
  dkv_kernel<<<dim3((Lk + BR - 1) / BR, S, B * NPAIRS), kThreads, SMEM_BYTES,
               st>>>(tq, tdo, tk, tv, (const float*)lse2,
                     (const float*)rterm, (const int*)count, (bf16*)dk,
                     (bf16*)dv, B, Lq, LqP, S, Lk, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3((Lq + BR - 1) / BR, B * NPAIRS, (S + G - 1) / G), kThreads,
              SMEM_BYTES, st>>>(tq, tdo, tk, tv, (const float*)lse2,
                                (const float*)rterm, (const int*)count,
                                (float*)part, B, Lq, LqP, S, Lk, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n8 = B * Lq * C / 8;
  dq_sum_kernel<<<(n8 + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)count, (bf16*)dq, n8, S, scale);
  return (int)cudaGetLastError();
}

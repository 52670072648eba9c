// The bank attention's backward at 2 heads of 128 with values 128 a head
// (kernel K2x2v128, R50-AOTL's no_memory_gap): dq, dk and dv of the
// training forward K1'x2v128 (csrc/bank_attention_infer.cu's lse
// instantiation at 128 value columns), with the gradient of the slot mass,
// and no scratch in device memory.
//
// Replaces rmem_tpu/kernels/bank_attention.py:_bank_attention_bwd (its
// pallas_calls of _dq_kernel and _dkv_kernel) at that head shape. Per head
// h (columns 128h .. 128h + 127 of q, k, v, dout and the gradients), query
// i, valid slot s < count and key j < Lk, with the forward's lse_h:
//   p  = exp(q.k * scale - lse_h[i]),
//   ds = p * (dout_h . v + drec[i, s] / 2 - delta_h[i]),
//   dq = scale sum ds k,  dk = scale sum_i ds q,  dv = sum_i p dout_h,
// delta_h = the rowsum of dout.out over the head's columns + rowsum_s(drec
// / 2 rec_h) (the record is the head mean of the slot mass), computed by
// the wrapper in f32 from K1''s f32 output. The wrapper hands the kernels
// two f32 row arrays, lse2 = lse_h log2(e) [B, 2, LqP] (+inf past Lq, so a
// padded query's p is 0) and rterm = drec / 2 - delta_h [B, 2, S, LqP] (0
// past Lq), LqP = Lq rounded up to 64. dk and dv are exact zeros in slots >=
// count (read on the device): training adds the slot PE to the keys, so
// autograd sums dk over every slot into the PE's gradient.
//
// What bounds it on an H100: operations. At phase 19's call (B 4, Lq = Lk
// = 900, 9 valid slots) the products the backward needs (S = Q K^T and G =
// dO V^T once, then dq, dk and dv: 3 x 128 + 2 x 128 a query-key pair and
// head) come to ~7.5e10 FLOP, 0.075 ms at 989 TFLOP/s; this design does 6 x
// 128 + 3 x 128 (S and G recomputed in each kernel, ds K and ds^T Q as two
// products each), ~1.3e11, 0.14 ms. It moves ~75 MB (0.022 ms at 3.35
// TB/s), dk and dv of every slot included.
//
// Design. K2 at 512 and 1024 values a head (csrc/bank_attention_bwd.cu)
// writes p and ds to a [B, H, S, Lq, LkP] scratch, because ds needs the
// whole dout . v^T before it exists and a 64-key tile's dV is too wide for
// registers. At 128 values a head both fit a warpgroup's registers, so this
// source takes K2h's split (csrc/bank_attention_mh_bwd.cu: each kernel
// recomputes p and ds from the lse) onto Hopper's TMA and wgmma, K1's
// template's building blocks (csrc/hopper.cuh):
//   dkv_kernel: a block owns one 64-key tile of one slot, head and batch row
//     per consumer warpgroup (two: 128 keys), its K and V tiles resident in
//     shared memory. A producer warp keeps the query tiles (64 queries: Q,
//     dO by TMA, and their lse2 and rterm by bulk copy) in flight in a ring
//     of 3 stages with full and empty mbarriers. Per query tile a consumer
//     computes S^T = K Q^T and G^T = V dO^T as wgmma from shared memory
//     (keys are the rows: the accumulators are p^T's and ds^T's A operand
//     layout), p^T = exp2(S^T scale log2(e) - lse2) and ds^T = p^T (G^T +
//     rterm) in registers, then dV += p^T dO and dK += ds_hi^T Q + ds_lo^T Q
//     as register-A wgmma, dO and Q read MN-major from the same tiles.
//     Blocks of slots >= count write zeros and end.
//   dq_kernel: a block owns 64 queries per consumer warpgroup (two: 128) of
//     one head and batch row, their Q and dO tiles resident, and walks the
//     keys of a group of G valid slots in 64-key chunks (K and V by TMA, 3
//     stages): S = Q K^T, G = dO V^T, ds, then dQ += ds_hi K + ds_lo K with
//     K read MN-major. 8 tiles of 128 queries x 2 heads x 4 rows is 64
//     blocks of two warpgroups, under half of the 132 SMs, so the valid
//     slots are split into groups of G = 2 across blocks and each block
//     writes an f32 partial dq [NG, B, Lq, 256]; a second small kernel sums
//     the partials of the valid groups (read on the device) in a fixed
//     order, scales and rounds to bf16: deterministic, where atomics into
//     one f32 sum would not be, at 3.7 MB of partials a group written and
//     read back.
// ds enters the dq and dk products as a bf16 hi/lo pair, hi = bf16(ds) and
// lo = bf16(ds - hi): a row of ds sums to the slot-mass term, so ds k is a
// small difference of large terms, and ds rounded once to bf16 missed dq by
// 7.5e-2 of its largest value on a training call. Keys past Lk and queries
// past Lq arrive as zeros from TMA; their p is masked to 0 (keys) or made 0
// by lse2 (queries), and they are never written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rmem_bwdf {

using namespace rmem_hopper;
using bf16 = __nv_bfloat16;

constexpr int H = 2;            // heads
constexpr int D = 128;          // a head's keys and values
constexpr int C = H * D;        // row width of q, k, v, dout and grads
constexpr int BR = 64;          // rows a consumer warpgroup owns
constexpr int BW = 64;          // rows of a walked tile
constexpr int NCONS = 2;        // consumer warpgroups
constexpr int STAGES = 3;       // walked tiles in flight
constexpr int kThreads = 128 * (1 + NCONS);
constexpr int G = 2;            // slots a dq block walks
constexpr int ATOM = 64 * 128;  // one [64 x 64] bf16 TMA box
constexpr int TILE = 2 * ATOM;  // [64 x 128] bf16: two boxes
constexpr int ROW_BYTES = BW * 4;
// shared memory: the consumers' resident tiles, then the stages' tiles
// (every tile 1024-byte aligned, the 128-byte swizzle's period), then
// (dkv) the stages' row arrays, then the barriers
constexpr int RES_BYTES = NCONS * 2 * TILE;
constexpr int STAGE_BYTES = 2 * TILE;
constexpr int ROWS_OFF = RES_BYTES + STAGES * STAGE_BYTES;
constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * ROW_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
constexpr float LOG2E = 1.4426950408889634f;

// Eight f32 values.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// An m64n64 accumulator (rows this thread's two, columns the walked
// tile's) as the A operand of four k16 steps, in bf16: hi, and with `lo`
// its rounding error.
__device__ __forceinline__ void pack_a(const float* x, uint32_t (*hi)[4],
                                       uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * kk + 2 * j], b = x[8 * kk + 2 * j + 1];
      hi[kk][j] = pack_bf16(a, b);
      if (lo != nullptr) {
        const __nv_bfloat162 h2 =
            *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][j]);
        lo[kk][j] = pack_bf16(a - __low2float(h2), b - __high2float(h2));
      }
    }
  }
}

// acc[64 x 64] = A[64 x 128] B[64 x 128]^T, both [64 x 128] tiles K-major
// (two 128-byte-swizzled boxes each).
__device__ __forceinline__ void mul_abt(float* acc, const char* a,
                                        const char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk >> 2) * ATOM + (kk & 3) * 32;
    wgmma_ss_m64n64(acc, desc_sw128(a + off, 16, 1024),
                    desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc[64 x 128] += X[64 x 64] T[64 x 128], X from registers (pack_a), T a
// [64 x 128] tile read MN-major.
__device__ __forceinline__ void mul_ab(float* acc, const uint32_t (*x)[4],
                                       const char* t) {
#pragma unroll
  for (int kk = 0; kk < BW / 16; ++kk)
    wgmma_rs_m64n128(acc, x[kk], desc_sw128(t + kk * 2048, 8192, 1024));
}

// dk, dv [S, B, Lk, 256] bf16. Block (128 keys, slot, batch x head).
__global__ void __launch_bounds__(kThreads, 1)
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

  const int s = blockIdx.y, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * (BR * NCONS);
  const size_t kv_row0 = ((size_t)s * B + b) * Lk;
  if (s >= clamp_count(count_ptr, S)) {   // an invalid slot: exact zeros
    for (int e = threadIdx.x; e < BR * NCONS * (D / 8); e += kThreads) {
      const int j = e / (D / 8), seg = e % (D / 8);
      if (key0 + j >= Lk) continue;
      const size_t off = (kv_row0 + key0 + j) * C + h * D + seg * 8;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int nq = (Lq + BW - 1) / BW;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NCONS);   // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int z = s * B + b;
      mbar_expect_tx(kvbar, RES_BYTES);
      for (int c = 0; c < NCONS; ++c) {
        char* sk = smem + c * 2 * TILE;
        for (int a = 0; a < 2; ++a) {
          tma_load(sk + a * ATOM, &tm_k, kvbar, a * 64, h, key0 + c * BR, z);
          tma_load(sk + TILE + a * ATOM, &tm_v, kvbar, a * 64, h,
                   key0 + c * BR, z);
        }
      }
      for (int i = 0; i < nq; ++i) {
        const int st = i % STAGES, use = i / STAGES;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        char* sq = smem + RES_BYTES + st * STAGE_BYTES;
        float* rl = rows + st * 2 * BW;
        mbar_expect_tx(&full[st], STAGE_BYTES + 2 * ROW_BYTES);
        for (int a = 0; a < 2; ++a) {
          tma_load(sq + a * ATOM, &tm_q, &full[st], a * 64, h, i * BW, b);
          tma_load(sq + TILE + a * ATOM, &tm_do, &full[st], a * 64, h,
                   i * BW, b);
        }
        bulk_load(rl, lse2 + (size_t)bh * LqP + i * BW, ROW_BYTES, &full[st]);
        bulk_load(rl + BW, rterm + ((size_t)bh * S + s) * LqP + i * BW,
                  ROW_BYTES, &full[st]);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int t4 = lane & 3;
    const char* sk = smem + cw * 2 * TILE;
    const char* sv = sk + TILE;
    // this thread's two keys, and whether each is a real key
    const int ka = key0 + cw * BR + warp * 16 + (lane >> 2), kb = ka + 8;
    const bool ok_a = ka < Lk, ok_b = kb < Lk;
    float dka[64], dva[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int i = 0; i < nq; ++i) {
      const int st = i % STAGES;
      mbar_wait(&full[st], (i / STAGES) & 1);
      const char* sq = smem + RES_BYTES + st * STAGE_BYTES;
      const char* so = sq + TILE;
      const float* rl = rows + st * 2 * BW;
      const float* rr = rl + BW;

      // ---- S^T = K Q^T, G^T = V dO^T: rows this warpgroup's keys ----
      float sc[32], gg[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = gg[j] = 0.f;
      wgmma_fence();
      mul_abt(sc, sk, sq);
      mul_abt(gg, sv, so);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(sc);
      fence_regs<32>(gg);

      // ---- p^T and ds^T; columns are queries ----
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e;
          const float l = rl[col], r = rr[col];
          const float p0 =
              ok_a ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -l)) : 0.f;
          const float p1 =
              ok_b ? exp2_approx(fmaf(sc[4 * j + 2 + e], scale_log2, -l)) : 0.f;
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
          gg[4 * j + e] = p0 * (gg[4 * j + e] + r);
          gg[4 * j + 2 + e] = p1 * (gg[4 * j + 2 + e] + r);
        }
      }
      uint32_t pa[4][4], ha[4][4], la[4][4];
      pack_a(sc, pa, nullptr);
      pack_a(gg, ha, la);

      // ---- dV += p^T dO, dK += ds_hi^T Q + ds_lo^T Q ----
      wgmma_fence();
      mul_ab(dva, pa, so);
      mul_ab(dka, ha, sq);
      mul_ab(dka, la, sq);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<64>(dva);
      fence_regs<64>(dka);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with it
    }

    bf16* dkr = dk + kv_row0 * C + h * D;
    bf16* dvr = dv + kv_row0 * C + h * D;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
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
}

// part [NG, B, Lq, 256] f32, each group's dq / scale. Block (128 queries,
// batch x head, slot group).
__global__ void __launch_bounds__(kThreads, 1)
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

  const int bh = blockIdx.y, b = bh / H, h = bh % H, grp = blockIdx.z;
  const int count = clamp_count(count_ptr, S);
  const int s0 = grp * G;
  if (s0 >= count) return;   // the whole block, before any barrier or copy
  const int ns = count - s0 < G ? count - s0 : G;
  const int cps = (Lk + BW - 1) / BW;
  const int nch = ns * cps;
  const int q0 = blockIdx.x * (BR * NCONS);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NCONS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, RES_BYTES);
      for (int c = 0; c < NCONS; ++c) {
        char* sq = smem + c * 2 * TILE;
        for (int a = 0; a < 2; ++a) {
          tma_load(sq + a * ATOM, &tm_q, qbar, a * 64, h, q0 + c * BR, b);
          tma_load(sq + TILE + a * ATOM, &tm_do, qbar, a * 64, h,
                   q0 + c * BR, b);
        }
      }
      for (int ch = 0; ch < nch; ++ch) {
        const int st = ch % STAGES, use = ch / STAGES;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        char* sk = smem + RES_BYTES + st * STAGE_BYTES;
        const int z = (s0 + ch / cps) * B + b, key0 = (ch % cps) * BW;
        mbar_expect_tx(&full[st], STAGE_BYTES);
        for (int a = 0; a < 2; ++a) {
          tma_load(sk + a * ATOM, &tm_k, &full[st], a * 64, h, key0, z);
          tma_load(sk + TILE + a * ATOM, &tm_v, &full[st], a * 64, h, key0,
                   z);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int t4 = lane & 3;
    const char* sq = smem + cw * 2 * TILE;
    const char* so = sq + TILE;
    // this thread's two queries and their lse (log2 units; +inf past Lq)
    const int qa = q0 + cw * BR + warp * 16 + (lane >> 2), qb = qa + 8;
    const float* lrow = lse2 + (size_t)bh * LqP;
    const float lsa = qa < Lq ? lrow[qa] : INFINITY;
    const float lsb = qb < Lq ? lrow[qb] : INFINITY;
    float ra = 0.f, rb = 0.f;     // the current slot's rterm of each row
    float dqa[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
    mbar_wait(qbar, 0);

    for (int ch = 0; ch < nch; ++ch) {
      const int st = ch % STAGES;
      const int c = ch % cps, key0 = c * BW;
      if (c == 0) {
        const float* rs = rterm + ((size_t)bh * S + s0 + ch / cps) * LqP;
        ra = qa < Lq ? rs[qa] : 0.f;
        rb = qb < Lq ? rs[qb] : 0.f;
      }
      mbar_wait(&full[st], (ch / STAGES) & 1);
      const char* sk = smem + RES_BYTES + st * STAGE_BYTES;
      const char* sv = sk + TILE;

      // ---- S = Q K^T, G = dO V^T ----
      float sc[32], gg[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = gg[j] = 0.f;
      wgmma_fence();
      mul_abt(sc, sq, sk);
      mul_abt(gg, so, sv);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(sc);
      fence_regs<32>(gg);

      // ---- ds, the keys past Lk masked ----
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key0 + 8 * j + 2 * t4 + e < Lk;
          const float p0 =
              ok ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lsa)) : 0.f;
          const float p1 =
              ok ? exp2_approx(fmaf(sc[4 * j + 2 + e], scale_log2, -lsb)) : 0.f;
          gg[4 * j + e] = p0 * (gg[4 * j + e] + ra);
          gg[4 * j + 2 + e] = p1 * (gg[4 * j + 2 + e] + rb);
        }
      }
      uint32_t ha[4][4], la[4][4];
      pack_a(gg, ha, la);

      // ---- dQ += ds_hi K + ds_lo K ----
      wgmma_fence();
      mul_ab(dqa, ha, sk);
      mul_ab(dqa, la, sk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<64>(dqa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    float* prow = part + (size_t)grp * B * Lq * C + (size_t)b * Lq * C + h * D;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + 2 * t4;
      if (qa < Lq)
        *reinterpret_cast<float2*>(prow + (size_t)qa * C + col) =
            make_float2(dqa[4 * i], dqa[4 * i + 1]);
      if (qb < Lq)
        *reinterpret_cast<float2*>(prow + (size_t)qb * C + col) =
            make_float2(dqa[4 * i + 2], dqa[4 * i + 3]);
    }
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
    float v[8];
    load8(part + ((size_t)g * n8 + idx) * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += v[j];
  }
  uint4 o;
  o.x = pack_bf16(acc[0] * scale, acc[1] * scale);
  o.y = pack_bf16(acc[2] * scale, acc[3] * scale);
  o.z = pack_bf16(acc[4] * scale, acc[5] * scale);
  o.w = pack_bf16(acc[6] * scale, acc[7] * scale);
  *reinterpret_cast<uint4*>(dq + (size_t)idx * 8) = o;
}

// The four tensor maps: q, dout [B, Lq, 256] and k, v [S, B, Lk, 256], each
// read in [64 x 64] boxes of one head.
static int maps(CUtensorMap* tq, CUtensorMap* tdo, CUtensorMap* tk,
                CUtensorMap* tv, const void* q, const void* dout,
                const void* k, const void* v, int B, int Lq, int S, int Lk) {
  int e = map4d(tq, q, D, H, Lq, B);
  if (e == 0) e = map4d(tdo, dout, D, H, Lq, B);
  if (e == 0) e = map4d(tk, k, D, H, Lk, (uint64_t)S * B);
  if (e == 0) e = map4d(tv, v, D, H, Lk, (uint64_t)S * B);
  return e;
}

template <typename K>
static int configure(K kern) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

static bool shapes_ok(int B, int H_, int Lq, int S, int Lk, int LqP) {
  return H_ == H && B >= 1 && Lq >= 1 && Lk >= 1 && S >= 1 && S <= 128 &&
         LqP == (Lq + BW - 1) / BW * BW;
}

}  // namespace rmem_bwdf

// Layouts (bf16, contiguous, 16-byte aligned): q, dout [B, Lq, 2 x 128];
// k, v [S, B, Lk, 2 x 128]; f32 lse2 [B, 2, LqP] and rterm [B, 2, S, LqP]
// (see the note above); count an int32 on the card. Each returns the
// cudaError_t of its launches (0 on success), -1 for a shape it does not
// take, -2 or -3 if a tensor map cannot be made.

// dk, dv [S, B, Lk, 2 x 128] bf16, exact zeros in slots >= count.
extern "C" int rmem_bank_attention_bwd_fused_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* rterm, const void* count, void* dk,
    void* dv, int B, int H, int Lq, int S, int Lk, int LqP, float scale,
    void* stream) {
  using namespace rmem_bwdf;
  if (!shapes_ok(B, H, Lq, S, Lk, LqP)) return -1;
  CUtensorMap tq, tdo, tk, tv;
  int e = maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B, Lq, S, Lk);
  if (e != 0) return e;
  static bool configured = false;     // once per process
  if (!configured) {
    e = configure(dkv_kernel);
    if (e != 0) return e;
    configured = true;
  }
  dim3 grid((Lk + BR * NCONS - 1) / (BR * NCONS), S, B * H);
  dkv_kernel<<<grid, kThreads, SMEM_BYTES, (cudaStream_t)stream>>>(
      tq, tdo, tk, tv, (const float*)lse2, (const float*)rterm,
      (const int*)count, (bf16*)dk, (bf16*)dv, B, Lq, LqP, S, Lk, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// dq [B, Lq, 2 x 128] bf16; part [ceil(S / G), B, Lq, 256] f32 scratch,
// G = rmem_bank_attention_bwd_fused_slots().
extern "C" int rmem_bank_attention_bwd_fused_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* rterm, const void* count, void* part,
    void* dq, int B, int H, int Lq, int S, int Lk, int LqP, float scale,
    void* stream) {
  using namespace rmem_bwdf;
  if (!shapes_ok(B, H, Lq, S, Lk, LqP)) return -1;
  CUtensorMap tq, tdo, tk, tv;
  int e = maps(&tq, &tdo, &tk, &tv, q, dout, k, v, B, Lq, S, Lk);
  if (e != 0) return e;
  static bool configured = false;
  if (!configured) {
    e = configure(dq_kernel);
    if (e != 0) return e;
    configured = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((Lq + BR * NCONS - 1) / (BR * NCONS), B * H, (S + G - 1) / G);
  dq_kernel<<<grid, kThreads, SMEM_BYTES, st>>>(
      tq, tdo, tk, tv, (const float*)lse2, (const float*)rterm,
      (const int*)count, (float*)part, B, Lq, LqP, S, Lk, scale * LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n8 = B * Lq * C / 8;
  dq_sum_kernel<<<(n8 + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)count, (bf16*)dq, n8, S, scale);
  return (int)cudaGetLastError();
}

// The slots a dq block walks.
extern "C" int rmem_bank_attention_bwd_fused_slots() { return rmem_bwdf::G; }

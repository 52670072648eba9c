// Training's bank attention forward at 2 heads of 128 with values 128 a
// head (kernel K1'x2v128, R50-AOTL's no_memory_gap): each head's output in
// f32, its per-row log-sum-exp for the backward (K2x2v128,
// csrc/bank_attention_bwd_fused.cu) and its slot mass, in one kernel.
//
// Replaces the forward of rmem_tpu/kernels/bank_attention.py:
// pallas_bank_attention's VJP (_forward with want_lse) at that head shape.
// Per head h (columns 128h .. 128h + 127 of q, k and v), query i, valid slot
// s < count and key j < Lk: x = q.k * scale, p = softmax over every (s, j)
// of the row, out = sum p v (p rounded to bf16 for P.V, as the Pallas
// forward does), lse = log sum exp x, rec[b, h, i, s] = sum_j p.
//
// What bounds it on an H100: operations. At phase 19's call (B 4, Lq = Lk
// = 900, 9 valid slots) the two products take 2 Lq (9 Lk) (128 + 128) 2 x B
// = 3.0e10 FLOP, 30 us at 989 TFLOP/s, against ~20 MB moved.
//
// Design. K1's template (csrc/bank_attention_infer.cu) ran this call as
// 128-query blocks over slot groups of 2: 8 query tiles (the last holding 4
// of its 128 rows) x 8 (batch, head) x 5 groups = 320 blocks of one an SM,
// 2.4 waves on 132 SMs, and 18.4 MB of f32 partials written and read back by
// a second, merge kernel. This kernel gives a block 64 queries of one
// (batch, head) and every valid slot: 15 x 8 = 120 blocks, one wave, the
// 4-row tail a sixteenth of the queries, no partials and one launch.
//   - A producer warpgroup (one thread, its registers given back with
//     setmaxnreg) loads the Q tile once and keeps the 64-key chunks of the
//     valid slots (K, V [64 x 128] each by TMA, 128-byte swizzle; 4-D tensor
//     maps [slot x batch, key, head, column], so a chunk never crosses a
//     slot and the keys past Lk arrive as zeros) in flight in a ring of
//     STAGES with full and empty mbarriers.
//   - Two consumer warpgroups take the chunks alternately (chunk j, slot
//     major, goes to consumer j % 2 through stage j % STAGES; STAGES is
//     even, so a stage always feeds the same consumer). Each keeps its own
//     online softmax over its chunks: S = Q K^T as wgmma m64n64k16 from
//     shared memory, the key mask in a slot's last chunk, one fma and one
//     ex2.approx an element (log2 units), and O += P V as register-A wgmma
//     m64n128k16 with P in bf16. The softmax of a chunk overlaps the P.V
//     product of the chunk before it: S of the next chunk is issued before
//     P.V of this one, and the wait lets P.V run on into the next softmax.
//   - Each consumer books a slot's sum of p, relative to its running
//     maximum, in shared memory (with that maximum) when its walk leaves the
//     slot. At the end the second consumer leaves its O, maximum and sum in
//     shared memory (in its own stages, which nothing reads any more), and
//     the first merges the two: with M the larger maximum and w_c = 2^(m_c
//     - M), out = (w_0 O_0 + w_1 O_1) / (w_0 L_0 + w_1 L_1), lse = (M +
//     log2 of that sum) ln 2 and rec_s = sum_c 2^(m_c(s) - M) l_c(s) over the
//     same sum, 0 for slots >= count.
// Three stages a consumer: when a consumer releases a chunk's stage, the
// next but one chunk goes there while it works on the two before it.
// ~226 KB of shared memory and 384 threads a block, one block an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rmem_lse128 {

using namespace rmem_hopper;
using bf16 = __nv_bfloat16;

constexpr int H = 2;              // heads
constexpr int D = 128;            // a head's keys and values
constexpr int C = H * D;          // row width of q, k, v and out
constexpr int BQ = 64;            // queries a block
constexpr int BK = 64;            // keys a chunk
constexpr int NCONS = 2;          // consumer warpgroups, alternate chunks
constexpr int STAGES = 6;         // chunks in flight, three a consumer
constexpr int MAX_SLOTS = 16;     // slots the wrapper takes
constexpr int kThreads = 128 * (1 + NCONS);
constexpr int ATOM = 64 * 128;    // one [64 x 64] bf16 TMA box
constexpr int TILE = 2 * ATOM;    // [64 x 128] bf16
constexpr int STAGE_BYTES = 2 * TILE;     // K and V
// shared memory: Q, the stages (each 1024-byte aligned), each consumer's
// per-slot sums and maxima [NCONS][MAX_SLOTS][BQ], the second consumer's
// maximum and sum a row, the barriers
constexpr int SLOT_OFF = TILE + STAGES * STAGE_BYTES;
constexpr int SLOT_FLOATS = NCONS * MAX_SLOTS * BQ;
constexpr int XROW_OFF = SLOT_OFF + 2 * SLOT_FLOATS * 4;
constexpr int BAR_OFF = XROW_OFF + 2 * BQ * 4;
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(STAGES % NCONS == 0, "a stage feeds one consumer");
static_assert(STAGE_BYTES >= 128 * 64 * 4, "the O exchange fits a stage");

// acc[64 x 64] = Q K^T, both [64 x 128] tiles K-major (two boxes each).
__device__ __forceinline__ void mul_qk(float* acc, const char* q,
                                       const char* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk >> 2) * ATOM + (kk & 3) * 32;
    wgmma_ss_m64n64(acc, desc_sw128(q + off, 16, 1024),
                    desc_sw128(k + off, 16, 1024), kk > 0);
  }
}

// o[64 x 128] += P[64 x 64] V[64 x 128], P from registers, V MN-major.
__device__ __forceinline__ void mul_pv(float* o, const uint32_t (*p)[4],
                                       const char* v) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_m64n128(o, p[kk], desc_sw128(v + kk * 2048, 8192, 1024));
}

// Block (64-query tile, batch x head). out [B, Lq, 256] f32, head h's
// columns at 128h; rec [B, 2, Lq, S] and lse [B, 2, Lq] f32.
__global__ void __launch_bounds__(kThreads, 1)
lse_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const int* __restrict__ count_ptr, float* __restrict__ out,
           float* __restrict__ rec, float* __restrict__ lse, int B, int Lq,
           int S, int Lk, float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  float* slot_l = reinterpret_cast<float*>(smem + SLOT_OFF);
  float* slot_m = slot_l + SLOT_FLOATS;
  float* xm = reinterpret_cast<float*>(smem + XROW_OFF);
  float* xl = xm + BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int count = clamp_count(count_ptr, S);
  const int cps = (Lk + BK - 1) / BK;
  const int nch = count * cps;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);   // lane 0 of each warp of its consumer
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, TILE);
      for (int a = 0; a < 2; ++a)
        tma_load(smem + a * ATOM, &tm_q, qbar, a * 64, h, q0, b);
      for (int j = 0; j < nch; ++j) {
        const int st = j % STAGES, use = j / STAGES;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        char* sk = smem + TILE + st * STAGE_BYTES;
        const int z = (j / cps) * B + b, key0 = (j % cps) * BK;
        mbar_expect_tx(&full[st], STAGE_BYTES);
        for (int a = 0; a < 2; ++a) {
          tma_load(sk + a * ATOM, &tm_k, &full[st], a * 64, h, key0, z);
          tma_load(sk + TILE + a * ATOM, &tm_v, &full[st], a * 64, h, key0,
                   z);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: the chunks j = cw, cw + 2, ... ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;   // rows of the tile
  float* my_l = slot_l + cw * MAX_SLOTS * BQ;
  float* my_m = slot_m + cw * MAX_SLOTS * BQ;
  if (t4 == 0) {
    for (int s = 0; s < S; ++s) {
      my_l[s * BQ + ra] = my_l[s * BQ + rb] = 0.f;
      my_m[s * BQ + ra] = my_m[s * BQ + rb] = -INFINITY;
    }
  }
  const int n_my = nch > cw ? (nch - cw + 1) / NCONS : 0;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // this thread's two rows: running maximum (log2 units), the sum of p over
  // every chunk walked and over the current slot's, both relative to it
  float m0 = -INFINITY, m1 = -INFINITY, L0 = 0.f, L1 = 0.f;
  float l0 = 0.f, l1 = 0.f;
  int slot = -1;
  // books the current slot's sums (four threads a row) and its maximum
  auto book = [&]() {
    const float a = quad_sum(l0), c = quad_sum(l1);
    if (t4 == 0) {
      my_l[slot * BQ + ra] = a;
      my_l[slot * BQ + rb] = c;
      my_m[slot * BQ + ra] = m0;
      my_m[slot * BQ + rb] = m1;
    }
  };
  float sc[32];
  uint32_t pa[BK / 16][4];
  mbar_wait(qbar, 0);
  if (n_my > 0) {
    mbar_wait(&full[cw % STAGES], (cw / STAGES) & 1);
    wgmma_fence();
    mul_qk(sc, smem, smem + TILE + (cw % STAGES) * STAGE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
  }

  for (int i = 0; i < n_my; ++i) {
    const int j = cw + NCONS * i, st = j % STAGES;
    const int js = j / cps, key0 = (j % cps) * BK;

    // ---- the key mask: only a slot's last chunk reaches past Lk ----
    if (key0 + BK > Lk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key0 + n * 8 + 2 * t4 + e < Lk;
          sc[4 * n + e] = ok ? sc[4 * n + e] : -INFINITY;
          sc[4 * n + 2 + e] = ok ? sc[4 * n + 2 + e] : -INFINITY;
        }
      }
    }

    // ---- online softmax (log2 units): the scale is positive, so the
    // scaled logits' maximum is the logits' maximum scaled; every chunk
    // holds a valid key, so mn is finite ----
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, sc[4 * n + e]);
        mx1 = fmaxf(mx1, sc[4 * n + 2 + e]);
      }
    }
    if (js != slot) {   // the walk enters a slot: book the one it leaves
      if (slot >= 0) book();
      slot = js;
      l0 = l1 = 0.f;
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * n + e] = exp2_approx(fmaf(sc[4 * n + e], scale_log2, -mn0));
        sc[4 * n + 2 + e] =
            exp2_approx(fmaf(sc[4 * n + 2 + e], scale_log2, -mn1));
        ps0 += sc[4 * n + e];
        ps1 += sc[4 * n + 2 + e];
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    L0 = L0 * a0 + ps0;
    L1 = L1 * a1 + ps1;

    // ---- the previous chunk's P.V is done: release its stage, rescale O,
    // and P of this chunk takes P's registers ----
    if (i > 0) {
      wgmma_wait<0>();
      fence_regs<64>(o);
      fence_operand<16>(&pa[0][0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j - NCONS) % STAGES]);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // ---- S of this consumer's next chunk, then O += P V of this one ----
    const bool more = i + 1 < n_my;
    if (more)
      mbar_wait(&full[(j + NCONS) % STAGES], ((j + NCONS) / STAGES) & 1);
    fence_regs<64>(o);
    wgmma_fence();
    if (more) {
      mul_qk(sc, smem, smem + TILE + ((j + NCONS) % STAGES) * STAGE_BYTES);
      wgmma_commit();
    }
    mul_pv(o, pa, smem + TILE + st * STAGE_BYTES + TILE);
    wgmma_commit();
    if (more) {
      wgmma_wait<1>();   // S is ready; P.V runs on into the next softmax
      fence_regs<32>(sc);
    }
  }
  if (n_my > 0) {
    wgmma_wait<0>();
    fence_regs<64>(o);
    fence_operand<16>(&pa[0][0]);
    __syncwarp();
    if (lane == 0)
      mbar_arrive(&empty[(cw + NCONS * (n_my - 1)) % STAGES]);
    book();
  }
  L0 = quad_sum(L0);
  L1 = quad_sum(L1);

  // ---- merge the two consumers: the second leaves O, m and L in its own
  // (finished) stage and the row arrays, the first combines ----
  float* xo = reinterpret_cast<float*>(smem + TILE + STAGE_BYTES);
  if (cw == 1) {
#pragma unroll
    for (int k = 0; k < 64; ++k) xo[k * 128 + tid] = o[k];
    if (t4 == 0) {
      xm[ra] = m0;
      xm[rb] = m1;
      xl[ra] = L0;
      xl[rb] = L1;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NCONS) : "memory");
  if (cw == 0) {   // the merge; the second consumer is done
    const float mo0 = xm[ra], mo1 = xm[rb];
    const float M0 = fmaxf(m0, mo0), M1 = fmaxf(m1, mo1);
    const float w0 = m0 == -INFINITY ? 0.f : exp2f(m0 - M0);
    const float w1 = m1 == -INFINITY ? 0.f : exp2f(m1 - M1);
    const float v0 = mo0 == -INFINITY ? 0.f : exp2f(mo0 - M0);
    const float v1 = mo1 == -INFINITY ? 0.f : exp2f(mo1 - M1);
    const float T0 = w0 * L0 + v0 * xl[ra], T1 = w1 * L1 + v1 * xl[rb];
    const float i0 = T0 > 0.f ? 1.f / T0 : 0.f, i1 = T1 > 0.f ? 1.f / T1 : 0.f;
    const int qa = q0 + ra, qb = q0 + rb;
    float* orow = out + (size_t)b * Lq * C + h * D;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + 2 * t4;
      if (qa < Lq)
        *reinterpret_cast<float2*>(orow + (size_t)qa * C + col) = make_float2(
            (w0 * o[4 * n] + v0 * xo[(4 * n) * 128 + tid]) * i0,
            (w0 * o[4 * n + 1] + v0 * xo[(4 * n + 1) * 128 + tid]) * i0);
      if (qb < Lq)
        *reinterpret_cast<float2*>(orow + (size_t)qb * C + col) = make_float2(
            (w1 * o[4 * n + 2] + v1 * xo[(4 * n + 2) * 128 + tid]) * i1,
            (w1 * o[4 * n + 3] + v1 * xo[(4 * n + 3) * 128 + tid]) * i1);
    }
    const size_t row_a = (size_t)bh * Lq + qa, row_b = (size_t)bh * Lq + qb;
    if (t4 == 0) {
      if (qa < Lq) lse[row_a] = (M0 + log2f(T0)) * LN2;
      if (qb < Lq) lse[row_b] = (M1 + log2f(T1)) * LN2;
    }
    const float* l_1 = slot_l + MAX_SLOTS * BQ;
    const float* m_1 = slot_m + MAX_SLOTS * BQ;
    for (int s = t4; s < S; s += 4) {
      float r0 = 0.f, r1 = 0.f;
      if (s < count) {
        r0 = (my_l[s * BQ + ra] * exp2f(my_m[s * BQ + ra] - M0) +
              l_1[s * BQ + ra] * exp2f(m_1[s * BQ + ra] - M0)) * i0;
        r1 = (my_l[s * BQ + rb] * exp2f(my_m[s * BQ + rb] - M1) +
              l_1[s * BQ + rb] * exp2f(m_1[s * BQ + rb] - M1)) * i1;
      }
      if (qa < Lq) rec[row_a * S + s] = r0;
      if (qb < Lq) rec[row_b * S + s] = r1;
    }
  }
}

}  // namespace rmem_lse128

// K1'x2v128: 2 heads of 128 with values 128 a head, every key valid, no
// bias, any batch, 1 <= S <= 16 slots, 0 < Lk. q [B, Lq, 256], k, v [S, B,
// Lk, 256] bf16 (contiguous, 16-byte aligned); count an int32 on the card.
// out [B, Lq, 256] f32, rec [B, 2, Lq, S] f32 (each head's slot mass, 0 past
// count), lse [B, 2, Lq] f32 (each head's natural-log log-sum-exp of the
// scaled logits over the valid slots). Returns the cudaError_t of the
// launch (0 on success), -1 for a shape it does not take, -2 or -3 if a
// tensor map cannot be made.
extern "C" int rmem_bank_attention_lse_v128(
    const void* q, const void* k, const void* v, const void* count,
    void* out, void* rec, void* lse, int B, int H, int Lq, int S, int Lk,
    float scale, void* stream) {
  using namespace rmem_lse128;
  if (H != rmem_lse128::H || S < 1 || S > MAX_SLOTS || Lk < 1 || B < 1 ||
      Lq < 1)
    return -1;
  CUtensorMap tq, tk, tv;
  int e = map4d(&tq, q, D, rmem_lse128::H, Lq, B);
  if (e == 0) e = map4d(&tk, k, D, rmem_lse128::H, Lk, (uint64_t)S * B);
  if (e == 0) e = map4d(&tv, v, D, rmem_lse128::H, Lk, (uint64_t)S * B);
  if (e != 0) return e;
  static bool configured = false;     // once per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Lq + BQ - 1) / BQ, B * rmem_lse128::H);
  lse_kernel<<<grid, kThreads, SMEM_BYTES, (cudaStream_t)stream>>>(
      tq, tk, tv, (const int*)count, (float*)out, (float*)rec, (float*)lse,
      B, Lq, S, Lk, scale * LOG2E);
  return (int)cudaGetLastError();
}

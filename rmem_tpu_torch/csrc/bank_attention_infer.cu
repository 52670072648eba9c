// Bank attention with the slots split among blocks: the queries attend into
// the valid slots of the long-term memory bank, and each slot's share of
// the softmax mass is returned beside the output (RMem's eviction signal).
// One kernel template, instantiated for three uses:
//   - K1: with a per-(query, slot) logit bias (the factored slot temporal
//     PE) and the keys masked past true_lk, at values a multiple of 256 a
//     head (csrc/bank_attention_infer_v128.cu takes 128). Replaces
//     rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_infer
//     (_forward, _kernel) and, with one slot and no bias, the reference
//     frame's self-memory call of pallas_bank_attention;
//   - K3: neither; the slot PE arrives added to the keys. Replaces
//     pallas_bank_attention_qminor (_kernel_qminor, _forward_qminor);
//   - K1', training's forward: as K3, with f32 partial outputs, an f32
//     output and each head's per-row log-sum-exp for the backward
//     (csrc/bank_attention_bwd.cu), at values a multiple of 256 a head
//     (csrc/bank_attention_lse_v128.cu takes 128). Replaces the forward of
//     pallas_bank_attention's VJP (_forward with want_lse). The output stays
//     f32 all the way: the backward's row term delta = rowsum(dout * out)
//     is a small difference of large terms, and an output carrying bf16
//     rounding missed dq by 7.5e-2 of its largest value on a training call.
// K3's TPU kernel runs the grid (bh, slots x chunks, query tiles) so that
// each K/V chunk is fetched once and every query tile streams past it, with
// the online-softmax state and an [Lq, dv] f32 accumulator for all queries
// kept in VMEM. At the main path that accumulator is 1674 x 1024 x 4 B =
// 6.9 MB, 30x an SM's shared memory, so the order cannot keep its state on
// chip here. What this kernel takes from it is the other axis of the work:
// the slots.
//
// What bounds it on an H100: operations. At the main path (Lq = Lk = 1674,
// 9 valid slots, dh 128, dv 1024) the work is 2 Lq (S Lk) (dh + dv) ~ 5.8e10
// FLOP against ~40 MB of bank read: ~59 us at 989 TFLOP/s; at training's
// (B 4, Lq = Lk = 900, up to 4 valid slots) 3.0e10 FLOP, ~30 us. The full
// tensor-core rate needs wgmma fed by TMA, so the kernel is built on them.
//
// Design. A block owns 128 queries (two consumer warpgroups of 64 rows) of
// one head, a DVB-wide slice of that head's dv and a group of G slots; the
// grid is (query tile, dv slice, (batch x head) x slot group), the heads
// folded in as rmem_tpu/kernels/bank_attention.py:_layout folds them but
// without its transposes: every tensor keeps its [.., H x d] rows and the
// tensor maps pick a head's columns out of them. Blocks whose group starts
// at or beyond the slot count, read on the device, return before any
// barrier or copy, so a frame never waits for the host. Heads: 1 or 2, of
// 128 with values a multiple of DVB = 256 a head (DeAOT's, and DeAOT's
// no_memory_gap with 512 values a head); AOT's no_memory_gap, with values
// 128 a head, has its own kernels (csrc/bank_attention_infer_v128.cu,
// csrc/bank_attention_lse_v128.cu).
//   - A producer warpgroup (one thread, its registers given back with
//     setmaxnreg) loads the two Q tiles once and then keeps the block's K
//     and V chunks (64 keys: K [64 x 128], V [64 x DVB]) in flight by TMA
//     into a ring of 3 stages, each with a full and an empty mbarrier. The
//     tensor maps are 4-D, [slot x batch, key, head, column], so a chunk
//     never runs across two slots, a box holds one head's columns, and the
//     keys past Lk arrive as zeros. A slot
//     takes ceil(true_lk / 64) chunks, so every chunk holds a key below
//     true_lk.
//   - Each consumer warpgroup runs, per chunk, S = Q K^T as wgmma m64n64k16
//     from shared memory (K-major, 128-byte swizzle, as TMA wrote it), the
//     key mask at true_lk (a zero key past Lk would give logit 0, not -inf,
//     and a key in [true_lk, Lk) is padding), the bias of the chunk's slot
//     (K1: each row loads its G values once a block, in log2 units), the
//     online softmax in registers (exp2, four threads a row), and O += P V as
//     wgmma m64n256k16 with P in registers (the accumulator's layout is the
//     A operand's, so P needs no shuffle) and V from shared memory
//     (MN-major). O is 64 x DVB f32: DVB / 2 registers a thread.
//   - The two warpgroups share every K/V chunk, so the bank is read from L2
//     once per 128 queries and DVB columns. Q K^T is recomputed for each
//     dv slice (at one head of 1024 values, four: 1.33x the minimal work),
//     in exchange for no exchange of P between blocks.
// Each block writes its partial state: the row maximum m over its group
// (log2 units), the per-slot row sums l_s (relative to m) and its output
// normalised by its own sum, in bf16 (ceil(S / G) x B x H x Lq x dv x 2
// bytes, 17.1 MB at the main path with G = 2 over the bank's 10 slots at
// one head or two of half the values: half of
// the f32 accumulator it replaces); K1' keeps them in f32 (kF32), 29.5 MB
// written and read back at training's 4 valid slots. A second kernel reads
// the count and merges the groups of each row: with w_g = 2^(m_g - M)
// sum_{s in g} l_s, per head,
//   out   = sum_g w_g o_g / sum_g w_g            (bf16; f32 for K1')
//   rec_s = 2^(m_g(s) - M) l_s / sum_g w_g       (0 for slots >= count;
//                                                 the wrapper takes the
//                                                 head mean)
//   lse   = (M + log2 sum_g w_g) / log2(e)       (K1' only: natural units).
// G = 2 is fixed at compile time. Of 1, 2, 3 and 9 slots a block on this
// design (PERF.md), it is fastest at batch 1 on the 31 x 54 grid, and on
// phase 7's calls of chip_smoke.py (batch 2, half on 31 x 54, half on
// 40 x 70) it ties with 3 within 2 %.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace rmem_qminor {

using namespace rmem_hopper;
using bf16 = __nv_bfloat16;
constexpr int D = 128;        // head width: two 64-wide K-major atoms
constexpr int BQ = 64;        // query rows of one consumer warpgroup
constexpr int NCONS = 2;      // consumer warpgroups: 128 queries a block
constexpr int BK = 64;        // keys a chunk
constexpr int STAGES = 3;     // K/V chunks in flight
constexpr int kThreads = 128 * (1 + NCONS);
constexpr int G = 2;          // slots a block walks
constexpr int ATOM = 64 * 128;              // one [64 x 64] bf16 TMA box
constexpr int Q_BYTES = NCONS * 2 * ATOM;
constexpr int K_BYTES = 2 * ATOM;
constexpr int DVB = 256;      // value columns a block: four 64-wide boxes
constexpr int STAGE_BYTES = K_BYTES + (DVB / 64) * ATOM;
constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
// + 1024: the dynamic shared memory is aligned up to 1024 bytes by hand,
// the period of the 128-byte swizzle that TMA and wgmma must agree on
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
constexpr int kMergeThreads = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Two neighbouring columns of a partial output: bf16 for K1 and K3, f32 for
// K1' (the training output must not carry bf16 rounding).
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
// Eight columns of a partial output as f32.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One (128-query tile, DVB-wide slice of a head's DV columns, (batch x
// head) x slot group), bh = b H + h: part_m [NG, B H, Lq] and part_l
// [S, B H, Lq] f32, part_o [NG, B H, Lq, DV] bf16 (f32 with kF32). With
// kBias, qbias [B, H, Lq, S] f32 (natural units, or null for none) is added
// to the scaled logits and keys >= true_lk are masked; without, true_lk =
// Lk.
template <bool kBias, bool kF32>
__global__ void __launch_bounds__(kThreads, 1)
partial_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const int* __restrict__ count_ptr,
               const float* __restrict__ qbias, float* __restrict__ part_m,
               float* __restrict__ part_l,
               std::conditional_t<kF32, float, bf16>* __restrict__ part_o,
               int B, int H, int Lq, int S, int true_lk, int DV,
               float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int ngroups = (S + G - 1) / G;
  const int grp = blockIdx.z % ngroups, bh = blockIdx.z / ngroups;
  const int b = bh / H, h = bh % H, BH = B * H;
  int count = *count_ptr;
  count = count < 0 ? 0 : (count > S ? S : count);
  const int s0 = grp * G;
  if (s0 >= count) return;  // the whole block, before any barrier or copy
  const int ns = count - s0 < G ? count - s0 : G;
  const int cps = (true_lk + BK - 1) / BK;
  const int nch = ns * cps;
  const int q0 = blockIdx.x * (BQ * NCONS), c0 = blockIdx.y * DVB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NCONS);   // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int c = 0; c < NCONS; ++c)
        for (int a = 0; a < 2; ++a)
          tma_load(smem + (c * 2 + a) * ATOM, &tm_q, qbar, a * 64, h,
                   q0 + c * BQ, b);
      for (int ch = 0; ch < nch; ++ch) {
        const int st = ch % STAGES, use = ch / STAGES;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        char* sk = smem + Q_BYTES + st * STAGE_BYTES;
        char* sv = sk + K_BYTES;
        const int z = (s0 + ch / cps) * B + b, key0 = (ch % cps) * BK;
        mbar_expect_tx(&full[st], STAGE_BYTES);
        for (int a = 0; a < 2; ++a)
          tma_load(sk + a * ATOM, &tm_k, &full[st], a * 64, h, key0, z);
        for (int a = 0; a < DVB / 64; ++a)
          tma_load(sv + a * ATOM, &tm_v, &full[st], c0 + a * 64, h, key0, z);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int t4 = lane & 3;
    const char* sq = smem + cw * 2 * ATOM;
    float o[DVB / 2];
#pragma unroll
    for (int i = 0; i < DVB / 2; ++i) o[i] = 0.f;
    // this thread's two rows (g and g + 8 of its warp's 16): running max
    // (log2 units) and per-slot sums of its own four columns of each chunk
    float m0 = -INFINITY, m1 = -INFINITY;
    float la[G], lb[G];
#pragma unroll
    for (int j = 0; j < G; ++j) la[j] = lb[j] = 0.f;
    const int qa = q0 + cw * BQ + warp * 16 + (lane >> 2), qb = qa + 8;
    // the bias of this thread's two rows for the group's slots (log2 units)
    float ba[G], bb[G];
#pragma unroll
    for (int j = 0; j < G; ++j) ba[j] = bb[j] = 0.f;
    if (kBias && qbias != nullptr) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j >= ns) break;
        if (qa < Lq) ba[j] = qbias[((size_t)bh * Lq + qa) * S + s0 + j] * LOG2E;
        if (qb < Lq) bb[j] = qbias[((size_t)bh * Lq + qb) * S + s0 + j] * LOG2E;
      }
    }
    mbar_wait(qbar, 0);

    for (int ch = 0; ch < nch; ++ch) {
      const int st = ch % STAGES;
      mbar_wait(&full[st], (ch / STAGES) & 1);
      const char* sk = smem + Q_BYTES + st * STAGE_BYTES;
      const char* sv = sk + K_BYTES;

      // ---- S = Q K^T, [64 x 64] f32 ----
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * ATOM + (kk & 3) * 32;
        wgmma_ss_m64n64(sc, desc_sw128(sq + off, 16, 1024),
                        desc_sw128(sk + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(sc);

      // ---- mask, bias, online softmax (log2 units) ----
      const int key0 = (ch % cps) * BK, js = ch / cps;
      float bias0 = 0.f, bias1 = 0.f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j == js) {
          bias0 = ba[j];
          bias1 = bb[j];
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key0 + i * 8 + 2 * t4 + e < true_lk;
          float x0 = sc[4 * i + e] * scale_log2;
          float x1 = sc[4 * i + 2 + e] * scale_log2;
          if (kBias) {
            x0 += bias0;
            x1 += bias1;
          }
          sc[4 * i + e] = ok ? x0 : -INFINITY;
          sc[4 * i + 2 + e] = ok ? x1 : -INFINITY;
          mx0 = fmaxf(mx0, sc[4 * i + e]);
          mx1 = fmaxf(mx1, sc[4 * i + 2 + e]);
        }
      }
      // every chunk holds a key below true_lk, so the new maxima are finite
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * i + e] = exp2f(sc[4 * i + e] - mn0);
          sc[4 * i + 2 + e] = exp2f(sc[4 * i + 2 + e] - mn1);
          ps0 += sc[4 * i + e];
          ps1 += sc[4 * i + 2 + e];
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        la[j] = la[j] * a0 + (j == js ? ps0 : 0.f);
        lb[j] = lb[j] * a1 + (j == js ? ps1 : 0.f);
      }
#pragma unroll
      for (int i = 0; i < DVB / 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }

      // ---- O += P V: P from the S accumulator's registers ----
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      // V's 64-wide boxes lie 8 KB apart (the leading offset), its 8-key
      // groups 1024 bytes (the stride)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_m64n256(o, pa[kk], desc_sw128(sv + kk * 2048, 8192, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<DVB / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with it
    }

    // ---- the partial state ----
    float La = 0.f, Lb = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      la[j] = quad_sum(la[j]);
      lb[j] = quad_sum(lb[j]);
      La += la[j];
      Lb += lb[j];
    }
    const float ia = La > 0.f ? 1.f / La : 0.f;
    const float ib = Lb > 0.f ? 1.f / Lb : 0.f;
    auto* po = part_o + ((size_t)grp * BH + bh) * Lq * DV;
#pragma unroll
    for (int i = 0; i < DVB / 8; ++i) {
      const int col = c0 + 8 * i + 2 * t4;
      if (qa < Lq)
        store2(po + (size_t)qa * DV + col, o[4 * i] * ia, o[4 * i + 1] * ia);
      if (qb < Lq)
        store2(po + (size_t)qb * DV + col, o[4 * i + 2] * ib,
               o[4 * i + 3] * ib);
    }
    // one dv slice writes m and the per-slot l; every slice computed the
    // same values from the same logits
    if (blockIdx.y == 0 && t4 == 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j >= ns) break;
        const size_t base = ((size_t)(s0 + j) * BH + bh) * Lq;
        if (qa < Lq) part_l[base + qa] = la[j];
        if (qb < Lq) part_l[base + qb] = lb[j];
      }
      const size_t base = ((size_t)grp * BH + bh) * Lq;
      if (qa < Lq) part_m[base + qa] = m0;
      if (qb < Lq) part_m[base + qb] = m1;
    }
  }
}

// One row of one head and 8 columns a thread: merges the slot groups of the
// row. out [B, Lq, H DV] bf16, head h's columns at h DV (with kF32: f32,
// and lse [B, H, Lq] f32 in natural units, each head's); rec [B, H, Lq, S]
// f32, each head's slot mass.
template <bool kF32>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_m,
             const float* __restrict__ part_l,
             const std::conditional_t<kF32, float, bf16>* __restrict__ part_o,
             const int* __restrict__ count_ptr,
             std::conditional_t<kF32, float, bf16>* __restrict__ out,
             float* __restrict__ rec, float* __restrict__ lse, int B, int H,
             int Lq, int S, int DV) {
  const int row = blockIdx.x;                    // (b H + h) Lq + qi
  const int bh = row / Lq, qi = row % Lq, b = bh / H, h = bh % H;
  const int BH = B * H;
  const int col = (blockIdx.y * kMergeThreads + threadIdx.x) * 8;
  int count = *count_ptr;
  count = count < 0 ? 0 : (count > S ? S : count);
  const int ng = (count + G - 1) / G;
  float M = -INFINITY;
  for (int g = 0; g < ng; ++g)
    M = fmaxf(M, part_m[((size_t)g * BH + bh) * Lq + qi]);
  float Lsum = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int g = 0; g < ng; ++g) {
    const int s1 = (g + 1) * G < count ? (g + 1) * G : count;
    float lg = 0.f;
    for (int s = g * G; s < s1; ++s)
      lg += part_l[((size_t)s * BH + bh) * Lq + qi];
    const float wg = exp2f(part_m[((size_t)g * BH + bh) * Lq + qi] - M) * lg;
    Lsum += wg;
    if (col < DV) {
      float v[8];
      load8(part_o + (((size_t)g * BH + bh) * Lq + qi) * DV + col, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += wg * v[j];
    }
  }
  const float il = Lsum > 0.f ? 1.f / Lsum : 0.f;
  if (col < DV) {
    auto* orow = out + (((size_t)b * Lq + qi) * H + h) * DV + col;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store2(orow + 2 * j, acc[2 * j] * il, acc[2 * j + 1] * il);
  }
  if (kF32 && blockIdx.y == 0 && threadIdx.x == 0)
    lse[row] = (M + log2f(Lsum)) * LN2;
  if (blockIdx.y == 0 && (int)threadIdx.x < S) {
    const int s = threadIdx.x;
    float r = 0.f;
    if (s < count)
      r = exp2f(part_m[((size_t)(s / G) * BH + bh) * Lq + qi] - M) *
          part_l[((size_t)s * BH + bh) * Lq + qi] * il;
    rec[(size_t)row * S + s] = r;
  }
}

template <bool kBias, bool kF32>
static int launch(const void* q, const void* k, const void* v,
                  const void* qbias, const void* count, void* part_m,
                  void* part_l, void* part_o, void* out, void* rec, void* lse,
                  int B, int H, int Lq, int S, int Lk, int true_lk, int DV,
                  float scale, cudaStream_t stream) {
  using OT = std::conditional_t<kF32, float, bf16>;
  CUtensorMap tq, tk, tv;
  int e = map4d(&tq, q, D, H, Lq, B);
  if (e == 0) e = map4d(&tk, k, D, H, Lk, (uint64_t)S * B);
  if (e == 0) e = map4d(&tv, v, DV, H, Lk, (uint64_t)S * B);
  if (e != 0) return e;
  auto kern = partial_kernel<kBias, kF32>;
  static bool configured = false;     // once per process and instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int ngroups = (S + G - 1) / G;
  dim3 grid((Lq + BQ * NCONS - 1) / (BQ * NCONS), DV / DVB,
            B * H * ngroups);
  kern<<<grid, kThreads, SMEM_BYTES, stream>>>(
      tq, tk, tv, (const int*)count, (const float*)qbias, (float*)part_m,
      (float*)part_l, (OT*)part_o, B, H, Lq, S, true_lk, DV, scale * LOG2E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2(B * H * Lq, (DV / 8 + kMergeThreads - 1) / kMergeThreads);
  merge_kernel<kF32><<<grid2, kMergeThreads, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const OT*)part_o,
      (const int*)count, (OT*)out, (float*)rec, (float*)lse, B, H, Lq, S,
      DV);
  return (int)cudaGetLastError();
}

}  // namespace rmem_qminor

// Returns the cudaError_t of the launches (0 on success); -1 for anything
// but 1 or 2 heads of 128 with dv (a head's values) a multiple of 256 and
// true_lk in 1..Lk, -2 or -3 if a tensor map cannot be made.
// q [B, Lq, H x 128], k [S, B, Lk, H x 128], v [S, B, Lk, H x dv]; qbias
// [B, H, Lq, S] f32 (scaled logit units) or null; keys >= true_lk masked.
// With a bias or padded keys (K1) the kernel's kBias instantiation runs,
// with neither (K3, and K1's reference-frame call) the other. Scratch, with G =
// rmem_bank_attention_infer_slots(): part_m [ceil(S/G), B H, Lq] and part_l
// [S, B H, Lq] f32, part_o [ceil(S/G), B H, Lq, dv] bf16. q, k, v 16-byte
// aligned; out [B, Lq, H x dv] bf16, rec [B, H, Lq, S] f32 (each head's
// slot mass).
extern "C" int rmem_bank_attention_infer(
    const void* q, const void* k, const void* v, const void* qbias,
    const void* count, void* part_m, void* part_l, void* part_o, void* out,
    void* rec, int B, int H, int Lq, int S, int Lk, int true_lk, int dh,
    int dv, float scale, void* stream) {
  if ((H != 1 && H != 2) || dh != 128 || dv % 256 != 0 ||
      true_lk < 1 || true_lk > Lk)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (qbias == nullptr && true_lk == Lk)
    return rmem_qminor::launch<false, false>(
        q, k, v, nullptr, count, part_m, part_l, part_o, out, rec, nullptr, B,
        H, Lq, S, Lk, Lk, dv, scale, st);
  return rmem_qminor::launch<true, false>(
      q, k, v, qbias, count, part_m, part_l, part_o, out, rec, nullptr, B, H,
      Lq, S, Lk, true_lk, dv, scale, st);
}

// K1', training's forward: 1 or 2 heads of 128 with values a multiple of
// 256 a head (DeAOT's, and DeAOT's no_memory_gap; AOT's no_memory_gap, with
// values 128 a head, has its own kernel, csrc/bank_attention_lse_v128.cu),
// every key valid, no bias, f32 partial outputs. Layouts and scratch as
// above with part_o f32; out [B, Lq, H x dv] f32, rec [B, H, Lq, S] f32
// (each head's slot mass), lse [B, H, Lq] f32 (the natural log of each
// head's row sum of exp of the scaled logits over the valid slots). Returns
// as rmem_bank_attention_infer.
extern "C" int rmem_bank_attention_lse(
    const void* q, const void* k, const void* v, const void* count,
    void* part_m, void* part_l, void* part_o, void* out, void* rec,
    void* lse, int B, int H, int Lq, int S, int Lk, int dh, int dv,
    float scale, void* stream) {
  if ((H != 1 && H != 2) || dh != 128 || dv % 256 != 0 || Lk < 1) return -1;
  return rmem_qminor::launch<false, true>(
      q, k, v, nullptr, count, part_m, part_l, part_o, out, rec, lse, B, H,
      Lq, S, Lk, Lk, dv, scale, (cudaStream_t)stream);
}

// The slots a block walks.
extern "C" int rmem_bank_attention_infer_slots() { return rmem_qminor::G; }

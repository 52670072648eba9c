// Bank attention at 8 heads of 32 (kernels K1h and K1'h): the long-term
// attention of AOT's LSTT, from the frame's queries into the valid slots of
// the memory bank, with each slot's share of the softmax mass (the eviction
// signal).
//
// Replaces rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_infer
// and the forward of pallas_bank_attention at num_heads = 8, the AOT
// family's head count (rmem_tpu/config.py:53): the Pallas kernel folds the
// heads into its grid's first axis (_layout) and averages the slot mass
// over them outside the kernel (_unlayout_out). mh_kernel<false> is the
// inference kernel K1h (bf16 output, optional slot-PE bias); mh_kernel<true>
// is training's forward K1'h, the VJP forward of pallas_bank_attention
// (_bank_attention_fwd, want_lse): no bias (training adds the slot PE to
// the keys), every key valid, an f32 output for the backward's row term
// and each head's natural-log lse, M ln 2 + ln L. Its backward is K2h,
// csrc/bank_attention_mh_bwd.cu.
//
// Per head h (columns 32h .. 32h + 31 of q, k and v), query i, valid slot
// s < count and key j < true_lk: x = q.k * scale + qbias[b, h, i, s],
// p = softmax over every (s, j) of the row, out = sum p v, and the slot mass
// rec[b, h, i, s] = sum_j p (the wrapper takes the mean over the heads).
// Slots at or past count are skipped; keys at or past true_lk (zero padding)
// are masked, never read.
//
// What bounds it on an H100: operations. At the main path's call (Lq = Lk
// = 1674, 9 valid slots) the two products take 2 Lq (9 Lk) (32 + 32) 8 =
// 2.6e10 FLOP, 26 us at 989 TFLOP/s, against ~18 MB moved (5.5 us at 3.35
// TB/s). With heads this narrow the softmax's exponentials (2.0e8 of them)
// weigh as much as the products, and they run on the SMs' special-function
// units, not the tensor cores. K1'h at the training call (B 4, Lq = Lk =
// 900, 4 valid slots): 1.3e10 FLOP (13 us) and 1.0e8 exponentials.
//
// Design (simple first; no TMA, no wgmma): one block of 8 warps takes 128
// queries of one head of one batch row, so at 481 x 849 the grid is 14 query
// tiles x 8 heads x B (PERF.md has the sweep of 2, 4 and 8 warps that chose
// it: within 4 % at the main call, 9 % apart at batch 2). It walks every valid slot's keys in 64-key chunks
// (ceil(true_lk / 64) a slot), the next chunk's K and V [64 x 32] tiles in
// flight by cp.async (16 bytes a thread from the head's 64-byte slice of a
// 512-byte row; keys past true_lk are zero-filled, not read) while this one
// computes. Each warp owns 16 query rows: S = Q K^T is 2 k-steps of
// mma.sync m16n8k16 over 8 key tiles, with Q's fragments held in registers;
// the online softmax runs in exp2 (the scale and the bias in log2 units); O
// += P V takes the S accumulator, in bf16, as the A operand and V through
// ldmatrix.trans, 4 value tiles of 8.
// The slot mass under the online softmax: a row keeps its running maximum M
// over every slot so far, its total sum L and the current slot's sum l_s,
// both relative to M and both rescaled whenever M grows. When a slot's last
// chunk is done, (M, l_s) goes to shared memory and l_s restarts; at the end
// rec_s = 2^(M_s - M) l_s / L, with M the row's final maximum. Every chunk
// holds at least one key below true_lk, so the maximum is finite from the
// first chunk on.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace rmem_mh {

using bf16 = __nv_bfloat16;
using namespace rmem_mma;

constexpr int H = 8;              // heads
constexpr int D = 32;             // width of a head's queries, keys, values
constexpr int C = H * D;          // row width of q, k, v and out
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;    // threads
constexpr int BQ = 16 * WARPS;    // queries of a block
constexpr int BK = 64;            // keys of a chunk
constexpr int LD = D + 8;         // bf16 pitch of the Q, K and V tiles
constexpr int MAX_SLOTS = 16;     // slots whose mass a block keeps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// K1'h's output: two f32 values, never rounded to bf16
__device__ __forceinline__ void store_f32x2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// q [B, Lq, C]; k, v [S, B, Lk, C]; qbias [B, H, Lq, S] f32 or null (read
// only by K1h); count an int32 on the card; out [B, Lq, C], bf16 (K1h) or
// f32 (K1'h); rec [B, H, Lq, S] f32, each head's slot mass; lse [B, H, Lq]
// f32 (K1'h only). Block (query tile, head, batch row).
template <bool kTrain>
__global__ void __launch_bounds__(NT)
mh_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const float* __restrict__ qbias,
          const int* __restrict__ count, void* __restrict__ out,
          float* __restrict__ rec, float* __restrict__ lse, int B, int Lq,
          int S, int Lk, int true_lk, float scale_log2) {
  __shared__ __align__(128) bf16 sQ[BQ * LD];
  __shared__ __align__(128) bf16 sK[2][BK * LD];
  __shared__ __align__(128) bf16 sV[2][BK * LD];
  __shared__ float sM[MAX_SLOTS][BQ];   // a row's maximum when a slot ended
  __shared__ float sL[MAX_SLOTS][BQ];   // that slot's sum, relative to it
  __shared__ float sTot[2][BQ];         // the row's final maximum and sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int cnt = min(max(*count, 0), S);
  const int nch = (true_lk + BK - 1) / BK;
  const int steps = cnt * nch;
  // this thread's two rows of the tile, and their queries
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qa = q0 + r0, qb = q0 + r1;

  // step i: chunk i % nch of slot i / nch, K and V into buffer buf
  auto load_chunk = [&](int i, int buf) {
    const int s = i / nch, key0 = (i - s * nch) * BK;
    const size_t base = ((size_t)s * B + b) * Lk;
    for (int e = tid; e < 2 * BK * (D / 8); e += NT) {
      const bool is_v = e >= BK * (D / 8);
      const int j = (e / (D / 8)) % BK, seg = e % (D / 8);
      const bool ok = key0 + j < true_lk;
      const bf16* src = (is_v ? v : k) + (base + (ok ? key0 + j : 0)) * C +
                        h * D + seg * 8;
      cp_async16((is_v ? sV[buf] : sK[buf]) + j * LD + seg * 8, src, ok);
    }
  };

  // ---- one group: Q and the first chunk ----
  for (int e = tid; e < BQ * (D / 8); e += NT) {
    const int r = e / (D / 8), seg = e % (D / 8);
    const bool ok = q0 + r < Lq;
    cp_async16(sQ + r * LD + seg * 8,
               q + ((size_t)b * Lq + (ok ? q0 + r : 0)) * C + h * D + seg * 8,
               ok);
  }
  if (steps > 0) load_chunk(0, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  unsigned qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                        (lane >> 4) * 8);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // over every slot so far
  float l0 = 0.f, l1 = 0.f;               // the total sums, relative to m
  float ls0 = 0.f, ls1 = 0.f;             // the current slot's sums
  float bias0 = 0.f, bias1 = 0.f;         // its bias, log2 units
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load_chunk(i + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // step i's chunk is in buffer buf
    const int s = i / nch, c = i - s * nch;
    if (c == 0) {
      bias0 = bias1 = 0.f;
      if (!kTrain && qbias != nullptr) {
        const float* bp = qbias + (size_t)(b * H + h) * Lq * S + s;
        if (qa < Lq) bias0 = bp[(size_t)qa * S] * LOG2E;
        if (qb < Lq) bias1 = bp[(size_t)qb * S] * LOG2E;
      }
    }
    const bf16* cK = sK[buf];
    const bf16* cV = sV[buf];

    // ---- S = Q K^T, 16 rows x 64 keys, in registers ----
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned kb[4];
        ldsm_x4(kb, cK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(sc[2 * np], qf[ks], kb[0], kb[1]);
        mma16816(sc[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // ---- scale, bias, key mask at true_lk (log2 units) ----
    const int key0 = c * BK;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = key0 + n * 8 + 2 * t + e < true_lk;
        sc[n][e] = ok ? fmaf(sc[n][e], scale_log2, bias0) : -INFINITY;
        sc[n][e + 2] = ok ? fmaf(sc[n][e + 2], scale_log2, bias1) : -INFINITY;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][e + 2]);
      }
    }

    // ---- online softmax; the chunk holds a valid key, so mn is finite ----
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = exp2f(sc[n][e] - mn0);
        sc[n][e + 2] = exp2f(sc[n][e + 2] - mn1);
        ps0 += sc[n][e];
        ps1 += sc[n][e + 2];
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    ls0 = ls0 * a0 + ps0;
    ls1 = ls1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0; o[n][1] *= a0; o[n][2] *= a1; o[n][3] *= a1;
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
      for (int np = 0; np < D / 16; ++np) {
        unsigned vb[4];
        ldsm_x4_t(vb, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + np * 16 + (lane >> 4) * 8);
        mma16816(o[2 * np], pa, vb[0], vb[1]);
        mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }

    // ---- the slot's last chunk: keep its sum and the maximum it is
    // relative to ----
    if (c == nch - 1) {
      const float t0 = quad_sum(ls0), t1 = quad_sum(ls1);
      if (t == 0) {
        sM[s][r0] = m0;
        sL[s][r0] = t0;
        sM[s][r1] = m1;
        sL[s][r1] = t1;
      }
      ls0 = ls1 = 0.f;
    }
    __syncthreads();  // buffer buf is free for the chunk after next
  }

  // ---- epilogue: normalise, write the valid rows (bf16, or f32 and the
  // lse for training) ----
  const float L0 = quad_sum(l0), L1 = quad_sum(l1);
  const float il0 = L0 > 0.f ? 1.f / L0 : 0.f;
  const float il1 = L1 > 0.f ? 1.f / L1 : 0.f;
  const size_t oa = ((size_t)b * Lq + qa) * C + h * D + 2 * t;
  const size_t ob = ((size_t)b * Lq + qb) * C + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if constexpr (kTrain) {
      float* fo = static_cast<float*>(out);
      if (qa < Lq) store_f32x2(fo + oa + n * 8, o[n][0] * il0, o[n][1] * il0);
      if (qb < Lq) store_f32x2(fo + ob + n * 8, o[n][2] * il1, o[n][3] * il1);
    } else {
      bf16* bo = static_cast<bf16*>(out);
      if (qa < Lq)
        *reinterpret_cast<unsigned*>(bo + oa + n * 8) =
            pack_bf16(o[n][0] * il0, o[n][1] * il0);
      if (qb < Lq)
        *reinterpret_cast<unsigned*>(bo + ob + n * 8) =
            pack_bf16(o[n][2] * il1, o[n][3] * il1);
    }
  }
  if constexpr (kTrain) {
    // the natural-log lse of each row's scaled logits, M ln 2 + ln L
    float* lrow = lse + ((size_t)b * H + h) * Lq;
    if (t == 0 && qa < Lq) lrow[qa] = (m0 + log2f(L0)) * LN2;
    if (t == 0 && qb < Lq) lrow[qb] = (m1 + log2f(L1)) * LN2;
  }
  if (t == 0) {
    sTot[0][r0] = m0;
    sTot[1][r0] = L0;
    sTot[0][r1] = m1;
    sTot[1][r1] = L1;
  }
  __syncthreads();
  // ---- the slot masses, rec_s = 2^(M_s - M) l_s / L, 0 past count ----
  for (int e = tid; e < BQ * S; e += NT) {
    const int r = e / S, s = e - r * S;
    if (q0 + r >= Lq) continue;
    float mass = 0.f;
    if (s < cnt && sTot[1][r] > 0.f)
      mass = exp2f(sM[s][r] - sTot[0][r]) * sL[s][r] / sTot[1][r];
    rec[(((size_t)b * H + h) * Lq + q0 + r) * S + s] = mass;
  }
}

}  // namespace rmem_mh

// K1h: 8 heads of 32, any batch, S <= 16 slots, 0 < true_lk <= Lk. Returns
// a CUDA error code (0 on success; -1 for a shape it does not take).
extern "C" int rmem_bank_attention_mh(const void* q, const void* k,
                                      const void* v, const void* qbias,
                                      const void* count, void* out, void* rec,
                                      int B, int H, int Lq, int S, int Lk,
                                      int true_lk, float scale,
                                      void* stream) {
  using namespace rmem_mh;
  if (H != rmem_mh::H || S < 1 || S > MAX_SLOTS || true_lk < 1 ||
      true_lk > Lk || B < 1 || Lq < 1)
    return -1;
  const dim3 grid((Lq + BQ - 1) / BQ, rmem_mh::H, B);
  mh_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)qbias,
      (const int*)count, out, (float*)rec, nullptr, B, Lq, S, Lk, true_lk,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// K1'h: training's forward at 8 heads of 32, every key valid, no bias:
// out [B, Lq, 256] f32, rec [B, 8, Lq, S] f32 and lse [B, 8, Lq] f32.
// Returns a CUDA error code (0 on success; -1 for a shape it does not
// take).
extern "C" int rmem_bank_attention_mh_lse(const void* q, const void* k,
                                          const void* v, const void* count,
                                          void* out, void* rec, void* lse,
                                          int B, int H, int Lq, int S,
                                          int Lk, float scale,
                                          void* stream) {
  using namespace rmem_mh;
  if (H != rmem_mh::H || S < 1 || S > MAX_SLOTS || Lk < 1 || B < 1 ||
      Lq < 1)
    return -1;
  const dim3 grid((Lq + BQ - 1) / BQ, rmem_mh::H, B);
  mh_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, nullptr,
      (const int*)count, out, (float*)rec, (float*)lse, B, Lq, S, Lk, Lk,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

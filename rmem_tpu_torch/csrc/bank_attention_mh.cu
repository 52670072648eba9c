// Bank attention at 8 heads of 32 (kernels K1h, K3h and K1'h): the
// long-term attention of AOT's LSTT, from the frame's queries into the
// valid slots of the memory bank, with each slot's share of the softmax
// mass (the eviction signal).
//
// Replaces rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_infer,
// pallas_bank_attention_qminor and the forward of pallas_bank_attention at
// num_heads = 8, the AOT family's head count (rmem_tpu/config.py:53): the
// Pallas kernels fold the heads into their grid's first axis (_layout) and
// average the slot mass over them outside the kernel (_unlayout_out).
// mh_kernel<false> is the inference kernel K1h (bf16 output, optional
// slot-PE bias, keys masked past true_lk) and K3h (no bias, every key
// valid); mh_kernel<true> is training's forward K1'h, the VJP forward of
// pallas_bank_attention (_bank_attention_fwd, want_lse): no bias (training
// adds the slot PE to the keys), every key valid, an f32 output for the
// backward's row term and each head's natural-log lse. Its backward is K2h,
// csrc/bank_attention_mh_bwd.cu.
//
// Per head h (columns 32h .. 32h + 31 of q, k and v), query i, valid slot
// s < count and key j < true_lk: x = q.k * scale + qbias[b, h, i, s],
// p = softmax over every (s, j) of the row, out = sum p v, and the slot mass
// rec[b, h, i, s] = sum_j p (the wrapper takes the mean over the heads).
// Slots at or past count are skipped; keys at or past true_lk (zero padding)
// are masked and never read.
//
// What bounds it on an H100: operations. At the served call (Lq = Lk =
// 1674, 9 valid slots) the two products take 2 Lq (9 Lk) (32 + 32) 8 =
// 2.6e10 FLOP, 26 us at 989 TFLOP/s, against ~18 MB moved (5.5 us at 3.35
// TB/s). With heads this narrow the softmax's exponentials (2.0e8 of them,
// 48 us at the special-function units' 16 a clock an SM) weigh as much as
// the products. K1'h at the training call (B 4, Lq = Lk = 900, 4 valid
// slots): 1.3e10 FLOP (13 us) and 1.0e8 exponentials (25 us).
//
// Design. The first version (one block of 8 warps for 128 queries of one
// head walking every valid slot, 64-key chunks by cp.async into two
// buffers with a __syncthreads a chunk) ran 112 blocks at the served call,
// under one a SM, and kept 2 blocks an SM. This one splits the work as K1's
// template does (csrc/bank_attention_infer.cu):
//   - Slot groups. A block owns 64 queries (4 warps, 16 rows each) of one
//     head and a group of G = 2 valid slots: the grid is (query tile, head,
//     batch x slot group), 1080 blocks at the served call, 960 at the
//     training call. Blocks whose group starts at or past count, read on
//     the device, return before any barrier or copy, so a frame never waits
//     for the host. Each block writes its partial state: the row maximum m
//     over its group (log2 units), the per-slot sums l_s relative to it and
//     its output normalised by its own sum (bf16; f32 for K1'h). The merge
//     kernel reads count and combines the groups of each row, with w_g =
//     2^(m_g - M) sum_{s in g} l_s:
//       out   = sum_g w_g o_g / sum_g w_g,
//       rec_s = 2^(m_g(s) - M) l_s / sum_g w_g    (0 for slots >= count),
//       lse   = (M + log2 sum_g w_g) ln 2           (K1'h only).
//   - K and V by TMA. 4-D tensor maps [slot x batch, key, head, column] read
//     one head's 32 columns of 128 keys a box (64-byte rows, the 64-byte
//     swizzle) into a ring of 3 stages with full and empty mbarriers. The
//     key map spans true_lk rows, so TMA zero-fills the keys past it
//     instead of reading them; a slot takes ceil(true_lk / 128) chunks, and
//     every chunk holds a key below true_lk. Thread 0 issues the copies: Q
//     and the first chunks up front, then each stage's next chunk once all
//     4 warps have released it.
//   - Occupancy: 128 threads and ~54 KB of shared memory a block, so 4
//     blocks (16 warps) share an SM to hide the exponentials' latency.
// Each warp computes S = Q K^T on mma.sync m16n8k16 (2 k-steps over 16 key
// tiles, Q's fragments in registers, K through ldmatrix at the swizzled
// addresses), the online softmax in exp2 (the scale and the bias in log2
// units, each slot's bias read once, at its first chunk; one fma and one
// ex2.approx an element, the key mask only in a slot's last chunk), and
// O += P V with the S accumulator in bf16 as the A operand and V through
// ldmatrix.trans.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace rmem_mh {

using bf16 = __nv_bfloat16;
using namespace rmem_mma;
namespace hp = rmem_hopper;

constexpr int H = 8;              // heads
constexpr int D = 32;             // width of a head's queries, keys, values
constexpr int C = H * D;          // row width of q, k, v and out
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;    // threads
constexpr int BQ = 16 * WARPS;    // queries of a block
constexpr int BK = 128;           // keys of a chunk
constexpr int STAGES = 3;         // chunks in flight
constexpr int G = 2;              // slots a block walks
constexpr int MAX_SLOTS = 16;     // slots the wrapper takes
constexpr int ROW = D * 2;        // bytes of a tile row: the swizzle's span
constexpr int Q_BYTES = BQ * ROW;
constexpr int KV_BYTES = BK * ROW;
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
// + 1024: the dynamic shared memory is aligned up by hand
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
constexpr int kMergeThreads = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The address of 16-byte chunk `ch` (0..3) of row `r` of a tile of 64-byte
// rows that TMA wrote with the 64-byte swizzle (the tile 512-byte aligned):
// the chunk lies at ch ^ ((r >> 1) & 3). ldmatrix's 8 rows of one chunk
// then fall on 8 distinct bank groups.
__device__ __forceinline__ const char* sw64(const char* tile, int r,
                                            int ch) {
  return tile + r * ROW + ((ch ^ ((r >> 1) & 3)) << 4);
}

// Two neighbouring columns of a partial output or the output: bf16 for K1h
// and K3h, f32 for K1'h (the training output must not carry bf16
// rounding).
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Block (64-query tile, head, batch x slot group), bh = b H + h: part_m
// [NG, B H, Lq] and part_l [S, B H, Lq] f32, part_o [NG, B H, Lq, 32]
// (bf16, f32 for K1'h). tm_q reads q [B, Lq, C], tm_k and tm_v k and v
// [S, B, Lk, C] over true_lk rows; qbias [B, H, Lq, S] f32 or null (read
// only by K1h).
template <bool kTrain>
__global__ void __launch_bounds__(NT, 4)
mh_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ qbias, const int* __restrict__ count_ptr,
          float* __restrict__ part_m, float* __restrict__ part_l,
          std::conditional_t<kTrain, float, bf16>* __restrict__ part_o,
          int B, int Lq, int S, int true_lk, float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ngroups = (S + G - 1) / G;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int grp = blockIdx.z % ngroups, b = blockIdx.z / ngroups;
  const int bh = b * H + h, BH = B * H;
  const int cnt = min(max(*count_ptr, 0), S);
  const int s0 = grp * G;
  if (s0 >= cnt) return;  // the whole block, before any barrier or copy
  const int ns = min(G, cnt - s0);
  const int cps = (true_lk + BK - 1) / BK;
  const int nch = ns * cps;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      hp::mbar_init(&full[st], 1);
      hp::mbar_init(&empty[st], WARPS);   // lane 0 of each warp
    }
    hp::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: chunk ch's K and V into its stage
  auto issue = [&](int ch) {
    const int st = ch % STAGES;
    char* sk = smem + Q_BYTES + st * STAGE_BYTES;
    const int z = (s0 + ch / cps) * B + b, key0 = (ch % cps) * BK;
    hp::mbar_expect_tx(&full[st], STAGE_BYTES);
    hp::tma_load(sk, &tm_k, &full[st], 0, h, key0, z);
    hp::tma_load(sk + KV_BYTES, &tm_v, &full[st], 0, h, key0, z);
  };
  if (tid == 0) {
    hp::mbar_expect_tx(qbar, Q_BYTES);
    hp::tma_load(smem, &tm_q, qbar, 0, h, q0, b);
    for (int ch = 0; ch < STAGES && ch < nch; ++ch) issue(ch);
  }

  // this thread's two rows of the tile and their queries
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qa = q0 + r0, qb = q0 + r1;
  hp::mbar_wait(qbar, 0);
  unsigned qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(qf[ks], sw64(smem, warp * 16 + (lane & 15), ks * 2 + (lane >> 4)));

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // over the group's chunks so far
  float la[G], lb[G];                     // per-slot sums, relative to m
#pragma unroll
  for (int j = 0; j < G; ++j) la[j] = lb[j] = 0.f;
  float bias0 = 0.f, bias1 = 0.f;         // the slot's bias, log2 units

  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch % STAGES;
    hp::mbar_wait(&full[st], (ch / STAGES) & 1);
    const char* cK = smem + Q_BYTES + st * STAGE_BYTES;
    const char* cV = cK + KV_BYTES;
    const int js = ch / cps, key0 = (ch % cps) * BK;
    if (!kTrain && qbias != nullptr && key0 == 0) {   // once a slot
      const float* bp = qbias + (size_t)bh * Lq * S + s0 + js;
      bias0 = qa < Lq ? bp[(size_t)qa * S] * LOG2E : 0.f;
      bias1 = qb < Lq ? bp[(size_t)qb * S] * LOG2E : 0.f;
    }

    // ---- S = Q K^T, 16 rows x 128 keys, in registers ----
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned kb[4];
        ldsm_x4(kb, sw64(cK, np * 16 + (lane & 7) + (lane >> 4) * 8,
                         ks * 2 + ((lane >> 3) & 1)));
        mma16816(sc[2 * np], qf[ks], kb[0], kb[1]);
        mma16816(sc[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // ---- key mask at true_lk: only a slot's last chunk reaches past it ----
    if (key0 + BK > true_lk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key0 + n * 8 + 2 * t + e < true_lk;
          sc[n][e] = ok ? sc[n][e] : -INFINITY;
          sc[n][e + 2] = ok ? sc[n][e + 2] : -INFINITY;
        }
      }
    }

    // ---- online softmax in log2 units, x = s scale_log2 + bias: the scale
    // is positive, so x's maximum is s's maximum scaled, and p = exp2(x -
    // m) is one fma and one exponential; the chunk holds a valid key, so
    // mn is finite ----
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][e + 2]);
      }
    }
    const float mn0 = fmaxf(m0, fmaf(quad_max(mx0), scale_log2, bias0));
    const float mn1 = fmaxf(m1, fmaf(quad_max(mx1), scale_log2, bias1));
    const float a0 = hp::exp2_approx(m0 - mn0);
    const float a1 = hp::exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float c0 = bias0 - mn0, c1 = bias1 - mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = hp::exp2_approx(fmaf(sc[n][e], scale_log2, c0));
        sc[n][e + 2] = hp::exp2_approx(fmaf(sc[n][e + 2], scale_log2, c1));
        ps0 += sc[n][e];
        ps1 += sc[n][e + 2];
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      la[j] = la[j] * a0 + (j == js ? ps0 : 0.f);
      lb[j] = lb[j] * a1 + (j == js ? ps1 : 0.f);
    }
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
        ldsm_x4_t(vb, sw64(cV, kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                           np * 2 + (lane >> 4)));
        mma16816(o[2 * np], pa, vb[0], vb[1]);
        mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }

    // ---- release the stage; thread 0 refills it once every warp has ----
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[st]);
    if (tid == 0 && ch + STAGES < nch) {
      hp::mbar_wait(&empty[st], (ch / STAGES) & 1);
      issue(ch + STAGES);
    }
    __syncwarp();
  }

  // ---- the partial state: m, each slot's l, the output over l ----
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
  auto* po = part_o + ((size_t)grp * BH + bh) * Lq * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qa < Lq)
      store2(po + (size_t)qa * D + n * 8, o[n][0] * ia, o[n][1] * ia);
    if (qb < Lq)
      store2(po + (size_t)qb * D + n * 8, o[n][2] * ib, o[n][3] * ib);
  }
  if (t == 0) {
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

// One row of one head, 8 columns a thread (4 threads a row): merges the
// slot groups of the row. out [B, Lq, C] (bf16; f32 for K1'h), head h's
// columns at 32h; rec [B, H, Lq, S] f32, each head's slot mass; lse
// [B, H, Lq] f32 in natural units (K1'h only).
template <bool kTrain>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_m,
             const float* __restrict__ part_l,
             const std::conditional_t<kTrain, float, bf16>* __restrict__ part_o,
             const int* __restrict__ count_ptr,
             std::conditional_t<kTrain, float, bf16>* __restrict__ out,
             float* __restrict__ rec, float* __restrict__ lse, int B, int Lq,
             int S) {
  const int idx = blockIdx.x * kMergeThreads + threadIdx.x;
  const int row = idx >> 2, seg = idx & 3;      // row = (b H + h) Lq + qi
  const int BH = B * H;
  if (row >= BH * Lq) return;
  const int bh = row / Lq, qi = row % Lq, b = bh / H, h = bh % H;
  const int cnt = min(max(*count_ptr, 0), S);
  const int ng = (cnt + G - 1) / G;
  float M = -INFINITY;
  for (int gi = 0; gi < ng; ++gi)
    M = fmaxf(M, part_m[((size_t)gi * BH + bh) * Lq + qi]);
  float Lsum = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int gi = 0; gi < ng; ++gi) {
    const int s1 = min((gi + 1) * G, cnt);
    float lg = 0.f;
    for (int s = gi * G; s < s1; ++s)
      lg += part_l[((size_t)s * BH + bh) * Lq + qi];
    const float wg =
        exp2f(part_m[((size_t)gi * BH + bh) * Lq + qi] - M) * lg;
    Lsum += wg;
    float v[8];
    load8(part_o + (((size_t)gi * BH + bh) * Lq + qi) * D + seg * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += wg * v[j];
  }
  const float il = Lsum > 0.f ? 1.f / Lsum : 0.f;
  auto* orow = out + ((size_t)b * Lq + qi) * C + h * D + seg * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store2(orow + 2 * j, acc[2 * j] * il, acc[2 * j + 1] * il);
  if (kTrain && seg == 0) lse[row] = (M + log2f(Lsum)) * LN2;
  for (int s = seg; s < S; s += 4) {
    float r = 0.f;
    if (s < cnt)
      r = exp2f(part_m[((size_t)(s / G) * BH + bh) * Lq + qi] - M) *
          part_l[((size_t)s * BH + bh) * Lq + qi] * il;
    rec[(size_t)row * S + s] = r;
  }
}

template <bool kTrain>
static int launch(const void* q, const void* k, const void* v,
                  const void* qbias, const void* count, void* part_m,
                  void* part_l, void* part_o, void* out, void* rec, void* lse,
                  int B, int Lq, int S, int Lk, int true_lk, float scale,
                  cudaStream_t stream) {
  using OT = std::conditional_t<kTrain, float, bf16>;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  int e = hp::map4d(&tq, q, D, H, Lq, B, D, BQ, sw);
  // the key and value maps span true_lk of the Lk rows a slot holds: the
  // padding past true_lk is zero-filled, never read
  if (e == 0)
    e = hp::map4d(&tk, k, D, H, true_lk, (uint64_t)S * B, D, BK, sw, Lk);
  if (e == 0)
    e = hp::map4d(&tv, v, D, H, true_lk, (uint64_t)S * B, D, BK, sw, Lk);
  if (e != 0) return e;
  auto kern = mh_kernel<kTrain>;
  static bool configured = false;     // once per process and instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Lq + BQ - 1) / BQ, H, B * ((S + G - 1) / G));
  kern<<<grid, NT, SMEM_BYTES, stream>>>(
      tq, tk, tv, (const float*)qbias, (const int*)count, (float*)part_m,
      (float*)part_l, (OT*)part_o, B, Lq, S, true_lk, scale * LOG2E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = B * H * Lq * 4;
  merge_kernel<kTrain><<<(threads + kMergeThreads - 1) / kMergeThreads,
                         kMergeThreads, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const OT*)part_o,
      (const int*)count, (OT*)out, (float*)rec, (float*)lse, B, Lq, S);
  return (int)cudaGetLastError();
}

}  // namespace rmem_mh

// Layouts (bf16, contiguous, 16-byte aligned): q [B, Lq, 256]; k, v
// [S, B, Lk, 256]; count an int32 on the card. Scratch, with G =
// rmem_bank_attention_mh_slots(): part_m [ceil(S/G), B x 8, Lq] and part_l
// [S, B x 8, Lq] f32, part_o [ceil(S/G), B x 8, Lq, 32] (bf16 for K1h and
// K3h, f32 for K1'h). Each returns a CUDA error code (0 on success; -1 for a
// shape it does not take, -2 or -3 if a tensor map cannot be made).

// K1h and K3h: 8 heads of 32, any batch, S <= 16 slots, 0 < true_lk <= Lk;
// qbias [B, 8, Lq, S] f32 or null. out [B, Lq, 256] bf16, rec [B, 8, Lq, S]
// f32.
extern "C" int rmem_bank_attention_mh(const void* q, const void* k,
                                      const void* v, const void* qbias,
                                      const void* count, void* part_m,
                                      void* part_l, void* part_o, void* out,
                                      void* rec, int B, int H, int Lq, int S,
                                      int Lk, int true_lk, float scale,
                                      void* stream) {
  using namespace rmem_mh;
  if (H != rmem_mh::H || S < 1 || S > MAX_SLOTS || true_lk < 1 ||
      true_lk > Lk || B < 1 || Lq < 1)
    return -1;
  return launch<false>(q, k, v, qbias, count, part_m, part_l, part_o, out,
                       rec, nullptr, B, Lq, S, Lk, true_lk, scale,
                       (cudaStream_t)stream);
}

// K1'h: training's forward at 8 heads of 32, every key valid, no bias:
// out [B, Lq, 256] f32, rec [B, 8, Lq, S] f32 and lse [B, 8, Lq] f32.
extern "C" int rmem_bank_attention_mh_lse(const void* q, const void* k,
                                          const void* v, const void* count,
                                          void* part_m, void* part_l,
                                          void* part_o, void* out, void* rec,
                                          void* lse, int B, int H, int Lq,
                                          int S, int Lk, float scale,
                                          void* stream) {
  using namespace rmem_mh;
  if (H != rmem_mh::H || S < 1 || S > MAX_SLOTS || Lk < 1 || B < 1 ||
      Lq < 1)
    return -1;
  return launch<true>(q, k, v, nullptr, count, part_m, part_l, part_o, out,
                      rec, lse, B, Lq, S, Lk, Lk, scale,
                      (cudaStream_t)stream);
}

// The slots a block walks.
extern "C" int rmem_bank_attention_mh_slots() { return rmem_mh::G; }

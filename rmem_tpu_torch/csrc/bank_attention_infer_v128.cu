// Serving bank attention at 2 heads of 128 with values 128 a head (kernel
// K1x2v128, R50-AOTL's no_memory_gap): the queries attend into the valid
// slots of the long-term bank, and each slot's share of the softmax mass is
// returned beside the output, in one launch.
//
// Replaces rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_infer
// (_forward, _kernel) at that head shape, with the per-(query, slot) logit
// bias and the keys masked at true_lk, and the reference frame's one-slot
// call (no bias); without a bias and with every key valid it is also K3
// (pallas_bank_attention_qminor) at that shape. Per head h (columns 128h ..
// 128h + 127 of q, k and v), query i, valid slot s < count and key j <
// true_lk: x = q.k * scale + bias[i, s], p = softmax over every (s, j) of the
// row, out = sum p v (p rounded to bf16 for P.V, as the Pallas kernel does),
// rec[b, h, i, s] = sum_j p.
//
// What bounds it on an H100: operations. At phase 17's call of
// chip_smoke.py (batch 1, Lq = Lk = 1674, 9 valid slots) the two products
// take 2 Lq (9 Lk) (128 + 128) x 2 heads = 2.6e10 FLOP, 26 us at 989
// TFLOP/s, against ~11 MB moved.
//
// Design. K1's template (csrc/bank_attention_infer.cu) ran this call as 140
// blocks of one an SM (14 query tiles x 2 heads x 5 slot groups): two waves
// on 132 SMs, the second almost empty, and bf16 partials through HBM to a
// merge kernel. This kernel keeps the template's block and changes the grid
// and the merge:
//   - A block owns 128 queries of one (batch, head): two consumer
//     warpgroups of 64 rows share every 64-key chunk of K and V, which one
//     producer thread keeps in flight by TMA in a ring of STAGES (4-D tensor
//     maps [slot x batch, key, head, column], 128-byte swizzle; a chunk
//     never crosses a slot and the keys past Lk arrive as zeros). Each
//     consumer runs S = Q K^T as wgmma m64n64k16, the key mask in a slot's
//     last chunk (a zero key past Lk would give logit 0, not -inf, and a key
//     in [true_lk, Lk) is padding), the bias of the chunk's slot (loaded
//     once a slot, log2 units), the online softmax in registers, and O += P V
//     as register-A wgmma m64n128k16 with P in bf16.
//   - The tile's walk, the valid (slot, chunk) pairs in slot-major order
//     (n = count x ceil(true_lk / 64), count read on the device), is cut
//     into CL even ranges, one for each block of a thread-block cluster of
//     CL along the grid's x axis. The launcher picks CL so that the grid,
//     tiles x batch x heads x CL, is one wave (at phase 17's call 28 tiles
//     x 4 = 112 blocks of about 61 chunks each).
//   - Each block books what it walked: each row's running maximum m and sum
//     L of p relative to it, its output O relative to it, and, when its
//     walk leaves a slot, that slot's sum relative to the maximum then,
//     l(s) and m(s). A slot may be split between two blocks; a slot or a
//     whole range that a block never touched has m = -inf and l = 0.
//   - After a cluster barrier each block merges an even share of the tile's
//     rows from every block's shared memory (mapa + ld.shared::cluster),
//     with M the largest m and w_r = 2^(m_r - M) (0 for m_r = -inf):
//       out   = sum_r w_r O_r / sum_r w_r L_r                (bf16)
//       rec_s = sum_r 2^(m_r(s) - M) l_r(s) / sum_r w_r L_r  (0 for s >=
//               count; the wrapper takes the head mean).
//     A second cluster barrier keeps every block's shared memory alive
//     until the remote reads end. No partials go through global memory.
// ~183 KB of shared memory and 384 threads a block, one block an SM. A
// block's chunk takes ~1.07 us (clock64 stamps: at phase 17's call the walk
// is ~92 % of a block's time, the merge ~6 %). Measured slower on this
// card (PERF.md): S of the next chunk issued before P.V of this one, as
// csrc/bank_attention_lse_v128.cu does, and the two consumers taking the
// products in turn on named barriers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rmem_infer128 {

using namespace rmem_hopper;
using bf16 = __nv_bfloat16;

constexpr int H = 2;              // heads
constexpr int D = 128;            // a head's keys and values
constexpr int C = H * D;          // row width of q, k, v and out
constexpr int BQ = 64;            // query rows of one consumer warpgroup
constexpr int NCONS = 2;          // consumer warpgroups
constexpr int TQ = BQ * NCONS;    // queries a block (a tile)
constexpr int BK = 64;            // keys a chunk
constexpr int STAGES = 4;         // K/V chunks in flight
constexpr int MAX_SLOTS = 16;     // slots the wrapper takes
constexpr int MAX_CLUSTER = 8;    // blocks a cluster (the portable limit)
constexpr int kThreads = 128 * (1 + NCONS);
constexpr int ATOM = 64 * 128;    // one [64 x 64] bf16 TMA box
constexpr int TILE = 2 * ATOM;    // [64 x 128] bf16
constexpr int Q_BYTES = NCONS * TILE;
constexpr int STAGE_BYTES = 2 * TILE;     // K and V
constexpr int XO = 136;           // floats a row of the booked output
// shared memory: Q, the stages (after the walk, the booked output O [TQ x
// XO] f32), the booked slot sums and maxima [MAX_SLOTS][TQ] each, each
// row's m and L, the merge's weights [MAX_CLUSTER][TQ], 1 / sum and M a
// row, the barriers
constexpr int SLOT_OFF = Q_BYTES + STAGES * STAGE_BYTES;
constexpr int ROW_OFF = SLOT_OFF + 2 * MAX_SLOTS * TQ * 4;
constexpr int WGT_OFF = ROW_OFF + 2 * TQ * 4;
constexpr int BAR_OFF = WGT_OFF + (MAX_CLUSTER + 2) * TQ * 4;
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TQ * XO * 4 <= STAGES * STAGE_BYTES, "O fits the stages");

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// Every thread of the cluster arrives (release), then waits (acquire):
// shared-memory writes before it are visible to every block.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this block's shared variable `p` in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_remote(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_remote4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Block (cluster rank, 128-query tile, batch x head). qbias [B, 2, Lq, S]
// f32 (natural units) or null; out [B, Lq, 256] bf16, head h's columns at
// 128h; rec [B, 2, Lq, S] f32. Keys >= true_lk masked.
template <bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
infer_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const int* __restrict__ count_ptr,
             const float* __restrict__ qbias, bf16* __restrict__ out,
             float* __restrict__ rec, int B, int Lq, int S, int true_lk,
             float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  float* bl = reinterpret_cast<float*>(smem + SLOT_OFF);   // [slot][row]
  float* bm = bl + MAX_SLOTS * TQ;
  float* xm = reinterpret_cast<float*>(smem + ROW_OFF);    // [row]
  float* xl = xm + TQ;
  float* wgt = reinterpret_cast<float*>(smem + WGT_OFF);   // [rank][row]
  float* inv = wgt + MAX_CLUSTER * TQ;                     // [row]
  float* big_m = inv + TQ;                                 // [row]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int rank = (int)cluster_rank(), CL = (int)cluster_size();
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * TQ;
  const int count = clamp_count(count_ptr, S);
  const int cps = (true_lk + BK - 1) / BK;
  const int n = count * cps;
  // this block's range of the tile's walk
  const int p0 = (int)((long long)n * rank / CL);
  const int nch = (int)((long long)n * (rank + 1) / CL) - p0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NCONS);   // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy; the warpgroup
    // then meets the consumers at the two cluster barriers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0 && nch > 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int c = 0; c < NCONS; ++c)
        for (int a = 0; a < 2; ++a)
          tma_load(smem + (c * 2 + a) * ATOM, &tm_q, qbar, a * 64, h,
                   q0 + c * BQ, b);
      for (int it = 0; it < nch; ++it) {
        const int st = it % STAGES, use = it / STAGES;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        char* sk = smem + Q_BYTES + st * STAGE_BYTES;
        const int p = p0 + it;
        const int z = (p / cps) * B + b, key0 = (p % cps) * BK;
        mbar_expect_tx(&full[st], STAGE_BYTES);
        for (int a = 0; a < 2; ++a) {
          tma_load(sk + a * ATOM, &tm_k, &full[st], a * 64, h, key0, z);
          tma_load(sk + TILE + a * ATOM, &tm_v, &full[st], a * 64, h, key0,
                   z);
        }
      }
    }
    __syncwarp();
    cluster_sync();
    cluster_sync();
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int ctid = threadIdx.x - 128;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int ra = cw * BQ + warp * 16 + (lane >> 2), rb = ra + 8;
  const int qa = q0 + ra, qb = q0 + rb;
  if (t4 == 0) {
    for (int s = 0; s < S; ++s) {
      bl[s * TQ + ra] = bl[s * TQ + rb] = 0.f;
      bm[s * TQ + ra] = bm[s * TQ + rb] = -INFINITY;
    }
  }
  const char* sq = smem + cw * TILE;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // this thread's two rows: running maximum (log2 units), the sums of p of
  // its four columns over the walk and over the current slot, relative to it
  float m0 = -INFINITY, m1 = -INFINITY, L0 = 0.f, L1 = 0.f;
  float l0 = 0.f, l1 = 0.f, ba = 0.f, bb = 0.f;
  int slot = -1;
  // books the current slot's sums (four threads a row) and the maximum
  auto book = [&]() {
    const float la = quad_sum(l0), lb = quad_sum(l1);
    if (t4 == 0) {
      bl[slot * TQ + ra] = la;
      bl[slot * TQ + rb] = lb;
      bm[slot * TQ + ra] = m0;
      bm[slot * TQ + rb] = m1;
    }
  };
  if (nch > 0) mbar_wait(qbar, 0);

  for (int it = 0; it < nch; ++it) {
    const int st = it % STAGES, p = p0 + it;
    const int js = p / cps, key0 = (p % cps) * BK;
    if (js != slot) {   // the walk enters a slot: book the one it leaves
      if (slot >= 0) book();
      slot = js;
      l0 = l1 = 0.f;
      if (kBias && qbias != nullptr) {
        ba = qa < Lq ? qbias[((size_t)bh * Lq + qa) * S + js] * LOG2E : 0.f;
        bb = qb < Lq ? qbias[((size_t)bh * Lq + qb) * S + js] * LOG2E : 0.f;
      }
    }
    mbar_wait(&full[st], (it / STAGES) & 1);
    const char* sk = smem + Q_BYTES + st * STAGE_BYTES;
    const char* sv = sk + TILE;

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

    // ---- bias, key mask, online softmax (log2 units) ----
    const bool edge = key0 + BK > true_lk;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = kBias ? fmaf(sc[4 * i + e], scale_log2, ba)
                         : sc[4 * i + e] * scale_log2;
        float x1 = kBias ? fmaf(sc[4 * i + 2 + e], scale_log2, bb)
                         : sc[4 * i + 2 + e] * scale_log2;
        if (edge) {
          const bool ok = key0 + i * 8 + 2 * t4 + e < true_lk;
          x0 = ok ? x0 : -INFINITY;
          x1 = ok ? x1 : -INFINITY;
        }
        sc[4 * i + e] = x0;
        sc[4 * i + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    // every chunk holds a key below true_lk, so the new maxima are finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * i + e] = exp2_approx(sc[4 * i + e] - mn0);
        sc[4 * i + 2 + e] = exp2_approx(sc[4 * i + 2 + e] - mn1);
        ps0 += sc[4 * i + e];
        ps1 += sc[4 * i + 2 + e];
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    L0 = L0 * a0 + ps0;
    L1 = L1 * a1 + ps1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
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
    // V's two 64-wide boxes lie 8 KB apart (the leading offset), its 8-key
    // groups 1024 bytes (the stride)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_m64n128(o, pa[kk], desc_sw128(sv + kk * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with it
  }
  if (slot >= 0) book();
  L0 = quad_sum(L0);
  L1 = quad_sum(L1);

  // ---- book O, m and L: O into the stages, which both consumers are done
  // reading (every copy issued has landed: each was waited for) ----
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NCONS) : "memory");
  float* xo = reinterpret_cast<float*>(smem + Q_BYTES);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * t4;
    *reinterpret_cast<float2*>(xo + ra * XO + col) =
        make_float2(o[4 * i], o[4 * i + 1]);
    *reinterpret_cast<float2*>(xo + rb * XO + col) =
        make_float2(o[4 * i + 2], o[4 * i + 3]);
  }
  if (t4 == 0) {
    xm[ra] = m0;
    xm[rb] = m1;
    xl[ra] = L0;
    xl[rb] = L1;
  }
  cluster_sync();

  // ---- merge this block's share of the tile's rows from every block ----
  const int r0 = TQ * rank / CL, nrows = TQ * (rank + 1) / CL - r0;
  // each row's weights w_r / sum_r w_r L_r, 1 / sum_r w_r L_r and M
  for (int i = ctid; i < nrows; i += 128 * NCONS) {
    const int row = r0 + i;
    float mr[MAX_CLUSTER], M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      mr[r] = r < CL ? ld_remote(remote(xm + row, r)) : -INFINITY;
      M = fmaxf(M, mr[r]);
    }
    float T = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      mr[r] = mr[r] == -INFINITY ? 0.f : exp2f(mr[r] - M);
      if (r < CL) T += mr[r] * ld_remote(remote(xl + row, r));
    }
    const float iT = T > 0.f ? 1.f / T : 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < CL) wgt[r * TQ + row] = mr[r] * iT;
    inv[row] = iT;
    big_m[row] = M;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NCONS) : "memory");
  for (int i = ctid; i < nrows * (D / 4); i += 128 * NCONS) {
    const int row = r0 + i / (D / 4), c4 = (i % (D / 4)) * 4;
    const int q = q0 + row;
    if (q >= Lq) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r >= CL) break;
      const float w = wgt[r * TQ + row];
      const float4 v = ld_remote4(remote(xo + row * XO + c4, r));
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    uint2 pk;
    pk.x = pack_bf16(acc.x, acc.y);
    pk.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>(out + ((size_t)b * Lq + q) * C + h * D + c4) =
        pk;
  }
  for (int i = ctid; i < nrows * S; i += 128 * NCONS) {
    const int row = r0 + i / S, s = i % S;
    const int q = q0 + row;
    if (q >= Lq) continue;
    const float M = big_m[row];
    float r_s = 0.f;
    if (s < count && M != -INFINITY) {
      for (int r = 0; r < CL; ++r) {
        const float mrs = ld_remote(remote(bm + s * TQ + row, r));
        if (mrs != -INFINITY)
          r_s += exp2f(mrs - M) * ld_remote(remote(bl + s * TQ + row, r));
      }
      r_s *= inv[row];
    }
    rec[((size_t)bh * Lq + q) * S + s] = r_s;
  }
  cluster_sync();   // no block leaves while another reads its memory
}

template <bool kBias>
static int configure() {
  static bool configured = false;     // once per process and instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        infer_kernel<kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  return 0;
}

static cudaLaunchConfig_t config(dim3 grid, int cl, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kBias>
static int launch(const void* q, const void* k, const void* v,
                  const void* qbias, const void* count, void* out, void* rec,
                  int B, int Lq, int S, int Lk, int true_lk, int cl,
                  float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = map4d(&tq, q, D, H, Lq, B);
  if (e == 0) e = map4d(&tk, k, D, H, Lk, (uint64_t)S * B);
  if (e == 0) e = map4d(&tv, v, D, H, Lk, (uint64_t)S * B);
  if (e == 0) e = configure<kBias>();
  if (e != 0) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(dim3(cl, (Lq + TQ - 1) / TQ, B * H), cl, stream, &attr);
  auto kern = infer_kernel<kBias>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, tq, tk, tv, (const int*)count,
      (const float*)qbias, (bf16*)out, (float*)rec, B, Lq, S, true_lk,
      scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace rmem_infer128

// K1x2v128: 2 heads of 128 with values 128 a head, any batch, 1 <= S <= 16
// slots, 1 <= true_lk <= Lk, clusters of 1 <= cl <= 8 blocks. q [B, Lq,
// 256], k, v [S, B, Lk, 256] bf16 (contiguous, 16-byte aligned); count an
// int32 on the card; qbias [B, 2, Lq, S] f32 (scaled logit units) or null;
// keys >= true_lk masked. out [B, Lq, 256] bf16, rec [B, 2, Lq, S] f32
// (each head's slot mass, 0 past count). With a bias or padded keys the
// kBias instantiation runs, with neither (K3, and the reference frame's
// call) the other. Returns the cudaError_t of the launch (0 on success), -1
// for a shape it does not take, -2 or -3 if a tensor map cannot be made.
extern "C" int rmem_bank_attention_infer_v128(
    const void* q, const void* k, const void* v, const void* qbias,
    const void* count, void* out, void* rec, int B, int H, int Lq, int S,
    int Lk, int true_lk, int cl, float scale, void* stream) {
  using namespace rmem_infer128;
  if (H != rmem_infer128::H || B < 1 || Lq < 1 || S < 1 || S > MAX_SLOTS ||
      true_lk < 1 || true_lk > Lk || cl < 1 || cl > MAX_CLUSTER)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (qbias == nullptr && true_lk == Lk)
    return launch<false>(q, k, v, nullptr, count, out, rec, B, Lq, S, Lk, Lk,
                         cl, scale, st);
  return launch<true>(q, k, v, qbias, count, out, rec, B, Lq, S, Lk, true_lk,
                      cl, scale, st);
}

// The clusters of `cl` blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int rmem_bank_attention_infer_v128_clusters(int cl) {
  using namespace rmem_infer128;
  if (cl < 1 || cl > MAX_CLUSTER) return -1;
  const int e = configure<true>();
  if (e != 0) return -e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(cl, 1, 1), cl, 0, &attr);
  int n = 0;
  auto kern = infer_kernel<true>;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The queries a block takes and the blocks a cluster may hold.
extern "C" int rmem_bank_attention_infer_v128_tile() {
  return rmem_infer128::TQ;
}
extern "C" int rmem_bank_attention_infer_v128_max_cluster() {
  return rmem_infer128::MAX_CLUSTER;
}

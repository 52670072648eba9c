// The bank attention's backward at one or two heads of 128 with values a
// multiple of 256 a head (kernel K2: R50-DeAOTL, one head with values 1024;
// K2x2: its no_memory_gap, two heads with values 512 a head): dq, dk and dv
// of the training forward K1' (csrc/bank_attention_infer.cu's lse
// instantiation), with the gradient of the slot mass, and no p or ds in
// device memory.
//
// Replaces rmem_tpu/kernels/bank_attention.py:_bank_attention_bwd (its
// pallas_calls of _dq_kernel and _dkv_kernel). Per head h (columns 128h ..
// 128h + 127 of q, k and dq, dk; dv h dv .. of v, dout and dv), query i,
// valid slot s < count and key j < Lk, with the forward's lse_h:
//   p  = exp(q.k * scale - lse_h[i]),
//   ds = p * (dout_h . v + drec[i, s] / H - delta_h[i]),
//   dq = scale sum ds k,  dk = scale sum_i ds q,  dv = sum_i p dout_h,
// delta_h = rowsum over the head's value columns of dout.out + rowsum_s(drec
// / H rec_h) (the record is the head mean of the slot mass), computed by the
// wrapper in f32 from K1''s f32 output. The wrapper hands the kernels two
// f32 row arrays, lse2 = lse_h log2(e) [B, H, LqP] (+inf past Lq, so a
// padded query's p is 0) and rterm = drec / H - delta_h [B, H, S, LqP] (0
// past Lq), LqP = Lq rounded up to 64. dk and dv are exact zeros in slots
// >= count (read on the device): training adds the slot PE to the keys, so
// autograd sums dk over every slot into the PE's gradient.
//
// What bounds it on an H100: operations. At the training calls (B 4, Lq =
// Lk = 900) the products the function needs (S = Q K^T and G = dO V^T once,
// then dq, dk and dv: 3 x 128 + 2 dv a query-key pair and head) come to
// 6.3e10 FLOP at one head, values 1024 and 4 valid slots (0.064 ms at 989
// TFLOP/s), and 1.6e11 at two heads, values 512 a head and 9 slots (0.166
// ms), against 0.05 to 0.3 GB of inputs and outputs.
//
// Design. The first port wrote p and ds (as a bf16 hi/lo pair) to a [B, H,
// S, Lq, LkP] scratch that its dq and dkv kernels read back: 0.41 GB a call
// at two heads, whose traffic alone bounded it at twice the function's time,
// on Ampere's mma.sync. Here no kernel writes p or ds. Each of three
// kernels recomputes p from the lse (p = exp2(S scale log2(e) - lse2)), as
// the fused pair at 128 values a head does (csrc/bank_attention_bwd_fused.cu),
// and the JAX kernels do; the difference is the width of the values: a
// 64-key dV tile at dv 1024 is 256 KB in f32, more than an SM holds, so dV
// is split across blocks by value columns, and G = dO V^T, which needs all
// of a head's values, is accumulated over 128-wide value chunks streamed
// through a ring. All products are wgmma (bf16 in, f32 sums) on tiles that
// TMA brings in [64 x 64] boxes with the 128-byte swizzle; one producer
// warpgroup (thread 0 issues every copy) keeps a ring of STAGES 16 KB
// entries in flight with full and empty mbarriers, and NCONS consumer
// warpgroups of 64 rows each share every walked entry (csrc/hopper.cuh).
//   g_kernel<false> (the dq role): a consumer owns 64 queries of one head
//     and batch row, their Q and dO resident (dO [64 x dv]). The block
//     walks the 64-key tiles of a group of G valid slots; per tile the ring
//     brings the dv / 128 V chunks, then K: G += dO_c V_c^T over the chunks
//     (the chunk's stage released as soon as its product is done), S = Q
//     K^T, ds = p (G + rterm), dQ += ds_hi K + ds_lo K. Each group writes an
//     f32 partial [NG, B, Lq, H x 128]; dq_sum_kernel adds the valid groups'
//     partials in group order (deterministic, where atomics into one f32
//     sum would not be), scales and rounds to bf16.
//   g_kernel<true> (the dk role): the same kernel with keys and queries
//     exchanged: a consumer owns 64 keys of one slot, head and batch row, K
//     and V resident; per 64-query tile the dO chunks, then Q with its lse2
//     and rterm rows (bulk copies): G^T, S^T, ds^T, dK += ds_hi^T Q +
//     ds_lo^T Q. Blocks of slots >= count write zeros and end.
//   dv_kernel: a consumer owns 64 keys of one slot and head and NV of its
//     value columns, K resident; per 64-query tile Q, the NV dO columns and
//     lse2 arrive in one stage: S^T, p^T, dV += p^T dO (wgmma m64nNVk16, p
//     from registers). It needs no G; each of the dv / NV groups recomputes
//     S (128 of the 128 + NV products a pair). Blocks of slots >= count
//     write zeros and end.
// Resident Y (dO or V) takes 128 dv bytes a consumer, so at dv <= 512 a
// block holds two consumers (128 rows share each streamed chunk) and a ring
// of 4, at dv 1024 one consumer and a ring of 5: within the 227 KB a block
// may use; a ring one entry shallower made the dq and dk kernels 10-25 %
// slower (PERF.md has the sweep of these constants, NV and G). G is
// computed twice, by the dq and the dk kernel (8 704 products a pair and
// head at dv 1024 against the function's 4 864, 5 120 against 2 816 at
// 512). The FlashAttention-2 form computes it once: the dk kernel also adds
// ds K into an f32 dQ by atomics (one consumer at dv 512, so that the ds
// tile fits in shared memory), and no dq kernel runs. Timed in one call on
// an H100 against this design with rings of 3 and 4, it took 0.556 ms
// where dq, its sum and dk took 0.508 at two heads and 9 slots, and 0.189
// against 0.206 at one head and 4 slots; it was not kept: slower at two
// heads, and its dq changes from run to run with the atomics' order, where
// this one is deterministic.
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

namespace rmem_bwd {

using namespace rmem_hopper;
using bf16 = __nv_bfloat16;

constexpr int D = 128;          // a head's keys
constexpr int BR = 64;          // rows a consumer warpgroup owns
constexpr int BW = 64;          // rows of a walked tile
constexpr int ATOM = 64 * 128;  // one [64 x 64] bf16 TMA box
constexpr int TILE = 2 * ATOM;  // [64 x 128] bf16: two boxes, a ring entry
constexpr int NV = 256;         // value columns of a dv block
constexpr int G = 2;            // slots a dq block walks
constexpr int MAX_DV = 1024;    // a head's values, at most
// the G kernels: consumers and ring entries up to 512 values a head, and
// above
constexpr int NCONS_NARROW = 2, STAGES_NARROW = 4;
constexpr int NCONS_WIDE = 1, STAGES_WIDE = 5;
// the dv kernel: consumers and ring stages
constexpr int NCONS_V = 2, STAGES_V = 4;
constexpr int ROW_BYTES = BW * 4;
constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a G kernel: NCONS consumers' resident X [64 x 128] and Y
// [64 x dv] (every tile 1024-byte aligned, the 128-byte swizzle's period),
// the ring's entries, the rows of two walked tiles (the dk role's lse2 and
// rterm of a query tile, by the tile's parity), the barriers, and the slack
// that aligns the start.
__host__ __device__ constexpr int g_smem_bytes(int ncons, int stages,
                                               int dv) {
  return ncons * TILE * (1 + dv / 128) + stages * TILE + 2 * 2 * ROW_BYTES +
         (2 * stages + 1) * 8 + 1024;
}
// The dv kernel: resident K, then stages of Q [64 x 128], dO [64 x NV] and
// the lse2 row.
constexpr int V_STAGE = TILE + NV * 128;
constexpr int V_SMEM = NCONS_V * TILE + STAGES_V * (V_STAGE + ROW_BYTES) +
                       (2 * STAGES_V + 1) * 8 + 1024;
static_assert(V_SMEM <= SMEM_LIMIT, "the dv kernel's shared memory");

// An m64n64 accumulator (rows this thread's two, columns the walked tile's)
// as the A operand of four k16 steps, in bf16: hi, and with `lo` its
// rounding error.
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

// acc[64 x 64] (+)= A[64 x 128] B[64 x 128]^T, both [64 x 128] tiles
// K-major (two 128-byte-swizzled boxes each); `accumulate` false overwrites.
__device__ __forceinline__ void mul_abt(float* acc, const char* a,
                                        const char* b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk >> 2) * ATOM + (kk & 3) * 32;
    wgmma_ss_m64n64(acc, desc_sw128(a + off, 16, 1024),
                    desc_sw128(b + off, 16, 1024), accumulate || kk > 0);
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

// acc[64 x NV] += X[64 x 64] T[64 x NV], T NV / 64 boxes 8 KB apart (the
// leading offset) read MN-major.
__device__ __forceinline__ void mul_pv(float* acc, const uint32_t (*x)[4],
                                       const char* t) {
#pragma unroll
  for (int kk = 0; kk < BW / 16; ++kk) {
    if constexpr (NV == 256)
      wgmma_rs_m64n256(acc, x[kk], desc_sw128(t + kk * 2048, 8192, 1024));
    else
      wgmma_rs_m64n128(acc, x[kk], desc_sw128(t + kk * 2048, 8192, 1024));
  }
}

// This warp is done with a ring entry: its lane 0 arrives on the entry's
// empty barrier (4 NCONS arrivals free it).
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Zeros over rows [r0, r0 + n) (those below `rows`) and `cols` columns
// starting at `col0` of a bf16 array with rows `ld` wide.
__device__ __forceinline__ void zero_rows(bf16* base, size_t ld, int r0,
                                          int n, int rows, int col0,
                                          int cols) {
  const int segs = cols / 8;
  for (int e = threadIdx.x; e < n * segs; e += blockDim.x) {
    const int r = r0 + e / segs, seg = e % segs;
    if (r >= rows) continue;
    *reinterpret_cast<uint4*>(base + (size_t)r * ld + col0 + seg * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// kKeys false, the dq role: part [NG, B, Lq, H x 128] f32, each slot
// group's dq / scale; block (NCONS x 64 queries, batch x head, slot group).
// kKeys true, the dk role: dk [S, B, Lk, H x 128] bf16; block (NCONS x 64
// keys, slot, batch x head). DV a head's values.
template <bool kKeys, int DV, int NCONS, int STAGES>
__global__ void __launch_bounds__(384, 1)
g_kernel(const __grid_constant__ CUtensorMap tm_q,
         const __grid_constant__ CUtensorMap tm_do,
         const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v,
         const float* __restrict__ lse2, const float* __restrict__ rterm,
         const int* __restrict__ count_ptr, float* __restrict__ part,
         bf16* __restrict__ dk, int B, int H, int Lq, int LqP, int S, int Lk,
         float scale, float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  constexpr int ny = DV / 128;            // value chunks a walked tile
  constexpr int resc = TILE * (1 + ny);   // a consumer's resident X and Y
  // the rows of tile t + 2 arrive after the consumers have left tile t
  // (its entry waits for the release of one of tile t + 1's)
  static_assert(STAGES <= 2 * ny + 1, "two tiles' rows in flight at most");
  char* ring = smem + NCONS * resc;
  float* rows = reinterpret_cast<float*>(ring + STAGES * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 2 * 2 * BW);
  uint64_t* empty = full + STAGES;
  uint64_t* resbar = empty + STAGES;

  const int C = H * D;
  const int count = clamp_count(count_ptr, S);
  const int cps = (Lk + BW - 1) / BW;
  const int row0 = blockIdx.x * (BR * NCONS);
  int bh, s0, ntile;
  if constexpr (kKeys) {
    s0 = blockIdx.y;
    bh = blockIdx.z;
    if (s0 >= count) {   // an invalid slot: exact zeros
      zero_rows(dk + ((size_t)s0 * B + bh / H) * Lk * C, C, row0,
                BR * NCONS, Lk, (bh % H) * D, D);
      return;
    }
    ntile = LqP / BW;
  } else {
    bh = blockIdx.y;
    s0 = blockIdx.z * G;
    if (s0 >= count) return;   // the whole block, before any barrier
    ntile = (count - s0 < G ? count - s0 : G) * cps;
  }
  const int b = bh / H, h = bh % H;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NCONS);   // lane 0 of each consumer warp
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // the resident rows: X (Q or K) and all of Y (dO or V)
      const CUtensorMap* mx = kKeys ? &tm_k : &tm_q;
      const CUtensorMap* my = kKeys ? &tm_v : &tm_do;
      const int zr = kKeys ? s0 * B + b : b;
      mbar_expect_tx(resbar, NCONS * resc);
      for (int c = 0; c < NCONS; ++c) {
        char* x = smem + c * resc;
        const int r = row0 + c * BR;
        for (int a = 0; a < 2; ++a)
          tma_load(x + a * ATOM, mx, resbar, a * 64, h, r, zr);
        for (int a = 0; a < 2 * ny; ++a)
          tma_load(x + TILE + a * ATOM, my, resbar, a * 64, h, r, zr);
      }
      // the walk: per tile its ny value chunks (V or dO), then X' (K or Q)
      const CUtensorMap* mxw = kKeys ? &tm_q : &tm_k;
      const CUtensorMap* myw = kKeys ? &tm_do : &tm_v;
      int e = 0;
      for (int t = 0; t < ntile; ++t) {
        const int z = kKeys ? b : (s0 + t / cps) * B + b;
        const int r = kKeys ? t * BW : (t % cps) * BW;
        for (int j = 0; j <= ny; ++j, ++e) {
          const int st = e % STAGES, use = e / STAGES;
          if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
          char* dst = ring + st * TILE;
          const bool last = j == ny;
          if (kKeys && last) {
            float* rl = rows + (t & 1) * 2 * BW;
            mbar_expect_tx(&full[st], TILE + 2 * ROW_BYTES);
            bulk_load(rl, lse2 + (size_t)bh * LqP + r, ROW_BYTES, &full[st]);
            bulk_load(rl + BW, rterm + ((size_t)bh * S + s0) * LqP + r,
                      ROW_BYTES, &full[st]);
          } else {
            mbar_expect_tx(&full[st], TILE);
          }
          for (int a = 0; a < 2; ++a)
            tma_load(dst + a * ATOM, last ? mxw : myw, &full[st],
                     (last ? 0 : j * 128) + a * 64, h, r, z);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int t4 = lane & 3;
    const char* x = smem + cw * resc;
    const char* y = x + TILE;
    // this thread's two rows (queries or keys)
    const int ra = row0 + cw * BR + warp * 16 + (lane >> 2), rb = ra + 8;
    // dq role: their lse (log2 units; +inf past Lq) and the current slot's
    // rterm; dk role: whether each is a real key
    float lsa = 0.f, lsb = 0.f, rra = 0.f, rrb = 0.f;
    const bool ok_a = ra < Lk, ok_b = rb < Lk;
    if constexpr (!kKeys) {
      const float* lrow = lse2 + (size_t)bh * LqP;
      lsa = ra < Lq ? lrow[ra] : INFINITY;
      lsb = rb < Lq ? lrow[rb] : INFINITY;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    mbar_wait(resbar, 0);

    int e = 0;
    for (int t = 0; t < ntile; ++t) {
      // ---- G = Y Y'^T over the value chunks ----
      float gg[32], sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) gg[i] = sc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < ny; ++j, ++e) {
        const int st = e % STAGES;
        mbar_wait(&full[st], (e / STAGES) & 1);
        wgmma_fence();   // each chunk's, as the compiler would insert it
        mul_abt(gg, y + j * TILE, ring + st * TILE, true);
        wgmma_commit();
        if (j > 0) {   // the previous chunk's product is done: free it
          wgmma_wait<1>();
          release(&empty[(e - 1) % STAGES], lane);
        }
      }
      wgmma_wait<0>();
      release(&empty[(e - 1) % STAGES], lane);
      fence_regs<32>(gg);

      // ---- S = X X'^T ----
      const int stx = e % STAGES;
      mbar_wait(&full[stx], (e / STAGES) & 1);
      const char* xw = ring + stx * TILE;
      wgmma_fence();
      mul_abt(sc, x, xw, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);

      // ---- p and ds: columns are the walked tile's rows ----
      if constexpr (kKeys) {
        const float* rl = rows + (t & 1) * 2 * BW;
        const float* rr = rl + BW;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = 8 * j + 2 * t4 + q;
            const float l = rl[col], r = rr[col];
            const float p0 =
                ok_a ? exp2_approx(fmaf(sc[4 * j + q], scale_log2, -l)) : 0.f;
            const float p1 =
                ok_b ? exp2_approx(fmaf(sc[4 * j + 2 + q], scale_log2, -l))
                     : 0.f;
            gg[4 * j + q] = p0 * (gg[4 * j + q] + r);
            gg[4 * j + 2 + q] = p1 * (gg[4 * j + 2 + q] + r);
          }
        }
      } else {
        const int c = t % cps, key0 = c * BW;
        if (c == 0) {   // the walk enters a slot: its rterm of each row
          const float* rs = rterm + ((size_t)bh * S + s0 + t / cps) * LqP;
          rra = ra < Lq ? rs[ra] : 0.f;
          rrb = rb < Lq ? rs[rb] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const bool ok = key0 + 8 * j + 2 * t4 + q < Lk;
            const float p0 =
                ok ? exp2_approx(fmaf(sc[4 * j + q], scale_log2, -lsa)) : 0.f;
            const float p1 =
                ok ? exp2_approx(fmaf(sc[4 * j + 2 + q], scale_log2, -lsb))
                   : 0.f;
            gg[4 * j + q] = p0 * (gg[4 * j + q] + rra);
            gg[4 * j + 2 + q] = p1 * (gg[4 * j + 2 + q] + rrb);
          }
        }
      }
      uint32_t ha[4][4], la[4][4];
      pack_a(gg, ha, la);

      // ---- acc += ds_hi X' + ds_lo X' ----
      wgmma_fence();
      mul_ab(acc, ha, xw);
      mul_ab(acc, la, xw);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(acc);
      fence_operand<16>(&ha[0][0]);
      fence_operand<16>(&la[0][0]);
      release(&empty[stx], lane);
      ++e;
    }

    if constexpr (kKeys) {
      bf16* dkr = dk + ((size_t)s0 * B + b) * Lk * C + h * D;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + 2 * t4;
        if (ok_a)
          *reinterpret_cast<uint32_t*>(dkr + (size_t)ra * C + col) =
              pack_bf16(acc[4 * i] * scale, acc[4 * i + 1] * scale);
        if (ok_b)
          *reinterpret_cast<uint32_t*>(dkr + (size_t)rb * C + col) =
              pack_bf16(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
      }
    } else {
      float* prow = part + ((size_t)blockIdx.z * B + b) * Lq * C + h * D;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + 2 * t4;
        if (ra < Lq)
          *reinterpret_cast<float2*>(prow + (size_t)ra * C + col) =
              make_float2(acc[4 * i], acc[4 * i + 1]);
        if (rb < Lq)
          *reinterpret_cast<float2*>(prow + (size_t)rb * C + col) =
              make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
  }
}

// dv [S, B, Lk, H x dv] bf16. Block (NCONS_V x 64 keys, slot, (batch x
// head) x value group).
__global__ void __launch_bounds__(384, 1)
dv_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k,
          const float* __restrict__ lse2, const int* __restrict__ count_ptr,
          bf16* __restrict__ dvo, int B, int H, int Lq, int LqP, int S,
          int Lk, int dv, float scale_log2) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  char* ring = smem + NCONS_V * TILE;
  float* rows = reinterpret_cast<float*>(ring + STAGES_V * V_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + STAGES_V * BW);
  uint64_t* empty = full + STAGES_V;
  uint64_t* kbar = empty + STAGES_V;

  const int ngrp = dv / NV;
  const int s = blockIdx.y, bh = blockIdx.z / ngrp, grp = blockIdx.z % ngrp;
  const int b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * (BR * NCONS_V);
  const size_t ldv = (size_t)H * dv;
  const int col0 = h * dv + grp * NV;   // this block's columns of a row
  bf16* dvs = dvo + ((size_t)s * B + b) * Lk * ldv;
  if (s >= clamp_count(count_ptr, S)) {   // an invalid slot: exact zeros
    zero_rows(dvs, ldv, key0, BR * NCONS_V, Lk, col0, NV);
    return;
  }
  const int nq = LqP / BW;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES_V; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NCONS_V);
    }
    mbar_init(kbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kbar, NCONS_V * TILE);
      for (int c = 0; c < NCONS_V; ++c)
        for (int a = 0; a < 2; ++a)
          tma_load(smem + c * TILE + a * ATOM, &tm_k, kbar, a * 64, h,
                   key0 + c * BR, s * B + b);
      for (int i = 0; i < nq; ++i) {
        const int st = i % STAGES_V, use = i / STAGES_V;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        char* sq = ring + st * V_STAGE;
        mbar_expect_tx(&full[st], V_STAGE + ROW_BYTES);
        for (int a = 0; a < 2; ++a)
          tma_load(sq + a * ATOM, &tm_q, &full[st], a * 64, h, i * BW, b);
        for (int a = 0; a < NV / 64; ++a)
          tma_load(sq + TILE + a * ATOM, &tm_do, &full[st],
                   grp * NV + a * 64, h, i * BW, b);
        bulk_load(rows + st * BW, lse2 + (size_t)bh * LqP + i * BW,
                  ROW_BYTES, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int t4 = lane & 3;
    const char* sk = smem + cw * TILE;
    const int ka = key0 + cw * BR + warp * 16 + (lane >> 2), kb = ka + 8;
    const bool ok_a = ka < Lk, ok_b = kb < Lk;
    float dva[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) dva[i] = 0.f;
    mbar_wait(kbar, 0);

    for (int i = 0; i < nq; ++i) {
      const int st = i % STAGES_V;
      mbar_wait(&full[st], (i / STAGES_V) & 1);
      const char* sq = ring + st * V_STAGE;
      const float* rl = rows + st * BW;

      // ---- S^T = K Q^T: rows this warpgroup's keys ----
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      wgmma_fence();
      mul_abt(sc, sk, sq, false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);

      // ---- p^T; columns are queries ----
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float l = rl[8 * j + 2 * t4 + q];
          sc[4 * j + q] =
              ok_a ? exp2_approx(fmaf(sc[4 * j + q], scale_log2, -l)) : 0.f;
          sc[4 * j + 2 + q] =
              ok_b ? exp2_approx(fmaf(sc[4 * j + 2 + q], scale_log2, -l))
                   : 0.f;
        }
      }
      uint32_t pa[4][4];
      pack_a(sc, pa, nullptr);

      // ---- dV += p^T dO over this group's columns ----
      wgmma_fence();
      mul_pv(dva, pa, sq + TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NV / 2>(dva);
      fence_operand<16>(&pa[0][0]);
      release(&empty[st], lane);
    }

#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int col = col0 + 8 * i + 2 * t4;
      if (ok_a)
        *reinterpret_cast<uint32_t*>(dvs + (size_t)ka * ldv + col) =
            pack_bf16(dva[4 * i], dva[4 * i + 1]);
      if (ok_b)
        *reinterpret_cast<uint32_t*>(dvs + (size_t)kb * ldv + col) =
            pack_bf16(dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
}

// dq [B, Lq, H x 128] bf16 = scale x the sum of the valid groups' partials,
// in group order. One thread a run of 8 values.
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
    const float4 u = p[0], w = p[1];
    acc[0] += u.x; acc[1] += u.y; acc[2] += u.z; acc[3] += u.w;
    acc[4] += w.x; acc[5] += w.y; acc[6] += w.z; acc[7] += w.w;
  }
  uint4 o;
  o.x = pack_bf16(acc[0] * scale, acc[1] * scale);
  o.y = pack_bf16(acc[2] * scale, acc[3] * scale);
  o.z = pack_bf16(acc[4] * scale, acc[5] * scale);
  o.w = pack_bf16(acc[6] * scale, acc[7] * scale);
  *reinterpret_cast<uint4*>(dq + (size_t)idx * 8) = o;
}

// The four tensor maps: q [B, Lq, H x 128], dout [B, Lq, H x dv], k
// [S, B, Lk, H x 128] and v [S, B, Lk, H x dv], each read in [64 x 64]
// boxes of one head.
struct Maps {
  CUtensorMap q, dout, k, v;
};
static int maps(Maps* m, const void* q, const void* dout, const void* k,
                const void* v, int B, int H, int Lq, int S, int Lk, int dv) {
  int e = map4d(&m->q, q, D, H, Lq, B);
  if (e == 0) e = map4d(&m->dout, dout, dv, H, Lq, B);
  if (e == 0) e = map4d(&m->k, k, D, H, Lk, (uint64_t)S * B);
  if (e == 0) e = map4d(&m->v, v, dv, H, Lk, (uint64_t)S * B);
  return e;
}

template <typename K>
static int configure(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

static bool shapes_ok(int B, int H, int Lq, int S, int Lk, int LqP, int dv) {
  return (H == 1 || H == 2) && B >= 1 && Lq >= 1 && Lk >= 1 && S >= 1 &&
         S <= 128 && dv >= NV && dv % NV == 0 && dv <= MAX_DV &&
         LqP == (Lq + BW - 1) / BW * BW;
}

// One G kernel's launch at a head's values DV: two consumers and a ring
// of STAGES_NARROW up to 512, else one and STAGES_WIDE.
template <bool kKeys, int DV>
static int launch_g_at(const Maps& m, const void* lse2, const void* rterm,
                       const void* count, float* part, bf16* dk, int B,
                       int H, int Lq, int LqP, int S, int Lk, float scale,
                       cudaStream_t stream) {
  constexpr int NCONS = DV <= 512 ? NCONS_NARROW : NCONS_WIDE;
  constexpr int STAGES = DV <= 512 ? STAGES_NARROW : STAGES_WIDE;
  constexpr int SMEM = g_smem_bytes(NCONS, STAGES, DV);
  static_assert(SMEM <= SMEM_LIMIT, "a G kernel's shared memory");
  auto kern = g_kernel<kKeys, DV, NCONS, STAGES>;
  static bool configured = false;     // once per process
  if (!configured) {
    const int e = configure(kern, SMEM);
    if (e != 0) return e;
    configured = true;
  }
  constexpr int rows = BR * NCONS;
  const dim3 grid = kKeys ? dim3((Lk + rows - 1) / rows, S, B * H)
                          : dim3((Lq + rows - 1) / rows, B * H,
                                 (S + G - 1) / G);
  kern<<<grid, 128 * (1 + NCONS), SMEM, stream>>>(
      m.q, m.dout, m.k, m.v, (const float*)lse2, (const float*)rterm,
      (const int*)count, part, dk, B, H, Lq, LqP, S, Lk, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <bool kKeys>
static int launch_g(const Maps& m, const void* lse2, const void* rterm,
                    const void* count, float* part, bf16* dk, int B, int H,
                    int Lq, int LqP, int S, int Lk, int dv, float scale,
                    cudaStream_t stream) {
  switch (dv) {
    case 256:
      return launch_g_at<kKeys, 256>(m, lse2, rterm, count, part, dk, B, H,
                                     Lq, LqP, S, Lk, scale, stream);
    case 512:
      return launch_g_at<kKeys, 512>(m, lse2, rterm, count, part, dk, B, H,
                                     Lq, LqP, S, Lk, scale, stream);
    case 768:
      return launch_g_at<kKeys, 768>(m, lse2, rterm, count, part, dk, B, H,
                                     Lq, LqP, S, Lk, scale, stream);
    case 1024:
      return launch_g_at<kKeys, 1024>(m, lse2, rterm, count, part, dk, B, H,
                                      Lq, LqP, S, Lk, scale, stream);
  }
  return -1;
}

}  // namespace rmem_bwd

// Layouts (bf16, contiguous, 16-byte aligned): q [B, Lq, H x 128], dout
// [B, Lq, H x dv]; k [S, B, Lk, H x 128], v [S, B, Lk, H x dv], H 1 or 2
// and dv a multiple of NV up to 1024; f32 lse2 [B, H, LqP] and rterm
// [B, H, S, LqP] (see the note above); count an int32 on the card. Each
// returns the cudaError_t of its launches (0 on success), -1 for a shape it
// does not take, -2 or -3 if a tensor map cannot be made.

// dq [B, Lq, H x 128] bf16; part [ceil(S / G), B, Lq, H x 128] f32
// scratch, G = rmem_bank_attention_bwd_split_slots().
extern "C" int rmem_bank_attention_bwd_split_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* rterm, const void* count, void* part,
    void* dq, int B, int H, int Lq, int S, int Lk, int LqP, int dv,
    float scale, void* stream) {
  using namespace rmem_bwd;
  if (!shapes_ok(B, H, Lq, S, Lk, LqP, dv)) return -1;
  Maps m;
  int e = maps(&m, q, dout, k, v, B, H, Lq, S, Lk, dv);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  e = launch_g<false>(m, lse2, rterm, count, (float*)part, nullptr, B, H, Lq,
                      LqP, S, Lk, dv, scale, st);
  if (e != 0) return e;
  const int n8 = B * Lq * H * D / 8;
  dq_sum_kernel<<<(n8 + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)count, (bf16*)dq, n8, S, scale);
  return (int)cudaGetLastError();
}

// dk [S, B, Lk, H x 128] bf16, exact zeros in slots >= count.
extern "C" int rmem_bank_attention_bwd_split_dk(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* rterm, const void* count, void* dk, int B,
    int H, int Lq, int S, int Lk, int LqP, int dv, float scale,
    void* stream) {
  using namespace rmem_bwd;
  if (!shapes_ok(B, H, Lq, S, Lk, LqP, dv)) return -1;
  Maps m;
  const int e = maps(&m, q, dout, k, v, B, H, Lq, S, Lk, dv);
  if (e != 0) return e;
  return launch_g<true>(m, lse2, rterm, count, nullptr, (bf16*)dk, B, H, Lq,
                        LqP, S, Lk, dv, scale, (cudaStream_t)stream);
}

// dv [S, B, Lk, H x dv] bf16, exact zeros in slots >= count.
extern "C" int rmem_bank_attention_bwd_split_dv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* rterm, const void* count, void* dv_out,
    int B, int H, int Lq, int S, int Lk, int LqP, int dv, float scale,
    void* stream) {
  using namespace rmem_bwd;
  (void)rterm;
  if (!shapes_ok(B, H, Lq, S, Lk, LqP, dv)) return -1;
  Maps m;
  int e = maps(&m, q, dout, k, v, B, H, Lq, S, Lk, dv);
  if (e != 0) return e;
  static bool configured = false;
  if (!configured) {
    e = configure(dv_kernel, V_SMEM);
    if (e != 0) return e;
    configured = true;
  }
  const int rows = BR * NCONS_V;
  dim3 grid((Lk + rows - 1) / rows, S, B * H * (dv / NV));
  dv_kernel<<<grid, 128 * (1 + NCONS_V), V_SMEM, (cudaStream_t)stream>>>(
      m.q, m.dout, m.k, (const float*)lse2, (const int*)count, (bf16*)dv_out,
      B, H, Lq, LqP, S, Lk, dv, scale * LOG2E);
  return (int)cudaGetLastError();
}

// The slots a dq block walks, and the value columns a dv block takes.
extern "C" int rmem_bank_attention_bwd_split_slots() { return rmem_bwd::G; }
extern "C" int rmem_bank_attention_bwd_split_columns() {
  return rmem_bwd::NV;
}

// Bank attention backward (kernel K2): the gradients of the training
// forward (K1', csrc/bank_attention_infer.cu's lse instantiation) with
// respect to the queries and the valid slots of the bank, including the
// gradient that flows in through the per-slot mass.
//
// Replaces rmem_tpu/kernels/bank_attention.py:_bank_attention_bwd, its
// _dq_kernel and _dkv_kernel. With p = exp(q.k * scale - lse),
// g = dout . v, and delta = rowsum(dout * out) + rowsum(drec * rec)
// (computed by the caller):
//   ds = p * (g + drec[slot] - delta)
//   dq = scale * ds K,  dk = scale * ds^T Q,  dv = p^T dout
// Slots >= count (read on the device) take no work; their dk and dv are 0.
//
// Heads: H of 128 (1, DeAOT's; 2, its no_memory_gap with 512 values a
// head), each head its own softmax, as rmem_tpu/kernels/bank_attention.py:
// _layout folds them into the grid, but without its transposes: q, k, v,
// dout, dq, dk and dv keep their [.., H x d] rows and each block reads and
// writes its head's columns in place; lse, delta and the scratch carry the
// head axis. drec arrives divided by H (the record is the head mean).
//
// What bounds it on an H100: operations. At the training shapes (B 4,
// Lq = Lk = 900, n valid slots, H x 128 keys, 1024 values over the heads)
// the work is 2*B*Lq*(n*Lk)*H*(3*128 + 2*dv) (dv a head's values): ~1.3e11
// FLOP at one head and 4 slots, ~3.0e11 at two heads and 9 slots, against
// ~0.2 to 0.6 GB of inputs, outputs and intermediates.
//
// Design. The TPU kernels keep a [TK, 1024] f32 dV accumulator in VMEM and
// recompute p and ds in both the dq and the dkv kernel. On an SM a 64-key
// dV tile in f32 is 256 KB, more than its shared memory, and ds needs the
// full 1024-wide g = dout . v^T before it exists. So the work is split in
// three kernels that each own an output tile small enough for registers:
//   ds_kernel: one block per (64 queries, 64 keys of one valid slot)
//     of one head computes S = Q K^T and G = dOut V^T (dOut and V streamed
//     in 128-wide chunks through a double buffer), and writes p in bf16 and
//     ds as two bf16 planes, hi = bf16(ds) and lo = bf16(ds - hi), to
//     [B, H, S, Lq, LkP] scratch (LkP = keys padded to 64, padding written
//     0);
//   dq_kernel: one block per (64 queries, head) sums ds K over the valid
//     slots;
//   dkv_kernel: one block per (64 keys of one slot and head, 128 output
//     columns of the head's [dk | dv]) sums ds^T Q or p^T dOut over the
//     queries.
// The scratch costs ~0.1 GB of writes and reads per call, a few percent of
// the time the products take, and nothing is computed twice. ds needs more
// than bf16: each row of ds sums to zero (to the slot-mass term), so dq =
// ds K is a small difference of large terms, and ds rounded to bf16 missed
// dq by 7.5e-2 of its largest value on a training call. dq and dk take
// ds K as hi K + lo K, two products on the tensor cores, ~16 bits of ds.
// Products are mma.sync m16n8k16 (bf16 in, f32 sums) with ldmatrix
// operands, the transposed operands through ldmatrix.trans; tiles arrive by
// cp.async.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace rmem_bwd {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int BQ = 64;         // queries per tile
constexpr int BK = 64;         // keys per tile
constexpr int D = 128;         // key width
constexpr int DC = 128;        // column chunk of the 1024-wide values
constexpr int LD = D + 8;      // pitch of 128-wide tiles (bf16 elements)
constexpr int LT = BK + 8;     // pitch of 64-wide tiles

using namespace rmem_mma;

// Copy a [64][W] bf16 tile whose row r starts at src + r * ld into shared
// memory with pitch P; rows >= nrows are zero-filled.
template <int W, int P>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld, int nrows) {
  for (int i = threadIdx.x; i < 64 * (W / 8); i += kThreads) {
    const int r = i / (W / 8), c8 = i % (W / 8);
    const bool ok = r < nrows;
    cp_async16(dst + r * P + c8 * 8, src + (size_t)(ok ? r : 0) * ld + c8 * 8,
               ok);
  }
}

__device__ __forceinline__ int clamp_count(const int* count_ptr, int S) {
  const int c = *count_ptr;
  return c < 0 ? 0 : (c > S ? S : c);
}

// acc[4][4] += A[rt*16 .. +16][0, W) . B[kh*32 .. +32][0, W)^T, both tiles
// row-major with pitch LD (the Q K^T pattern of the forward kernel).
template <int W>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* sA,
                                        const bf16* sB, int rt, int kh,
                                        int lane) {
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) {
    unsigned a[4];
    ldsm_x4(a, sA + (rt * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned b[4];
      ldsm_x4(b, sB + (kh * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     ks * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// ---- ds: p and ds of one (query tile, key tile of a valid slot, batch x
// head) ----
// DS holds two planes of B*H*S*Lq*LkP values: hi, then lo.
__global__ void __launch_bounds__(kThreads)
ds_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ drec, const int* __restrict__ count_ptr,
          bf16* __restrict__ P, bf16* __restrict__ DS, int B, int H, int Lq,
          int S, int Lk, int LkP, int dv, float scale) {
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sA = sK + BK * LD;          // 2 buffers of dOut chunks
  bf16* sB = sA + 2 * BQ * LD;      // 2 buffers of V chunks

  const int cps = LkP / BK;
  const int s = blockIdx.y / cps, c = blockIdx.y % cps;
  if (s >= clamp_count(count_ptr, S)) return;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ, key0 = c * BK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp & 3;    // 16-query tile
  const int kh = warp >> 2;   // 32-key half
  const int nq = Lq - q0, nk = Lk - key0;
  // row strides over the heads; this head's columns within a row
  const size_t ldk = (size_t)H * D, ldv = (size_t)H * dv;
  const bf16* qb = q + ((size_t)b * Lq + q0) * ldk + h * D;
  const bf16* kb = k + (((size_t)s * B + b) * Lk + key0) * ldk + h * D;
  const bf16* ob = dout + ((size_t)b * Lq + q0) * ldv + (size_t)h * dv;
  const bf16* vb = v + (((size_t)s * B + b) * Lk + key0) * ldv + (size_t)h * dv;

  load_tile<D, LD>(sQ, qb, ldk, nq);
  load_tile<D, LD>(sK, kb, ldk, nk);
  cp_commit();
  auto load_chunk = [&](int ch, int buf) {
    load_tile<DC, LD>(sA + buf * BQ * LD, ob + ch * DC, ldv, nq);
    load_tile<DC, LD>(sB + buf * BK * LD, vb + ch * DC, ldv, nk);
  };
  load_chunk(0, 0);
  cp_commit();

  float sc[4][4], gg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = gg[i][j] = 0.f;
  const int nch = dv / DC;
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nch) load_chunk(ch + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // Q, K and chunk ch are in shared memory
    if (ch == 0) mma_abt<D>(sc, sQ, sK, rt, kh, lane);
    mma_abt<DC>(gg, sA + buf * BQ * LD, sB + buf * BK * LD, rt, kh, lane);
    __syncthreads();  // buffer buf free for chunk ch + 2
  }

  const int qa = q0 + rt * 16 + g, qc = qa + 8;
  float la = 0.f, lc = 0.f, da = 0.f, dc = 0.f, ra = 0.f, rc = 0.f;
  if (qa < Lq) {
    la = lse[(size_t)bh * Lq + qa];
    da = delta[(size_t)bh * Lq + qa];
    ra = drec[((size_t)b * Lq + qa) * S + s];
  }
  if (qc < Lq) {
    lc = lse[(size_t)bh * Lq + qc];
    dc = delta[(size_t)bh * Lq + qc];
    rc = drec[((size_t)b * Lq + qc) * S + s];
  }
  const size_t base = ((size_t)bh * S + s) * Lq;
  bf16* DSL = DS + (size_t)B * H * S * Lq * LkP;
  auto put = [&](size_t o, float p0, float p1, float d0, float d1) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(d0, d1);
    *reinterpret_cast<unsigned*>(P + o) = pack_bf16(p0, p1);
    *reinterpret_cast<__nv_bfloat162*>(DS + o) = hi;
    *reinterpret_cast<unsigned*>(DSL + o) =
        pack_bf16(d0 - __low2float(hi), d1 - __high2float(hi));
  };
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int key = key0 + kh * 32 + nt * 8 + 2 * t;
    float p[4], d[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = key + e < Lk;
      p[e] = ok ? __expf(sc[nt][e] * scale - la) : 0.f;
      p[e + 2] = ok ? __expf(sc[nt][e + 2] * scale - lc) : 0.f;
      d[e] = p[e] * (gg[nt][e] + ra - da);
      d[e + 2] = p[e + 2] * (gg[nt][e + 2] + rc - dc);
    }
    if (qa < Lq) put((base + qa) * LkP + key, p[0], p[1], d[0], d[1]);
    if (qc < Lq) put((base + qc) * LkP + key, p[2], p[3], d[2], d[3]);
  }
}

// ---- dq = scale * sum over valid slots of (ds hi + ds lo) K, one head ----
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ k, const bf16* __restrict__ DS,
          const int* __restrict__ count_ptr, bf16* __restrict__ dq, int B,
          int H, int Lq, int S, int Lk, int LkP, float scale) {
  extern __shared__ __align__(128) char smem[];
  bf16* sD = reinterpret_cast<bf16*>(smem);     // 2 x {hi, lo} x [BQ][LT]
  bf16* sK = sD + 4 * BQ * LT;                    // 2 x [BK][LD]
  const size_t plane = (size_t)B * H * S * Lq * LkP;

  const int cps = LkP / BK;
  const int nch = clamp_count(count_ptr, S) * cps;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ, nq = Lq - q0;
  const size_t ldk = (size_t)H * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp & 3;    // 16-query tile
  const int ch = warp >> 2;   // 64-column half of dq

  auto load = [&](int i, int buf) {
    const int s = i / cps, key0 = (i % cps) * BK;
    const bf16* src = DS + (((size_t)bh * S + s) * Lq + q0) * LkP + key0;
    load_tile<BK, LT>(sD + 2 * buf * BQ * LT, src, LkP, nq);
    load_tile<BK, LT>(sD + (2 * buf + 1) * BQ * LT, src + plane, LkP, nq);
    load_tile<D, LD>(sK + buf * BK * LD,
                     k + (((size_t)s * B + b) * Lk + key0) * ldk + h * D,
                     ldk, Lk - key0);
  };
  if (nch > 0) load(0, 0);
  cp_commit();

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int i = 0; i < nch; ++i) {
    const int buf = i & 1;
    if (i + 1 < nch) load(i + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* cD = sD + 2 * buf * BQ * LT;
    const bf16* cK = sK + buf * BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[4], al[4];
      const int off = (rt * 16 + (lane & 15)) * LT + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(a, cD + off);
      ldsm_x4(al, cD + BQ * LT + off);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bb[4];
        ldsm_x4_t(bb, cK + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          ch * 64 + np * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * np], a, bb[0], bb[1]);
        mma16816(acc[2 * np + 1], a, bb[2], bb[3]);
        mma16816(acc[2 * np], al, bb[0], bb[1]);
        mma16816(acc[2 * np + 1], al, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }

  const int qa = q0 + rt * 16 + g, qc = qa + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = ch * 64 + nt * 8 + 2 * t;
    if (qa < Lq)
      *reinterpret_cast<unsigned*>(dq + ((size_t)b * Lq + qa) * ldk + h * D +
                                   col) =
          pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
    if (qc < Lq)
      *reinterpret_cast<unsigned*>(dq + ((size_t)b * Lq + qc) * ldk + h * D +
                                   col) =
          pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

// ---- dk = scale * (ds hi + ds lo)^T Q (blockIdx.y 0), dv = p^T dOut, of
// one slot and head (blockIdx.z = s B H + b H + h) ----
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ dout,
           const bf16* __restrict__ P, const bf16* __restrict__ DS,
           const int* __restrict__ count_ptr, bf16* __restrict__ dk,
           bf16* __restrict__ dvv, int B, int H, int Lq, int S, int Lk,
           int LkP, int dv, float scale) {
  extern __shared__ __align__(128) char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);   // 2 x {p | ds hi, ds lo} tiles
  bf16* sB = sA + 4 * BQ * LT;                  // 2 x [BQ][LD] of Q or dOut

  const int key0 = blockIdx.x * BK, nk = Lk - key0;
  const bool is_k = blockIdx.y == 0;
  const int col0 = is_k ? 0 : (blockIdx.y - 1) * DC;
  const int wh = is_k ? D : dv;            // a head's columns
  const size_t ld = (size_t)H * wh;        // the row stride over the heads
  const int BH = B * H;
  const int s = blockIdx.z / BH, bh = blockIdx.z % BH, b = bh / H,
            h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp & 3;    // 16-key tile
  const int ch = warp >> 2;   // 64-column half of the 128 columns

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (s < clamp_count(count_ptr, S)) {
    const bf16* A = (is_k ? DS : P) + ((size_t)bh * S + s) * Lq * LkP + key0;
    const size_t plane = (size_t)BH * S * Lq * LkP;
    const bf16* Bm = (is_k ? q : dout) + (size_t)b * Lq * ld +
                     (size_t)h * wh + col0;
    const int nqc = (Lq + BQ - 1) / BQ;
    auto load = [&](int i, int buf) {
      const int q0 = i * BQ;
      const bf16* src = A + (size_t)q0 * LkP;
      load_tile<BK, LT>(sA + 2 * buf * BQ * LT, src, LkP, Lq - q0);
      if (is_k)
        load_tile<BK, LT>(sA + (2 * buf + 1) * BQ * LT, src + plane, LkP,
                          Lq - q0);
      load_tile<DC, LD>(sB + buf * BQ * LD, Bm + (size_t)q0 * ld, ld, Lq - q0);
    };
    load(0, 0);
    cp_commit();
    for (int i = 0; i < nqc; ++i) {
      const int buf = i & 1;
      if (i + 1 < nqc) load(i + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const bf16* cA = sA + 2 * buf * BQ * LT;
      const bf16* cB = sB + buf * BQ * LD;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        // A^T: keys x queries, from the [query][key] tile(s)
        const int off = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LT +
                        rt * 16 + ((lane >> 3) & 1) * 8;
        unsigned a[4], al[4];
        ldsm_x4_t(a, cA + off);
        if (is_k) ldsm_x4_t(al, cA + BQ * LT + off);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned bb[4];
          ldsm_x4_t(bb, cB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD + ch * 64 + np * 16 + (lane >> 4) * 8);
          mma16816(acc[2 * np], a, bb[0], bb[1]);
          mma16816(acc[2 * np + 1], a, bb[2], bb[3]);
          if (is_k) {
            mma16816(acc[2 * np], al, bb[0], bb[1]);
            mma16816(acc[2 * np + 1], al, bb[2], bb[3]);
          }
        }
      }
      __syncthreads();
    }
  }

  const float mul = is_k ? scale : 1.f;
  bf16* out = (is_k ? dk : dvv) + (((size_t)s * B + b) * Lk + key0) * ld +
              (size_t)h * wh + col0;
  const int ra = rt * 16 + g, rc = ra + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = ch * 64 + nt * 8 + 2 * t;
    if (ra < nk)
      *reinterpret_cast<unsigned*>(out + (size_t)ra * ld + col) =
          pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    if (rc < nk)
      *reinterpret_cast<unsigned*>(out + (size_t)rc * ld + col) =
          pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

template <typename K>
static int set_smem(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace rmem_bwd

// Each returns the cudaError_t of its launch (0 on success), -1 for shapes
// the kernels do not take. Layouts, H heads of 128 (1 or 2) and dv a head's
// values (a multiple of 128): q [B, Lq, H x 128]; k [S, B, Lk, H x 128];
// v [S, B, Lk, H x dv]; dout [B, Lq, H x dv] (all bf16); lse, delta
// [B, H, Lq] and drec [B, Lq, S] (the record's cotangent over H) f32;
// count an int32 on the device; P scratch [B, H, S, Lq, LkP] and DS scratch
// [2, B, H, S, Lq, LkP] (hi, lo) bf16, with LkP = Lk rounded up to 64.
static bool bwd_shapes(int H, int Lk, int LkP, int dv) {
  using namespace rmem_bwd;
  return (H == 1 || H == 2) && dv % DC == 0 && LkP == (Lk + BK - 1) / BK * BK;
}

extern "C" int rmem_bank_attention_bwd_ds(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* drec, const void* count,
    void* P, void* DS, int B, int H, int Lq, int S, int Lk, int LkP, int dv,
    float scale, void* stream) {
  using namespace rmem_bwd;
  if (!bwd_shapes(H, Lk, LkP, dv)) return -1;
  const int smem = 6 * 64 * LD * 2;
  int err = set_smem(ds_kernel, smem);
  if (err) return err;
  dim3 grid((Lq + BQ - 1) / BQ, S * (LkP / BK), B * H);
  ds_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const float*)drec,
      (const int*)count, (bf16*)P, (bf16*)DS, B, H, Lq, S, Lk, LkP, dv,
      scale);
  return (int)cudaGetLastError();
}

extern "C" int rmem_bank_attention_bwd_dq(const void* k, const void* DS,
                                          const void* count, void* dq, int B,
                                          int H, int Lq, int S, int Lk,
                                          int LkP, float scale,
                                          void* stream) {
  using namespace rmem_bwd;
  if (!bwd_shapes(H, Lk, LkP, DC)) return -1;
  const int smem = (4 * BQ * LT + 2 * BK * LD) * 2;
  int err = set_smem(dq_kernel, smem);
  if (err) return err;
  dim3 grid((Lq + BQ - 1) / BQ, 1, B * H);
  dq_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)k, (const bf16*)DS, (const int*)count, (bf16*)dq, B, H,
      Lq, S, Lk, LkP, scale);
  return (int)cudaGetLastError();
}

extern "C" int rmem_bank_attention_bwd_dkv(
    const void* q, const void* dout, const void* P, const void* DS,
    const void* count, void* dk, void* dv_out, int B, int H, int Lq, int S,
    int Lk, int LkP, int dv, float scale, void* stream) {
  using namespace rmem_bwd;
  if (!bwd_shapes(H, Lk, LkP, dv)) return -1;
  const int smem = (4 * BQ * LT + 2 * BQ * LD) * 2;
  int err = set_smem(dkv_kernel, smem);
  if (err) return err;
  dim3 grid(LkP / BK, 1 + dv / DC, S * B * H);
  dkv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)dout, (const bf16*)P, (const bf16*)DS,
      (const int*)count, (bf16*)dk, (bf16*)dv_out, B, H, Lq, S, Lk, LkP, dv,
      scale);
  return (int)cudaGetLastError();
}

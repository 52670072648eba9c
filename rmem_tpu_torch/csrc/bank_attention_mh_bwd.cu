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
//   ds = p * (dout_h . v + drec_h[i, s] - delta_h[i]),
//   dq = scale sum ds k,  dk = scale sum_i ds q,  dv = sum_i p dout_h,
// delta_h = rowsum over the head's columns of dout.out + rowsum_s(drec_h
// rec_h), computed by the wrapper in f32. dk and dv are written as exact
// zeros in slots >= count: training adds the slot PE to the keys, so
// autograd sums dk over every slot into the PE's gradient.
//
// What bounds it on an H100: operations. At the training call (B 4, Lq =
// Lk = 900, 4 valid slots) the products the backward needs (S = Q K^T and
// G = dO V^T once, then dq, dk and dv) come to 2 Lq (4 Lk) 32 x 5 x 8 x B
// = 3.3e10 FLOP, 34 us at 989 TFLOP/s, against ~30 MB moved; p's 1.0e8
// exponentials run twice (once in each kernel) on the special-function
// units.
//
// Design (simple first): the JAX kernels' own split, which fits registers
// at 32 wide, and no scratch in device memory (K2 at one head of 128 writes
// p and ds to [B, S, Lq, Lk] scratch, which at 8 heads would be ~1.6 GB a
// call). Two kernels, each recomputing p from the lse, on mma.sync m16n8k16
// with bf16 operands and f32 sums; 4 warps a block, 16 rows a warp:
// - dkv_kernel: one block per (64 keys, slot, batch x head). It keeps its
//   keys' K and V fragments in registers and walks the queries in tiles of
//   64, the next tile's Q and dO in flight by cp.async. Each warp computes
//   S^T = K Q^T and G^T = V dO^T for its 16 keys (the accumulators are
//   p^T's and ds^T's A operands), then dV += p^T dO and dK += ds^T Q.
//   Blocks of slots >= count write zeros and end.
// - dq_kernel: one block per (64 queries, batch x head). It keeps Q's and
//   dO's fragments in registers and walks every valid slot's keys in
//   chunks of 64, the next chunk's K and V in flight; S = Q K^T, G = dO V^T,
//   then dQ += ds K.
// ds enters the dq and dk products as a bf16 hi/lo pair (two mma.sync): a
// row of ds sums to the slot-mass term, so ds k is a small difference of
// large terms that one bf16 rounding would lose. Keys past Lk (the last
// chunk holds 900 - 896 = 4 at the training grid) are zero-filled, masked
// out of p and never written; queries past Lq likewise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace rmem_mhb {

using bf16 = __nv_bfloat16;
using namespace rmem_mma;

constexpr int H = 8;              // heads
constexpr int D = 32;             // width of a head's q, k, v
constexpr int C = H * D;          // row width of q, k, v, dout and grads
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;    // threads
constexpr int BR = 16 * WARPS;    // rows a block owns: keys or queries
constexpr int BW = 64;            // rows of a walked tile: queries, keys
constexpr int LD = D + 8;         // bf16 pitch of the tiles in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// rows [row0, row0 + BW) x the head's 32 columns of a [rows, C] bf16 tensor
// into a [BW, LD] tile; rows at or past n_rows zero-filled, never read
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int n_rows, int h,
                                          int tid) {
  for (int e = tid; e < BW * (D / 8); e += NT) {
    const int r = e / (D / 8), seg = e % (D / 8);
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * LD + seg * 8,
               src + (size_t)(ok ? row0 + r : 0) * C + h * D + seg * 8, ok);
  }
}

// a warp's 16 x 32 A fragments (2 k-steps) from rows warp*16.. of a tile
__device__ __forceinline__ void load_a(unsigned (&f)[D / 16][4],
                                       const bf16* tile, int warp,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(f[ks], tile + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                       (lane >> 4) * 8);
}

// acc[16 x 64] = A[16 x 32] . tile[64 x 32]^T (tile rows are the columns)
__device__ __forceinline__ void mul_abt(float (&acc)[BW / 8][4],
                                        const unsigned (&a)[D / 16][4],
                                        const bf16* tile, int lane) {
#pragma unroll
  for (int n = 0; n < BW / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;
#pragma unroll
  for (int np = 0; np < BW / 16; ++np) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned bb[4];
      ldsm_x4(bb, tile + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                      ks * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], a[ks], bb[0], bb[1]);
      mma16816(acc[2 * np + 1], a[ks], bb[2], bb[3]);
    }
  }
}

// out[16 x 32] += X[16 x 64] . tile[64 x 32], X from an accumulator's
// registers in bf16; with `lo`, X's rounding error goes in a second product
__device__ __forceinline__ void mul_ab(float (&out)[D / 8][4],
                                       const float (&x)[BW / 8][4],
                                       const bf16* tile, int lane, bool lo) {
#pragma unroll
  for (int kk = 0; kk < BW / 16; ++kk) {
    unsigned hi[4], rest[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float c0 = x[2 * kk + (j >> 1)][2 * (j & 1)];
      const float c1 = x[2 * kk + (j >> 1)][2 * (j & 1) + 1];
      hi[j] = pack_bf16(c0, c1);
      if (lo) {
        const __nv_bfloat162 h2 = *reinterpret_cast<__nv_bfloat162*>(&hi[j]);
        rest[j] = pack_bf16(c0 - __low2float(h2), c1 - __high2float(h2));
      }
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned bb[4];
      ldsm_x4_t(bb, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + np * 16 + (lane >> 4) * 8);
      mma16816(out[2 * np], hi, bb[0], bb[1]);
      mma16816(out[2 * np + 1], hi, bb[2], bb[3]);
      if (lo) {
        mma16816(out[2 * np], rest, bb[0], bb[1]);
        mma16816(out[2 * np + 1], rest, bb[2], bb[3]);
      }
    }
  }
}

// a warp's 16 x 32 result rows row0 + warp*16 + (g, g + 8) times `mul`,
// in bf16, rows at or past n_rows not written
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&a)[D / 8][4],
                                           float mul, int row0, int n_rows,
                                           int h, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + warp * 16 + g + 8 * half;
    if (r >= n_rows) continue;
    bf16* p = dst + (size_t)r * C + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(p + n * 8) =
          pack_bf16(a[n][2 * half] * mul, a[n][2 * half + 1] * mul);
  }
}

// q, dout [B, Lq, C]; k, v [S, B, Lk, C] bf16; lse, delta [B, H, Lq] f32;
// drec_h [B, Lq, S] f32 (drec / 8); count an int32 on the card; dk, dv
// [S, B, Lk, C] bf16. Block (key chunk, slot, batch x head).
__global__ void __launch_bounds__(NT)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ drec_h, const int* __restrict__ count,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Lq,
           int S, int Lk, float scale) {
  __shared__ __align__(128) bf16 sK[BR * LD];
  __shared__ __align__(128) bf16 sV[BR * LD];
  __shared__ __align__(128) bf16 sQ[2][BW * LD];
  __shared__ __align__(128) bf16 sO[2][BW * LD];
  __shared__ float sL[2][BW];     // lse in log2 units, +inf past Lq
  __shared__ float sR[2][BW];     // drec_h[i, s] - delta[i], 0 past Lq

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.x * BR, s = blockIdx.y;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int cnt = min(max(*count, 0), S);
  const size_t kv_base = ((size_t)s * B + b) * Lk;
  if (s >= cnt) {     // an invalid slot's gradients are exact zeros
    for (int e = tid; e < BR * (D / 8); e += NT) {
      const int j = e / (D / 8), seg = e % (D / 8);
      if (key0 + j >= Lk) continue;
      const size_t off = (kv_base + key0 + j) * C + h * D + seg * 8;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const float* lse_bh = lse + ((size_t)b * H + h) * Lq;
  const float* delta_bh = delta + ((size_t)b * H + h) * Lq;
  const bf16* q_b = q + (size_t)b * Lq * C;
  const bf16* o_b = dout + (size_t)b * Lq * C;
  // query tile i's Q, dO (cp.async) and row terms (plain loads) into buf
  auto load_queries = [&](int i, int buf) {
    load_tile(sQ[buf], q_b, i * BW, Lq, h, tid);
    load_tile(sO[buf], o_b, i * BW, Lq, h, tid);
    if (tid < BW) {
      const int qi = i * BW + tid;
      const bool ok = qi < Lq;
      sL[buf][tid] = ok ? lse_bh[qi] * LOG2E : INFINITY;
      sR[buf][tid] =
          ok ? drec_h[((size_t)b * Lq + qi) * S + s] - delta_bh[qi] : 0.f;
    }
  };

  load_tile(sK, k + kv_base * C, key0, Lk, h, tid);
  load_tile(sV, v + kv_base * C, key0, Lk, h, tid);
  load_queries(0, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  unsigned kf[D / 16][4], vf[D / 16][4];
  load_a(kf, sK, warp, lane);
  load_a(vf, sV, warp, lane);
  // this thread's two keys, and whether each is a real key
  const bool key_ok0 = key0 + warp * 16 + g < Lk;
  const bool key_ok1 = key0 + warp * 16 + g + 8 < Lk;
  const float scale_log2 = scale * LOG2E;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int tiles = (Lq + BW - 1) / BW;
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < tiles) load_queries(i + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // tile i is in buffer buf
    // S^T = K Q^T and G^T = V dO^T: rows are this warp's keys, columns the
    // tile's queries
    float sc[BW / 8][4], gg[BW / 8][4];
    mul_abt(sc, kf, sQ[buf], lane);
    mul_abt(gg, vf, sO[buf], lane);
#pragma unroll
    for (int n = 0; n < BW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const bool ok = e < 2 ? key_ok0 : key_ok1;
        const float p =
            ok ? exp2f(fmaf(sc[n][e], scale_log2, -sL[buf][col])) : 0.f;
        sc[n][e] = p;
        gg[n][e] = p * (gg[n][e] + sR[buf][col]);
      }
    }
    mul_ab(dva, sc, sO[buf], lane, false);   // dV += p^T dO
    mul_ab(dka, gg, sQ[buf], lane, true);    // dK += ds^T Q, hi/lo
    __syncthreads();  // buffer buf is free for the tile after next
  }
  store_rows(dk + kv_base * C, dka, scale, key0, Lk, h, warp, lane);
  store_rows(dv + kv_base * C, dva, 1.f, key0, Lk, h, warp, lane);
}

// The same inputs; dq [B, Lq, C] bf16. Block (query tile, batch x head).
__global__ void __launch_bounds__(NT)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ drec_h, const int* __restrict__ count,
          bf16* __restrict__ dq, int B, int Lq, int S, int Lk, float scale) {
  __shared__ __align__(128) bf16 sQ[BR * LD];
  __shared__ __align__(128) bf16 sO[BR * LD];
  __shared__ __align__(128) bf16 sK[2][BW * LD];
  __shared__ __align__(128) bf16 sV[2][BW * LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BR;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int cnt = min(max(*count, 0), S);
  const int nch = (Lk + BW - 1) / BW;
  const int steps = cnt * nch;
  // step i: key chunk i % nch of slot i / nch into buffer buf
  auto load_chunk = [&](int i, int buf) {
    const int sl = i / nch, c = i - sl * nch;
    const size_t base = ((size_t)sl * B + b) * Lk * C;
    load_tile(sK[buf], k + base, c * BW, Lk, h, tid);
    load_tile(sV[buf], v + base, c * BW, Lk, h, tid);
  };

  load_tile(sQ, q + (size_t)b * Lq * C, q0, Lq, h, tid);
  load_tile(sO, dout + (size_t)b * Lq * C, q0, Lq, h, tid);
  if (steps > 0) load_chunk(0, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  unsigned qf[D / 16][4], of[D / 16][4];
  load_a(qf, sQ, warp, lane);
  load_a(of, sO, warp, lane);
  // this thread's two queries and their row terms (log2 units; a query
  // past Lq takes lse +inf, so its p is 0)
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  const float* lse_bh = lse + ((size_t)b * H + h) * Lq;
  const float* delta_bh = delta + ((size_t)b * H + h) * Lq;
  const float la = qa < Lq ? lse_bh[qa] * LOG2E : INFINITY;
  const float lb = qb < Lq ? lse_bh[qb] * LOG2E : INFINITY;
  const float da = qa < Lq ? delta_bh[qa] : 0.f;
  const float db = qb < Lq ? delta_bh[qb] : 0.f;
  const float scale_log2 = scale * LOG2E;

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  float ra = 0.f, rb = 0.f;     // drec_h[i, s] - delta[i] of the slot
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load_chunk(i + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // step i's chunk is in buffer buf
    const int sl = i / nch, c = i - sl * nch;
    if (c == 0) {
      const float* dr = drec_h + (size_t)b * Lq * S + sl;
      ra = qa < Lq ? dr[(size_t)qa * S] - da : 0.f;
      rb = qb < Lq ? dr[(size_t)qb * S] - db : 0.f;
    }
    float sc[BW / 8][4], gg[BW / 8][4];
    mul_abt(sc, qf, sK[buf], lane);     // S = Q K^T
    mul_abt(gg, of, sV[buf], lane);     // G = dO V^T
#pragma unroll
    for (int n = 0; n < BW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = c * BW + n * 8 + 2 * t + (e & 1) < Lk;
        const float p = ok ? exp2f(fmaf(sc[n][e], scale_log2,
                                        -(e < 2 ? la : lb)))
                           : 0.f;
        sc[n][e] = p * (gg[n][e] + (e < 2 ? ra : rb));
      }
    }
    mul_ab(dqa, sc, sK[buf], lane, true);   // dQ += ds K, hi/lo
    __syncthreads();  // buffer buf is free for the chunk after next
  }
  store_rows(dq + (size_t)b * Lq * C, dqa, scale, q0, Lq, h, warp, lane);
}

}  // namespace rmem_mhb

// K2h: dq, dk and dv at 8 heads of 32, any batch, 0 < Lk, S <= 128. dk and
// dv are zero in slots >= count. Returns a CUDA error code (0 on success;
// -1 for a shape it does not take).
extern "C" int rmem_bank_attention_mh_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* drec_h,
    const void* count, void* dq, void* dk, void* dv, int B, int H, int Lq,
    int S, int Lk, float scale, void* stream) {
  using namespace rmem_mhb;
  if (H != rmem_mhb::H || S < 1 || S > 128 || Lk < 1 || B < 1 || Lq < 1)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  dq_kernel<<<dim3((Lq + BR - 1) / BR, B * rmem_mhb::H), NT, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const float*)drec_h,
      (const int*)count, (bf16*)dq, B, Lq, S, Lk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<dim3((Lk + BR - 1) / BR, S, B * rmem_mhb::H), NT, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const float*)drec_h,
      (const int*)count, (bf16*)dk, (bf16*)dv, B, Lq, S, Lk, scale);
  return (int)cudaGetLastError();
}

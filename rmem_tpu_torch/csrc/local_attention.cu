// Local (windowed) attention for DeAOT's short-term memory: each query of
// the H x W token grid attends to the (2m+1)^2 keys around it (m = 7, a
// 15 x 15 window), with the learned relative bias rel[q, dy, dx] added to
// the logits and keys outside the image masked out.
//
// Replaces rmem_tpu/kernels/local_attention.py:pallas_local_attention.
//
// What bounds it on an H100: bytes. At the main path's shapes (31 x 54
// grid, dh = 128, dv = 1024, bf16) a layer needs ~0.9 GFLOP but moves
// ~8.5 MB (q, k, v and the 225-wide bias read once, the output written
// once), ~2.5 us at 3.35 TB/s
// against ~1 us of tensor-core time. Design: a block owns an 8 x 8 tile of
// queries and a 128-wide slice of dv. Its keys are the tile's halo, the
// (8 + 2m)^2 = 484 grid cells around it, taken in 64-key chunks, so each
// key and value row is read once per tile and slice rather than once per
// query; the products run densely on the tensor cores (WMMA) and the window
// mask, the image mask and the bias are applied per logit. The TPU kernel's
// scatter of the bias into halo space and its 8-aligned halo width were
// layout tricks for the TPU and are gone: the bias is read in its own
// [q, 225] layout. Grids smaller than the window need no special case: the
// window is always the full 15 x 15 and the image mask removes what lies
// beyond the grid, which is what the cropped relative table of the JAX
// version computes.
//
// Inside a block the attention makes two passes over the keys:
//
//   1. logits = Q K^T on the tensor cores; each row keeps its running max m
//      and its sum l of exp(logit - m) in registers (four threads per row);
//   2. the logits again, p = exp(logit - m) / l written to shared memory in
//      bf16, and O += P V on the tensor cores, the accumulators staying in
//      registers for the whole pass.
//
// The second pass of Q K^T costs D / DVB of the P V work; in exchange no
// accumulator is ever rescaled, so the WMMA fragments never need their
// opaque register layout.
//
// The backward (K5's gradient), rmem_local_attention_bwd. Replaces the
// gradient of rmem_tpu/kernels/local_attention.py:
// pallas_local_attention_trainable, which has no Pallas backward: its rule
// (_trainable_bwd) is the XLA VJP of tiled_local_attention. Per query i and
// window key j, with s = scale q.k + rel[w(i,j)] and p = softmax_j(s):
//   dp = g_i.v_j, delta_i = sum_j p dp (f32, from p and dp, never from the
//   bf16 output), ds = p (dp - delta), drel[i, w] = ds (0 where the window
//   leaves the image), dq = scale sum_j ds k_j, dk = scale sum_i ds q_i,
//   dv = sum_i p g_i.
// What bounds it on an H100: bytes. At the training shapes (B 4, 30 x 30,
// dh 128, dv 1024) the work is 2 pairs (3 dh + 2 dv) ~ 3 GFLOP (~3 us at
// 989 TFLOP/s) against q, k, v, rel and g read once and dq, dk, dv and
// drel written once, ~31 MB (~9 us at 3.35 TB/s). Design: two kernels,
// no atomics, so the result does not depend on the order of blocks.
//   (a) The query side: a block owns an 8 x 8 query tile and its 22 x 22
//       key halo, in 64-key chunks, as the forward. A first pass recomputes
//       each row's max and softmax sum; a second forms p, and dp = G V^T on
//       the tensor cores (dv in 128-wide slices), takes delta in f32 and
//       writes p and dp to [B, HW, 225] f32 in window layout (p to a
//       scratch, dp into drel); a third turns dp into ds in place (drel is
//       ds) and sums dq = scale ds K on the tensor cores, ds entering as a
//       bf16 hi/lo pair (~16 bits: dq is a small difference of large terms,
//       the trap of the bank-attention backward).
//   (b) The key side: a block owns an 8 x 8 key tile and the 22 x 22 halo
//       of queries that see it, and one 128-wide slice of dv (dv = P^T G)
//       or dk (dk = scale ds^T Q, the hi/lo pair again). It gathers p and ds
//       from (a)'s window layout at the mirrored offset: the query sits at
//       offset w' from the key, the key at 224 - w' from the query, and the
//       image mask is the query's own.
// The recomputed logits and the dense halo (484 keys, ~1/3 of them in a
// query's window) cost ~3x the pairs' operations on the tensor cores; the
// scratch (3.2 MB) and the re-read G slices stay in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace rmem {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int TILE = 8;  // TILE * TILE == BQ query rows per block

template <int D, int DVB>
struct TileSmem {
  static constexpr int LQ = D + 8;      // bf16 row pitch of Q and K
  static constexpr int LS = BK + 4;     // f32 row pitch of the logits
  static constexpr int LP = BK + 8;     // bf16 row pitch of P
  static constexpr int LV = DVB + 8;    // bf16 row pitch of V
  static constexpr int LO = DVB + 4;    // f32 row pitch of the output stage
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * LQ * 2;
  static constexpr int s_off = k_off + BK * LQ * 2;
  static constexpr int p_off = s_off + BQ * LS * 4;
  static constexpr int v_off = p_off + BQ * LP * 2;
  static constexpr int end = v_off + BK * LV * 2;
  static constexpr int stage = BQ * LO * 4;
  static constexpr int bytes = end > stage ? end : stage;
  static_assert(D % 16 == 0 && DVB % 32 == 0, "tile shapes");
  static_assert(k_off % 32 == 0 && s_off % 32 == 0 && p_off % 32 == 0 &&
                v_off % 32 == 0, "WMMA needs 32-byte aligned tiles");
};

// Copy `rows` rows of `width` bf16 into shared memory (pitch `pitch`), 16
// bytes a thread; a row whose pointer is null is zero-filled.
template <int width, class RowFn>
__device__ __forceinline__ void load_rows(bf16* dst, int pitch, int rows,
                                          RowFn row_ptr) {
  constexpr int segs = width / 8;
  for (int i = threadIdx.x; i < rows * segs; i += kThreads) {
    const int r = i / segs, s = i % segs;
    const bf16* src = row_ptr(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + s * 8);
    *reinterpret_cast<uint4*>(dst + r * pitch + s * 8) = val;
  }
}

// S[64 x 64] = Q[64 x D] K[64 x D]^T; warp w computes row tile w/2 and
// column tiles 2*(w%2) + {0, 1}.
template <int D, int DVB>
__device__ __forceinline__ void qk_tile(const bf16* sQ, const bf16* sK,
                                        float* sS) {
  using T = TileSmem<D, DVB>;
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1, ct = (warp & 1) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + rt * 16 * T::LQ + k0, T::LQ);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sK + (ct + t) * 16 * T::LQ + k0, T::LQ);
      wmma::mma_sync(c[t], a, b, c[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
    wmma::store_matrix_sync(sS + rt * 16 * T::LS + (ct + t) * 16, c[t],
                            T::LS, wmma::mem_row_major);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The block's queries, keys and values, and its logit rule.
template <int D>
struct LocalPolicy {
  const bf16* q;     // [B, HW, H*D]
  const bf16* k;     // [B, HW, H*D]
  const bf16* v;     // [B, HW, H*dv]
  const bf16* rel;   // [B, HW, H*win*win]
  bf16* out;         // [B, HW, H*dv]
  int Hg, Wg, H, dv, m, win, halo;
  float scale;
  int b, h, y0, x0, c0;

  __device__ int num_chunks() const { return (halo * halo + BK - 1) / BK; }
  __device__ bool query(int r, int& qi, int& qy, int& qx) const {
    qy = y0 + r / TILE;
    qx = x0 + r % TILE;
    qi = qy * Wg + qx;
    return qy < Hg && qx < Wg;
  }
  __device__ bool key(int ch, int j, int& ky, int& kx) const {
    const int hj = ch * BK + j;
    ky = y0 - m + hj / halo;
    kx = x0 - m + hj % halo;
    return hj < halo * halo && ky >= 0 && ky < Hg && kx >= 0 && kx < Wg;
  }
  // null: a padding row (zero-filled) or an output row not written
  __device__ const bf16* q_row(int r) const {
    int qi, qy, qx;
    return query(r, qi, qy, qx)
               ? q + ((size_t)b * Hg * Wg + qi) * H * D + h * D
               : nullptr;
  }
  __device__ const bf16* k_row(int ch, int j) const {
    int ky, kx;
    return key(ch, j, ky, kx)
               ? k + ((size_t)b * Hg * Wg + ky * Wg + kx) * H * D + h * D
               : nullptr;
  }
  __device__ const bf16* v_row(int ch, int j) const {
    int ky, kx;
    return key(ch, j, ky, kx) ? v + ((size_t)b * Hg * Wg + ky * Wg + kx) *
                                        H * dv + h * dv + c0
                              : nullptr;
  }
  __device__ bf16* out_row(int r) const {
    int qi, qy, qx;
    return query(r, qi, qy, qx)
               ? out + ((size_t)b * Hg * Wg + qi) * H * dv + h * dv + c0
               : nullptr;
  }
  // 16 logits of one row from their dot products; -INFINITY = masked
  __device__ void logits(int ch, int row, int col0, const float* dots,
                         float* x) const {
    int qi, qy, qx;
    const bool qok = query(row, qi, qy, qx);
    const bf16* rrow =
        rel + (((size_t)b * Hg * Wg + qi) * H + h) * win * win;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int ky, kx;
      const bool kok = key(ch, col0 + j, ky, kx);
      const int dy = ky - qy, dx = kx - qx;
      const bool ok = qok && kok && dy >= -m && dy <= m && dx >= -m &&
                      dx <= m;
      x[j] = ok ? dots[j] * scale +
                      __bfloat162float(rrow[(dy + m) * win + (dx + m)])
                : -INFINITY;
    }
  }
};

template <int D, int DVB, class Policy>
__device__ void attend(const Policy& pol, char* smem) {
  using T = TileSmem<D, DVB>;
  bf16* sQ = reinterpret_cast<bf16*>(smem + T::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + T::k_off);
  float* sS = reinterpret_cast<float*>(smem + T::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + T::p_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::v_off);
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int col0 = part * 16;
  const int nch = pol.num_chunks();

  load_rows<D>(sQ, T::LQ, BQ, [&](int r) { return pol.q_row(r); });

  // ---- pass 1: row max and softmax denominator ----
  float m = -INFINITY, l = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sK and sS are free again
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    __syncthreads();
    qk_tile<D, DVB>(sQ, sK, sS);
    __syncthreads();
    float x[16];
    pol.logits(ch, row, col0, sS + row * T::LS + col0, x);
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) cmax = fmaxf(cmax, x[j]);
    const float mn = fmaxf(m, quad_max(cmax));
    float s = 0.f;
    if (mn != -INFINITY) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s += (x[j] == -INFINITY) ? 0.f : __expf(x[j] - mn);
    }
    s = quad_sum(s);
    l = (m == -INFINITY ? 0.f : l * __expf(m - mn)) + s;
    m = mn;
  }
  const float inv_l = l > 0.f ? 1.f / l : 0.f;

  // ---- pass 2: normalised probabilities and O = P V ----
  constexpr int NCT = DVB / 32;  // 16-wide column tiles per warp
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1, cb = (warp & 1) * NCT;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NCT];
#pragma unroll
  for (int t = 0; t < NCT; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sK, sS, sP and sV are free again
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    load_rows<DVB>(sV, T::LV, BK, [&](int j) { return pol.v_row(ch, j); });
    __syncthreads();
    qk_tile<D, DVB>(sQ, sK, sS);
    __syncthreads();
    float x[16];
    pol.logits(ch, row, col0, sS + row * T::LS + col0, x);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = (x[j] == -INFINITY) ? 0.f : __expf(x[j] - m) * inv_l;
      sP[row * T::LP + col0 + j] = __float2bfloat16_rn(p);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sP + rt * 16 * T::LP + kk, T::LP);
#pragma unroll
      for (int t = 0; t < NCT; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sV + kk * T::LV + (cb + t) * 16, T::LV);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
  }

  // ---- epilogue: stage in shared memory, write bf16 rows ----
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < NCT; ++t)
    wmma::store_matrix_sync(stage + rt * 16 * T::LO + (cb + t) * 16, acc[t],
                            T::LO, wmma::mem_row_major);
  __syncthreads();
  constexpr int segs = DVB / 8;
  for (int i = threadIdx.x; i < BQ * segs; i += kThreads) {
    const int r = i / segs, s = i % segs;
    bf16* dst = pol.out_row(r);
    if (dst == nullptr) continue;
    const float* src = stage + r * T::LO + s * 8;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(src[j]);
    *reinterpret_cast<uint4*>(dst + s * 8) = *reinterpret_cast<uint4*>(o);
  }
}

template <int D, int DVB>
__global__ void __launch_bounds__(kThreads)
local_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ rel, bf16* __restrict__ out,
                       int Hg, int Wg, int H, int dv, int m, float scale) {
  extern __shared__ __align__(128) char smem[];
  const int tiles_x = (Wg + TILE - 1) / TILE;
  LocalPolicy<D> pol;
  pol.q = q; pol.k = k; pol.v = v; pol.rel = rel; pol.out = out;
  pol.Hg = Hg; pol.Wg = Wg; pol.H = H; pol.dv = dv; pol.m = m;
  pol.win = 2 * m + 1; pol.halo = TILE + 2 * m;
  pol.scale = scale;
  pol.b = blockIdx.z / H; pol.h = blockIdx.z % H;
  pol.y0 = (blockIdx.x / tiles_x) * TILE;
  pol.x0 = (blockIdx.x % tiles_x) * TILE;
  pol.c0 = blockIdx.y * DVB;
  attend<D, DVB>(pol, smem);
}

template <int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* rel, void* out, int B, int Hg, int Wg, int H,
                  int dv, int m, float scale, cudaStream_t stream) {
  constexpr int DVB = 128;
  constexpr int smem = TileSmem<D, DVB>::bytes;
  auto kern = local_attention_kernel<D, DVB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hg + TILE - 1) / TILE) * ((Wg + TILE - 1) / TILE);
  dim3 grid(tiles, dv / DVB, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rel,
      (bf16*)out, Hg, Wg, H, dv, m, scale);
  return (int)cudaGetLastError();
}

// ---- the backward -------------------------------------------------------

template <int D>
struct BwdSmem {
  static constexpr int LQ = D + 8;    // bf16 pitch of Q, K and the G, V slices
  static constexpr int LS = BK + 4;   // f32 pitch of the logits, dp and p
  static constexpr int LP = BK + 8;   // bf16 pitch of the ds hi / lo pair
  static constexpr int LO = D + 4;    // f32 pitch of the output stage
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * LQ * 2;
  static constexpr int s_off = k_off + BK * LQ * 2;
  static constexpr int p_off = s_off + BQ * LS * 4;
  static constexpr int g_off = p_off + BQ * LS * 4;
  static constexpr int v_off = g_off + BQ * LQ * 2;
  static constexpr int hi_off = v_off + BK * LQ * 2;
  static constexpr int lo_off = hi_off + BQ * LP * 2;
  static constexpr int end = lo_off + BQ * LP * 2;
  static constexpr int stage = BQ * LO * 4;    // over Q and K at the end
  static constexpr int bytes = end;
  static_assert(stage <= s_off, "the output stage overlays Q and K");
  static_assert(LQ == TileSmem<D, D>::LQ && LS == TileSmem<D, D>::LS,
                "qk_tile's pitches");
  static_assert(k_off % 32 == 0 && s_off % 32 == 0 && p_off % 32 == 0 &&
                g_off % 32 == 0 && v_off % 32 == 0 && hi_off % 32 == 0 &&
                lo_off % 32 == 0, "WMMA needs 32-byte aligned tiles");
};

// The key side's tiles: P^T or the ds pair [keys x queries], the query
// rows of G or Q, and the output stage over all of them at the end.
template <int D>
struct KeySmem {
  static constexpr int LQ = D + 8;
  static constexpr int LP = BK + 8;
  static constexpr int LO = D + 4;
  static constexpr int hi_off = 0;
  static constexpr int lo_off = hi_off + BQ * LP * 2;
  static constexpr int b_off = lo_off + BQ * LP * 2;
  static constexpr int end = b_off + BK * LQ * 2;
  static constexpr int stage = BQ * LO * 4;
  static constexpr int bytes = end > stage ? end : stage;
};

__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// Write a [64 x D] f32 tile of accumulators, times `mul`, as bf16 rows;
// row_ptr(r) null skips the row. Ends with the stage consumed.
template <int D, int NF, class RowFn>
__device__ __forceinline__ void store_rows(
    char* smem, wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
    int rt, int cb, float mul, RowFn row_ptr) {
  constexpr int LO = D + 4;
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < NF; ++t)
    wmma::store_matrix_sync(stage + rt * 16 * LO + (cb + t) * 16, acc[t], LO,
                            wmma::mem_row_major);
  __syncthreads();
  constexpr int segs = D / 8;
  for (int i = threadIdx.x; i < BQ * segs; i += kThreads) {
    const int r = i / segs, s = i % segs;
    bf16* dst = row_ptr(r);
    if (dst == nullptr) continue;
    const float* src = stage + r * LO + s * 8;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(src[j] * mul);
    *reinterpret_cast<uint4*>(dst + s * 8) = *reinterpret_cast<uint4*>(o);
  }
}

// (a) One 8 x 8 query tile: p to p_out and ds to drel ([B, HW, win^2] f32,
// window layout), dq [B, HW, D] bf16.
template <int D>
__global__ void __launch_bounds__(kThreads)
local_bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ rel,
                       const bf16* __restrict__ g, float* __restrict__ p_out,
                       float* __restrict__ drel, bf16* __restrict__ dq,
                       int Hg, int Wg, int dv, int m, float scale) {
  using T = BwdSmem<D>;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + T::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + T::k_off);
  float* sS = reinterpret_cast<float*>(smem + T::s_off);
  float* sP = reinterpret_cast<float*>(smem + T::p_off);
  bf16* sG = reinterpret_cast<bf16*>(smem + T::g_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::v_off);
  bf16* sHi = reinterpret_cast<bf16*>(smem + T::hi_off);
  bf16* sLo = reinterpret_cast<bf16*>(smem + T::lo_off);

  const int tiles_x = (Wg + TILE - 1) / TILE;
  LocalPolicy<D> pol;
  pol.q = q; pol.k = k; pol.v = v; pol.rel = rel; pol.out = nullptr;
  pol.Hg = Hg; pol.Wg = Wg; pol.H = 1; pol.dv = dv; pol.m = m;
  pol.win = 2 * m + 1; pol.halo = TILE + 2 * m;
  pol.scale = scale;
  pol.b = blockIdx.y; pol.h = 0;
  pol.y0 = (blockIdx.x / tiles_x) * TILE;
  pol.x0 = (blockIdx.x % tiles_x) * TILE;
  pol.c0 = 0;
  const int win = pol.win, win2 = win * win;
  const size_t HW = (size_t)Hg * Wg;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int col0 = part * 16;
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1;
  const int nch = pol.num_chunks();
  int qi, qy, qx;
  const bool qok = pol.query(row, qi, qy, qx);
  float* prow = p_out + ((size_t)pol.b * HW + (qok ? qi : 0)) * win2;
  float* drow = drel + ((size_t)pol.b * HW + (qok ? qi : 0)) * win2;
  // this thread's 16 keys of a chunk: their window offset, -1 outside
  auto offsets = [&](int ch, int* w) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int ky, kx;
      const bool kok = pol.key(ch, col0 + j, ky, kx);
      const int dy = ky - qy, dx = kx - qx;
      w[j] = (qok && kok && dy >= -m && dy <= m && dx >= -m && dx <= m)
                 ? (dy + m) * win + (dx + m)
                 : -1;
    }
  };

  load_rows<D>(sQ, T::LQ, BQ, [&](int r) { return pol.q_row(r); });

  // ---- pass 1: row max and softmax denominator, as the forward ----
  float mrow = -INFINITY, l = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    __syncthreads();
    qk_tile<D, D>(sQ, sK, sS);
    __syncthreads();
    float x[16];
    pol.logits(ch, row, col0, sS + row * T::LS + col0, x);
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) cmax = fmaxf(cmax, x[j]);
    const float mn = fmaxf(mrow, quad_max(cmax));
    float s = 0.f;
    if (mn != -INFINITY) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s += (x[j] == -INFINITY) ? 0.f : __expf(x[j] - mn);
    }
    s = quad_sum(s);
    l = (mrow == -INFINITY ? 0.f : l * __expf(mrow - mn)) + s;
    mrow = mn;
  }
  const float inv_l = l > 0.f ? 1.f / l : 0.f;

  // ---- pass 2: p, dp = G V^T, delta; p and dp out in window layout ----
  float delta = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sK, sS, sP free again
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    __syncthreads();
    qk_tile<D, D>(sQ, sK, sS);
    __syncthreads();
    float x[16];
    int w[16];
    pol.logits(ch, row, col0, sS + row * T::LS + col0, x);
    offsets(ch, w);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = (x[j] == -INFINITY) ? 0.f : __expf(x[j] - mrow) * inv_l;
      sP[row * T::LS + col0 + j] = p;
      if (w[j] >= 0) prow[w[j]] = p;
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    const int ct = (warp & 1) * 2;
    for (int c0 = 0; c0 < dv; c0 += D) {
      __syncthreads();  // sG, sV free; in the first slice, sS read
      load_rows<D>(sG, T::LQ, BQ, [&](int r) -> const bf16* {
        int i, y, xx;
        return pol.query(r, i, y, xx)
                   ? g + ((size_t)pol.b * HW + i) * dv + c0
                   : nullptr;
      });
      load_rows<D>(sV, T::LQ, BK, [&](int j) -> const bf16* {
        int ky, kx;
        return pol.key(ch, j, ky, kx)
                   ? v + ((size_t)pol.b * HW + ky * Wg + kx) * dv + c0
                   : nullptr;
      });
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sG + rt * 16 * T::LQ + k0, T::LQ);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              b;
          wmma::load_matrix_sync(b, sV + (ct + t) * 16 * T::LQ + k0, T::LQ);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
      wmma::store_matrix_sync(sS + rt * 16 * T::LS + (ct + t) * 16, acc[t],
                              T::LS, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float dp = sS[row * T::LS + col0 + j];
      delta += sP[row * T::LS + col0 + j] * dp;
      if (w[j] >= 0) drow[w[j]] = dp;
    }
  }
  delta = quad_sum(delta);

  // ---- pass 3: ds = p (dp - delta) into drel, dq = scale ds K ----
  if (qok)
    for (int wi = part; wi < win2; wi += 4) {
      const int ky = qy + wi / win - m, kx = qx + wi % win - m;
      if (ky < 0 || ky >= Hg || kx < 0 || kx >= Wg) drow[wi] = 0.f;
    }
  constexpr int NF = D / 32;      // 16-wide column tiles of dq per warp
  const int cb = (warp & 1) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[NF];
#pragma unroll
  for (int t = 0; t < NF; ++t) wmma::fill_fragment(dacc[t], 0.f);
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sK, sHi, sLo free again
    load_rows<D>(sK, T::LQ, BK, [&](int j) { return pol.k_row(ch, j); });
    int w[16];
    offsets(ch, w);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bf16 hi = __float2bfloat16_rn(0.f), lo = hi;
      if (w[j] >= 0) {
        // this thread wrote p and dp of these entries in pass 2
        const float ds = prow[w[j]] * (drow[w[j]] - delta);
        drow[w[j]] = ds;
        split_bf16(ds, hi, lo);
      }
      sHi[row * T::LP + col0 + j] = hi;
      sLo[row * T::LP + col0 + j] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ah,
          al;
      wmma::load_matrix_sync(ah, sHi + rt * 16 * T::LP + kk, T::LP);
      wmma::load_matrix_sync(al, sLo + rt * 16 * T::LP + kk, T::LP);
#pragma unroll
      for (int t = 0; t < NF; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sK + kk * T::LQ + (cb + t) * 16, T::LQ);
        wmma::mma_sync(dacc[t], ah, b, dacc[t]);
        wmma::mma_sync(dacc[t], al, b, dacc[t]);
      }
    }
  }
  store_rows<D, NF>(smem, dacc, rt, cb, scale, [&](int r) -> bf16* {
    int i, y, xx;
    return pol.query(r, i, y, xx) ? dq + ((size_t)pol.b * HW + i) * D
                                  : nullptr;
  });
}

// (b) One 8 x 8 key tile and one 128-wide column slice: dv = P^T G for
// slice blockIdx.y < dv / D, dk = scale ds^T Q for the last.
template <int D>
__global__ void __launch_bounds__(kThreads)
local_bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ g,
                     const float* __restrict__ p_in,
                     const float* __restrict__ ds_in, bf16* __restrict__ dk,
                     bf16* __restrict__ dvo, int Hg, int Wg, int dv, int m,
                     float scale) {
  using T = KeySmem<D>;
  extern __shared__ __align__(128) char smem[];
  bf16* sHi = reinterpret_cast<bf16*>(smem + T::hi_off);
  bf16* sLo = reinterpret_cast<bf16*>(smem + T::lo_off);
  bf16* sB = reinterpret_cast<bf16*>(smem + T::b_off);

  const int tiles_x = (Wg + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_x) * TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int b = blockIdx.z;
  const bool is_dk = (int)blockIdx.y == dv / D;
  const int c0 = blockIdx.y * D;
  const int win = 2 * m + 1, win2 = win * win, halo = TILE + 2 * m;
  const size_t HW = (size_t)Hg * Wg;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int col0 = part * 16;
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1;
  constexpr int NF = D / 32;
  const int cb = (warp & 1) * NF;
  const int ky = y0 + row / TILE, kx = x0 + row % TILE;
  const bool kok = ky < Hg && kx < Wg;
  const int nch = (halo * halo + BK - 1) / BK;
  const float* src = is_dk ? ds_in : p_in;
  auto query = [&](int ch, int c, int& qi) {
    const int hj = ch * BK + c;
    const int qy = y0 - m + hj / halo, qx = x0 - m + hj % halo;
    qi = qy * Wg + qx;
    return hj < halo * halo && qy >= 0 && qy < Hg && qx >= 0 && qx < Wg;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int t = 0; t < NF; ++t) wmma::fill_fragment(acc[t], 0.f);
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // sHi, sLo, sB free again
    load_rows<D>(sB, T::LQ, BK, [&](int c) -> const bf16* {
      int qi;
      if (!query(ch, c, qi)) return nullptr;
      return is_dk ? q + ((size_t)b * HW + qi) * D
                   : g + ((size_t)b * HW + qi) * dv + c0;
    });
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int qi;
      const bool qok = query(ch, col0 + j, qi);
      const int qy = qi / Wg, qx = qi - qy * Wg;
      const int dy = qy - ky, dx = qx - kx;
      float val = 0.f;
      if (qok && kok && dy >= -m && dy <= m && dx >= -m && dx <= m) {
        // the query at offset wk from the key sees the key at win2-1-wk
        const int wk = (dy + m) * win + (dx + m);
        val = src[((size_t)b * HW + qi) * win2 + (win2 - 1 - wk)];
      }
      bf16 hi, lo;
      split_bf16(val, hi, lo);
      sHi[row * T::LP + col0 + j] = hi;
      sLo[row * T::LP + col0 + j] = lo;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ah,
          al;
      wmma::load_matrix_sync(ah, sHi + rt * 16 * T::LP + kk, T::LP);
      if (is_dk) wmma::load_matrix_sync(al, sLo + rt * 16 * T::LP + kk, T::LP);
#pragma unroll
      for (int t = 0; t < NF; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, sB + kk * T::LQ + (cb + t) * 16, T::LQ);
        wmma::mma_sync(acc[t], ah, bm, acc[t]);
        if (is_dk) wmma::mma_sync(acc[t], al, bm, acc[t]);
      }
    }
  }
  store_rows<D, NF>(smem, acc, rt, cb, is_dk ? scale : 1.f,
                    [&](int r) -> bf16* {
    const int y = y0 + r / TILE, x = x0 + r % TILE;
    if (y >= Hg || x >= Wg) return nullptr;
    const size_t ki = (size_t)b * HW + y * Wg + x;
    return is_dk ? dk + ki * D : dvo + ki * dv + c0;
  });
}

template <int D>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* rel, const void* g, void* dq, void* dk,
                      void* dv_out, void* drel, void* p_scratch, int B,
                      int Hg, int Wg, int dv, int m, float scale,
                      cudaStream_t stream) {
  constexpr int smem_q = BwdSmem<D>::bytes, smem_k = KeySmem<D>::bytes;
  auto kq = local_bwd_query_kernel<D>;
  auto kk = local_bwd_key_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_k);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hg + TILE - 1) / TILE) * ((Wg + TILE - 1) / TILE);
  kq<<<dim3(tiles, B), kThreads, smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rel,
      (const bf16*)g, (float*)p_scratch, (float*)drel, (bf16*)dq, Hg, Wg, dv,
      m, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kk<<<dim3(tiles, dv / D + 1, B), kThreads, smem_k, stream>>>(
      (const bf16*)q, (const bf16*)g, (const float*)p_scratch,
      (const float*)drel, (bf16*)dk, (bf16*)dv_out, Hg, Wg, dv, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace rmem

// The backward: dq, dk [B, HW, 128] and dv [B, HW, dv] bf16, drel and the
// p scratch [B, HW, (2m+1)^2] f32. Returns the cudaError_t of the launches
// (0 on success); -1 for anything but one head of 128 and dv a multiple of
// 128.
extern "C" int rmem_local_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* rel,
                                        const void* g, void* dq, void* dk,
                                        void* dv_out, void* drel,
                                        void* p_scratch, int B, int Hg,
                                        int Wg, int H, int dh, int dv,
                                        int max_dis, float scale,
                                        void* stream) {
  if (H != 1 || dh != 128 || dv % 128 != 0) return -1;
  return rmem::launch_bwd<128>(q, k, v, rel, g, dq, dk, dv_out, drel,
                               p_scratch, B, Hg, Wg, dv, max_dis, scale,
                               (cudaStream_t)stream);
}

// Returns the cudaError_t of the launch (0 on success); -1 for a head width
// other than 128, the only one instantiated.
extern "C" int rmem_local_attention(const void* q, const void* k,
                                    const void* v, const void* rel, void* out,
                                    int B, int Hg, int Wg, int H, int dh,
                                    int dv, int max_dis, float scale,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh != 128) return -1;
  return rmem::launch<128>(q, k, v, rel, out, B, Hg, Wg, H, dv, max_dis,
                           scale, st);
}

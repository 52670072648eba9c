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

}  // namespace rmem

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

// Bank attention for training's forward: the clip's queries attend into
// the valid slots of the long-term memory bank, each slot's share of the
// softmax mass is returned beside the output, and the per-row log-sum-exp
// of the scaled logits is written for the backward
// (csrc/bank_attention_bwd.cu).
//
// Replaces the forward of rmem_tpu/kernels/bank_attention.py:
// pallas_bank_attention's VJP (_forward with want_lse). The output is
// written in f32, because the backward's row term delta = rowsum(dout *
// out) must not carry the output's bf16 rounding: dq is a small difference
// of large terms, and delta from the bf16 output missed it by 7.5e-2 of its
// largest value on a training call. Serving's bank attention, with the
// slot-PE bias and key padding, is csrc/bank_attention_infer.cu.
//
// What bounds it on an H100: operations. At the training shapes (B 4,
// Lq = Lk = 900, up to 4 valid slots, dh = 128, dv = 1024) the work is
// 2*B*Lq*(S*Lk)*(dh + dv) ~ 3.0e10 FLOP against ~34 MB read, so the tensor
// cores set the bound (~30 us at 989 TFLOP/s), not the 3.35 TB/s.
//
// Design. The TPU kernel keeps a [256, 1024] f32 accumulator in VMEM, which
// no SM can hold. Here a block of 8 warps owns 64 query rows and a 256-wide
// slice of dv, so its accumulators fit in registers; each slice recomputes
// the 128-wide logits, a quarter of the P V work. The keys stream in chunks
// of 64: each chunk's K and V arrive by cp.async into one of two
// shared-memory buffers while the block computes on the other. Products are
// mma.sync m16n8k16 (bf16 in, f32 sums) with ldmatrix operands. One
// online-softmax pass: warps 0-3 and 4-7 each take half a chunk's keys for
// the S = Q K^T tile of their 16 rows, exchange row maxima and sums through
// shared memory, write P in bf16, and then each warp rescales and
// accumulates O for its 16 rows and half of the slice. The slot mass is
// rescaled with the row sum l, as in the TPU kernel, and divided by l at
// the end. The slot count stays on the device: the kernel reads it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace rmem {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int SMAX = 16;

using namespace rmem_mma;

template <int D, int DVB>
struct Smem {
  static constexpr int LQ = D + 8;
  static constexpr int LV = DVB + 8;
  static constexpr int LP = BK + 8;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * LQ * 2;            // 2 buffers
  static constexpr int v_off = k_off + 2 * BK * LQ * 2;        // 2 buffers
  static constexpr int p_off = v_off + 2 * BK * LV * 2;
  static constexpr int red_off = p_off + BQ * LP * 2;          // [2][2][BQ]
  static constexpr int mass_off = red_off + 4 * BQ * 4;        // [BQ][SMAX]
  static constexpr int bytes = mass_off + BQ * SMAX * 4;
};

template <int D, int DVB>
__global__ void __launch_bounds__(kThreads)
bank_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const int* __restrict__ count_ptr,
            float* __restrict__ rec, float* __restrict__ lse,
            float* __restrict__ out32, int B, int H, int Lq, int S, int Lk,
            int dv, float scale) {
  using L = Smem<D, DVB>;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  float* sMass = reinterpret_cast<float*>(smem + L::mass_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp & 3;   // 16-row tile
  const int kh = warp >> 2;  // key half (S phase) and column half (P V phase)
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int q0 = blockIdx.x * BQ, c0 = blockIdx.y * DVB;
  const int HD = H * D, HDV = H * dv;
  int count = *count_ptr;
  count = count < 0 ? 0 : (count > S ? S : count);
  const int cps = (Lk + BK - 1) / BK;
  const int nch = count * cps;
  const int r0 = rt * 16 + g, r1 = r0 + 8;      // this thread's two rows
  const bool write_rec = blockIdx.y == 0 && kh == 0 && t == 0;

  // ---- Q tile (group 0), chunk 0 (group 1) ----
  for (int i = tid; i < BQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8), s8 = i % (D / 8);
    const int qi = q0 + r;
    const bf16* src = q + ((size_t)b * Lq + (qi < Lq ? qi : 0)) * HD + h * D +
                      s8 * 8;
    cp_async16(sQ + r * L::LQ + s8 * 8, src, qi < Lq);
  }
  cp_commit();
  auto load_chunk = [&](int ch, int buf) {
    const int s = ch / cps, key0 = (ch % cps) * BK;
    bf16* dK = sK + buf * BK * L::LQ;
    bf16* dV = sV + buf * BK * L::LV;
    for (int i = tid; i < BK * (D / 8); i += kThreads) {
      const int j = i / (D / 8), s8 = i % (D / 8);
      const int key = key0 + j;
      const bf16* src = k + (((size_t)s * B + b) * Lk + (key < Lk ? key : 0)) *
                                HD + h * D + s8 * 8;
      cp_async16(dK + j * L::LQ + s8 * 8, src, key < Lk);
    }
    for (int i = tid; i < BK * (DVB / 8); i += kThreads) {
      const int j = i / (DVB / 8), s8 = i % (DVB / 8);
      const int key = key0 + j;
      const bf16* src = v + (((size_t)s * B + b) * Lk + (key < Lk ? key : 0)) *
                                HDV + h * dv + c0 + s8 * 8;
      cp_async16(dV + j * L::LV + s8 * 8, src, key < Lk);
    }
  };
  if (nch > 0) load_chunk(0, 0);
  cp_commit();

  if (write_rec)
    for (int j = 0; j < SMAX; ++j) {
      sMass[r0 * SMAX + j] = 0.f;
      sMass[r1 * SMAX + j] = 0.f;
    }

  constexpr int NT = DVB / 16;      // n8 tiles of this warp's column half
  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  unsigned qf[D / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nch) load_chunk(ch + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // (A) chunk ch and Q are in shared memory
    if (ch == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        ldsm_x4(qf[ks], sQ + (rt * 16 + (lane & 15)) * L::LQ + ks * 16 +
                            (lane >> 4) * 8);
    }
    const int slot = ch / cps, key0 = (ch % cps) * BK;
    const bf16* cK = sK + buf * BK * L::LQ;
    const bf16* cV = sV + buf * BK * L::LV;

    // ---- S = Q K^T for rows rt, keys kh*32 .. +32 ----
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int np = 0; np < 2; ++np) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned kb[4];
        ldsm_x4(kb, cK + (kh * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                             L::LQ + ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(sc[2 * np], qf[ks], kb[0], kb[1]);
        mma16816(sc[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + kh * 32 + nt * 8 + 2 * t + e;
        const bool ok = key < Lk;
        sc[nt][e] = ok ? sc[nt][e] * scale : -INFINITY;
        sc[nt][e + 2] = ok ? sc[nt][e + 2] * scale : -INFINITY;
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][e + 2]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (t == 0) {
      red[kh * BQ + r0] = mx0;
      red[kh * BQ + r1] = mx1;
    }
    __syncthreads();  // (B)
    const float mn0 = fmaxf(m0, fmaxf(red[r0], red[BQ + r0]));
    const float mn1 = fmaxf(m1, fmaxf(red[r1], red[BQ + r1]));
    const float a0 = (m0 == -INFINITY) ? 0.f : __expf(m0 - mn0);
    const float a1 = (m1 == -INFINITY) ? 0.f : __expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = sc[nt][e] == -INFINITY ? 0.f : __expf(sc[nt][e] - mn0);
        p[e + 2] =
            sc[nt][e + 2] == -INFINITY ? 0.f : __expf(sc[nt][e + 2] - mn1);
      }
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      const int col = kh * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<unsigned*>(sP + r0 * L::LP + col) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<unsigned*>(sP + r1 * L::LP + col) = pack_bf16(p[2], p[3]);
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    if (t == 0) {
      red[2 * BQ + kh * BQ + r0] = ps0;
      red[2 * BQ + kh * BQ + r1] = ps1;
    }
    __syncthreads();  // (C) P and the row sums are in shared memory
    const float cs0 = red[2 * BQ + r0] + red[3 * BQ + r0];
    const float cs1 = red[2 * BQ + r1] + red[3 * BQ + r1];
    l0 = l0 * a0 + cs0;
    l1 = l1 * a1 + cs1;
    m0 = mn0;
    m1 = mn1;
    if (write_rec) {
      for (int j = 0; j < S; ++j) {
        sMass[r0 * SMAX + j] *= a0;
        sMass[r1 * SMAX + j] *= a1;
      }
      sMass[r0 * SMAX + slot] += cs0;
      sMass[r1 * SMAX + slot] += cs1;
    }

    // ---- O = O * alpha + P V for rows rt, columns hc*DVB/2 .. ----
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      o[i][0] *= a0; o[i][1] *= a0; o[i][2] *= a1; o[i][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[4];
      ldsm_x4(pa, sP + (rt * 16 + (lane & 15)) * L::LP + kk * 16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned vb[4];
        ldsm_x4_t(vb, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               L::LV + kh * (DVB / 2) + np * 16 +
                           (lane >> 4) * 8);
        mma16816(o[2 * np], pa, vb[0], vb[1]);
        mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // (D) buffers, P and red free for the next chunk
  }

  // ---- epilogue ----
  const float il0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float il1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int qa = q0 + r0, qb = q0 + r1;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = c0 + kh * (DVB / 2) + nt * 8 + 2 * t;
    const size_t oa = ((size_t)b * Lq + qa) * HDV + h * dv + col;
    const size_t ob = ((size_t)b * Lq + qb) * HDV + h * dv + col;
    if (qa < Lq)
      *reinterpret_cast<float2*>(out32 + oa) =
          make_float2(o[nt][0] * il0, o[nt][1] * il0);
    if (qb < Lq)
      *reinterpret_cast<float2*>(out32 + ob) =
          make_float2(o[nt][2] * il1, o[nt][3] * il1);
  }
  if (write_rec) {
    const size_t base = ((size_t)b * H + h) * Lq;
    for (int j = 0; j < S; ++j) {
      if (qa < Lq) rec[(base + qa) * S + j] = sMass[r0 * SMAX + j] * il0;
      if (qb < Lq) rec[(base + qb) * S + j] = sMass[r1 * SMAX + j] * il1;
    }
    // one dv slice writes the row's log-sum-exp; every slice computed the
    // same m and l from the same logits
    if (qa < Lq) lse[base + qa] = l0 > 0.f ? m0 + logf(l0) : -INFINITY;
    if (qb < Lq) lse[base + qb] = l1 > 0.f ? m1 + logf(l1) : -INFINITY;
  }
}

template <int D, int DVB>
static int launch(const void* q, const void* k, const void* v,
                  const void* count, void* rec, void* lse, void* out32, int B,
                  int H, int Lq, int S, int Lk, int dv, float scale,
                  cudaStream_t stream) {
  constexpr int smem = Smem<D, DVB>::bytes;
  auto kern = bank_kernel<D, DVB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, dv / DVB, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)count,
      (float*)rec, (float*)lse, (float*)out32, B, H, Lq, S, Lk, dv, scale);
  return (int)cudaGetLastError();
}

}  // namespace rmem

// Returns the cudaError_t of the launch (0 on success); -1 for a head width
// other than 128, the only one instantiated. out32 [B, Lq, H*dv] f32, rec
// [B*H, Lq, S] f32, lse [B*H, Lq] f32.
extern "C" int rmem_bank_attention_lse(const void* q, const void* k,
                                       const void* v, const void* count,
                                       void* out32, void* rec, void* lse,
                                       int B, int H, int Lq, int S, int Lk,
                                       int dh, int dv, float scale,
                                       void* stream) {
  if (dh != 128) return -1;
  return rmem::launch<128, 256>(q, k, v, count, rec, lse, out32, B, H, Lq, S,
                                Lk, dv, scale, (cudaStream_t)stream);
}

// Bank attention for inference with the slots split among blocks: the
// current frame's queries attend into the valid slots of the long-term
// memory bank, and each slot's share of the softmax mass is returned beside
// the output. The function of csrc/bank_attention.cu (K1) without its logit
// bias and key padding: the slot temporal PE arrives added to the keys.
//
// Replaces rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_qminor
// (_kernel_qminor, _forward_qminor). That kernel runs the grid (bh,
// slots x chunks, query tiles) so that each K/V chunk is fetched once and
// every query tile streams past it, with the online-softmax state and an
// [Lq, dv] f32 accumulator for all queries kept in VMEM. At the main path
// that accumulator is 1674 x 1024 x 4 B = 6.9 MB, 30x an SM's shared memory
// and more than a cluster's, so the order cannot keep its state on chip
// here. What this kernel takes from it is the other axis of the work: the
// slots.
//
// What bounds it on an H100: operations, as K1. At the main path (Lq = Lk =
// 1674, 9 valid slots, dh 128, dv 1024) the work is 2*Lq*(S*Lk)*(dh + dv)
// ~ 5.8e10 FLOP against ~40 MB of bank read: ~59 us at 989 TFLOP/s.
//
// Design. K1 gives a block 64 queries and a 256-wide slice of dv and walks
// all valid slots; its grid at the main path is 27 x 4 = 108 blocks on 132
// SMs. Here the grid is (query tile, dv slice, batch x head x slot group):
// a block walks only the G = 2 slots of its group, and blocks whose group
// starts at or beyond the slot count, read on the device, return at once,
// so a frame never waits for the host. With 9 valid slots that is
// 27 x 4 x 5 = 540 working blocks, ~4.1 waves of one block per SM (176
// registers a thread, 131 KB of shared memory a block). G = 2 timed
// fastest of 1, 2, 3 and 9 slots a block in chip_smoke.py's phase 2 on an
// H100 80GB HBM3 at 700 W (0.595 ms against 0.620, 0.653 and 0.723; K1
// 0.755 on the same inputs), so G is fixed at compile time. The block's
// inner loop is K1's:
// 8 warps, keys in chunks of 64 by cp.async into two buffers, mma.sync
// m16n8k16 with ldmatrix, one online-softmax pass. Each block writes its
// partial state in f32: the row maximum m over its group, the per-slot row
// sums l_s (relative to m, rescaled as m grows, as K1 rescales its slot
// mass) and the unnormalised accumulator acc. The scratch is
// ceil(S / G) x B x Lq x dv x 4 bytes for acc (34.3 MB at the main path
// with G = 2 over the bank's 10 slots; only the valid groups are written)
// plus 2 x S x B x Lq x 4 for m and l. A second kernel reads the count and
// merges the groups of each row: with M = max_g m_g and
// L = sum_g e^(m_g - M) sum_{s in g} l_s,
//   out   = sum_g e^(m_g - M) acc_g / L          (rounded to bf16)
//   rec_s = e^(m_g(s) - M) l_s / L               (0 for slots >= count).
// The slot mass falls out of the per-slot l with no extra pass. The
// scratch is written once and read once by the merge (~69 MB at the main
// path, ~20 us at 3.35 TB/s), the price of the split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rmem_qminor {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int G = 2;      // slots a block walks

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

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
  static constexpr int mass_off = red_off + 4 * BQ * 4;        // [BQ][G]
  static constexpr int bytes = mass_off + BQ * G * 4;
};

// One (query tile, dv slice, bh, slot group): part_m [NG, B*H, Lq],
// part_l [S, B*H, Lq], part_acc [NG, B, Lq, H*dv], all f32.
template <int D, int DVB>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ count_ptr,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int B, int H, int Lq, int S,
               int Lk, int dv, float scale) {
  using L = Smem<D, DVB>;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  float* sMass = reinterpret_cast<float*>(smem + L::mass_off);

  const int ngroups = (S + G - 1) / G;
  const int grp = blockIdx.z % ngroups, bh = blockIdx.z / ngroups;
  const int b = bh / H, h = bh % H;
  int count = *count_ptr;
  count = count < 0 ? 0 : (count > S ? S : count);
  const int s0 = grp * G;
  if (s0 >= count) return;            // the whole block: no slot to walk
  const int ns = count - s0 < G ? count - s0 : G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp & 3;   // 16-row tile
  const int kh = warp >> 2;  // key half (S phase) and column half (P V phase)
  const int q0 = blockIdx.x * BQ, c0 = blockIdx.y * DVB;
  const int HD = H * D, HDV = H * dv;
  const int cps = (Lk + BK - 1) / BK;
  const int nch = ns * cps;
  const int r0 = rt * 16 + g, r1 = r0 + 8;      // this thread's two rows
  const bool write_ml = blockIdx.y == 0 && kh == 0 && t == 0;

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
    const int s = s0 + ch / cps, key0 = (ch % cps) * BK;
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
  load_chunk(0, 0);
  cp_commit();

  if (write_ml)
    for (int j = 0; j < G; ++j) {
      sMass[r0 * G + j] = 0.f;
      sMass[r1 * G + j] = 0.f;
    }

  constexpr int NT = DVB / 16;      // n8 tiles of this warp's column half
  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  unsigned qf[D / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY;

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
    const int js = ch / cps, key0 = (ch % cps) * BK;   // slot in the group
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
    m0 = mn0;
    m1 = mn1;
    if (write_ml) {
      const float cs0 = red[2 * BQ + r0] + red[3 * BQ + r0];
      const float cs1 = red[2 * BQ + r1] + red[3 * BQ + r1];
      for (int j = 0; j < ns; ++j) {
        sMass[r0 * G + j] *= a0;
        sMass[r1 * G + j] *= a1;
      }
      sMass[r0 * G + js] += cs0;
      sMass[r1 * G + js] += cs1;
    }

    // ---- O = O * alpha + P V for rows rt, columns kh*DVB/2 .. ----
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

  // ---- the partial state, unnormalised ----
  const int qa = q0 + r0, qb = q0 + r1;
  float* acc = part_acc + (size_t)grp * B * Lq * HDV;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = c0 + kh * (DVB / 2) + nt * 8 + 2 * t;
    const size_t oa = ((size_t)b * Lq + qa) * HDV + h * dv + col;
    const size_t ob = ((size_t)b * Lq + qb) * HDV + h * dv + col;
    if (qa < Lq)
      *reinterpret_cast<float2*>(acc + oa) = make_float2(o[nt][0], o[nt][1]);
    if (qb < Lq)
      *reinterpret_cast<float2*>(acc + ob) = make_float2(o[nt][2], o[nt][3]);
  }
  // one dv slice writes m and the per-slot l; every slice computed the same
  // m from the same logits
  if (write_ml) {
    const size_t BH = (size_t)B * H;
    for (int j = 0; j < ns; ++j) {
      const size_t base = ((s0 + j) * BH + bh) * Lq;
      if (qa < Lq) part_l[base + qa] = sMass[r0 * G + j];
      if (qb < Lq) part_l[base + qb] = sMass[r1 * G + j];
    }
    const size_t base = (grp * BH + bh) * Lq;
    if (qa < Lq) part_m[base + qa] = m0;
    if (qb < Lq) part_m[base + qb] = m1;
  }
}

// One (row, 4 columns) per thread: merges the slot groups of the row.
// out [B, Lq, H*dv] bf16; rec [B*H, Lq, S] f32.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc,
               const int* __restrict__ count_ptr, bf16* __restrict__ out,
               float* __restrict__ rec, int B, int H, int Lq, int S,
               int dv) {
  const int HDV = H * dv;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * 4;
  if (col >= HDV) return;
  const int row = blockIdx.x;                    // b * Lq + qi
  const int b = row / Lq, qi = row % Lq;
  const int h = col / dv;
  const size_t BH = (size_t)B * H, bh = (size_t)b * H + h;
  int count = *count_ptr;
  count = count < 0 ? 0 : (count > S ? S : count);
  const int ng = (count + G - 1) / G;
  float M = -INFINITY;
  for (int gi = 0; gi < ng; ++gi)
    M = fmaxf(M, part_m[(gi * BH + bh) * Lq + qi]);
  float Lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int gi = 0; gi < ng; ++gi) {
    const float wg = __expf(part_m[(gi * BH + bh) * Lq + qi] - M);
    const int s1 = (gi + 1) * G < count ? (gi + 1) * G : count;
    float lg = 0.f;
    for (int s = gi * G; s < s1; ++s) lg += part_l[(s * BH + bh) * Lq + qi];
    Lsum += wg * lg;
    const float4 a = *reinterpret_cast<const float4*>(
        part_acc + (((size_t)gi * B + b) * Lq + qi) * HDV + col);
    acc.x += wg * a.x;
    acc.y += wg * a.y;
    acc.z += wg * a.z;
    acc.w += wg * a.w;
  }
  const float il = Lsum > 0.f ? 1.f / Lsum : 0.f;
  uint2 packed;
  packed.x = pack_bf16(acc.x * il, acc.y * il);
  packed.y = pack_bf16(acc.z * il, acc.w * il);
  *reinterpret_cast<uint2*>(out + (size_t)row * HDV + col) = packed;
  if (col % dv == 0) {              // one thread per head writes the mass
    for (int s = 0; s < S; ++s) {
      float r = 0.f;
      if (s < count)
        r = __expf(part_m[((s / G) * BH + bh) * Lq + qi] - M) *
            part_l[(s * BH + bh) * Lq + qi] * il;
      rec[(bh * Lq + qi) * S + s] = r;
    }
  }
}

template <int D, int DVB>
static int launch(const void* q, const void* k, const void* v,
                  const void* count, void* part_m, void* part_l,
                  void* part_acc, void* out, void* rec, int B, int H, int Lq,
                  int S, int Lk, int dv, float scale,
                  cudaStream_t stream) {
  constexpr int smem = Smem<D, DVB>::bytes;
  auto kern = partial_kernel<D, DVB>;
  static bool configured = false;     // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int ngroups = (S + G - 1) / G;
  dim3 grid((Lq + BQ - 1) / BQ, dv / DVB, B * H * ngroups);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)count,
      (float*)part_m, (float*)part_l, (float*)part_acc, B, H, Lq, S, Lk, dv,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2(B * Lq, (H * dv / 4 + kThreads - 1) / kThreads);
  combine_kernel<<<grid2, kThreads, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (const int*)count, (bf16*)out, (float*)rec, B, H, Lq, S, dv);
  return (int)cudaGetLastError();
}

}  // namespace rmem_qminor

// Returns the cudaError_t of the launches (0 on success); -1 for a head
// width other than 128 (the only one instantiated) or dv not a multiple of
// 256. With G = 2, part_m [ceil(S/2), B*H, Lq], part_l [S, B*H, Lq] and
// part_acc [ceil(S/2), B, Lq, H*dv] are f32 scratch.
extern "C" int rmem_bank_attention_qminor(
    const void* q, const void* k, const void* v, const void* count,
    void* part_m, void* part_l, void* part_acc, void* out, void* rec, int B,
    int H, int Lq, int S, int Lk, int dh, int dv, float scale,
    void* stream) {
  if (dh != 128 || dv % 256 != 0)
    return -1;
  return rmem_qminor::launch<128, 256>(
      q, k, v, count, part_m, part_l, part_acc, out, rec, B, H, Lq, S, Lk,
      dv, scale, (cudaStream_t)stream);
}

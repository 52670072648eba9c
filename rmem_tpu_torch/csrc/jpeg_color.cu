// libjpeg's last two decode stages on the card: the chroma planes' fancy
// upsampling and the YCbCr -> RGB conversion, from the planes nvJPEG
// decodes (NVJPEG_OUTPUT_YUV, the chroma at the image's own subsampling)
// into interleaved uint8 RGB.
//
// No TPU kernel: it stands where the JAX package decodes frames with
// cv2.imread on the host (rmem_tpu/data/eval_datasets.py:64), libjpeg with
// do_fancy_upsampling and the islow IDCT. nvJPEG's own RGB output
// upsamples chroma by replication, which put 4:2:0 frames ~6 dB further
// from their source than libjpeg's decode of the same file (34.9 against
// 41.3 dB PSNR on an H100, seeded 480 x 854 frames at quality 95). This
// kernel does libjpeg's integer arithmetic exactly, so on the same planes
// it gives libjpeg's bits; the plain version
// (data/jpeg.py:ycc_to_rgb_plain) is held to libjpeg on the CPU.
//
//   4:2:0 (h2v2, jdsample.c:h2v2_fancy_upsample): a column sum of the
//     chroma row and its nearer neighbour row, 3 * cur + near (the image's
//     edge rows replicated), then across columns (3 * sum + left + 8) >> 4
//     for even outputs and (3 * sum + right + 7) >> 4 for odd ones (edge
//     columns replicated);
//   4:4:4: no upsampling; grey: R = G = B = Y.
//   jdcolor.c:ycc_rgb_convert with SCALEBITS 16: R = Y + ((91881 * cr +
//     32768) >> 16), G = Y + ((-22554 * cb + 32768 - 46802 * cr) >> 16),
//     B = Y + ((116130 * cb + 32768) >> 16), cb and cr less 128, clamped to
//     0..255 (arithmetic shifts of negative values, as libjpeg's
//     RIGHT_SHIFT).
//
// Bound: bytes. It reads Y (H * W) and the two chroma planes once and
// writes 3 * H * W: 4.5 * 480 * 854 B = 1.8 MB a 4:2:0 frame, ~0.55 us at
// 3.35 TB/s; a launch costs more than that. One thread an output pixel
// pair (two columns of one row, which share their chroma column), a row of
// pairs across the block's x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace rmem_jpeg {

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__device__ __forceinline__ void store_rgb(uint8_t* out, int y, int cb,
                                          int cr) {
  cb -= 128;
  cr -= 128;
  out[0] = clamp255(y + ((91881 * cr + 32768) >> 16));
  out[1] = clamp255(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  out[2] = clamp255(y + ((116130 * cb + 32768) >> 16));
}

// mode: 0 grey, 1 4:4:4, 2 4:2:0. Planes pitched; rgb [H, W, 3] dense.
__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ yp, int ypitch,
                                  const uint8_t* __restrict__ cbp,
                                  const uint8_t* __restrict__ crp,
                                  int cpitch, int ch, int cw,
                                  uint8_t* __restrict__ rgb, int H, int W,
                                  int mode) {
  const int row = blockIdx.y;
  const int x0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (row >= H || x0 >= W) return;
  const uint8_t* yrow = yp + (size_t)row * ypitch;
  uint8_t* orow = rgb + (size_t)row * W * 3;
  const int n = x0 + 1 < W ? 2 : 1;
  if (mode == 0) {
    for (int k = 0; k < n; ++k) {
      const uint8_t v = yrow[x0 + k];
      orow[3 * (x0 + k)] = orow[3 * (x0 + k) + 1] = orow[3 * (x0 + k) + 2] = v;
    }
    return;
  }
  if (mode == 1) {
    for (int k = 0; k < n; ++k) {
      const size_t c = (size_t)row * cpitch + x0 + k;
      store_rgb(orow + 3 * (x0 + k), yrow[x0 + k], cbp[c], crp[c]);
    }
    return;
  }
  // 4:2:0: chroma row i, its nearer neighbour above (even rows) or below
  const int i = row >> 1;
  const int near = (row & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
  const int j = x0 >> 1;
  const int jl = max(j - 1, 0), jr = min(j + 1, cw - 1);
  const uint8_t* planes[2] = {cbp, crp};
  int up[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint8_t* cur = planes[p] + (size_t)i * cpitch;
    const uint8_t* nb = planes[p] + (size_t)near * cpitch;
    const int s = 3 * cur[j] + nb[j];
    const int sl = 3 * cur[jl] + nb[jl];
    const int sr = 3 * cur[jr] + nb[jr];
    up[p][0] = (3 * s + sl + 8) >> 4;
    up[p][1] = (3 * s + sr + 7) >> 4;
  }
  for (int k = 0; k < n; ++k)
    store_rgb(orow + 3 * (x0 + k), yrow[x0 + k], up[0][k], up[1][k]);
}

}  // namespace rmem_jpeg

// y [H, W] (row pitch ypitch), cb and cr [ch, cw] (row pitch cpitch; for
// grey unused), rgb [H, W, 3]; mode 0 grey, 1 4:4:4 (ch = H, cw = W), 2
// 4:2:0 (ch = ceil(H / 2), cw = ceil(W / 2)). Returns the launch's
// cudaError_t (0 on success), -1 on a bad shape or mode.
extern "C" int rmem_jpeg_ycc_to_rgb(const void* y, int ypitch, const void* cb,
                                    const void* cr, int cpitch, int ch,
                                    int cw, void* rgb, int H, int W, int mode,
                                    void* stream) {
  using namespace rmem_jpeg;
  if (H < 1 || W < 1 || ypitch < W || mode < 0 || mode > 2) return -1;
  if (mode == 1 && (ch != H || cw != W || cpitch < W)) return -1;
  if (mode == 2 && (ch != (H + 1) / 2 || cw != (W + 1) / 2 || cpitch < cw))
    return -1;
  const int threads = 128;
  const int pairs = (W + 1) / 2;
  dim3 grid((pairs + threads - 1) / threads, H);
  ycc_to_rgb_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, ypitch, (const uint8_t*)cb, (const uint8_t*)cr,
      cpitch, ch, cw, (uint8_t*)rgb, H, W, mode);
  return (int)cudaGetLastError();
}

"""libjpeg's chroma upsampling and YCbCr -> RGB conversion of a decoded
JPEG's planes (the frames' last decode stage on the card).

`ycc_to_rgb` launches the CUDA kernel `csrc/jpeg_color.cu` for planes on
the card and runs `ycc_to_rgb_plain` for planes on the CPU. Both do
libjpeg's integer arithmetic (jdsample.c:h2v2_fancy_upsample,
jdcolor.c:ycc_rgb_convert), so from the same planes they give libjpeg's
bits. There is no TPU kernel here: the JAX package decodes frames with
cv2 on the host (rmem_tpu/data/eval_datasets.py:64).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.kernels.launches import launched
from rmem_tpu_torch.utils.trace import spanned

_P = ctypes.c_void_p
_I = ctypes.c_int
# the kernel's modes
GREY, YCC444, YCC420 = 0, 1, 2
# jdcolor.c's FIX(x) = x * 2^16 rounded, for SCALEBITS 16
_CR_R, _CB_B, _CR_G, _CB_G = 91881, 116130, 46802, 22554


def _shifted(x: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """x moved one place along dim (step -1: each entry takes its
    predecessor), the edge entry replicated."""
    n = x.shape[dim]
    if step < 0:
        idx = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.arange(n - 1)])
    else:
        idx = torch.cat([torch.arange(1, n), torch.tensor([n - 1])])
    return x.index_select(dim, idx.to(x.device))


def upsample_h2v2_plain(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """libjpeg's h2v2 fancy upsampling: uint8 [ch, cw] -> int32 [h, w]
    (the [2ch, 2cw] result cropped)."""
    c = c.to(torch.int32)
    rows = torch.stack([3 * c + _shifted(c, 0, -1), 3 * c + _shifted(c, 0, 1)],
                       1).reshape(-1, c.shape[1])        # column sums
    even = (3 * rows + _shifted(rows, 1, -1) + 8) >> 4
    odd = (3 * rows + _shifted(rows, 1, 1) + 7) >> 4
    return torch.stack([even, odd], 2).reshape(rows.shape[0], -1)[:h, :w]


def ycc_to_rgb_plain(y: torch.Tensor, cb: Optional[torch.Tensor],
                     cr: Optional[torch.Tensor], mode: int) -> torch.Tensor:
    """Planes (uint8 y [H, W]; cb, cr [H, W] for 4:4:4, [ceil(H/2),
    ceil(W/2)] for 4:2:0, None for grey) -> uint8 [H, W, 3] RGB."""
    h, w = y.shape
    if mode == GREY:
        return y[..., None].expand(h, w, 3).contiguous()
    if mode == YCC420:
        cb, cr = upsample_h2v2_plain(cb, h, w), upsample_h2v2_plain(cr, h, w)
    elif mode != YCC444:
        raise ValueError(f"ycc_to_rgb: mode {mode}")
    y, cb, cr = y.to(torch.int32), cb.to(torch.int32) - 128, \
        cr.to(torch.int32) - 128
    r = y + ((_CR_R * cr + 32768) >> 16)
    g = y + ((-_CB_G * cb + 32768 - _CR_G * cr) >> 16)
    b = y + ((_CB_B * cb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("jpeg_color").rmem_jpeg_ycc_to_rgb
    fn.argtypes = [_P, _I, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@spanned("rmem.kernel.ycc_to_rgb")
def ycc_to_rgb(y: torch.Tensor, cb: Optional[torch.Tensor],
               cr: Optional[torch.Tensor], mode: int) -> torch.Tensor:
    """As ycc_to_rgb_plain. On the card the planes may be row-pitched
    views (each row contiguous, cb and cr with one pitch); the result is
    written on the current stream."""
    if not y.is_cuda:
        return ycc_to_rgb_plain(y, cb, cr, mode)
    h, w = y.shape
    if mode == GREY:
        cb = cr = y
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dtype != torch.uint8 or t.device != y.device or t.stride(1) != 1:
            raise ValueError(f"ycc_to_rgb: {name} must be uint8 rows on "
                             f"{y.device}")
    if cb.shape != cr.shape or cb.stride(0) != cr.stride(0):
        raise ValueError(f"ycc_to_rgb: cb {tuple(cb.shape)}, cr "
                         f"{tuple(cr.shape)} differ")
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    err = _entry()(y.data_ptr(), y.stride(0), cb.data_ptr(), cr.data_ptr(),
                   cb.stride(0), cb.shape[0], cb.shape[1], out.data_ptr(),
                   h, w, mode, torch.cuda.current_stream(y.device).cuda_stream)
    build.check(err, "ycc_to_rgb")
    ycc_to_rgb.launches += launched(ycc_to_rgb)
    return out


ycc_to_rgb.launches = 0

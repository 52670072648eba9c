"""ResNet stem (kernel K6): maxpool3x3/s2/pad1(relu(conv7x7/s2/pad3(x) *
scale + bias)) for 3-channel images, NHWC in and out.

`stem` launches the CUDA kernel `csrc/stem.cu` for tensors on the card and
runs `stem_plain` for tensors on the CPU. It replaces
rmem_tpu/kernels/stem.py:pallas_stem (the forward of pallas_stem_trainable).

`stem_trainable` (K7) is its differentiable form, the counterpart of
pallas_stem_trainable: on the card the forward is the kernel's training
instantiation, which also writes the bf16 conv map before the affine and
each pooled value's argmax (`stem_saved_plain` is its plain version), and
the backward is `stem_bwd` on those (the VJP of xla_stem_chain, in bf16,
without recomputing the conv or the pool); on the CPU it is autograd
through the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.ops.layers import max_pool_3x3_s2
from rmem_tpu_torch.utils.trace import spanned

_P = ctypes.c_void_p
_I = ctypes.c_int


def stem_conv_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The conv map the stem pools, in the dtype of `weight`: x rounded to
    that dtype, the conv summed in f32 and rounded. x [B, H, W, 3]; weight
    [64, 3, 7, 7]; returns [B, ho, wo, 64] (NHWC view)."""
    dt = weight.dtype
    xc = x.permute(0, 3, 1, 2).to(dt).float()
    y = F.conv2d(xc, weight.float(), stride=2, padding=3).to(dt)
    return y.permute(0, 2, 3, 1)


def stem_plain(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the dtype of `weight`
    (bf16 in the engine, as the JAX chain xla_stem_chain): the conv map of
    `stem_conv_plain`, then the affine and relu in that dtype, then torch's
    max pool (padding never wins).
    x [B, H, W, 3]; weight [64, 3, 7, 7]; returns [B, ph, pw, 64]."""
    dt = weight.dtype
    y = torch.relu(stem_conv_plain(x, weight) * scale.to(dt)
                   + bias.to(dt))
    return max_pool_3x3_s2(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def stem_saved_plain(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's forward in plain PyTorch: what the kernel's training
    instantiation writes. Returns (the output [B, ph, pw, 64], the conv map
    [B, ho, wo, 64], each output's argmax in the conv grid [B, ph, pw, 64]
    int64, as torch's max pool returns it), NHWC views."""
    dt = weight.dtype
    conv = stem_conv_plain(x, weight)
    y = torch.relu(conv.permute(0, 3, 1, 2) * scale.to(dt)[:, None, None]
                   + bias.to(dt)[:, None, None])
    out, idx = F.max_pool2d(y, 3, 2, 1, return_indices=True)
    return out.permute(0, 2, 3, 1), conv, idx.permute(0, 2, 3, 1)


def stem_bwd(x: torch.Tensor, conv: torch.Tensor, argmax: torch.Tensor,
             out: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
             g: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's backward from the forward's saved state, in plain PyTorch in the
    dtype of `conv` (bf16 on the card; the VJP of xla_stem_chain): the
    relu's backward at each pooled value (its argmax holds a positive value
    exactly where the output is positive), dbias = sum(du), the max pool's
    backward through the saved argmax, dscale = sum(du * conv), and the
    weight's gradient by the library's weight gradient of the conv. The
    image takes none. x [B, H, W, 3]; conv [B, ho, wo, 64]; argmax, out and
    g [B, ph, pw, 64]. Returns (dweight [64, 3, 7, 7], dscale [64], dbias
    [64])."""
    dt = conv.dtype
    z = conv.permute(0, 3, 1, 2)                 # NCHW view, channels-last
    du = torch.ops.aten.threshold_backward(g.to(dt), out, 0)
    dbias = du.sum((0, 1, 2))
    du = torch.ops.aten.max_pool2d_with_indices_backward(
        du.permute(0, 3, 1, 2), z, [3, 3], [2, 2], [1, 1], [1, 1], False,
        argmax.permute(0, 3, 1, 2))
    dscale = (du * z).sum((0, 2, 3))
    dweight = torch.ops.aten.convolution_backward(
        du * scale.to(dt)[:, None, None], x.to(dt).permute(0, 3, 1, 2),
        weight.to(dt), None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]
    return dweight, dscale, dbias


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"stem: {msg}")


@spanned("rmem.kernel.stem")
def stem(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
         bias: torch.Tensor, save: bool = False):
    """x [B, H, W, 3] (f32 on the card); weight [64, 3, 7, 7]; scale, bias
    [64]. Returns [B, ph, pw, 64] in the weight's dtype (bf16 on the card);
    with `save`, `stem_saved_plain`'s three tensors from the kernel's
    training instantiation. While a graph is traced, the call (without
    `save`) is the custom op rmem::stem (kernels/ops.py)."""
    if not save and torch.compiler.is_compiling():
        from rmem_tpu_torch.kernels import ops  # noqa: F401 (registers)
        return torch.ops.rmem.stem(x, weight, scale, bias)
    if not x.is_cuda:
        return (stem_saved_plain if save else stem_plain)(x, weight, scale,
                                                          bias)
    b, h, w, c = x.shape
    _check(c == 3, f"{c} input channels (takes 3)")
    _check(x.dtype == torch.float32 and x.is_contiguous(),
           "x must be contiguous f32 NHWC")
    _check(weight.shape == (64, 3, 7, 7) and weight.dtype == torch.bfloat16
           and weight.is_contiguous(), "weight must be contiguous bf16 "
           "[64, 3, 7, 7]")
    for name, t in (("x", x), ("weight", weight), ("scale", scale),
                    ("bias", bias)):
        _check(t.device == x.device, f"{name} not on {x.device}")
    scale = scale.to(torch.bfloat16).contiguous()
    bias = bias.to(torch.bfloat16).contiguous()
    _check(scale.shape == (64,) and bias.shape == (64,), "scale/bias [64]")
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    ph, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    fn = build.load("stem").rmem_stem
    fn.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    fn.restype = _I
    out = torch.empty((b, ph, pw, 64), dtype=torch.bfloat16, device=x.device)
    conv = argmax = None
    if save:
        conv = torch.empty((b, ho, wo, 64), dtype=torch.bfloat16,
                           device=x.device)
        argmax = torch.empty((b, ph, pw, 64), dtype=torch.int64,
                             device=x.device)
    err = fn(x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), out.data_ptr(),
             None if conv is None else conv.data_ptr(),
             None if argmax is None else argmax.data_ptr(), b, h, w,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "stem")
    stem.launches += 1
    return (out, conv, argmax) if save else out


stem.launches = 0


class _Stem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, scale, bias):
        out, conv, argmax = stem(x, weight, scale, bias, save=True)
        ctx.save_for_backward(x, conv, argmax, out, weight, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = stem_bwd(*ctx.saved_tensors,
                         g.to(torch.bfloat16).contiguous())
        return (None, *(d if need else None for d, need in
                        zip(grads, ctx.needs_input_grad[1:])))


def stem_trainable(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Differentiable `stem`. On the card the weight, scale and bias are
    taken in bf16, the kernel's type (their gradients flow back to the f32
    parameters through the cast), and the output is given back in f32
    where no autocast runs (f32 compute)."""
    if not x.is_cuda:
        return stem_plain(x, weight, scale, bias)
    bf = torch.bfloat16
    out = _Stem.apply(x.float().contiguous(), weight.to(bf).contiguous(),
                      scale.to(bf).contiguous(), bias.to(bf).contiguous())
    if not torch.is_autocast_enabled(x.device.type):
        out = out.float()
    return out

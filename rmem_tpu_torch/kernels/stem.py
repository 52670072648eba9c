"""ResNet stem (kernel K6): maxpool3x3/s2/pad1(relu(conv7x7/s2/pad3(x) *
scale + bias)) for 3-channel images, NHWC in and out.

`stem` launches the CUDA kernel `csrc/stem.cu` for tensors on the card and
runs `stem_plain` for tensors on the CPU. It replaces
rmem_tpu/kernels/stem.py:pallas_stem (the forward of pallas_stem_trainable).

`stem_trainable` (K7) is its differentiable form, the counterpart of
pallas_stem_trainable: on the card the forward is the kernel and the
backward is autograd of `stem_plain` in bf16 at the saved inputs (JAX's
VJP of xla_stem_chain); on the CPU it is autograd through the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rmem_tpu_torch.kernels import build, plain_vjp
from rmem_tpu_torch.ops.layers import max_pool_3x3_s2

_P = ctypes.c_void_p
_I = ctypes.c_int


def stem_plain(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the dtype of `weight`
    (bf16 in the engine, as the JAX chain xla_stem_chain): x rounded to that
    dtype, the conv summed in f32 and rounded, then the affine and relu in
    that dtype, then torch's max pool (padding never wins).
    x [B, H, W, 3]; weight [64, 3, 7, 7]; returns [B, ph, pw, 64]."""
    dt = weight.dtype
    xc = x.permute(0, 3, 1, 2).to(dt).float()
    y = F.conv2d(xc, weight.float(), stride=2, padding=3).to(dt)
    y = y * scale.to(dt)[:, None, None]
    y = torch.relu(y + bias.to(dt)[:, None, None])
    return max_pool_3x3_s2(y).permute(0, 2, 3, 1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"stem: {msg}")


def stem(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
         bias: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, 3] (f32 on the card); weight [64, 3, 7, 7]; scale, bias
    [64]. Returns [B, ph, pw, 64] in the weight's dtype (bf16 on the
    card)."""
    if not x.is_cuda:
        return stem_plain(x, weight, scale, bias)
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
    fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    fn.restype = _I
    out = torch.empty((b, ph, pw, 64), dtype=torch.bfloat16, device=x.device)
    err = fn(x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
             bias.data_ptr(), out.data_ptr(), b, h, w,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "stem")
    stem.launches += 1
    return out


stem.launches = 0


class _Stem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, scale, bias):
        ctx.save_for_backward(x, weight, scale, bias)
        return stem(x, weight, scale, bias)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(stem_plain, ctx.saved_tensors, ctx.needs_input_grad,
                         g.to(torch.bfloat16))


def stem_trainable(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Differentiable `stem`. On the card the weight, scale and bias are
    taken in bf16, the kernel's type (their gradients flow back to the f32
    parameters through the cast)."""
    if not x.is_cuda:
        return stem_plain(x, weight, scale, bias)
    bf = torch.bfloat16
    return _Stem.apply(x.float().contiguous(), weight.to(bf).contiguous(),
                       scale.to(bf).contiguous(), bias.to(bf).contiguous())

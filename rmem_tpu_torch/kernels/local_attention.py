"""Local window attention (kernel K4): each query attends to the 15 x 15
window of short-term keys around it, plus a learned relative bias.

`local_attention` launches the CUDA kernel `csrc/local_attention.cu` for
tensors on the card and runs `local_attention_plain` for tensors on the
CPU. It replaces rmem_tpu/kernels/local_attention.py:pallas_local_attention.

`local_attention_trainable` (K5) is its differentiable form, the
counterpart of pallas_local_attention_trainable: on the card the forward is
the kernel and the backward is autograd of the plain version at the saved
inputs; on the CPU it is autograd through the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rmem_tpu_torch.kernels import build, plain_vjp
from rmem_tpu_torch.ops.attention import dense_local_attention

_P = ctypes.c_void_p
_I = ctypes.c_int


def local_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rel_emb: torch.Tensor, size_2d: Tuple[int, int],
                          num_heads: int, max_dis: int,
                          scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in f32."""
    out = dense_local_attention(q.float(), k.float(), v.float(),
                                rel_emb.float(), size_2d, num_heads,
                                max_dis=max_dis, scale=scale)
    return out.to(q.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"local_attention: {msg}")


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rel_emb: torch.Tensor, size_2d: Tuple[int, int],
                    num_heads: int, max_dis: int,
                    scale: float) -> torch.Tensor:
    """q, k [B, HW, h*dh]; v [B, HW, h*dv]; rel_emb [B, HW, h*(2m+1)^2] made
    from the unscaled q. Returns [B, HW, h*dv]. On the card: bf16, one head
    of 128, dv a multiple of 128, all contiguous."""
    if not q.is_cuda:
        return local_attention_plain(q, k, v, rel_emb, size_2d, num_heads,
                                     max_dis, scale)
    h2d, w2d = size_2d
    b, hw, chd = q.shape
    dh = chd // num_heads
    dv = v.shape[-1] // num_heads
    win2 = (2 * max_dis + 1) ** 2
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_emb", rel_emb)):
        _check(t.is_cuda and t.device == q.device, f"{name} not on {q.device}")
        _check(t.dtype == torch.bfloat16, f"{name} must be bf16")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _check(hw == h2d * w2d, f"{hw} tokens for a {h2d}x{w2d} grid")
    _check(k.shape == q.shape, f"k shape {tuple(k.shape)}")
    _check(v.shape[:2] == (b, hw), f"v shape {tuple(v.shape)}")
    _check(rel_emb.shape == (b, hw, num_heads * win2),
           f"rel_emb shape {tuple(rel_emb.shape)}")
    _check(num_heads == 1 and dh == 128,
           f"{num_heads} heads of width {dh} (the kernel is held to its "
           "plain version for one head of 128, r50_deaotl's)")
    _check(dv % 128 == 0, f"value width {dv} (multiple of 128)")
    fn = build.load("local_attention").rmem_local_attention
    fn.argtypes = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    out = torch.empty((b, hw, num_heads * dv), dtype=v.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_emb.data_ptr(),
             out.data_ptr(), b, h2d, w2d, num_heads, dh, dv, max_dis,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "local_attention")
    local_attention.launches += 1
    return out


local_attention.launches = 0


class _LocalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_emb, size_2d, num_heads, max_dis, scale):
        ctx.save_for_backward(q, k, v, rel_emb)
        ctx.args = (size_2d, num_heads, max_dis, scale)
        return local_attention(q, k, v, rel_emb, size_2d, num_heads, max_dis,
                               scale)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(
            lambda *x: local_attention_plain(*x, *ctx.args),
            ctx.saved_tensors, ctx.needs_input_grad[:4], g)
        return (*grads, None, None, None, None)


def local_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, rel_emb: torch.Tensor,
                              size_2d: Tuple[int, int], num_heads: int,
                              max_dis: int, scale: float) -> torch.Tensor:
    """Differentiable `local_attention`. On the card the inputs are taken in
    bf16, the kernel's type."""
    if not q.is_cuda:
        return local_attention_plain(q, k, v, rel_emb, size_2d, num_heads,
                                     max_dis, scale)
    bf = torch.bfloat16
    return _LocalAttention.apply(
        q.to(bf).contiguous(), k.to(bf).contiguous(), v.to(bf).contiguous(),
        rel_emb.to(bf).contiguous(), size_2d, num_heads, max_dis, scale)

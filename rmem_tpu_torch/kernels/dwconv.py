"""Gated depthwise 5x5 conv (kernel K8): dwconv5x5(x * gate), zero-padded,
on the [B, H*W, C] sequence layout of the GPM's gated tails.

`gated_dwconv` launches the CUDA kernel `csrc/gated_dwconv.cu` (bands of
rows streamed through a ring in shared memory, the sums of five output
rows in registers) for tensors on the card and runs `gated_dwconv_plain`
for tensors on the CPU. It replaces
rmem_tpu/kernels/dwconv.py:pallas_gated_dwconv. Inference only: it has no
backward, as the TPU kernel has none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.kernels.launches import launched
from rmem_tpu_torch.utils.trace import spanned

_P = ctypes.c_void_p
_I = ctypes.c_int


def gated_dwconv_plain(x: torch.Tensor, gate: torch.Tensor,
                       weight: torch.Tensor,
                       size_2d: Tuple[int, int]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in x's dtype as the JAX
    kernel computes it: x * gate rounded to that dtype, each tap's product
    with its weight rounded to it, the 25 taps summed in f32 in the order
    dy then dx, the sum cast back. x, gate [B, H*W, C]; weight [C, 1, 5, 5]
    (the depthwise conv's); returns [B, H*W, C]."""
    b, hw, c = x.shape
    h, w = size_2d
    dt = x.dtype
    xg = (x * gate.to(dt)).reshape(b, h, w, c)
    xp = F.pad(xg, (0, 0, 2, 2, 2, 2))
    k = weight.to(dt).reshape(c, 25)
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    for dy in range(5):
        for dx in range(5):
            out += (xp[:, dy:dy + h, dx:dx + w, :]
                    * k[:, dy * 5 + dx]).float()
    return out.to(dt).reshape(b, hw, c)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gated_dwconv: {msg}")


@functools.lru_cache(maxsize=None)
def _entry():
    """csrc/gated_dwconv.cu's C entry and the channels a block takes."""
    lib = build.load("gated_dwconv")
    lib.rmem_gated_dwconv_channels.argtypes = []
    lib.rmem_gated_dwconv_channels.restype = _I
    fn = lib.rmem_gated_dwconv
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    fn.restype = _I
    return fn, lib.rmem_gated_dwconv_channels()


@spanned("rmem.kernel.gated_dwconv")
def gated_dwconv(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                 size_2d: Tuple[int, int]) -> torch.Tensor:
    """x, gate [B, H*W, C]; weight [C, 1, 5, 5]; size_2d (H, W). On the
    card: bf16, contiguous, 16-byte aligned, C a multiple of the channels a
    block takes (32). While a graph is traced, the call is the custom op
    rmem::gated_dwconv (kernels/ops.py)."""
    if torch.compiler.is_compiling():
        from rmem_tpu_torch.kernels import ops  # noqa: F401 (registers)
        return torch.ops.rmem.gated_dwconv(x, gate, weight, list(size_2d))
    if not x.is_cuda:
        return gated_dwconv_plain(x, gate, weight, size_2d)
    b, hw, c = x.shape
    h, w = size_2d
    _check(h * w == hw, f"grid {h}x{w} for {hw} tokens")
    _check(gate.shape == x.shape, f"gate {tuple(gate.shape)}, x "
           f"{tuple(x.shape)}")
    _check(weight.shape == (c, 1, 5, 5), f"weight {tuple(weight.shape)}")
    for name, t in (("x", x), ("gate", gate), ("weight", weight)):
        _check(t.device == x.device, f"{name} not on {x.device}")
        _check(t.dtype == torch.bfloat16, f"{name} must be bf16")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    fn, block_channels = _entry()
    _check(c % block_channels == 0,
           f"{c} channels (a multiple of {block_channels})")
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), gate.data_ptr(), weight.data_ptr(), out.data_ptr(),
             b, h, w, c, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "gated_dwconv")
    gated_dwconv.launches += launched(gated_dwconv)
    return out


gated_dwconv.launches = 0

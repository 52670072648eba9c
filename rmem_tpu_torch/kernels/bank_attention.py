"""Bank attention for inference (kernel K1): the frame's queries into the
valid slots of the long-term bank, with each slot's softmax mass.

`bank_attention_infer` launches the CUDA kernel `csrc/bank_attention.cu`
for tensors on the card and runs `bank_attention_plain` for tensors on the
CPU. It replaces rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_infer
and the forward of pallas_bank_attention (the reference frame's S = 1
self-memory call).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.ops.attention import bank_attention

_P = ctypes.c_void_p
_I = ctypes.c_int


def bank_attention_plain(q: torch.Tensor, bank_k: torch.Tensor,
                         bank_v: torch.Tensor, count: torch.Tensor,
                         num_heads: int, scale: float,
                         true_lk: Optional[int] = None,
                         qbias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, computed in f32: slots
    >= count and keys >= true_lk masked, qbias [B, h, Lq, S] added to the
    scaled logits. Returns (out [B, Lq, h*dv] in q's dtype, rec [B, Lq, S]
    f32, the head-mean slot mass)."""
    mask = torch.arange(bank_k.shape[0], device=count.device) < count
    out, rec = bank_attention(
        q.float(), bank_k.float(), bank_v.float(), mask, num_heads,
        need_record=True, scale=scale, true_lk=true_lk,
        logit_bias=None if qbias is None else qbias.float())
    return out.to(q.dtype), rec


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bank_attention_infer: {msg}")


def bank_attention_infer(q: torch.Tensor, bank_k: torch.Tensor,
                         bank_v: torch.Tensor, count: torch.Tensor,
                         num_heads: int, scale: float,
                         true_lk: Optional[int] = None,
                         qbias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Lq, h*dh]; bank_k [S, B, Lk, h*dh]; bank_v [S, B, Lk, h*dv];
    count: int32 scalar tensor of valid slots, read on the device; qbias
    [B, h, Lq, S] f32 or None. On the card: bf16 q/k/v, one head of 128,
    dv a multiple of 256, all contiguous."""
    if not q.is_cuda:
        return bank_attention_plain(q, bank_k, bank_v, count, num_heads,
                                    scale, true_lk, qbias)
    s, b, lk, ck = bank_k.shape
    lq = q.shape[1]
    dh = ck // num_heads
    dv = bank_v.shape[-1] // num_heads
    true_lk = lk if true_lk is None else true_lk
    for name, t in (("q", q), ("bank_k", bank_k), ("bank_v", bank_v)):
        _check(t.is_cuda and t.device == q.device, f"{name} not on {q.device}")
        _check(t.dtype == torch.bfloat16, f"{name} must be bf16")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _check(q.shape == (b, lq, num_heads * dh), f"q shape {tuple(q.shape)}")
    _check(bank_v.shape[:3] == (s, b, lk), f"bank_v shape {tuple(bank_v.shape)}")
    _check(num_heads == 1 and dh == 128,
           f"{num_heads} heads of width {dh} (the kernel is held to its "
           "plain version for one head of 128, r50_deaotl's)")
    _check(dv % 256 == 0, f"value width {dv} (multiple of 256)")
    _check(0 < true_lk <= lk, f"true_lk {true_lk} for {lk} keys")
    _check(s <= 16, f"{s} slots (kernel takes up to 16)")
    _check(count.device == q.device and count.dtype == torch.int32
           and count.numel() == 1, "count must be an int32 scalar on q's card")
    if qbias is not None:
        _check(qbias.device == q.device and qbias.dtype == torch.float32
               and qbias.is_contiguous()
               and qbias.shape == (b, num_heads, lq, s),
               "qbias must be contiguous f32 [B, h, Lq, S]")
    fn = build.load("bank_attention").rmem_bank_attention
    fn.argtypes = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P]
    fn.restype = _I
    out = torch.empty((b, lq, num_heads * dv), dtype=q.dtype, device=q.device)
    rec = torch.empty((b * num_heads, lq, s), dtype=torch.float32,
                      device=q.device)
    err = fn(q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
             None if qbias is None else qbias.data_ptr(), count.data_ptr(),
             out.data_ptr(), rec.data_ptr(), b, num_heads, lq, s, lk,
             true_lk, dh, dv, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention")
    bank_attention_infer.launches += 1
    rec = rec.view(b, num_heads, lq, s)
    return out, (rec[:, 0] if num_heads == 1 else rec.mean(dim=1))


bank_attention_infer.launches = 0

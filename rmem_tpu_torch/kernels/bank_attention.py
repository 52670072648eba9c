"""Bank attention: the frame's queries into the valid slots of the
long-term bank, with each slot's softmax mass.

Inference (kernel K1): `bank_attention_infer` launches the CUDA kernel
`csrc/bank_attention.cu` for tensors on the card and runs
`bank_attention_plain` for tensors on the CPU. It replaces
rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_infer and the
forward of pallas_bank_attention (the reference frame's S = 1 self-memory
call).

Inference with the slots split among blocks (kernel K3, opt-in):
`bank_attention_qminor` launches `csrc/bank_attention_qminor.cu` for
tensors on the card and runs `bank_attention_qminor_plain` for tensors on
the CPU. K1's function with neither key padding nor a logit bias (the
slot PE arrives added to the keys); it replaces
rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_qminor.

Training: `bank_attention_train` is differentiable. On the card it is an
autograd Function whose forward is K1 with the per-row log-sum-exp output
(`bank_attention_lse`) and whose backward is kernel K2
(`csrc/bank_attention_bwd.cu`: `bank_attention_bwd_ds`, `_dq` and `_dkv`);
it replaces pallas_bank_attention and its custom VJP. On the CPU it is
autograd through `bank_attention_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.ops.attention import bank_attention

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
BLOCK_K = 64      # key tile of the backward kernels: the scratch pads Lk to it
# K3: slots walked by one block, fixed in csrc/bank_attention_qminor.cu. 2
# gives 27 x 4 x 5 = 540 blocks and 34.3 MB of partial scratch at the main
# path; it timed fastest of 1, 2, 3 and 9 on the H100 (PERF.md)
SLOTS_PER_BLOCK = 2


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
        raise ValueError(f"bank_attention: {msg}")


def _check_bf16(ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Each tensor bf16, contiguous, aligned, on ref's card."""
    for name, t in tensors.items():
        _check(t.is_cuda and t.device == ref.device,
               f"{name} not on {ref.device}")
        _check(t.dtype == torch.bfloat16, f"{name} must be bf16")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _check_count(count: torch.Tensor, q: torch.Tensor) -> None:
    _check(count.device == q.device and count.dtype == torch.int32
           and count.numel() == 1, "count must be an int32 scalar on q's card")


def _forward(q, bank_k, bank_v, count, num_heads, scale, true_lk, qbias,
             train: bool):
    """Launch K1; returns (out, rec [B*h, Lq, S], lse [B*h, Lq] or None).
    With `train` the output is f32 and lse is written."""
    s, b, lk, ck = bank_k.shape
    lq = q.shape[1]
    dh = ck // num_heads
    dv = bank_v.shape[-1] // num_heads
    true_lk = lk if true_lk is None else true_lk
    _check_bf16(q, q=q, bank_k=bank_k, bank_v=bank_v)
    _check(q.shape == (b, lq, num_heads * dh), f"q shape {tuple(q.shape)}")
    _check(bank_v.shape[:3] == (s, b, lk), f"bank_v shape {tuple(bank_v.shape)}")
    _check(num_heads == 1 and dh == 128,
           f"{num_heads} heads of width {dh} (the kernel is held to its "
           "plain version for one head of 128, r50_deaotl's)")
    _check(dv % 256 == 0, f"value width {dv} (multiple of 256)")
    _check(0 < true_lk <= lk, f"true_lk {true_lk} for {lk} keys")
    _check(s <= 16, f"{s} slots (kernel takes up to 16)")
    _check_count(count, q)
    if qbias is not None:
        _check(qbias.device == q.device and qbias.dtype == torch.float32
               and qbias.is_contiguous()
               and qbias.shape == (b, num_heads, lq, s),
               "qbias must be contiguous f32 [B, h, Lq, S]")
    fn = build.load("bank_attention").rmem_bank_attention
    fn.argtypes = [_P] * 9 + [_I] * 8 + [_F, _P]
    fn.restype = _I
    out = torch.empty((b, lq, num_heads * dv), device=q.device,
                      dtype=torch.float32 if train else q.dtype)
    rec = torch.empty((b * num_heads, lq, s), dtype=torch.float32,
                      device=q.device)
    lse = (torch.empty((b * num_heads, lq), dtype=torch.float32,
                       device=q.device) if train else None)
    err = fn(q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
             None if qbias is None else qbias.data_ptr(), count.data_ptr(),
             None if train else out.data_ptr(), rec.data_ptr(),
             lse.data_ptr() if train else None,
             out.data_ptr() if train else None, b, num_heads, lq, s, lk,
             true_lk, dh, dv, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention")
    return out, rec, lse


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
    out, rec, _ = _forward(q, bank_k, bank_v, count, num_heads, scale,
                           true_lk, qbias, train=False)
    bank_attention_infer.launches += 1
    rec = rec.view(q.shape[0], num_heads, q.shape[1], -1)
    return out, (rec[:, 0] if num_heads == 1 else rec.mean(dim=1))


bank_attention_infer.launches = 0


def bank_attention_qminor_plain(q: torch.Tensor, bank_k: torch.Tensor,
                                bank_v: torch.Tensor, count: torch.Tensor,
                                num_heads: int, scale: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: `bank_attention_plain` with every
    key valid and no bias."""
    return bank_attention_plain(q, bank_k, bank_v, count, num_heads, scale)


def bank_attention_qminor(q: torch.Tensor, bank_k: torch.Tensor,
                          bank_v: torch.Tensor, count: torch.Tensor,
                          num_heads: int, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Lq, h*dh]; bank_k [S, B, Lk, h*dh]; bank_v [S, B, Lk, h*dv];
    count: int32 scalar tensor of valid slots, read on the device. Returns
    (out [B, Lq, h*dv] in q's dtype, rec [B, Lq, S] f32). On the card: bf16
    q/k/v, one head of 128, dv a multiple of 256, all contiguous; each block
    walks SLOTS_PER_BLOCK slots."""
    if not q.is_cuda:
        return bank_attention_qminor_plain(q, bank_k, bank_v, count,
                                           num_heads, scale)
    s, b, lk, ck = bank_k.shape
    lq = q.shape[1]
    dh = ck // num_heads
    dv = bank_v.shape[-1] // num_heads
    _check_bf16(q, q=q, bank_k=bank_k, bank_v=bank_v)
    _check(q.shape == (b, lq, num_heads * dh), f"q shape {tuple(q.shape)}")
    _check(bank_v.shape[:3] == (s, b, lk),
           f"bank_v shape {tuple(bank_v.shape)}")
    _check(num_heads == 1 and dh == 128,
           f"{num_heads} heads of width {dh} (the kernel is held to its "
           "plain version for one head of 128, r50_deaotl's)")
    _check(dv % 256 == 0, f"value width {dv} (multiple of 256)")
    _check_count(count, q)
    groups = -(-s // SLOTS_PER_BLOCK)
    bh = b * num_heads
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((groups, bh, lq), **f32)
    part_l = torch.empty((s, bh, lq), **f32)
    part_acc = torch.empty((groups, b, lq, num_heads * dv), **f32)
    out = torch.empty((b, lq, num_heads * dv), dtype=q.dtype,
                      device=q.device)
    rec = torch.empty((bh, lq, s), **f32)
    fn = build.load("bank_attention_qminor").rmem_bank_attention_qminor
    fn.argtypes = [_P] * 9 + [_I] * 7 + [_F, _P]
    fn.restype = _I
    err = fn(q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
             count.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
             part_acc.data_ptr(), out.data_ptr(), rec.data_ptr(), b,
             num_heads, lq, s, lk, dh, dv, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention_qminor")
    bank_attention_qminor.launches += 1
    rec = rec.view(b, num_heads, lq, s)
    return out, (rec[:, 0] if num_heads == 1 else rec.mean(dim=1))


bank_attention_qminor.launches = 0


def bank_attention_lse(q: torch.Tensor, bank_k: torch.Tensor,
                       bank_v: torch.Tensor, count: torch.Tensor,
                       scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 for training (card only): one head, no bias, every key valid.
    Returns (out [B, Lq, dv] f32, rec [B, Lq, S] f32, lse [B, Lq] f32, the
    log-sum-exp of each row's scaled logits over the valid slots). The
    output stays f32 for the backward's row term (csrc/bank_attention.cu)."""
    out, rec, lse = _forward(q, bank_k, bank_v, count, 1, scale, None, None,
                             train=True)
    bank_attention_lse.launches += 1
    return out, rec, lse


bank_attention_lse.launches = 0


# ---- the backward (kernel K2) --------------------------------------------

def bwd_delta(dout: torch.Tensor, out: torch.Tensor, drec: torch.Tensor,
              rec: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dout * out) + rowsum(drec * rec), f32 [B, Lq]: the
    softmax backward's row term, with the slot mass's share."""
    return ((dout.float() * out.float()).sum(-1)
            + (drec.float() * rec.float()).sum(-1)).contiguous()


def bank_attention_bwd_ds_plain(q, bank_k, bank_v, count, dout, lse, delta,
                                drec, scale):
    """K2's first kernel in plain PyTorch (f32): p = exp(q.k*scale - lse)
    and ds = p * (dout.v + drec[slot] - delta), [B, S, Lq, Lk], zero in
    slots >= count."""
    valid = (torch.arange(bank_k.shape[0], device=q.device) < count)
    logits = torch.einsum("bqd,sbkd->bsqk", q.float(), bank_k.float()) * scale
    p = torch.exp(logits - lse.float()[:, None, :, None])
    p = torch.where(valid[None, :, None, None], p, 0.0)
    g = torch.einsum("bqd,sbkd->bsqk", dout.float(), bank_v.float())
    r = drec.float().permute(0, 2, 1)[..., None]            # [B, S, Lq, 1]
    ds = p * (g + r - delta.float()[:, None, :, None])
    return p, ds


def bank_attention_bwd_dq_plain(ds, bank_k, scale):
    """dq = scale * sum over slots of ds K, f32 [B, Lq, dh]."""
    return torch.einsum("bsqk,sbkd->bqd", ds.float(), bank_k.float()) * scale


def bank_attention_bwd_dkv_plain(p, ds, q, dout, scale):
    """dk = scale * ds^T Q, dv = p^T dOut, f32 [S, B, Lk, *]."""
    dk = torch.einsum("bsqk,bqd->sbkd", ds.float(), q.float()) * scale
    dv = torch.einsum("bsqk,bqd->sbkd", p.float(), dout.float())
    return dk, dv


def bank_attention_bwd_plain(q, bank_k, bank_v, count, dout, drec, scale):
    """The whole backward in plain PyTorch: autograd of
    bank_attention_plain, f32. Returns (dq, dk, dv)."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in (q, bank_k,
                                                             bank_v)]
        out, rec = bank_attention_plain(*ins, count, 1, scale)
        return torch.autograd.grad((out, rec), ins,
                                   (dout.float(), drec.float()))


def _scratch_cols(lk: int) -> int:
    return (lk + BLOCK_K - 1) // BLOCK_K * BLOCK_K


def bank_attention_bwd_ds(q, bank_k, bank_v, count, dout, lse, delta, drec,
                          scale):
    """Launch K2's ds kernel. Returns (p bf16 [B, S, Lq, LkP], ds bf16
    [2, B, S, Lq, LkP]: ds = ds[0] + ds[1], a bf16 pair that carries ~16
    bits), the keys padded to 64 (padding 0); slots >= count are left
    unwritten."""
    s, b, lk, dh = bank_k.shape
    lq, dv = q.shape[1], bank_v.shape[-1]
    _check_bf16(q, q=q, bank_k=bank_k, bank_v=bank_v, dout=dout)
    _check(dh == 128 and q.shape == (b, lq, dh), f"q {tuple(q.shape)}, "
           f"bank_k {tuple(bank_k.shape)} (one head of 128)")
    _check(bank_v.shape[:3] == (s, b, lk) and dout.shape == (b, lq, dv)
           and dv % 128 == 0, f"bank_v {tuple(bank_v.shape)}, dout "
           f"{tuple(dout.shape)}")
    for name, t, shape in (("lse", lse, (b, lq)), ("delta", delta, (b, lq)),
                           ("drec", drec, (b, lq, s))):
        _check(t.device == q.device and t.dtype == torch.float32
               and t.is_contiguous() and t.shape == shape,
               f"{name} must be contiguous f32 {shape}")
    _check_count(count, q)
    lkp = _scratch_cols(lk)
    p = torch.empty((b, s, lq, lkp), dtype=torch.bfloat16, device=q.device)
    ds = torch.empty((2, b, s, lq, lkp), dtype=torch.bfloat16,
                     device=q.device)
    fn = build.load("bank_attention_bwd").rmem_bank_attention_bwd_ds
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_F, _P]
    fn.restype = _I
    err = fn(q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             drec.data_ptr(), count.data_ptr(), p.data_ptr(), ds.data_ptr(),
             b, lq, s, lk, lkp, dv, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention_bwd_ds")
    bank_attention_bwd_ds.launches += 1
    return p, ds


bank_attention_bwd_ds.launches = 0


def bank_attention_bwd_dq(bank_k, ds, count, scale):
    """Launch K2's dq kernel: dq bf16 [B, Lq, 128]."""
    s, b, lk, dh = bank_k.shape
    lq = ds.shape[3]
    _check_bf16(bank_k, bank_k=bank_k, ds=ds)
    _check(ds.shape == (2, b, s, lq, _scratch_cols(lk)),
           f"ds shape {tuple(ds.shape)}")
    _check_count(count, bank_k)
    dq = torch.empty((b, lq, dh), dtype=torch.bfloat16, device=ds.device)
    fn = build.load("bank_attention_bwd").rmem_bank_attention_bwd_dq
    fn.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
    fn.restype = _I
    err = fn(bank_k.data_ptr(), ds.data_ptr(), count.data_ptr(),
             dq.data_ptr(), b, lq, s, lk, ds.shape[-1], float(scale),
             torch.cuda.current_stream(ds.device).cuda_stream)
    build.check(err, "bank_attention_bwd_dq")
    bank_attention_bwd_dq.launches += 1
    return dq


bank_attention_bwd_dq.launches = 0


def bank_attention_bwd_dkv(q, dout, p, ds, count, scale, lk: int):
    """Launch K2's dkv kernel: (dk bf16 [S, B, Lk, 128], dv bf16
    [S, B, Lk, dv]), zero in slots >= count."""
    b, s, lq, lkp = p.shape
    dh, dv = q.shape[-1], dout.shape[-1]
    _check_bf16(q, q=q, dout=dout, p=p, ds=ds)
    _check(dh == 128 and q.shape == (b, lq, dh) and dout.shape == (b, lq, dv)
           and dv % 128 == 0 and ds.shape == (2, *p.shape)
           and lkp == _scratch_cols(lk), f"q {tuple(q.shape)}, dout "
           f"{tuple(dout.shape)}, p {tuple(p.shape)} for {lk} keys")
    _check_count(count, q)
    dk = torch.empty((s, b, lk, dh), dtype=torch.bfloat16, device=q.device)
    dvv = torch.empty((s, b, lk, dv), dtype=torch.bfloat16, device=q.device)
    fn = build.load("bank_attention_bwd").rmem_bank_attention_bwd_dkv
    fn.argtypes = [_P] * 7 + [_I] * 6 + [_F, _P]
    fn.restype = _I
    err = fn(q.data_ptr(), dout.data_ptr(), p.data_ptr(), ds.data_ptr(),
             count.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, lq, s, lk,
             lkp, dv, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention_bwd_dkv")
    bank_attention_bwd_dkv.launches += 1
    return dk, dvv


bank_attention_bwd_dkv.launches = 0


def bank_attention_bwd(q, bank_k, bank_v, count, out, rec, lse, dout, drec,
                       scale):
    """K2 on the card: (dq, dk, dv) in bf16 from the forward's inputs,
    outputs (out f32) and lse and the cotangents dout (bf16) and drec
    (f32)."""
    delta = bwd_delta(dout, out, drec, rec)
    p, ds = bank_attention_bwd_ds(q, bank_k, bank_v, count, dout, lse, delta,
                                  drec, scale)
    dq = bank_attention_bwd_dq(bank_k, ds, count, scale)
    dk, dv = bank_attention_bwd_dkv(q, dout, p, ds, count, scale,
                                    bank_k.shape[2])
    return dq, dk, dv


class _BankAttention(torch.autograd.Function):
    """K1 with lse forward, K2 backward (bf16 tensors on the card)."""

    @staticmethod
    def forward(ctx, q, bank_k, bank_v, count, scale):
        out, rec, lse = bank_attention_lse(q, bank_k, bank_v, count, scale)
        ctx.save_for_backward(q, bank_k, bank_v, count, out, rec, lse)
        ctx.scale = scale
        return out.to(q.dtype), rec

    @staticmethod
    def backward(ctx, dout, drec):
        q, bank_k, bank_v, count, out, rec, lse = ctx.saved_tensors
        # FIFO eviction reads no slot mass, so drec arrives as zeros
        dout = (out.new_zeros(out.shape, dtype=torch.bfloat16)
                if dout is None else dout.to(torch.bfloat16).contiguous())
        drec = (torch.zeros_like(rec) if drec is None
                else drec.float().contiguous())
        dq, dk, dv = bank_attention_bwd(q, bank_k, bank_v, count, out, rec,
                                        lse, dout, drec, ctx.scale)
        return dq, dk, dv, None, None


def bank_attention_train(q: torch.Tensor, bank_k: torch.Tensor,
                         bank_v: torch.Tensor, count: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable bank attention for one head, every key valid:
    q [B, Lq, dh], bank_k [S, B, Lk, dh], bank_v [S, B, Lk, dv], count the
    valid slots (int32 on q's device). Returns (out [B, Lq, dv], rec
    [B, Lq, S]). On the card the inputs are taken in bf16 (the kernel's
    type, as autocast takes a matmul's) and K1/K2 run; on the CPU it is
    autograd through the plain version."""
    if not q.is_cuda:
        return bank_attention_plain(q, bank_k, bank_v, count, 1, scale)
    bf = torch.bfloat16
    return _BankAttention.apply(q.to(bf).contiguous(),
                                bank_k.to(bf).contiguous(),
                                bank_v.to(bf).contiguous(), count, scale)

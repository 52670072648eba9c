"""Local window attention (kernel K4): each query attends to the 15 x 15
window of short-term keys around it, plus a learned relative bias.

`local_attention` launches the CUDA kernel `csrc/local_attention.cu` for
tensors on the card and runs `local_attention_plain` for tensors on the
CPU. It replaces rmem_tpu/kernels/local_attention.py:pallas_local_attention.
It takes one or two heads of 128 (DeAOT's, and its `no_memory_gap`); at two
it hands the kernel the bias head-major (`rel_head_major`), one copy of it.

`local_attention_trainable` (K5) is its differentiable form, the
counterpart of pallas_local_attention_trainable: on the card the forward is
the kernel and the backward is `local_attention_bwd`, two more kernels of
the same source at one or two heads of 128 (`local_attention_bwd_plain` is
their plain version; `local_attention_bwd_stages_plain` composes the plain
forms of their stages: the query side's lse rows, the key side's P^T from
that lse and its mirrored re-indexing of window rows); on the CPU it is
autograd through the plain forward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.kernels.launches import launched
from rmem_tpu_torch.ops.attention import dense_local_attention
from rmem_tpu_torch.utils.trace import spanned

_P = ctypes.c_void_p
_I = ctypes.c_int
# K4: the dv slice of one block, fixed in csrc/local_attention.cu (FWD_DVB,
# checked against the library when it loads; PERF.md has the sweep of 128
# and 256, each with its columns on one or two warps, that chose it)
SLICE = 256


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


# the head counts of 128 that the forward kernel takes on its grid
FWD_HEADS = (1, 2)


def rel_head_major(rel_emb: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The bias [B, HW, h*win^2] as the forward kernel reads it, [B, h, HW,
    win^2] contiguous: each head's rows of a tile are then one span. A
    copy at two heads (1.5 MB in bf16 at 31 x 54); the same tensor at
    one."""
    if num_heads == 1:
        return rel_emb
    b, hw, _ = rel_emb.shape
    return rel_emb.reshape(b, hw, num_heads, -1).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _forward_entry():
    """The forward's C entry, its slice width held to SLICE once."""
    lib = build.load("local_attention")
    lib.rmem_local_attention_slice.argtypes = []
    lib.rmem_local_attention_slice.restype = _I
    slice_width = lib.rmem_local_attention_slice()
    _check(slice_width == SLICE, f"the library's dv slice is {slice_width}, "
           f"the wrapper expects {SLICE}")
    fn = lib.rmem_local_attention
    fn.argtypes = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


@spanned("rmem.kernel.local_attention")
def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rel_emb: torch.Tensor, size_2d: Tuple[int, int],
                    num_heads: int, max_dis: int,
                    scale: float) -> torch.Tensor:
    """q, k [B, HW, h*dh]; v [B, HW, h*dv]; rel_emb [B, HW, h*(2m+1)^2] made
    from the unscaled q. Returns [B, HW, h*dv]. On the card: bf16, one or
    two heads of 128, a 15 x 15 window (max_dis 7), dv a multiple of SLICE
    a head, all contiguous. While a graph is traced, the call is the custom
    op rmem::local_attention (kernels/ops.py)."""
    if torch.compiler.is_compiling():
        from rmem_tpu_torch.kernels import ops  # noqa: F401 (registers)
        return torch.ops.rmem.local_attention(
            q, k, v, rel_emb, list(size_2d), num_heads, max_dis,
            float(scale))
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
    _check(num_heads in FWD_HEADS and dh == 128,
           f"{num_heads} heads of width {dh} (the kernel is held to its "
           "plain version for one or two heads of 128, r50_deaotl's)")
    _check(max_dis == 7, f"max_dis {max_dis} (the kernel's window is 15 x 15)")
    _check(dv % SLICE == 0, f"value width {dv} (multiple of {SLICE})")
    fn = _forward_entry()
    rel = rel_head_major(rel_emb, num_heads)
    out = torch.empty((b, hw, num_heads * dv), dtype=v.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(),
             out.data_ptr(), b, h2d, w2d, num_heads, dh, dv, max_dis,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "local_attention")
    local_attention.launches += launched(local_attention)
    return out


local_attention.launches = 0


@functools.lru_cache(maxsize=16)
def _window_keys(h: int, w: int, max_dis: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Window layout of an h x w grid: ([HW, win^2] int64 key index of each
    query's window offset, 0 where the key lies outside the image;
    [HW, win^2] bool, whether it lies inside)."""
    win = 2 * max_dis + 1
    qy, qx = np.divmod(np.arange(h * w), w)
    dy, dx = np.divmod(np.arange(win * win), win)
    ky = qy[:, None] + dy[None, :] - max_dis
    kx = qx[:, None] + dx[None, :] - max_dis
    ok = (ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)
    return np.where(ok, ky * w + kx, 0).astype(np.int64), ok


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """[b, hw, nh * d] -> [b, nh, hw, d], f32."""
    b, hw, _ = x.shape
    return x.float().reshape(b, hw, nh, -1).transpose(1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[b, nh, hw, d] -> [b, hw, nh * d]."""
    b, nh, hw, _ = x.shape
    return x.transpose(1, 2).reshape(b, hw, -1)


def local_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, rel_emb: torch.Tensor,
                              g: torch.Tensor, size_2d: Tuple[int, int],
                              num_heads: int, max_dis: int, scale: float
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' function in plain PyTorch, step by step in
    window layout, in f32: for the cotangent g of the output, returns
    (dq, dk, dv, drel) of local_attention_plain's inputs, f32. drel holds
    ds = p (dp - delta) at each window offset, 0 where the window leaves
    the image."""
    h2d, w2d = size_2d
    b, hw, _ = q.shape
    nh = num_heads
    win2 = (2 * max_dis + 1) ** 2
    idx_np, ok_np = _window_keys(h2d, w2d, max_dis)
    idx = torch.from_numpy(idx_np).to(q.device).expand(b, nh, hw, win2)
    ok = torch.from_numpy(ok_np).to(q.device)
    qh, kh, vh, gh = (_heads(x, nh) for x in (q, k, v, g))
    rel = _heads(rel_emb, nh)
    # the logits and dp = g.v of each query's window keys
    s = torch.gather(qh @ kh.transpose(-1, -2), -1, idx) * scale + rel
    s = torch.where(ok, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dp = torch.where(ok, torch.gather(gh @ vh.transpose(-1, -2), -1, idx),
                     0.0)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)                              # 0 outside the image
    # back to [query, key] to sum over the window's keys and queries
    zeros = torch.zeros((b, nh, hw, hw), device=q.device)
    ds_d = zeros.scatter_add(-1, idx, ds)
    p_d = zeros.scatter_add(-1, idx, p)
    dq = (ds_d @ kh) * scale
    dk = (ds_d.transpose(-1, -2) @ qh) * scale
    dvv = p_d.transpose(-1, -2) @ gh
    return _tokens(dq), _tokens(dk), _tokens(dvv), _tokens(ds)


# K5's backward: a head's value widths the kernels are instantiated for
# (csrc/local_attention.cu's rmem_local_attention_bwd)
BWD_VALUES = (512, 1024)


def _window(size_2d: Tuple[int, int], max_dis: int, device):
    """_window_keys on `device`, with the mirrored offsets win^2 - 1 - w."""
    idx_np, ok_np = _window_keys(*size_2d, max_dis)
    win2 = idx_np.shape[1]
    idx = torch.from_numpy(idx_np).to(device)
    flip = (win2 - 1 - torch.arange(win2, device=device)).expand_as(idx)
    return idx, torch.from_numpy(ok_np).to(device), flip


def local_bwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        rel_emb: torch.Tensor, size_2d: Tuple[int, int],
                        num_heads: int, max_dis: int,
                        scale: float) -> torch.Tensor:
    """The query side's first stage: each query's lse over its window keys
    inside the image, [B, H, HW] f32 (4 bytes a row: all that the key side
    needs to recompute p)."""
    idx, ok, _ = _window(size_2d, max_dis, q.device)
    qh, kh = _heads(q, num_heads), _heads(k, num_heads)
    s = (qh[:, :, :, None] * kh[:, :, idx]).sum(-1) * scale
    s = torch.where(ok, s + _heads(rel_emb, num_heads), float("-inf"))
    return torch.logsumexp(s, dim=-1)


def mirror_rows(x: torch.Tensor, size_2d: Tuple[int, int],
                max_dis: int) -> torch.Tensor:
    """The key side's re-indexing of query-major window rows [B, H, HW,
    win^2] (p, ds, the bias) into key-major rows: out[.., j, w] = x[.., i,
    win^2 - 1 - w] for the query i at window offset w from key j (the key
    sits at the mirrored offset from the query), 0 where i lies outside the
    image. Row j of the result is row j of the [keys x queries] tile."""
    idx, ok, flip = _window(size_2d, max_dis, x.device)
    return torch.where(ok, x[:, :, idx, flip], 0.0)


def local_bwd_key_probs_plain(q: torch.Tensor, k: torch.Tensor,
                              rel_emb: torch.Tensor, lse: torch.Tensor,
                              size_2d: Tuple[int, int], num_heads: int,
                              max_dis: int, scale: float) -> torch.Tensor:
    """The key side's P^T, recomputed from q, k, the bias and the query
    side's lse [B, H, HW], in mirror_rows' key-major layout: for key j and
    the query i at offset w from it, exp(scale q_i.k_j + rel[i, win^2 - 1 -
    w] - lse_i); 0 where i lies outside the image."""
    idx, ok, flip = _window(size_2d, max_dis, q.device)
    qh, kh = _heads(q, num_heads), _heads(k, num_heads)
    s = (qh[:, :, idx] * kh[:, :, :, None]).sum(-1) * scale
    s = s + _heads(rel_emb, num_heads)[:, :, idx, flip] - lse[:, :, idx]
    return torch.where(ok, torch.exp(s), 0.0)


def local_attention_bwd_stages_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, rel_emb: torch.Tensor,
                                     g: torch.Tensor,
                                     size_2d: Tuple[int, int],
                                     num_heads: int, max_dis: int,
                                     scale: float
                                     ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' stages in plain PyTorch, f32, gathering each
    window rather than forming [HW x HW]: the query side's lse rows, p, dp,
    delta, ds (drel) and dq; the key side's P^T from that lse
    (local_bwd_key_probs_plain), ds^T re-indexed from drel's rows
    (mirror_rows), dv and dk. Returns (dq, dk, dv, drel) as
    local_attention_bwd_plain does."""
    nh = num_heads
    idx, ok, _ = _window(size_2d, max_dis, q.device)
    qh, kh, vh, gh = (_heads(x, nh) for x in (q, k, v, g))
    # the query side
    lse = local_bwd_lse_plain(q, k, rel_emb, size_2d, nh, max_dis, scale)
    s = (qh[:, :, :, None] * kh[:, :, idx]).sum(-1) * scale
    s = torch.where(ok, s + _heads(rel_emb, nh), float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.where(ok, (gh[:, :, :, None] * vh[:, :, idx]).sum(-1), 0.0)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)                              # 0 outside the image
    dq = (ds[..., None] * kh[:, :, idx]).sum(-2) * scale
    # the key side
    pt = local_bwd_key_probs_plain(q, k, rel_emb, lse, size_2d, nh, max_dis,
                                   scale)
    dst = mirror_rows(ds, size_2d, max_dis)
    dv = (pt[..., None] * gh[:, :, idx]).sum(-2)
    dk = (dst[..., None] * qh[:, :, idx]).sum(-2) * scale
    return _tokens(dq), _tokens(dk), _tokens(dv), _tokens(ds)


@spanned("rmem.kernel.local_attention_bwd", backward=True)
def local_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rel_emb: torch.Tensor, g: torch.Tensor,
                        size_2d: Tuple[int, int], num_heads: int,
                        max_dis: int, scale: float
                        ) -> Tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv, drel) of `local_attention` for the cotangent
    g [B, HW, h*dv]. On the card: the two backward kernels of
    csrc/local_attention.cu at one or two heads of 128, a 15 x 15 window
    and values BWD_VALUES a head, every tensor in the caller's layout (the
    query side also writes each row's lse, f32 [B, h, HW], for the key
    side), bf16 inputs as the forward takes them, g bf16; dq, dk, dv come
    back bf16 and drel f32 [B, HW, h*win^2]. On the CPU: the plain
    version."""
    if not q.is_cuda:
        return local_attention_bwd_plain(q, k, v, rel_emb, g, size_2d,
                                         num_heads, max_dis, scale)
    h2d, w2d = size_2d
    b, hw, chd = q.shape
    dh, dv = chd // num_heads, v.shape[-1] // num_heads
    win2 = (2 * max_dis + 1) ** 2
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_emb", rel_emb),
                    ("g", g)):
        _check(t.is_cuda and t.device == q.device, f"{name} not on {q.device}")
        _check(t.dtype == torch.bfloat16, f"{name} must be bf16")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _check(hw == h2d * w2d, f"{hw} tokens for a {h2d}x{w2d} grid")
    _check(k.shape == q.shape, f"k shape {tuple(k.shape)}")
    _check(v.shape[:2] == (b, hw) and g.shape == v.shape,
           f"v shape {tuple(v.shape)}, g shape {tuple(g.shape)}")
    _check(rel_emb.shape == (b, hw, num_heads * win2),
           f"rel_emb shape {tuple(rel_emb.shape)}")
    _check(num_heads in FWD_HEADS and dh == 128,
           f"{num_heads} heads of width {dh} (the kernels are held to their "
           "plain version for one or two heads of 128, r50_deaotl's)")
    _check(max_dis == 7, f"max_dis {max_dis} (the kernels' window is 15 x 15)")
    _check(dv in BWD_VALUES, f"value width {dv} (one of {BWD_VALUES})")
    fn = build.load("local_attention").rmem_local_attention_bwd
    fn.argtypes = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dvv = torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    drel = torch.empty((b, hw, num_heads * win2), **f32)
    lse = torch.empty((b, num_heads, hw), **f32)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_emb.data_ptr(),
             g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
             drel.data_ptr(), lse.data_ptr(), b, h2d, w2d, num_heads, dh, dv,
             max_dis, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "local_attention_bwd")
    local_attention_bwd.launches += launched(local_attention_bwd)
    return dq, dk, dvv, drel


local_attention_bwd.launches = 0


class _LocalAttention(torch.autograd.Function):
    """K4 forward, the backward kernels (bf16 tensors on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_emb, size_2d, num_heads, max_dis, scale):
        ctx.save_for_backward(q, k, v, rel_emb)
        ctx.args = (size_2d, num_heads, max_dis, scale)
        return local_attention(q, k, v, rel_emb, size_2d, num_heads, max_dis,
                               scale)

    @staticmethod
    def backward(ctx, g):
        # read once: under torch.utils.checkpoint a second read fails
        saved = ctx.saved_tensors
        # every gradient is computed; those not asked for are dropped
        grads = local_attention_bwd(*saved, g.to(torch.bfloat16).contiguous(),
                                    *ctx.args)
        return (*(gr.to(t.dtype) if need else None for gr, t, need in zip(
            grads, saved, ctx.needs_input_grad)), None, None, None, None)


def local_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, rel_emb: torch.Tensor,
                              size_2d: Tuple[int, int], num_heads: int,
                              max_dis: int, scale: float) -> torch.Tensor:
    """Differentiable `local_attention`. On the card the inputs are taken in
    bf16, the kernels' type, at one or two heads of 128 (the forward raises
    on any other shape), and the output is given back in q's dtype where no
    autocast runs (f32 compute)."""
    if not q.is_cuda:
        return local_attention_plain(q, k, v, rel_emb, size_2d, num_heads,
                                     max_dis, scale)
    bf = torch.bfloat16
    out = _LocalAttention.apply(
        q.to(bf).contiguous(), k.to(bf).contiguous(), v.to(bf).contiguous(),
        rel_emb.to(bf).contiguous(), size_2d, num_heads, max_dis, scale)
    if not torch.is_autocast_enabled(q.device.type):
        out = out.to(q.dtype)
    return out

"""Bank attention: the frame's queries into the valid slots of the
long-term bank, with each slot's softmax mass.

Inference (kernel K1): `bank_attention_infer` launches the CUDA kernel
`csrc/bank_attention_infer.cu` (with the slot-PE logit bias and key padding)
for tensors on the card and runs `bank_attention_plain` for tensors on the
CPU. It replaces rmem_tpu/kernels/bank_attention.py:
pallas_bank_attention_infer and the forward of pallas_bank_attention (the
reference frame's S = 1 self-memory call).

The template takes one head of 128 or two (DeAOT's `no_memory_gap`: 2
heads of 128, values 512 a head), the heads on its grid; at two it returns
each head's slot mass and the wrapper averages them, as
rmem_tpu/kernels/bank_attention.py:_unlayout_out does. AOT's
`no_memory_gap` (2 heads of 128, values 128 a head, K1×2ᵛ¹²⁸) has a kernel
of its own, `csrc/bank_attention_infer_v128.cu`: one launch a call, each
128-query tile's walk over the valid (slot, chunk) pairs split across a
thread-block cluster of `v128_cluster` blocks and merged in distributed
shared memory; `bank_attention_infer_v128_plain` is its form.

At 8 heads of 32 (AOT's LSTT, kernel K1ʰ) `bank_attention_infer` routes
to `bank_attention_infer_mh`, which launches `csrc/bank_attention_mh.cu`
(its own launch count: a kernel over slot groups of MH_SLOTS_PER_BLOCK and
the merge of their partial state, as K1's template splits the slots) and
averages the per-head slot mass over the heads; `infer_route` is the shape
rule. `bank_attention_plain` is the plain version of both, and
`bank_attention_lse_plain` (with `true_lk` and `qbias`) the kernels' own
partial + merge form.

Inference with the slot PE in the keys (kernel K3, opt-in):
`bank_attention_qminor` launches the same source's other instantiation (no
bias, no key padding) for tensors on the card and runs
`bank_attention_qminor_plain` for tensors on the CPU; it replaces
rmem_tpu/kernels/bank_attention.py:pallas_bank_attention_qminor. Both split
the slots among blocks, SLOTS_PER_BLOCK each, and merge on the card. At 8
heads of 32 (K3ʰ) it launches K1ʰ's kernel with no bias and every key
valid, counted on `bank_attention_qminor.launches`.

Training: `bank_attention_train` is differentiable and routes by head
shape (`train_route`, the same rule as `infer_route`). At one or two heads
of 128 it is, on the card, an autograd Function whose forward is the same
source's third instantiation, with f32 partial outputs, an f32 output and
each head's per-row log-sum-exp (`bank_attention_lse`, K1';
`bank_attention_lse_plain` is its plain version, in the kernel's partial +
merge form, per head) or, at 2 heads of 128 with values 128 a head,
K1'×2ᵛ¹²⁸ (`csrc/bank_attention_lse_v128.cu`: one kernel, 64-query blocks
whose two consumers take the 64-key chunks in turn and merge in shared
memory; `bank_attention_lse_v128_plain` is its form), and whose backward
is kernel K2
(`csrc/bank_attention_bwd.cu`: `bank_attention_bwd_split`, a dq, a dk and
a dv kernel that recompute p and ds from the lse, no scratch, dV split
across blocks by value columns; each head's row term from `bwd_delta_mh`,
and drec / h into each head, the record being the head mean;
`bank_attention_bwd_split_plain` is its plain form), except at 2
heads of 128 with values 128 a head, where it is K2×2ᵛ¹²⁸
(`csrc/bank_attention_bwd_fused.cu`: `bank_attention_bwd_fused`, a dkv and a
dq kernel that recompute p and ds from the lse, no scratch;
`bank_attention_bwd_fused_plain` is its plain version); `bwd_route` is the
backward's shape rule. At 8 heads of 32
(AOT's LSTT) the forward is K1'ʰ, the training instantiation of
`csrc/bank_attention_mh.cu` (`bank_attention_lse_mh`: f32 output, each
head's slot mass and lse), and the backward K2ʰ
(`csrc/bank_attention_mh_bwd.cu`: `bank_attention_bwd_mh`, one call of a
rows kernel, which computes each head's row term on the card, a dkv and a
dq kernel and the sum of dq's slot groups;
`bank_attention_bwd_mh_form_plain` is its form). The head-generic plain
stages `bank_attention_bwd_mh_dq_plain` and `_dkv_plain` are K2ʰ's plain
versions. Both replace pallas_bank_attention and
its custom VJP. On the CPU it is autograd through `bank_attention_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.kernels.launches import launched
from rmem_tpu_torch.ops.attention import bank_attention
from rmem_tpu_torch.utils.trace import spanned

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
BLOCK_K = 64      # row tile of the backward kernels: their rows pad Lq to it
# K1, K3 and K1': slots walked by one block, fixed in
# csrc/bank_attention_infer.cu (G, checked against the library when it
# loads; PERF.md has the sweep of 1, 2, 3 and 9 that chose it)
SLOTS_PER_BLOCK = 2
# K1 and K3: the head counts of 128 that the template takes on its grid;
# values 128 a head only at AOT's no_memory_gap shape, the one K1×2ᵛ¹²⁸
# (csrc/bank_attention_infer_v128.cu) is held at
SLOT_HEADS = (1, 2)
NARROW_VALUES = (2, 128, 128)
# K1×2ᵛ¹²⁸ (csrc/bank_attention_infer_v128.cu; keys a chunk and slots a
# call as K1'×2ᵛ¹²⁸'s below): queries a block and blocks a cluster at most
# (TQ in the source; 4, the largest measured, of the source's 8)
V128_TILE, V128_MAX_CLUSTER = 128, 4
# K1ʰ: the head shape csrc/bank_attention_mh.cu is written for, the slots
# a call takes, and the slots a block walks (G in the source, checked
# against the library when it loads)
MH_HEADS, MH_WIDTH, MH_MAX_SLOTS = 8, 32, 16
MH_SLOTS_PER_BLOCK = SLOTS_PER_BLOCK    # so one plain form is both kernels'
# K2×2ᵛ¹²⁸ (csrc/bank_attention_bwd_fused.cu): the slots a dq block walks,
# checked the same way
FUSED_DQ_SLOTS = 2
# K1'×2ᵛ¹²⁸ (csrc/bank_attention_lse_v128.cu): keys a chunk, the consumer
# warpgroups that take the chunks in turn, and the slots a call takes
# (BK, NCONS and MAX_SLOTS in the source; K1×2ᵛ¹²⁸'s BK and MAX_SLOTS too)
V128_CHUNK, V128_CONSUMERS, V128_MAX_SLOTS = 64, 2, 16
# K2ʰ (csrc/bank_attention_mh_bwd.cu): the slots a dq block walks (G in the
# source), which sizes its partials
MH_BWD_DQ_SLOTS = 2
# K2 and K2×2 (csrc/bank_attention_bwd.cu): the value columns a dv block
# takes and the slots a dq block walks (NV and G in the source, checked
# against the library when it loads), and a head's values at most
SPLIT_DV_COLUMNS, SPLIT_DQ_SLOTS, SPLIT_MAX_VALUES = 256, 2, 1024
_LOG2E = 1.0 / math.log(2.0)
# the slot-group kernels' partial state (K1ʰ, K3ʰ, K1'ʰ; the dq of K2,
# K2×2 and K2×2ᵛ¹²⁸):
# one buffer a (device, stream), grown as needed and reused by every call
# on that stream, so a call allocates none (stream order keeps a call from
# writing it before the last call's merge has read it)
_WORKSPACE = {}
_ALIGN = 256


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


def _workspace(nbytes: int, device: torch.device, stream: int) -> int:
    """The address of `nbytes` of scratch on `device` for kernels launched
    on `stream`, the current stream."""
    buf = _WORKSPACE.get((device, stream))
    if buf is None or buf.numel() < nbytes:
        buf = _WORKSPACE[(device, stream)] = torch.empty(
            nbytes, dtype=torch.uint8, device=device)
    return buf.data_ptr()


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


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


def _head_shape(shape: Tuple[int, ...], num_heads: int,
                axis: int) -> Tuple[int, ...]:
    """A shape with its head axis at `axis`, dropped at one head: the
    shapes one head's calls of K1' and K2 have always taken and given."""
    return shape[:axis] + shape[axis + 1:] if num_heads == 1 else shape


def _check_bank(q, bank_k, bank_v, count, num_heads) -> Tuple[int, ...]:
    """The kernels' common checks; returns (s, b, lq, lk, dh, dv), dv a
    head's values."""
    s, b, lk, ck = bank_k.shape
    lq = q.shape[1]
    dh = ck // num_heads
    dv = bank_v.shape[-1] // num_heads
    _check_bf16(q, q=q, bank_k=bank_k, bank_v=bank_v)
    _check(q.shape == (b, lq, num_heads * dh), f"q shape {tuple(q.shape)}")
    _check(bank_v.shape[:3] == (s, b, lk),
           f"bank_v shape {tuple(bank_v.shape)}")
    _check(infer_route(num_heads, dh, dv) == "slots",
           f"{num_heads} heads of width {dh} (the template takes one or two "
           "heads of 128)")
    _check_count(count, q)
    return s, b, lq, lk, dh, dv


@functools.lru_cache(maxsize=None)
def _slots_entry():
    """csrc/bank_attention_infer.cu's C entry, its slots a block held to
    SLOTS_PER_BLOCK once."""
    lib = build.load("bank_attention_infer")
    lib.rmem_bank_attention_infer_slots.argtypes = []
    lib.rmem_bank_attention_infer_slots.restype = _I
    groups_of = lib.rmem_bank_attention_infer_slots()
    _check(groups_of == SLOTS_PER_BLOCK, f"the library walks {groups_of} "
           f"slots a block, the wrapper expects {SLOTS_PER_BLOCK}")
    fn = lib.rmem_bank_attention_infer
    fn.argtypes = [_P] * 10 + [_I] * 8 + [_F, _P]
    fn.restype = _I
    return fn


def _scratch(s: int, b: int, lq: int, dv: int, dtype, device):
    """The template's partial state for s slots and b rows of (batch,
    head): (part_m, part_l, part_o)."""
    groups = -(-s // SLOTS_PER_BLOCK)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((groups, b, lq), **f32),
            torch.empty((s, b, lq), **f32),
            torch.empty((groups, b, lq, dv), dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _lse_entry():
    """K1''s C entry in the same library."""
    _slots_entry()
    fn = build.load("bank_attention_infer").rmem_bank_attention_lse
    fn.argtypes = [_P] * 10 + [_I] * 7 + [_F, _P]
    fn.restype = _I
    return fn


def _slots_call(q, bank_k, bank_v, count, num_heads, scale,
                true_lk: Optional[int] = None,
                qbias: Optional[torch.Tensor] = None):
    """Launch K1's and K3's kernel: csrc/bank_attention_infer.cu, or at 2
    heads of 128 with values 128 a head csrc/bank_attention_infer_v128.cu.
    Returns (out [B, Lq, h*dv] bf16, rec [B, Lq, S] f32, the head mean of
    the kernel's per-head slot mass)."""
    s, b, lq, lk, dh, dv = _check_bank(q, bank_k, bank_v, count, num_heads)
    true_lk = lk if true_lk is None else true_lk
    _check(0 < true_lk <= lk, f"true_lk {true_lk} for {lk} keys")
    _check(s <= 128, f"{s} slots (the merge takes up to 128)")
    if qbias is not None:
        _check(qbias.device == q.device and qbias.dtype == torch.float32
               and qbias.is_contiguous()
               and qbias.shape == (b, num_heads, lq, s),
               "qbias must be contiguous f32 [B, h, Lq, S]")
    if (num_heads, dh, dv) == NARROW_VALUES:
        out, rec_h = _v128_call(q, bank_k, bank_v, count, scale, true_lk,
                                qbias)
        return out, rec_h.mean(dim=1)
    fn = _slots_entry()
    part_m, part_l, part_o = _scratch(s, b * num_heads, lq, dv,
                                      torch.bfloat16, q.device)
    out = torch.empty((b, lq, num_heads * dv), dtype=q.dtype,
                      device=q.device)
    rec_h = torch.empty((b, num_heads, lq, s), dtype=torch.float32,
                        device=q.device)
    err = fn(q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
             None if qbias is None else qbias.data_ptr(), count.data_ptr(),
             part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
             out.data_ptr(), rec_h.data_ptr(), b, num_heads, lq, s, lk,
             true_lk, dh, dv, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention_infer")
    return out, rec_h[:, 0] if num_heads == 1 else rec_h.mean(dim=1)


def v128_cluster(units: int, sms: int, resident=None) -> int:
    """The blocks a cluster takes at K1×2ᵛ¹²⁸: the most, up to
    V128_MAX_CLUSTER, for which the grid (`units` = query tiles × batch ×
    heads clusters) is one wave on `sms` SMs at one block an SM, and, with
    `resident(cl)` (the clusters of cl blocks the card holds at once), every
    cluster is resident; 1 when no size fits."""
    for cl in range(V128_MAX_CLUSTER, 1, -1):
        if units * cl <= sms and (resident is None or units <= resident(cl)):
            return cl
    return 1


def v128_ranges(n: int, cl: int) -> list:
    """The ranges [lo, hi) of a tile's walk of n valid (slot, chunk) pairs
    that the cl blocks of a cluster take, as the kernel cuts them."""
    return [(n * r // cl, n * (r + 1) // cl) for r in range(cl)]


def bank_attention_infer_v128_plain(q: torch.Tensor, bank_k: torch.Tensor,
                                    bank_v: torch.Tensor, count: torch.Tensor,
                                    scale: float, true_lk: Optional[int] = None,
                                    qbias: Optional[torch.Tensor] = None,
                                    cluster: int = 1
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1×2ᵛ¹²⁸'s function in plain PyTorch (f32), in its kernel's form: per
    head, the valid (slot, chunk) pairs of V128_CHUNK keys (slot major,
    a slot's last chunk short at true_lk) cut into `cluster` ranges
    (`v128_ranges`); each range's maximum m_r of the scaled, biased logits
    (log2 units), its sum L_r and output O_r relative to it, and each slot's
    sum l_r(s) relative to the range's running maximum when its walk left
    the slot, m_r(s); then with M the largest m_r and w_r = 2^(m_r - M) (0
    for an empty range), out = sum_r w_r O_r / sum_r w_r L_r and rec_s =
    sum_r 2^(m_r(s) - M) l_r(s) / that sum. Returns (out [B, Lq, 256], rec_h
    [B, 2, Lq, S]), f32, rec_h 0 past count."""
    heads = NARROW_VALUES[0]
    s, b, lk, _ = bank_k.shape
    lq, n = q.shape[1], int(count)
    true_lk = lk if true_lk is None else true_lk
    cps = -(-true_lk // V128_CHUNK)
    qh = q.float().unflatten(-1, (heads, -1))             # [B, Lq, h, d]
    kh = bank_k[:n].float().unflatten(-1, (heads, -1))    # [n, B, Lk, h, d]
    vh = bank_v[:n].float().unflatten(-1, (heads, -1))
    x = torch.einsum("bqhd,sbkhd->bhqsk", qh, kh) * (scale * _LOG2E)
    if qbias is not None:
        x = x + qbias[..., :n, None].float() * _LOG2E
    key = torch.arange(lk)
    chunk = (torch.arange(n)[:, None] * cps + key // V128_CHUNK)
    valid = (key < true_lk)[None].expand(n, lk)
    inf = float("-inf")

    def finite(m):
        return torch.where(torch.isinf(m), torch.zeros_like(m), m)

    ms, ls, os_, bms, bls = [], [], [], [], []
    for lo, hi in v128_ranges(n * cps, cluster):
        mine = (valid & (chunk >= lo) & (chunk < hi)).to(q.device)
        xr = torch.where(mine, x, inf)                      # [B,h,Lq,n,Lk]
        m = xr.flatten(-2).amax(-1)                         # [B, h, Lq]
        p = torch.exp2(xr - finite(m)[..., None, None])
        ls.append(p.sum((-2, -1)))
        os_.append(torch.einsum("bhqsk,sbkhd->bhqd", p, vh))
        ms.append(m)
        # a slot's sum, booked relative to the running maximum when the
        # walk left it (untouched slots: -inf and 0)
        booked = torch.cummax(xr.amax(-1), dim=-1).values   # [B,h,Lq,n]
        touched = mine.any(-1).to(q.device)                 # [n]
        bm = torch.where(touched, booked, inf)
        bls.append(torch.where(touched, p.sum(-1) * torch.exp2(
            finite(m)[..., None] - finite(bm)), 0.0))
        bms.append(bm)
    big_m = finite(torch.stack(ms).amax(0))

    def weight(m, big):        # 2^(m - M), 0 where m is -inf
        return torch.where(torch.isinf(m), torch.zeros_like(m),
                           torch.exp2(m - big))

    total = sum(weight(m, big_m) * lr for m, lr in zip(ms, ls))
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
    out = sum(weight(m, big_m)[..., None] * o for m, o in zip(ms, os_)) \
        * inv[..., None]
    rec = torch.zeros(b, heads, lq, s, device=q.device)
    rec[..., :n] = sum(weight(bm, big_m[..., None]) * bl
                       for bm, bl in zip(bms, bls)) * inv[..., None]
    return out.permute(0, 2, 1, 3).reshape(b, lq, -1), rec


@functools.lru_cache(maxsize=None)
def _v128_lib():
    """csrc/bank_attention_infer_v128.cu, its tile and largest cluster held
    to V128_TILE and the source's 8 once."""
    lib = build.load("bank_attention_infer_v128")
    for name in ("tile", "max_cluster"):
        fn = getattr(lib, f"rmem_bank_attention_infer_v128_{name}")
        fn.argtypes, fn.restype = [], _I
    _check(lib.rmem_bank_attention_infer_v128_tile() == V128_TILE
           and lib.rmem_bank_attention_infer_v128_max_cluster()
           >= V128_MAX_CLUSTER, "the library's tile or cluster limit is "
           "not the wrapper's")
    lib.rmem_bank_attention_infer_v128.argtypes = [_P] * 7 + [_I] * 7 + [
        _F, _P]
    lib.rmem_bank_attention_infer_v128.restype = _I
    lib.rmem_bank_attention_infer_v128_clusters.argtypes = [_I]
    lib.rmem_bank_attention_infer_v128_clusters.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def v128_resident(device_index: int, cl: int) -> int:
    """The clusters of cl blocks of K1×2ᵛ¹²⁸ that the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(device_index):
        n = _v128_lib().rmem_bank_attention_infer_v128_clusters(cl)
    _check(n >= 0, f"cudaOccupancyMaxActiveClusters failed ({-n})")
    return n


def v128_launch_cluster(q: torch.Tensor) -> Tuple[int, int]:
    """The cluster size K1×2ᵛ¹²⁸ takes for the queries q [B, Lq, 256] on
    their card, and the clusters of that size the card holds at once."""
    units = -(-q.shape[1] // V128_TILE) * q.shape[0] * NARROW_VALUES[0]
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    cl = v128_cluster(units, sms, lambda c: v128_resident(index, c))
    return cl, v128_resident(index, cl)


def _v128_call(q, bank_k, bank_v, count, scale, true_lk, qbias):
    """Launch K1×2ᵛ¹²⁸ on checked inputs: (out [B, Lq, 256] bf16, rec_h
    [B, 2, Lq, S] f32, each head's slot mass)."""
    s, b, lk, _ = bank_k.shape
    lq, heads = q.shape[1], NARROW_VALUES[0]
    _check(s <= V128_MAX_SLOTS, f"{s} slots (the kernel takes up to "
           f"{V128_MAX_SLOTS})")
    cl, _ = v128_launch_cluster(q)
    out = torch.empty((b, lq, q.shape[-1]), dtype=q.dtype, device=q.device)
    rec = torch.empty((b, heads, lq, s), dtype=torch.float32,
                      device=q.device)
    err = _v128_lib().rmem_bank_attention_infer_v128(
        q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
        None if qbias is None else qbias.data_ptr(), count.data_ptr(),
        out.data_ptr(), rec.data_ptr(), b, heads, lq, s, lk, true_lk, cl,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention_infer_v128")
    return out, rec


def infer_route(num_heads: int, dh: int, dv: int) -> str:
    """The CUDA kernel that takes an inference call of this head shape on
    the card: "slots" (K1's template: one or two heads of 128, values a
    multiple of 256 a head; or K1×2ᵛ¹²⁸, 2 heads of 128 with values 128 a
    head) or
    "heads" (K1ʰ: 8 heads of 32, values 32 a head). Any other shape
    raises."""
    if num_heads in SLOT_HEADS and dh == 128 and dv % 256 == 0:
        return "slots"
    if (num_heads, dh, dv) == NARROW_VALUES:
        return "slots"
    if (num_heads, dh, dv) == (MH_HEADS, MH_WIDTH, MH_WIDTH):
        return "heads"
    raise ValueError(f"bank_attention: {num_heads} heads of width {dh}, "
                     f"values {dv} a head (the kernels are held to their "
                     "plain version for one or two heads of 128, two of "
                     "128 with values 128, and 8 heads of 32)")


def train_route(num_heads: int, dh: int, dv: int) -> str:
    """The CUDA kernels that take a training call of this head shape on the
    card, by `infer_route`'s rule: "slots" (K1' and K2: one or two heads of
    128, values a multiple of 256 a head, or 2 heads of 128 with values 128
    a head) or "heads" (K1'ʰ and K2ʰ: 8 heads of 32). Any other shape
    raises."""
    return infer_route(num_heads, dh, dv)


def _check_mh(q, bank_k, bank_v, count, num_heads: int = MH_HEADS
              ) -> Tuple[int, int, int, int]:
    """K1ʰ's, K1'ʰ's and K2ʰ's common checks; returns (s, b, lq, lk)."""
    s, b, lk, ck = bank_k.shape
    lq = q.shape[1]
    _check_bf16(q, q=q, bank_k=bank_k, bank_v=bank_v)
    _check(num_heads == MH_HEADS and ck == MH_HEADS * MH_WIDTH
           and q.shape == (b, lq, ck) and bank_v.shape == bank_k.shape,
           f"q {tuple(q.shape)}, bank_k {tuple(bank_k.shape)}, bank_v "
           f"{tuple(bank_v.shape)} at {num_heads} heads (8 of 32)")
    _check_count(count, q)
    _check(s <= MH_MAX_SLOTS, f"{s} slots (the kernel takes up to "
           f"{MH_MAX_SLOTS})")
    return s, b, lq, lk


@functools.lru_cache(maxsize=None)
def _mh_lib():
    """csrc/bank_attention_mh.cu, its slots a block held to
    MH_SLOTS_PER_BLOCK once."""
    lib = build.load("bank_attention_mh")
    lib.rmem_bank_attention_mh_slots.argtypes = []
    lib.rmem_bank_attention_mh_slots.restype = _I
    groups_of = lib.rmem_bank_attention_mh_slots()
    _check(groups_of == MH_SLOTS_PER_BLOCK, f"the library walks {groups_of} "
           f"slots a block, the wrapper expects {MH_SLOTS_PER_BLOCK}")
    return lib


@functools.lru_cache(maxsize=None)
def _mh_entry():
    fn = _mh_lib().rmem_bank_attention_mh
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_F, _P]
    fn.restype = _I
    return fn


def _mh_parts(s: int, b: int, lq: int, itemsize: int, device,
              stream: int) -> Tuple[int, int, int]:
    """K1ʰ's partial state for s slots and b rows of (batch, head), in the
    workspace: the addresses of part_m [groups, b, Lq] f32, part_l
    [s, b, Lq] f32 and part_o [groups, b, Lq, 32] (`itemsize` bytes a
    value), each 256-byte aligned."""
    groups = -(-s // MH_SLOTS_PER_BLOCK)
    m_bytes, l_bytes = _aligned(groups * b * lq * 4), _aligned(s * b * lq * 4)
    base = _workspace(m_bytes + l_bytes + groups * b * lq * MH_WIDTH
                      * itemsize, device, stream)
    return base, base + m_bytes, base + m_bytes + l_bytes


@spanned("rmem.kernel.bank_attention_infer_mh")
def bank_attention_infer_mh(q: torch.Tensor, bank_k: torch.Tensor,
                            bank_v: torch.Tensor, count: torch.Tensor,
                            num_heads: int, scale: float,
                            true_lk: Optional[int] = None,
                            qbias: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1ʰ: `bank_attention_infer` at 8 heads of 32. q [B, Lq, 256] (head
    h owns columns 32h .. 32h + 31); bank_k, bank_v [S, B, Lk, 256] bf16,
    contiguous; count an int32 scalar on the card; keys >= true_lk masked;
    qbias [B, 8, Lq, S] f32 or None. Returns (out [B, Lq, 256] bf16, rec
    [B, Lq, S] f32, the kernel's per-head slot mass averaged over the
    heads)."""
    if not q.is_cuda:
        return bank_attention_plain(q, bank_k, bank_v, count, num_heads,
                                    scale, true_lk, qbias)
    out = _mh_call(q, bank_k, bank_v, count, num_heads, scale, true_lk,
                   qbias)
    bank_attention_infer_mh.launches += launched(bank_attention_infer_mh)
    return out


bank_attention_infer_mh.launches = 0


def _mh_call(q, bank_k, bank_v, count, num_heads, scale,
             true_lk: Optional[int] = None,
             qbias: Optional[torch.Tensor] = None):
    """Launch csrc/bank_attention_mh.cu, K1ʰ's and K3ʰ's kernel. Returns
    (out [B, Lq, 256] bf16, rec [B, Lq, S] f32, the head mean of the
    kernel's per-head slot mass)."""
    s, b, lq, lk = _check_mh(q, bank_k, bank_v, count, num_heads)
    true_lk = lk if true_lk is None else true_lk
    _check(0 < true_lk <= lk, f"true_lk {true_lk} for {lk} keys")
    if qbias is not None:
        _check(qbias.device == q.device and qbias.dtype == torch.float32
               and qbias.is_contiguous()
               and qbias.shape == (b, num_heads, lq, s),
               "qbias must be contiguous f32 [B, h, Lq, S]")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    parts = _mh_parts(s, b * num_heads, lq, 2, q.device, stream)
    out = torch.empty_like(q)
    rec_h = torch.empty((b, num_heads, lq, s), dtype=torch.float32,
                        device=q.device)
    err = _mh_entry()(
        q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
        None if qbias is None else qbias.data_ptr(), count.data_ptr(),
        *parts, out.data_ptr(), rec_h.data_ptr(), b, num_heads, lq, s, lk,
        true_lk, float(scale), stream)
    build.check(err, "bank_attention_mh")
    return out, rec_h.mean(dim=1)


@spanned("rmem.kernel.bank_attention_infer")
def bank_attention_infer(q: torch.Tensor, bank_k: torch.Tensor,
                         bank_v: torch.Tensor, count: torch.Tensor,
                         num_heads: int, scale: float,
                         true_lk: Optional[int] = None,
                         qbias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Lq, h*dh]; bank_k [S, B, Lk, h*dh]; bank_v [S, B, Lk, h*dv];
    count: int32 scalar tensor of valid slots, read on the device; keys
    >= true_lk masked; qbias [B, h, Lq, S] f32 or None. Returns (out
    [B, Lq, h*dv] in q's dtype, rec [B, Lq, S] f32). On the card: bf16
    q/k/v, all contiguous, at a head shape `infer_route` takes: one or two
    heads of 128 with dv a multiple of 256 a head, or two with dv 128,
    launch K1 (counted here), 8 heads of 32 go to `bank_attention_infer_mh`
    (K1ʰ, counted there). While a graph is traced, the call is the custom
    op rmem::bank_attention_infer (kernels/ops.py)."""
    if torch.compiler.is_compiling():
        from rmem_tpu_torch.kernels import ops  # noqa: F401 (registers)
        return torch.ops.rmem.bank_attention_infer(
            q, bank_k, bank_v, count, num_heads, float(scale), true_lk,
            qbias)
    if not q.is_cuda:
        return bank_attention_plain(q, bank_k, bank_v, count, num_heads,
                                    scale, true_lk, qbias)
    if infer_route(num_heads, q.shape[-1] // num_heads,
                   bank_v.shape[-1] // num_heads) == "heads":
        return bank_attention_infer_mh(q, bank_k, bank_v, count, num_heads,
                                       scale, true_lk, qbias)
    out = _slots_call(q, bank_k, bank_v, count, num_heads, scale, true_lk,
                      qbias)
    bank_attention_infer.launches += launched(bank_attention_infer)
    return out


bank_attention_infer.launches = 0


def bank_attention_qminor_plain(q: torch.Tensor, bank_k: torch.Tensor,
                                bank_v: torch.Tensor, count: torch.Tensor,
                                num_heads: int, scale: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: `bank_attention_plain` with every
    key valid and no bias."""
    return bank_attention_plain(q, bank_k, bank_v, count, num_heads, scale)


@spanned("rmem.kernel.bank_attention_qminor")
def bank_attention_qminor(q: torch.Tensor, bank_k: torch.Tensor,
                          bank_v: torch.Tensor, count: torch.Tensor,
                          num_heads: int, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Lq, h*dh]; bank_k [S, B, Lk, h*dh]; bank_v [S, B, Lk, h*dv];
    count: int32 scalar tensor of valid slots, read on the device. Returns
    (out [B, Lq, h*dv] in q's dtype, rec [B, Lq, S] f32, the head mean). On
    the card: bf16 q/k/v, all contiguous, at a head shape `infer_route`
    takes: K1's template walking SLOTS_PER_BLOCK slots a block, or at 8
    heads of 32 (K3ʰ) K1ʰ's kernel with no bias and every key valid, both
    counted here. While a graph is traced, the call is the custom op
    rmem::bank_attention_qminor (kernels/ops.py)."""
    if torch.compiler.is_compiling():
        from rmem_tpu_torch.kernels import ops  # noqa: F401 (registers)
        return torch.ops.rmem.bank_attention_qminor(
            q, bank_k, bank_v, count, num_heads, float(scale))
    if not q.is_cuda:
        return bank_attention_qminor_plain(q, bank_k, bank_v, count,
                                           num_heads, scale)
    if infer_route(num_heads, q.shape[-1] // num_heads,
                   bank_v.shape[-1] // num_heads) == "heads":
        out = _mh_call(q, bank_k, bank_v, count, num_heads, scale)
    else:
        out = _slots_call(q, bank_k, bank_v, count, num_heads, scale)
    bank_attention_qminor.launches += launched(bank_attention_qminor)
    return out


bank_attention_qminor.launches = 0


def bank_attention_lse_plain(q: torch.Tensor, bank_k: torch.Tensor,
                             bank_v: torch.Tensor, count: torch.Tensor,
                             scale: float, num_heads: int = 1,
                             true_lk: Optional[int] = None,
                             qbias: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K1''s function in plain PyTorch (f32), in its kernel's partial + merge
    form, which K1ʰ's and K1'ʰ's kernel shares: the valid slots in groups
    of SLOTS_PER_BLOCK (= MH_SLOTS_PER_BLOCK); each
    group's row maximum m_g of the scaled logits in log2 units, per-slot
    sums l_s relative to it and its output normalised by its own sum; then
    with w_g = 2^(m_g - M) sum_{s in g} l_s over the groups, out = sum_g w_g
    o_g / sum_g w_g, rec_s = 2^(m_g(s) - M) l_s / sum_g w_g and lse = (M +
    log2 sum_g w_g) ln 2. Keys >= true_lk masked (every key valid by
    default); qbias [B, h, Lq, S] (K1ʰ's slot-PE bias) added to the scaled
    logits. At one head returns (out [B, Lq, dv], rec [B, Lq, S], lse
    [B, Lq]); at h heads each head's columns take the one-head form: (out
    [B, Lq, h*dv], rec_h [B, h, Lq, S], lse_h [B, h, Lq]). All f32."""
    if num_heads > 1:
        dh, dv = q.shape[-1] // num_heads, bank_v.shape[-1] // num_heads
        outs, recs, lses = zip(*(bank_attention_lse_plain(
            q[..., h * dh:(h + 1) * dh], bank_k[..., h * dh:(h + 1) * dh],
            bank_v[..., h * dv:(h + 1) * dv], count, scale, 1, true_lk,
            None if qbias is None else qbias[:, h:h + 1])
            for h in range(num_heads)))
        return torch.cat(outs, -1), torch.stack(recs, 1), torch.stack(lses, 1)
    n = int(count)
    s = bank_k.shape[0]
    lk = bank_k.shape[2] if true_lk is None else true_lk
    logits = torch.einsum("bqd,sbkd->sbqk", q.float(),
                          bank_k[:n, :, :lk].float()) * (scale / math.log(2.0))
    if qbias is not None:                  # [B, 1, Lq, S], natural units
        logits = logits + (qbias[:, 0, :, :n].float().permute(2, 0, 1)
                           * _LOG2E)[..., None]
    ms, ls, os_ = [], [], []
    group = SLOTS_PER_BLOCK
    for g0 in range(0, n, group):
        lg = logits[g0:g0 + group]                       # [G, B, Lq, Lk]
        m = lg.amax(dim=(0, 3))                          # [B, Lq]
        p = torch.exp2(lg - m[None, :, :, None])
        l = p.sum(-1)                                    # [G, B, Lq]
        o = torch.einsum("sbqk,sbkv->bqv", p,
                         bank_v[g0:min(g0 + group, n), :, :lk].float())
        ms.append(m)
        ls.append(l)
        os_.append(o / l.sum(0)[..., None])
    big_m = torch.stack(ms).amax(0)
    scales = [torch.exp2(m - big_m) for m in ms]         # 2^(m_g - M)
    total = sum(a * l.sum(0) for a, l in zip(scales, ls))
    out = sum((a * l.sum(0))[..., None] * o
              for a, l, o in zip(scales, ls, os_)) / total[..., None]
    rec = torch.zeros(q.shape[0], q.shape[1], s, device=q.device)
    rec[..., :n] = torch.cat([a[None] * l for a, l in zip(scales, ls)]
                             ).permute(1, 2, 0) / total[..., None]
    lse = (big_m + torch.log2(total)) * math.log(2.0)
    return out, rec, lse


@spanned("rmem.kernel.bank_attention_lse")
def bank_attention_lse(q: torch.Tensor, bank_k: torch.Tensor,
                       bank_v: torch.Tensor, count: torch.Tensor,
                       scale: float, num_heads: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1' for training (card only): one or two heads of 128 with values a
    multiple of 256 a head (the f32 instantiation of
    csrc/bank_attention_infer.cu), or two heads of 128 with values 128 a
    head (K1'×2ᵛ¹²⁸, csrc/bank_attention_lse_v128.cu: one kernel, no
    partials); no bias, every key valid. Returns (out [B, Lq, h*dv] f32, rec
    [B, h, Lq, S] f32 each head's slot mass, lse [B, h, Lq] f32 the
    log-sum-exp of each head's row of scaled logits over the valid slots),
    the head axis dropped at one head, as `bank_attention_lse_plain` returns
    them. The output stays f32 for the backward's row term."""
    s, b, lq, lk, dh, dv = _check_bank(q, bank_k, bank_v, count, num_heads)
    if (num_heads, dh, dv) == NARROW_VALUES:
        out = _lse_v128_call(q, bank_k, bank_v, count, scale)
        bank_attention_lse.launches += launched(bank_attention_lse)
        return out
    _check(s <= 128, f"{s} slots (the merge takes up to 128)")
    fn = _lse_entry()
    part_m, part_l, part_o = _scratch(s, b * num_heads, lq, dv,
                                      torch.float32, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((b, lq, num_heads * dv), **f32)
    rec = torch.empty(_head_shape((b, num_heads, lq, s), num_heads, 1), **f32)
    lse = torch.empty(_head_shape((b, num_heads, lq), num_heads, 1), **f32)
    err = fn(q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(),
             count.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
             part_o.data_ptr(), out.data_ptr(), rec.data_ptr(),
             lse.data_ptr(), b, num_heads, lq, s, lk, dh, dv, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention_lse")
    bank_attention_lse.launches += launched(bank_attention_lse)
    return out, rec, lse


bank_attention_lse.launches = 0


def bank_attention_lse_v128_plain(q: torch.Tensor, bank_k: torch.Tensor,
                                  bank_v: torch.Tensor, count: torch.Tensor,
                                  scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """K1'×2ᵛ¹²⁸'s function in plain PyTorch (f32), in its kernel's form:
    per head, the valid slots' keys in chunks of V128_CHUNK (slot major,
    each slot's last chunk short at Lk), chunk j walked by consumer j %
    V128_CONSUMERS; each consumer's maximum m_c of its scaled logits (log2
    units), its per-slot sums l_c(s) and output O_c relative to it; then with
    M the larger maximum and w_c = 2^(m_c - M), out = sum_c w_c O_c /
    sum_c w_c L_c, rec_s = sum_c w_c l_c(s) / that sum and lse = (M + log2
    of it) ln 2. Returns (out [B, Lq, 256], rec_h [B, 2, Lq, S], lse_h
    [B, 2, Lq]), all f32."""
    heads = NARROW_VALUES[0]
    s, b, lk, _ = bank_k.shape
    lq, n = q.shape[1], int(count)
    qh = q.float().unflatten(-1, (heads, -1))             # [B, Lq, h, d]
    kh = bank_k[:n].float().unflatten(-1, (heads, -1))    # [n, B, Lk, h, d]
    vh = bank_v[:n].float().unflatten(-1, (heads, -1))
    logits = torch.einsum("bqhd,sbkhd->bhqsk", qh, kh) * (scale * _LOG2E)
    chunk = (torch.arange(n)[:, None] * -(-lk // V128_CHUNK)
             + torch.arange(lk) // V128_CHUNK)                  # [n, Lk]
    ms, ls, os_ = [], [], []
    for c in range(V128_CONSUMERS):
        mine = (chunk % V128_CONSUMERS == c).to(q.device)       # [n, Lk]
        x = torch.where(mine, logits, float("-inf"))
        m = x.flatten(-2).amax(-1)                               # [B, h, Lq]
        p = torch.exp2(x - torch.where(torch.isinf(m), 0.0, m)[..., None,
                                                                None])
        ls.append(p.sum(-1))                                     # [B,h,Lq,n]
        os_.append(torch.einsum("bhqsk,sbkhd->bhqd", p, vh))
        ms.append(m)
    big_m = torch.stack(ms).amax(0)
    w = [torch.where(torch.isinf(m), 0.0, torch.exp2(m - big_m)) for m in ms]
    total = sum(wc * lc.sum(-1) for wc, lc in zip(w, ls))
    out = sum(wc[..., None] * oc for wc, oc in zip(w, os_)) / total[..., None]
    rec = torch.zeros(b, heads, lq, s, device=q.device)
    rec[..., :n] = sum(wc[..., None] * lc for wc, lc in zip(w, ls)) / total[
        ..., None]
    lse = (big_m + torch.log2(total)) * math.log(2.0)
    return out.permute(0, 2, 1, 3).reshape(b, lq, -1), rec, lse


@functools.lru_cache(maxsize=None)
def _lse_v128_entry():
    """csrc/bank_attention_lse_v128.cu's C entry."""
    fn = build.load("bank_attention_lse_v128").rmem_bank_attention_lse_v128
    fn.argtypes = [_P] * 7 + [_I] * 5 + [_F, _P]
    fn.restype = _I
    return fn


def _lse_v128_call(q, bank_k, bank_v, count, scale):
    """Launch K1'×2ᵛ¹²⁸ on checked inputs: (out [B, Lq, 256] f32, rec_h
    [B, 2, Lq, S] f32, lse_h [B, 2, Lq] f32)."""
    s, b, lk, _ = bank_k.shape
    lq, heads = q.shape[1], NARROW_VALUES[0]
    _check(s <= V128_MAX_SLOTS, f"{s} slots (the kernel takes up to "
           f"{V128_MAX_SLOTS})")
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((b, lq, q.shape[-1]), **f32)
    rec = torch.empty((b, heads, lq, s), **f32)
    lse = torch.empty((b, heads, lq), **f32)
    err = _lse_v128_entry()(
        q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(), count.data_ptr(),
        out.data_ptr(), rec.data_ptr(), lse.data_ptr(), b, heads, lq, s, lk,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "bank_attention_lse_v128")
    return out, rec, lse


# ---- the backward (kernel K2) --------------------------------------------

def bank_attention_bwd_plain(q, bank_k, bank_v, count, dout, drec, scale,
                             num_heads: int = 1):
    """The whole backward in plain PyTorch: autograd of
    bank_attention_plain, f32. Returns (dq, dk, dv)."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in (q, bank_k,
                                                             bank_v)]
        out, rec = bank_attention_plain(*ins, count, num_heads, scale)
        return torch.autograd.grad((out, rec), ins,
                                   (dout.float(), drec.float()))


def _padded_rows(n: int) -> int:
    return (n + BLOCK_K - 1) // BLOCK_K * BLOCK_K


def _check_k2(q, bank_k, bank_v, dout, num_heads) -> Tuple[int, ...]:
    """The backward kernels' common checks at one or two heads of 128
    (K2, K2×2 and K2×2ᵛ¹²⁸), values a multiple of 128 a head; returns (s,
    b, lq, lk, dv), dv a head's."""
    s, b, lk, ck = bank_k.shape
    lq, dv = q.shape[1], bank_v.shape[-1] // num_heads
    _check_bf16(q, q=q, bank_k=bank_k, bank_v=bank_v, dout=dout)
    _check(num_heads in SLOT_HEADS and ck == num_heads * 128
           and q.shape == (b, lq, ck), f"q {tuple(q.shape)}, bank_k "
           f"{tuple(bank_k.shape)} at {num_heads} heads (one or two of 128)")
    _check(bank_v.shape[:3] == (s, b, lk)
           and dout.shape == (b, lq, num_heads * dv) and dv % 128 == 0,
           f"bank_v {tuple(bank_v.shape)}, dout {tuple(dout.shape)}")
    return s, b, lq, lk, dv


def bank_attention_bwd(q, bank_k, bank_v, count, out, rec, lse, dout, drec,
                       scale, num_heads: int = 1):
    """K2 on the card: (dq, dk, dv) in bf16 from the forward's inputs,
    outputs (out f32, each head's slot mass rec) and lse as
    `bank_attention_lse` gives them, and the cotangents dout (bf16) and drec
    (f32, of the head-mean record). Each head's row term is `bwd_delta_mh`'s,
    over its own value columns. The head shape picks the kernels
    (`bwd_route`): K2×2ᵛ¹²⁸'s fused pair at 2 heads of 128 with values 128
    a head, else K2's dq, dk and dv kernels with dV split by value columns
    (`bank_attention_bwd_split`). CPU tensors take the route's plain form
    (f32)."""
    b, lq = q.shape[:2]
    rec_h = rec.reshape(b, num_heads, lq, -1)
    lse_h = lse.reshape(b, num_heads, lq)
    delta_h = bwd_delta_mh(dout, out, drec, rec_h)
    if bwd_route(num_heads, q.shape[-1] // num_heads,
                 bank_v.shape[-1] // num_heads) == "fused":
        return bank_attention_bwd_fused(q, bank_k, bank_v, count, dout,
                                        lse_h, delta_h, drec, scale)
    return bank_attention_bwd_split(q, bank_k, bank_v, count, dout, lse_h,
                                    delta_h, drec, scale)


def bwd_route(num_heads: int, dh: int, dv: int) -> str:
    """The CUDA kernels that take the bank attention's backward of this
    head shape on the card: `train_route`'s rule with its "slots" split in
    two, "fused" (K2×2ᵛ¹²⁸, csrc/bank_attention_bwd_fused.cu: NARROW_VALUES,
    each kernel holding a whole head's dV) and "split" (K2 and K2×2,
    csrc/bank_attention_bwd.cu: one or two heads of 128 with values a
    multiple of 256 a head, dV split across blocks by value columns), and
    "heads" (K2ʰ, csrc/bank_attention_mh_bwd.cu). None writes p or ds to
    device memory. Any other shape raises."""
    route = train_route(num_heads, dh, dv)
    if route == "heads":
        return route
    return "fused" if (num_heads, dh, dv) == NARROW_VALUES else "split"


def bank_attention_bwd_fused_plain(q, bank_k, bank_v, count, dout, lse_h,
                                   delta_h, drec, scale):
    """K2×2ᵛ¹²⁸'s kernels in plain PyTorch (f32), in their own form, each
    recomputing p and ds from the lse (`_mh_p_ds`): dk = scale sum_i ds q
    and dv = sum_i p dout (the dkv kernel's, zero in slots >= count), and dq
    as the dq kernel's partials, scale x the sum over the valid slots'
    groups of FUSED_DQ_SLOTS, in group order, of each group's ds K. Returns
    (dq [B, Lq, h*dh], dk, dv [S, B, Lk, h*d])."""
    b, lq = q.shape[:2]
    s, heads, n = bank_k.shape[0], lse_h.shape[1], int(count)
    dq = torch.zeros(b, lq, q.shape[-1], device=q.device)
    for g0 in range(0, n, FUSED_DQ_SLOTS):
        slots = slice(g0, min(g0 + FUSED_DQ_SLOTS, n))
        _, ds = _mh_p_ds(q, bank_k, bank_v, count, dout, lse_h, delta_h,
                         drec, scale, slots)
        part = torch.einsum("bhqsk,sbkhd->bqhd", ds, bank_k[slots].float()
                            .unflatten(-1, (heads, -1)))
        dq = dq + part.flatten(-2)
    dk, dv = bank_attention_bwd_mh_dkv_plain(q, bank_k, bank_v, count, dout,
                                             lse_h, delta_h, drec, scale)
    return dq * scale, dk, dv


@functools.lru_cache(maxsize=None)
def _fused_lib():
    """csrc/bank_attention_bwd_fused.cu, its slots a dq block walks held to
    FUSED_DQ_SLOTS once."""
    lib = build.load("bank_attention_bwd_fused")
    lib.rmem_bank_attention_bwd_fused_slots.argtypes = []
    lib.rmem_bank_attention_bwd_fused_slots.restype = _I
    groups_of = lib.rmem_bank_attention_bwd_fused_slots()
    _check(groups_of == FUSED_DQ_SLOTS, f"the library's dq walks {groups_of} "
           f"slots a block, the wrapper expects {FUSED_DQ_SLOTS}")
    for name, n_ptr in (("rmem_bank_attention_bwd_fused_dkv", 9),
                        ("rmem_bank_attention_bwd_fused_dq", 9)):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * n_ptr + [_I] * 6 + [_F, _P]
        fn.restype = _I
    return lib


def fused_rows(lse_h: torch.Tensor, delta_h: torch.Tensor,
               drec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2×2ᵛ¹²⁸'s two row arrays from lse_h, delta_h [B, h, Lq] and drec
    [B, Lq, S] (f32), the queries padded to 64: lse2 = lse_h log2(e)
    [B, h, LqP] (+inf past Lq, so a padded query's p is 0) and rterm =
    drec / h - delta_h [B, h, S, LqP] (0 past Lq)."""
    b, heads, lq = lse_h.shape
    lqp = _padded_rows(lq)
    lse2 = torch.full((b, heads, lqp), float("inf"), dtype=torch.float32,
                      device=lse_h.device)
    lse2[..., :lq] = lse_h * _LOG2E
    rterm = torch.zeros((b, heads, drec.shape[-1], lqp), dtype=torch.float32,
                        device=lse_h.device)
    rterm[..., :lq] = (drec.transpose(1, 2)[:, None] / heads
                       - delta_h[:, :, None])
    return lse2, rterm


def _fused_call(stage: str, q, bank_k, bank_v, count, dout, lse2, rterm,
                scale):
    """Launch one kernel of K2×2ᵛ¹²⁸ ("dkv": dk, dv; "dq": the dq kernel and
    the sum of its partials) on checked inputs."""
    s, b, lk, _ = bank_k.shape
    lq, lqp = q.shape[1], lse2.shape[-1]
    lib = _fused_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, bank_k, bank_v, dout, lse2, rterm,
                                   count)]
    dims = (b, NARROW_VALUES[0], lq, s, lk, lqp, float(scale), stream)
    if stage == "dkv":
        dk, dv = torch.empty_like(bank_k), torch.empty_like(bank_v)
        err = lib.rmem_bank_attention_bwd_fused_dkv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *dims)
        build.check(err, "bank_attention_bwd_fused_dkv")
        return dk, dv
    # dq's f32 partials [groups, B, Lq, 256]
    part = _workspace(-(-s // FUSED_DQ_SLOTS) * b * lq * q.shape[-1] * 4,
                      q.device, stream)
    dq = torch.empty_like(q)
    err = lib.rmem_bank_attention_bwd_fused_dq(*ptrs, part, dq.data_ptr(),
                                               *dims)
    build.check(err, "bank_attention_bwd_fused_dq")
    return dq


@spanned("rmem.kernel.bank_attention_bwd_fused", backward=True)
def bank_attention_bwd_fused(q, bank_k, bank_v, count, dout, lse_h, delta_h,
                             drec, scale):
    """K2×2ᵛ¹²⁸: (dq, dk, dv) at 2 heads of 128 with values 128 a head,
    from the forward's inputs, each head's lse_h and row term delta_h
    (`bwd_delta_mh`) [B, 2, Lq] and the cotangents dout [B, Lq, 256] (bf16
    on the card) and drec [B, Lq, S] (f32, of the head-mean record): the
    dkv kernel, the dq kernel and the sum of its slot groups' partials, no
    p/ds scratch. bf16 on the card, dk and dv exactly 0 in slots >= count;
    CPU tensors take the plain version (f32)."""
    if not q.is_cuda:
        return bank_attention_bwd_fused_plain(q, bank_k, bank_v, count, dout,
                                              lse_h, delta_h, drec, scale)
    s, b, lq, lk, dv = _check_k2(q, bank_k, bank_v, dout, NARROW_VALUES[0])
    _check(bwd_route(NARROW_VALUES[0], 128, dv) == "fused",
           f"values {dv} a head (the fused backward takes 128)")
    _check(s <= 128, f"{s} slots (the kernels take up to 128)")
    for name, t, shape in (("lse_h", lse_h, (b, 2, lq)),
                           ("delta_h", delta_h, (b, 2, lq)),
                           ("drec", drec, (b, lq, s))):
        _check(t.device == q.device and t.dtype == torch.float32
               and t.is_contiguous() and tuple(t.shape) == shape,
               f"{name} must be contiguous f32 {shape}")
    _check_count(count, q)
    lse2, rterm = fused_rows(lse_h, delta_h, drec)
    args = (q, bank_k, bank_v, count, dout, lse2, rterm, scale)
    dk, dv = _fused_call("dkv", *args)
    dq = _fused_call("dq", *args)
    bank_attention_bwd_fused.launches += launched(bank_attention_bwd_fused)
    return dq, dk, dv


bank_attention_bwd_fused.launches = 0


def bank_attention_bwd_split_plain(q, bank_k, bank_v, count, dout, lse_h,
                                   delta_h, drec, scale):
    """K2's kernels in plain PyTorch (f32), in their own form, from the
    same row arrays (`fused_rows`: lse2 [B, h, LqP], rterm [B, h, S, LqP]),
    each role recomputing p = 2^(q.k scale log2(e) - lse2) and ds = p
    (dout.v + rterm) per slot: dk = scale sum_i ds q (the dk kernel's), dv
    per group of SPLIT_DV_COLUMNS value columns, each with its own p (the dv
    kernel's), both zero in slots >= count, and dq as the dq kernel's
    partials, scale x the sum over the valid slots' groups of
    SPLIT_DQ_SLOTS, in group order, of each group's ds K. lse_h, delta_h
    [B, h, Lq], drec [B, Lq, S] over the bank's S slots. Returns (dq
    [B, Lq, h*dh], dk [S, B, Lk, h*dh], dv [S, B, Lk, h*dv])."""
    lse2, rterm = fused_rows(lse_h.float(), delta_h.float(), drec.float())
    lq, heads, n = q.shape[1], lse2.shape[1], int(count)
    lse2, rterm = lse2[..., :lq], rterm[..., :lq]
    qh, oh = (t.float().unflatten(-1, (heads, -1)) for t in (q, dout))
    kh, vh = (t.float().unflatten(-1, (heads, -1)) for t in (bank_k, bank_v))

    def p_of(sl):
        x = torch.einsum("bqhd,bkhd->bhqk", qh, kh[sl]) * (scale * _LOG2E)
        return torch.exp2(x - lse2[..., None])

    def ds_of(sl):
        return p_of(sl) * (torch.einsum("bqhd,bkhd->bhqk", oh, vh[sl])
                           + rterm[:, :, sl, :, None])

    dq = torch.zeros_like(qh)
    for g0 in range(0, n, SPLIT_DQ_SLOTS):
        part = torch.zeros_like(dq)
        for sl in range(g0, min(g0 + SPLIT_DQ_SLOTS, n)):
            part = part + torch.einsum("bhqk,bkhd->bqhd", ds_of(sl), kh[sl])
        dq = dq + part
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for sl in range(n):
        dk[sl] = torch.einsum("bhqk,bqhd->bkhd", ds_of(sl), qh) * scale
        for c0 in range(0, vh.shape[-1], SPLIT_DV_COLUMNS):
            cols = slice(c0, c0 + SPLIT_DV_COLUMNS)
            dv[sl, ..., cols] = torch.einsum("bhqk,bqhd->bkhd", p_of(sl),
                                             oh[..., cols])
    return (dq * scale).flatten(-2), dk.flatten(-2), dv.flatten(-2)


@functools.lru_cache(maxsize=None)
def _split_lib():
    """csrc/bank_attention_bwd.cu, its slot group and value group held to
    SPLIT_DQ_SLOTS and SPLIT_DV_COLUMNS once."""
    lib = build.load("bank_attention_bwd")
    for name, want in (("rmem_bank_attention_bwd_split_slots",
                        SPLIT_DQ_SLOTS),
                       ("rmem_bank_attention_bwd_split_columns",
                        SPLIT_DV_COLUMNS)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
        _check(fn() == want, f"{name}: the library's {fn()}, the wrapper "
               f"expects {want}")
    for stage, n_ptr in (("dq", 9), ("dk", 8), ("dv", 8)):
        fn = getattr(lib, f"rmem_bank_attention_bwd_split_{stage}")
        fn.argtypes = [_P] * n_ptr + [_I] * 7 + [_F, _P]
        fn.restype = _I
    return lib


def _split_call(stage: str, q, bank_k, bank_v, count, dout, lse2, rterm,
                scale):
    """Launch one role of K2 on checked inputs: "dq" (the dq kernel and the
    sum of its slot groups' partials, taken from the workspace), "dk" or
    "dv"."""
    s, b, lk, ck = bank_k.shape
    lq, lqp = q.shape[1], lse2.shape[-1]
    heads = lse2.shape[1]
    lib = _split_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, bank_k, bank_v, dout, lse2, rterm,
                                   count)]
    dims = (b, heads, lq, s, lk, lqp, bank_v.shape[-1] // heads, float(scale),
            stream)
    if stage == "dq":
        # the f32 partials [groups, B, Lq, h*128]
        part = _workspace(-(-s // SPLIT_DQ_SLOTS) * b * lq * ck * 4,
                          q.device, stream)
        out = torch.empty_like(q)
        err = lib.rmem_bank_attention_bwd_split_dq(*ptrs, part,
                                                   out.data_ptr(), *dims)
    else:
        out = torch.empty_like(bank_k if stage == "dk" else bank_v)
        err = getattr(lib, f"rmem_bank_attention_bwd_split_{stage}")(
            *ptrs, out.data_ptr(), *dims)
    build.check(err, f"bank_attention_bwd_split_{stage}")
    return out


@spanned("rmem.kernel.bank_attention_bwd_split", backward=True)
def bank_attention_bwd_split(q, bank_k, bank_v, count, dout, lse_h, delta_h,
                             drec, scale):
    """K2 and K2×2: (dq, dk, dv) at one or two heads of 128 with values a
    multiple of 256 a head (up to SPLIT_MAX_VALUES), from the forward's
    inputs, each head's lse_h and row term delta_h (`bwd_delta_mh`)
    [B, h, Lq] and the cotangents dout [B, Lq, h*dv] (bf16 on the card) and
    drec [B, Lq, S] (f32, of the head-mean record). On the card: the dq
    kernel and the sum of its slot groups' partials, the dk kernel and the
    dv kernel (dV split across blocks by SPLIT_DV_COLUMNS value columns),
    no p/ds scratch; bf16, dk and dv exactly 0 in slots >= count. CPU
    tensors take the plain form (f32)."""
    if not q.is_cuda:
        return bank_attention_bwd_split_plain(q, bank_k, bank_v, count, dout,
                                              lse_h, delta_h, drec, scale)
    heads = lse_h.shape[1]
    s, b, lq, lk, dv = _check_k2(q, bank_k, bank_v, dout, heads)
    _check(bwd_route(heads, 128, dv) == "split" and dv <= SPLIT_MAX_VALUES,
           f"values {dv} a head (the split backward takes a multiple of 256 "
           f"up to {SPLIT_MAX_VALUES}; 128 at two heads is the fused pair's)")
    _check(s <= 128, f"{s} slots (the kernels take up to 128)")
    for name, t, shape in (("lse_h", lse_h, (b, heads, lq)),
                           ("delta_h", delta_h, (b, heads, lq)),
                           ("drec", drec, (b, lq, s))):
        _check(t.device == q.device and t.dtype == torch.float32
               and t.is_contiguous() and tuple(t.shape) == shape,
               f"{name} must be contiguous f32 {shape}")
    _check_count(count, q)
    lse2, rterm = fused_rows(lse_h, delta_h, drec)
    args = (q, bank_k, bank_v, count, dout, lse2, rterm, scale)
    dq = _split_call("dq", *args)
    dk = _split_call("dk", *args)
    dv = _split_call("dv", *args)
    bank_attention_bwd_split.launches += launched(bank_attention_bwd_split)
    return dq, dk, dv


bank_attention_bwd_split.launches = 0


# ---- training at 8 heads of 32 (kernels K1'ʰ and K2ʰ) --------------------

def bank_attention_lse_mh_plain(q: torch.Tensor, bank_k: torch.Tensor,
                                bank_v: torch.Tensor, count: torch.Tensor,
                                scale: float, num_heads: int = MH_HEADS
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """K1'ʰ's function in plain PyTorch (f32): per head, one softmax over
    every key of the valid slots. Returns (out [B, Lq, h*dv], rec_h
    [B, h, Lq, S] each head's slot mass, 0 past count, and lse_h [B, h, Lq]
    the natural-log log-sum-exp of each row's scaled logits)."""
    s, b, lk, ck = bank_k.shape
    lq = q.shape[1]
    dh, dv = ck // num_heads, bank_v.shape[-1] // num_heads
    logits = torch.einsum(
        "bqhd,sbkhd->bhqsk", q.float().reshape(b, lq, num_heads, dh),
        bank_k.float().reshape(s, b, lk, num_heads, dh)) * scale
    valid = torch.arange(s, device=q.device) < count
    logits = torch.where(valid[:, None], logits, float("-inf"))
    lse = logits.flatten(-2).logsumexp(-1)                   # [B, h, Lq]
    p = torch.exp(logits - lse[..., None, None])
    out = torch.einsum("bhqsk,sbkhd->bqhd", p,
                       bank_v.float().reshape(s, b, lk, num_heads, dv))
    return out.reshape(b, lq, num_heads * dv), p.sum(-1), lse


@functools.lru_cache(maxsize=None)
def _mh_lse_entry():
    fn = _mh_lib().rmem_bank_attention_mh_lse
    fn.argtypes = [_P] * 10 + [_I] * 5 + [_F, _P]
    fn.restype = _I
    return fn


@spanned("rmem.kernel.bank_attention_lse_mh")
def bank_attention_lse_mh(q: torch.Tensor, bank_k: torch.Tensor,
                          bank_v: torch.Tensor, count: torch.Tensor,
                          scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K1'ʰ: training's forward at 8 heads of 32, every key valid, no
    bias. q [B, Lq, 256]; bank_k, bank_v [S, B, Lk, 256] bf16, contiguous;
    count an int32 scalar on the card. Returns (out [B, Lq, 256] f32, rec_h
    [B, 8, Lq, S] f32, lse_h [B, 8, Lq] f32). The output stays f32 for the
    backward's row term. CPU tensors take the plain version."""
    if not q.is_cuda:
        return bank_attention_lse_mh_plain(q, bank_k, bank_v, count, scale)
    s, b, lq, lk = _check_mh(q, bank_k, bank_v, count)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    parts = _mh_parts(s, b * MH_HEADS, lq, 4, q.device, stream)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((b, lq, MH_HEADS * MH_WIDTH), **f32)
    rec_h = torch.empty((b, MH_HEADS, lq, s), **f32)
    lse_h = torch.empty((b, MH_HEADS, lq), **f32)
    err = _mh_lse_entry()(
        q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(), count.data_ptr(),
        *parts, out.data_ptr(), rec_h.data_ptr(), lse_h.data_ptr(), b,
        MH_HEADS, lq, s, lk, float(scale), stream)
    build.check(err, "bank_attention_mh_lse")
    bank_attention_lse_mh.launches += launched(bank_attention_lse_mh)
    return out, rec_h, lse_h


bank_attention_lse_mh.launches = 0


def bwd_delta_mh(dout: torch.Tensor, out: torch.Tensor, drec: torch.Tensor,
                 rec_h: torch.Tensor) -> torch.Tensor:
    """delta_h [B, h, Lq] f32: per head, the rowsum over its columns of
    dout * out plus rowsum_s(drec / h * rec_h); the record is the head mean
    of the slot mass, so each head takes drec / h."""
    b, heads, lq, _ = rec_h.shape
    do = (dout.float() * out.float()).reshape(b, lq, heads, -1).sum(-1)
    dr = (drec.float()[:, None] / heads * rec_h.float()).sum(-1)
    return (do.transpose(1, 2) + dr).contiguous()


def _mh_p_ds(q, bank_k, bank_v, count, dout, lse_h, delta_h, drec, scale,
             slots: slice = slice(None)):
    """The backward's p and ds at any head shape (the heads are lse_h's,
    [B, h, Lq]: K2ʰ's 8, K2×2ᵛ¹²⁸'s 2), f32 [B, h, Lq, S', Lk]
    over the bank's slots `slots` (all by default), zero in slots >= count,
    each recomputed from the lse as the kernels do: p = exp(q.k scale -
    lse), ds = p (dout.v + drec / h - delta)."""
    bank_k, bank_v = bank_k[slots], bank_v[slots]
    s, b, lk, ck = bank_k.shape
    heads, lq = lse_h.shape[1], q.shape[1]
    dh, dv = ck // heads, bank_v.shape[-1] // heads
    logits = torch.einsum(
        "bqhd,sbkhd->bhqsk", q.float().reshape(b, lq, heads, dh),
        bank_k.float().reshape(s, b, lk, heads, dh)) * scale
    index = torch.arange(drec.shape[-1], device=q.device)[slots]
    valid = index < count
    p = torch.where(valid[:, None],
                    torch.exp(logits - lse_h.float()[..., None, None]), 0.0)
    g = torch.einsum("bqhd,sbkhd->bhqsk",
                     dout.float().reshape(b, lq, heads, dv),
                     bank_v.float().reshape(s, b, lk, heads, dv))
    r = (drec.float()[..., slots] / heads)[:, None, :, :, None]
    return p, p * (g + r - delta_h.float()[..., None, None])


def bank_attention_bwd_mh_dq_plain(q, bank_k, bank_v, count, dout, lse_h,
                                   delta_h, drec, scale):
    """K2ʰ's dq kernel in plain PyTorch (head-generic: the heads are
    lse_h's): dq = scale * sum over the valid slots' keys of
    ds k, f32 [B, Lq, h*dh]."""
    s, b, lk, ck = bank_k.shape
    heads = lse_h.shape[1]
    _, ds = _mh_p_ds(q, bank_k, bank_v, count, dout, lse_h, delta_h, drec,
                     scale)
    dq = torch.einsum("bhqsk,sbkhd->bqhd", ds,
                      bank_k.float().reshape(s, b, lk, heads, -1)) * scale
    return dq.reshape(q.shape)


def bank_attention_bwd_mh_dkv_plain(q, bank_k, bank_v, count, dout, lse_h,
                                    delta_h, drec, scale):
    """K2ʰ's dkv kernel in plain PyTorch (head-generic, as the dq stage):
    dk = scale * sum_i ds q, dv = sum_i p dout, f32 [S, B, Lk, h*d], zero in
    slots >= count."""
    b, lq = q.shape[:2]
    heads = lse_h.shape[1]
    p, ds = _mh_p_ds(q, bank_k, bank_v, count, dout, lse_h, delta_h, drec,
                     scale)
    dk = torch.einsum("bhqsk,bqhd->sbkhd", ds,
                      q.float().reshape(b, lq, heads, -1)) * scale
    dv = torch.einsum("bhqsk,bqhd->sbkhd", p,
                      dout.float().reshape(b, lq, heads, -1))
    return dk.flatten(-2), dv.flatten(-2)


def bank_attention_bwd_mh_form_plain(q, bank_k, bank_v, count, dout, lse2,
                                     rterm, scale):
    """K2ʰ's dkv, dq and dq-sum kernels in plain PyTorch (f32), in their own
    form, from the rows kernel's arrays (`fused_rows`: lse2 [B, 8, LqP],
    rterm [B, 8, S, LqP]): p = 2^(q.k scale log2(e) - lse2), ds = p (dout.v
    + rterm), dk = scale sum_i ds q and dv = sum_i p dout (zero in slots >=
    count), and dq as the dq kernel's partials, scale x the sum over the
    valid slots' groups of MH_BWD_DQ_SLOTS, in group order, of each group's
    ds K. Returns (dq [B, Lq, 256], dk, dv [S, B, Lk, 256])."""
    s, b, lk, _ = bank_k.shape
    lq, heads, n = q.shape[1], lse2.shape[1], int(count)
    qh, oh = (t.float().unflatten(-1, (heads, -1)) for t in (q, dout))
    kh, vh = (t.float().unflatten(-1, (heads, -1)) for t in (bank_k, bank_v))
    dq = torch.zeros(b, lq, heads, qh.shape[-1], device=q.device)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for g0 in range(0, n, MH_BWD_DQ_SLOTS):
        part = torch.zeros_like(dq)
        for sl in range(g0, min(g0 + MH_BWD_DQ_SLOTS, n)):
            x = torch.einsum("bqhd,bkhd->bhqk", qh, kh[sl]) * (scale * _LOG2E)
            p = torch.exp2(x - lse2[..., :lq, None])
            ds = p * (torch.einsum("bqhd,bkhd->bhqk", oh, vh[sl])
                      + rterm[:, :, sl, :lq, None])
            part = part + torch.einsum("bhqk,bkhd->bqhd", ds, kh[sl])
            dk[sl] = torch.einsum("bhqk,bqhd->bkhd", ds, qh) * scale
            dv[sl] = torch.einsum("bhqk,bqhd->bkhd", p, oh)
        dq = dq + part
    return (dq * scale).flatten(-2), dk.flatten(-2), dv.flatten(-2)


@functools.lru_cache(maxsize=None)
def _mh_bwd_entry():
    """csrc/bank_attention_mh_bwd.cu's C entry."""
    fn = build.load("bank_attention_mh_bwd").rmem_bank_attention_mh_bwd
    fn.argtypes = [_P] * 15 + [_I] * 5 + [_F, _P]
    fn.restype = _I
    return fn


@spanned("rmem.kernel.bank_attention_bwd_mh", backward=True)
def bank_attention_bwd_mh(q, bank_k, bank_v, count, out, rec_h, lse_h, dout,
                          drec, scale):
    """K2ʰ: (dq, dk, dv) at 8 heads of 32 from the forward's inputs, its f32
    output `out` [B, Lq, 256], slot mass `rec_h` [B, 8, Lq, S] and lse_h
    [B, 8, Lq], and the cotangents dout [B, Lq, 256] (bf16 on the card) and
    drec [B, Lq, S] (f32, of the head mean). On the card one call launches
    the rows kernel (each head's row terms, delta_h among them), the dkv
    kernel, the dq kernel and the sum of its slot groups' partials (taken
    from the workspace); bf16 out, dk and dv exactly 0 in slots >= count.
    CPU tensors take the plain stages (f32), delta_h from `bwd_delta_mh`."""
    if not q.is_cuda:
        args = (q, bank_k, bank_v, count, dout, lse_h,
                bwd_delta_mh(dout, out, drec, rec_h), drec, scale)
        return (bank_attention_bwd_mh_dq_plain(*args),
                *bank_attention_bwd_mh_dkv_plain(*args))
    s, b, lq, lk = _check_mh(q, bank_k, bank_v, count)
    _check_bf16(q, dout=dout)
    _check(dout.shape == q.shape, f"dout shape {tuple(dout.shape)}")
    rows = (b, MH_HEADS, lq)
    for name, t, shape in (("out", out, q.shape), ("rec_h", rec_h, (*rows, s)),
                           ("lse_h", lse_h, rows), ("drec", drec, (b, lq, s))):
        _check(t.device == q.device and t.dtype == torch.float32
               and t.is_contiguous() and tuple(t.shape) == tuple(shape),
               f"{name} must be contiguous f32 {tuple(shape)}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lqp = _padded_rows(lq)
    lse2_b = _aligned(b * MH_HEADS * lqp * 4)
    rterm_b = _aligned(b * MH_HEADS * s * lqp * 4)
    base = _workspace(lse2_b + rterm_b + -(-s // MH_BWD_DQ_SLOTS) * b * lq
                      * q.shape[-1] * 4, q.device, stream)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(bank_k), torch.empty_like(bank_v)
    err = _mh_bwd_entry()(
        q.data_ptr(), bank_k.data_ptr(), bank_v.data_ptr(), dout.data_ptr(),
        out.data_ptr(), rec_h.data_ptr(), lse_h.data_ptr(),
        drec.data_ptr(), count.data_ptr(), base,
        base + lse2_b, base + lse2_b + rterm_b, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, MH_HEADS, lq, s, lk, float(scale), stream)
    build.check(err, "bank_attention_mh_bwd")
    bank_attention_bwd_mh.launches += launched(bank_attention_bwd_mh)
    return dq, dk, dv


bank_attention_bwd_mh.launches = 0


class _BankAttentionMH(torch.autograd.Function):
    """K1'ʰ forward, K2ʰ backward (bf16 tensors on the card, 8 heads of
    32); the record is the head mean of the slot mass, as `_unlayout_out`
    returns it."""

    @staticmethod
    def forward(ctx, q, bank_k, bank_v, count, scale):
        out, rec_h, lse_h = bank_attention_lse_mh(q, bank_k, bank_v, count,
                                                  scale)
        ctx.save_for_backward(q, bank_k, bank_v, count, out, rec_h, lse_h)
        ctx.scale = scale
        return out.to(q.dtype), rec_h.mean(dim=1)

    @staticmethod
    def backward(ctx, dout, drec):
        q, bank_k, bank_v, count, out, rec_h, lse_h = ctx.saved_tensors
        # FIFO eviction reads no slot mass, so drec arrives as zeros
        dout = (torch.zeros_like(q) if dout is None
                else dout.to(q.dtype).contiguous())
        drec = (rec_h.new_zeros(rec_h[:, 0].shape) if drec is None
                else drec.float().contiguous())
        dq, dk, dv = bank_attention_bwd_mh(q, bank_k, bank_v, count, out,
                                           rec_h, lse_h, dout, drec,
                                           ctx.scale)
        return dq, dk, dv, None, None


class _BankAttention(torch.autograd.Function):
    """K1' forward, K2 backward (bf16 tensors on the card, one or two heads
    of 128); the record is the head mean of the slot mass."""

    @staticmethod
    def forward(ctx, q, bank_k, bank_v, count, scale, num_heads):
        out, rec, lse = bank_attention_lse(q, bank_k, bank_v, count, scale,
                                           num_heads)
        ctx.save_for_backward(q, bank_k, bank_v, count, out, rec, lse)
        ctx.args = (scale, num_heads)
        return out.to(q.dtype), rec if num_heads == 1 else rec.mean(dim=1)

    @staticmethod
    def backward(ctx, dout, drec):
        q, bank_k, bank_v, count, out, rec, lse = ctx.saved_tensors
        # FIFO eviction reads no slot mass, so drec arrives as zeros
        dout = (out.new_zeros(out.shape, dtype=torch.bfloat16)
                if dout is None else dout.to(torch.bfloat16).contiguous())
        drec = (rec.new_zeros((*q.shape[:2], bank_k.shape[0]))
                if drec is None else drec.float().contiguous())
        dq, dk, dv = bank_attention_bwd(q, bank_k, bank_v, count, out, rec,
                                        lse, dout, drec, *ctx.args)
        return dq, dk, dv, None, None, None


def bank_attention_train(q: torch.Tensor, bank_k: torch.Tensor,
                         bank_v: torch.Tensor, count: torch.Tensor,
                         scale: float, num_heads: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable bank attention, every key valid: q [B, Lq, h*dh],
    bank_k [S, B, Lk, h*dh], bank_v [S, B, Lk, h*dv], count the valid slots
    (int32 on q's device). Returns (out [B, Lq, h*dv], rec [B, Lq, S], the
    head-mean slot mass). On the card the inputs are taken in bf16 (the
    kernels' type, as autocast takes a matmul's), the output given back in
    q's dtype where no autocast runs (f32 compute), and the head shape
    picks the
    kernels (`train_route`: K1'/K2 at one or two heads of 128, K1'ʰ/K2ʰ at
    8 heads of 32, any other shape raises); on the CPU it is autograd
    through the plain version."""
    if not q.is_cuda:
        return bank_attention_plain(q, bank_k, bank_v, count, num_heads,
                                    scale)
    route = train_route(num_heads, q.shape[-1] // num_heads,
                        bank_v.shape[-1] // num_heads)
    bf = torch.bfloat16
    ins = (q.to(bf).contiguous(), bank_k.to(bf).contiguous(),
           bank_v.to(bf).contiguous(), count, scale)
    if route == "heads":
        out, rec = _BankAttentionMH.apply(*ins)
    else:
        out, rec = _BankAttention.apply(*ins, num_heads)
    if not torch.is_autocast_enabled(q.device.type):
        out = out.to(q.dtype)
    return out, rec

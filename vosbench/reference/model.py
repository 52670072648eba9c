"""The plain reference of the two benchmarked models, R50-AOTL and
R50-DeAOTL with RMem (and the tiny test encoder), in plain PyTorch.

Written from the published description of AOT (Yang et al., NeurIPS
2021), DeAOT (Yang and Yang, NeurIPS 2022) and RMem (Zhou et al., CVPR
2024) as the package under test implements them, with no kernel, no cache
and no batching trick: every product is an f32 matmul or conv whose
operands pass through `Numerics.q` (identity for the reference, fp8
rounding for the control). It imports nothing of the package under test.
Parameter names are the package's, so its `state_dict` loads here
strictly.

Departures from the program, each exact in real arithmetic:
- the encoder's frozen BN stays a separate affine (the program folds it
  into the convs when it serves in bf16);
- the slot temporal PE is added to the bank's keys (the program's serving
  kernels take it as a logit bias q.pe * scale);
- the bank attention reads only the valid slots, and the local attention is
  dense attention masked to the 15 x 15 window.

With `Numerics.counting` set (a meta-device FLOP count), the local
attention adds its windowed products to `Numerics.extra_flops` and returns
zeros, so a FLOP counter counts what the model needs, not the dense form.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vosbench.reference.numerics import Numerics

NEG_INF = -1e30
MAX_LOCAL_DIS = 7


# ---- layers ---------------------------------------------------------------

class Lin(nn.Module):
    """A dense layer: weight [out, in], bias [out]."""

    def __init__(self, num: Numerics, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.zeros(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(self.num.q(x), self.num.q(self.weight), b)


class Conv(nn.Module):
    """A conv with the symmetric padding k // 2 * dilation."""

    def __init__(self, num: Numerics, din: int, dout: int, k: int,
                 stride: int = 1, bias: bool = True, groups: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        self.num = num
        self.stride, self.groups = stride, groups
        self.padding = k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.zeros(dout, din // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.conv2d(self.num.q(x), self.num.q(self.weight), b,
                        stride=self.stride, padding=self.padding,
                        groups=self.groups)


class Affine(nn.Module):
    """Frozen BN: x * scale + bias over axis 1."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class GN(nn.Module):
    def __init__(self, groups: int, c: int):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, channels_last: bool = False):
        if channels_last:
            return F.group_norm(x.transpose(1, 2), self.groups, self.scale,
                                self.bias, 1e-5).transpose(1, 2)
        return F.group_norm(x, self.groups, self.scale, self.bias, 1e-5)


class LN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, 1e-5)


class ConvGN(nn.Module):
    def __init__(self, num, din, dout, k, groups=8):
        super().__init__()
        self.conv = Conv(num, din, dout, k)
        self.gn = GN(groups, dout)

    def forward(self, x):
        return self.gn(self.conv(x))


def seq_to_map(x, hw):
    b, n, c = x.shape
    return x.transpose(1, 2).reshape(b, c, *hw)


def map_to_seq(x):
    b, c = x.shape[:2]
    return x.reshape(b, c, -1).transpose(1, 2)


class DWConv(nn.Module):
    """5 x 5 depthwise conv on a [B, HW, C] sequence."""

    def __init__(self, num, c):
        super().__init__()
        self.conv = Conv(num, c, c, 5, bias=False, groups=c)

    def forward(self, x, hw):
        return map_to_seq(self.conv(seq_to_map(x, hw)))


class GNActDWConv(nn.Module):
    def __init__(self, num, c):
        super().__init__()
        self.gn = GN(32, c)
        self.conv = Conv(num, c, c, 5, bias=False, groups=c)

    def forward(self, x, hw):
        return map_to_seq(self.conv(F.gelu(self.gn(seq_to_map(x, hw)))))


# ---- attention --------------------------------------------------------------

def mha(num, q, k, v, heads, scale=None):
    """q [B,Lq,C], k [B,Lk,C], v [B,Lk,Cv] -> [B,Lq,Cv]."""
    b, lq, c = q.shape
    dh, dv = c // heads, v.shape[-1] // heads
    scale = dh ** -0.5 if scale is None else scale
    qh = num.q(q).reshape(b, lq, heads, dh).transpose(1, 2)
    kh = num.q(k).reshape(b, -1, heads, dh).transpose(1, 2)
    vh = num.q(v).reshape(b, -1, heads, dv).transpose(1, 2)
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, -1)
    out = torch.matmul(num.q(p), vh)
    return out.transpose(1, 2).reshape(b, lq, heads * dv)


def bank_attn(num, q, bank_k, bank_v, count: int, heads: int, scale: float,
              capacity: int):
    """Attention of q [B, Lq, Ck] into the first `count` slots of
    bank_k [S, B, Lk, Ck], bank_v [S, B, Lk, Cv], one softmax over all
    their keys. Returns (out [B, Lq, Cv], record [B, Lq, capacity]: each
    slot's head-mean mass, 0 past count)."""
    k, v = bank_k[:count], bank_v[:count]
    s, b, lk, ck = k.shape
    lq = q.shape[1]
    dh, dv = ck // heads, v.shape[-1] // heads
    qh = num.q(q).reshape(b, lq, heads, dh).transpose(1, 2)
    kh = num.q(k).reshape(s, b, lk, heads, dh).permute(1, 3, 0, 2, 4
                                                       ).reshape(b, heads,
                                                                 s * lk, dh)
    vh = num.q(v).reshape(s, b, lk, heads, dv).permute(1, 3, 0, 2, 4
                                                       ).reshape(b, heads,
                                                                 s * lk, dv)
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, -1)
    out = torch.matmul(num.q(p), vh).transpose(1, 2).reshape(b, lq, -1)
    rec = p.reshape(b, heads, lq, s, lk).sum(-1).mean(1)
    rec = F.pad(rec, (0, capacity - s))
    return out, rec


@functools.lru_cache(maxsize=16)
def _offset_map(h: int, w: int, m: int) -> np.ndarray:
    """[HW, HW]: key -> window offset (dy + m) * win + (dx + m), or win^2
    outside the window."""
    win = 2 * m + 1
    qy, qx = np.divmod(np.arange(h * w), w)
    dy = qy[None, :] - qy[:, None]
    dx = qx[None, :] - qx[:, None]
    inside = (np.abs(dy) <= m) & (np.abs(dx) <= m)
    return np.where(inside, (dy + m) * win + (dx + m), win * win)


def window_pairs(h: int, w: int, m: int = MAX_LOCAL_DIS) -> int:
    """(query, key) pairs inside the window, on an h x w grid."""
    cy = sum(min(y + m, h - 1) - max(y - m, 0) + 1 for y in range(h))
    cx = sum(min(x + m, w - 1) - max(x - m, 0) + 1 for x in range(w))
    return cy * cx


def local_attn(num, q, k, v, rel, hw, heads, scale):
    """DeAOT's local attention: each query over the keys of its 15 x 15
    window inside the image, with the relative bias rel [B, HW, h*225]
    gathered by offset."""
    b, n, c = q.shape
    dh, dv = c // heads, v.shape[-1] // heads
    if num.counting:
        # the windowed products' FLOPs, forward (and backward: twice)
        pairs = window_pairs(*hw)
        fwd = 2.0 * b * heads * pairs * (dh + dv)
        num.extra_flops += fwd * (3.0 if num.training_count else 1.0)
        return torch.zeros((b, n, heads * dv), device=q.device) + 0 * (
            q.sum() + k.sum() + v.sum() + rel.sum())
    win2 = (2 * MAX_LOCAL_DIS + 1) ** 2
    omap = num.on_device(("offsets", *hw), q.device,
                         lambda: torch.from_numpy(_offset_map(*hw,
                                                              MAX_LOCAL_DIS)))
    qh = num.q(q).reshape(b, n, heads, dh).transpose(1, 2)
    kh = num.q(k).reshape(b, n, heads, dh).transpose(1, 2)
    vh = num.q(v).reshape(b, n, heads, dv).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    r = rel.float().reshape(b, n, heads, win2)
    r = torch.cat([r, torch.full((b, n, heads, 1), NEG_INF, device=q.device)],
                  -1).transpose(1, 2)
    bias = torch.gather(r, -1, omap.expand(b, heads, n, n))
    p = torch.softmax(torch.clamp(logits + bias, min=NEG_INF), -1)
    out = torch.matmul(num.q(p), vh)
    return out.transpose(1, 2).reshape(b, n, heads * dv)


def interleave(x1, x2, heads):
    b, n, c = x1.shape
    if heads == 1:
        return torch.cat([x1, x2], -1)
    return torch.cat([x1.reshape(b, n, heads, c // heads),
                      x2.reshape(b, n, heads, c // heads)],
                     -1).reshape(b, n, 2 * c)


@functools.lru_cache(maxsize=8)
def _sine_pe(h: int, w: int, c: int) -> np.ndarray:
    """PositionEmbeddingSine(normalize=True), [H*W, C]."""
    npf, temp, scale = c // 2, 10000.0, 2 * math.pi
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    y = gy / (gy[-1:, :] + 1e-6) * scale
    x = gx / (gx[:, -1:] + 1e-6) * scale
    dim_t = temp ** (2 * np.trunc(np.arange(npf) / 2) / npf)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = np.stack((np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])),
                  3).reshape(h, w, -1)
    py = np.stack((np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])),
                  3).reshape(h, w, -1)
    return np.concatenate((py, px), 2).reshape(h * w, c).astype(np.float32)


def temporal_pe(table: torch.Tensor, t: int, capacity: int) -> torch.Tensor:
    """RMem's slot PE stretched to t valid slots: row i for t <= P, else
    row P-1 - floor((t-1-i) P / t); [capacity, C], rows >= t unused."""
    p = table.shape[0]
    rows = []
    for i in range(capacity):
        if t <= p:
            rows.append(min(i, p - 1))
        else:
            src = (p - 1) - math.floor((t - 1.0 - i) * p / max(t, 1.0))
            rows.append(int(min(max(src, 0), p - 1)))
    return table[torch.tensor(rows, device=table.device)]


# ---- encoders and decoder ---------------------------------------------------

class Bottleneck(nn.Module):
    def __init__(self, num, cin, planes, stride, down):
        super().__init__()
        self.conv1 = Conv(num, cin, planes, 1, bias=False)
        self.bn1 = Affine(planes)
        self.conv2 = Conv(num, planes, planes, 3, stride=stride, bias=False)
        self.bn2 = Affine(planes)
        self.conv3 = Conv(num, planes, planes * 4, 1, bias=False)
        self.bn3 = Affine(planes * 4)
        self.down = down
        if down:
            self.downsample_conv = Conv(num, cin, planes * 4, 1,
                                        stride=stride, bias=False)
            self.downsample_bn = Affine(planes * 4)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = self.downsample_bn(self.downsample_conv(x)) if self.down else x
        return torch.relu(y + r)


class ResNet50(nn.Module):
    """conv1 7x7/2 + BN + relu + maxpool 3x3/2, then stages 1-3 (OS16):
    the pyramid [4x, 8x, 16x, 16x] of an NHWC image."""

    def __init__(self, num):
        super().__init__()
        self.conv1 = Conv(num, 3, 64, 7, stride=2, bias=False, padding=3)
        self.bn1 = Affine(64)
        self.names = []
        cin = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256), (3, 4, 6), (1, 2, 2)), start=1):
            names = []
            for i in range(blocks):
                name = f"layer{stage}_{i}"
                setattr(self, name, Bottleneck(num, cin, planes,
                                               stride if i == 0 else 1,
                                               i == 0))
                cin = planes * 4
                names.append(name)
            self.names.append(names)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        xs = []
        for names in self.names:
            for n in names:
                x = getattr(self, n)(x)
            xs.append(x)
        return (*xs, x)


class Tiny(nn.Module):
    def __init__(self, num):
        super().__init__()
        self.stem = Conv(num, 3, 32, 5, stride=4)
        self.s8 = Conv(num, 32, 48, 3, stride=2)
        self.s16 = Conv(num, 48, 64, 3, stride=2)

    def forward(self, x):
        x4 = torch.relu(self.stem(x.permute(0, 3, 1, 2)))
        x8 = torch.relu(self.s8(x4))
        x16 = torch.relu(self.s16(x8))
        return (x4, x8, x16, x16)


def bilinear_ac(x, hw):
    """Align-corners bilinear resize of NCHW or [B,H,W,C] (channel_last is
    the caller's permute) to hw, in f32."""
    return F.interpolate(x.float(), size=tuple(hw), mode="bilinear",
                         align_corners=True)


class FPN(nn.Module):
    def __init__(self, num, din, dout, intermediate, hd, dims):
        super().__init__()
        self.intermediate = intermediate
        self.conv_in = ConvGN(num, din, hd, 1)
        self.adapter_16x = Conv(num, dims[-2], hd, 1)
        self.conv_16x = ConvGN(num, hd, hd, 3)
        self.adapter_8x = Conv(num, dims[-3], hd, 1)
        self.conv_8x = ConvGN(num, hd, hd // 2, 3)
        self.adapter_4x = Conv(num, dims[-4], hd // 2, 1)
        self.conv_4x = ConvGN(num, hd // 2, hd // 2, 3)
        self.conv_out = Conv(num, hd // 2, dout, 1)

    def forward(self, inputs, sc):
        x = torch.cat(list(inputs), 1) if self.intermediate else inputs[-1]
        x = torch.relu(self.conv_in(x))
        x = torch.relu(self.conv_16x(self.adapter_16x(sc[-2]) + x))
        x = bilinear_ac(x, sc[-3].shape[2:])
        x = torch.relu(self.conv_8x(self.adapter_8x(sc[-3]) + x))
        x = bilinear_ac(x, sc[-4].shape[2:])
        x = torch.relu(self.conv_4x(self.adapter_4x(sc[-4]) + x))
        return self.conv_out(x)


# ---- AOT's LSTT -------------------------------------------------------------

class MHAModule(nn.Module):
    def __init__(self, num, d, heads):
        super().__init__()
        self.num, self.heads = num, heads
        self.linear_Q = Lin(num, d, d)
        self.linear_K = Lin(num, d, d)
        self.linear_V = Lin(num, d, d)
        self.projection = Lin(num, d, d)

    def forward(self, q, k, v):
        return self.projection(mha(self.num, self.linear_Q(q),
                                   self.linear_K(k), self.linear_V(v),
                                   self.heads))


class LSTTBlock(nn.Module):
    def __init__(self, num, d, self_heads, att_heads, ff=1024):
        super().__init__()
        self.num, self.att_heads = num, att_heads
        self.norm1 = LN(d)
        self.self_attn = MHAModule(num, d, self_heads)
        self.norm2 = LN(d)
        self.linear_Q = Lin(num, d, d)
        self.linear_V = Lin(num, d, d)
        self.linear_QMem = Lin(num, d, d)
        self.linear_VMem = Lin(num, d, d)
        self.norm4 = LN(d)
        self.long_proj = Lin(num, d, d)
        self.short_proj = Lin(num, d, d)
        self.norm3 = LN(d)
        self.linear1 = Lin(num, d, ff)
        self.activation = GNActDWConv(num, ff)
        self.linear2 = Lin(num, ff, d)

    def forward(self, tgt, bank_k, bank_v, count, short_k, short_v, id_emb,
                pos, cur_pe, slot_pe, hw, capacity):
        _t = self.norm1(tgt)
        qk = _t + pos
        tgt = tgt + self.self_attn(qk, qk, _t)
        _t = self.norm2(tgt)
        curr_q = curr_k = self.linear_Q(_t)
        curr_v = _t
        if id_emb is not None:
            gv = self.linear_V(curr_v + id_emb)
            bank_k, bank_v, count = curr_k[None], gv[None], 1
            short_k, short_v = curr_k, gv
        q_t = curr_q + cur_pe
        bank_k = bank_k + slot_pe[:bank_k.shape[0], None, None, :]
        scale = (q_t.shape[-1] // self.att_heads) ** -0.5
        tgt2, rec = bank_attn(self.num, q_t, bank_k, bank_v, count,
                              self.att_heads, scale, capacity)
        tgt2 = self.long_proj(tgt2)
        sk = self.norm4(short_k + curr_k)
        sv = self.norm4(short_v + curr_v)
        tgt3 = self.short_proj(mha(self.num, curr_q, sk, sv, self.att_heads))
        tgt = tgt + tgt2 + tgt3
        _t = self.norm3(tgt)
        tgt = tgt + self.linear2(self.activation(self.linear1(_t), hw))
        mems = dict(curr_k=curr_k, curr_v=curr_v,
                    short_k=self.linear_QMem(tgt3), short_v=tgt3)
        return tgt, mems, rec


class LSTT(nn.Module):
    def __init__(self, num, layers, d, self_heads, att_heads, inter_norm):
        super().__init__()
        self.layers, self.inter_norm = layers, inter_norm
        for i in range(layers):
            setattr(self, f"block{i}",
                    LSTTBlock(num, d, self_heads, att_heads))
        self.num_norms = (layers - 1 if inter_norm else 0) + 1
        for i in range(self.num_norms):
            setattr(self, f"decoder_norm{i}", LN(d))

    def forward(self, tgt, bank, count, short, id_emb, cur_pe, slot_pe, hw,
                pos, capacity):
        outs, mems, rec0 = [], [], None
        for i in range(self.layers):
            tgt, m, rec = getattr(self, f"block{i}")(
                tgt, None if bank is None else bank[0][i],
                None if bank is None else bank[1][i], count,
                None if short is None else short[0][i],
                None if short is None else short[1][i], id_emb, pos,
                cur_pe, slot_pe, hw, capacity)
            rec0 = rec if i == 0 else rec0
            outs.append(tgt)
            mems.append(m)
        outs[-1] = getattr(self, f"decoder_norm{self.num_norms - 1}")(outs[-1])
        if self.inter_norm:
            for i in range(len(outs) - 1):
                outs[i] = getattr(self, f"decoder_norm{i}")(outs[i])
        return outs, {k: torch.stack([m[k] for m in mems]) for k in mems[0]}, \
            rec0

    def project(self, mems, id_emb):
        """(long_v, short_v) of every layer: the values id-conditioned."""
        lv, sv = [], []
        for i in range(self.layers):
            blk = getattr(self, f"block{i}")
            lv.append(blk.linear_V(mems["curr_v"][i] + id_emb))
            sv.append(blk.linear_VMem(mems["short_v"][i] + id_emb))
        return torch.stack(lv), torch.stack(sv)


# ---- DeAOT's GPM ------------------------------------------------------------

class GatedTail(nn.Module):
    def __init__(self, num, din, dout):
        super().__init__()
        self.dw_conv = DWConv(num, din)
        self.projection = Lin(num, din, dout)

    def forward(self, agg, gate, hw):
        return self.projection(self.dw_conv(agg * gate, hw))


class GatedSelfAttention(nn.Module):
    def __init__(self, num, dvu, heads, datt):
        super().__init__()
        self.num, self.heads, self.datt = num, heads, datt
        din = dvu // 2
        self.linear_QK = Lin(num, dvu, datt * heads)
        self.linear_V1 = Lin(num, din, dvu)
        self.linear_V2 = Lin(num, din, dvu)
        self.linear_U1 = Lin(num, din, dvu)
        self.linear_U2 = Lin(num, din, dvu)
        self.tail = GatedTail(num, 2 * dvu, dvu)

    def forward(self, x, hw):
        qk = self.linear_QK(x)
        x1, x2 = x.chunk(2, -1)
        v = F.silu(interleave(self.linear_V1(x1), self.linear_V2(x2),
                              self.heads))
        u = F.silu(interleave(self.linear_U1(x1), self.linear_U2(x2),
                              self.heads))
        agg = mha(self.num, qk, qk, v, self.heads, scale=self.datt ** -0.5)
        return self.tail(agg, u, hw)


class GPMBlock(nn.Module):
    def __init__(self, num, d, self_heads, att_heads, idx):
        super().__init__()
        self.num, self.idx, self.att_heads = num, idx, att_heads
        e = 2 * d
        self.datt = d // 2 if att_heads == 1 else d // att_heads
        dk = self.datt * att_heads
        self.dk = dk
        self.norm1 = LN(d)
        self.linear_QV = Lin(num, d, dk + e)
        self.linear_U = Lin(num, d, e)
        if idx == 0:
            self.linear_ID_V = Lin(num, d, e)
        else:
            self.id_norm1 = LN(d)
            self.linear_ID_V = Lin(num, 2 * d, e)
            self.linear_ID_U = Lin(num, d, e)
        self.long_tail = GatedTail(num, 2 * e, 2 * d)
        self.relative_emb_k = Lin(num, dk, att_heads * 225)
        self.short_tail = GatedTail(num, 2 * e, 2 * d)
        self.norm2 = LN(d)
        self.id_norm2 = LN(d)
        self.self_attn = GatedSelfAttention(num, 2 * d, self_heads,
                                            self.datt)

    def fuse_id(self, curr_id_v, id_emb):
        if self.idx == 0:
            return F.silu(self.linear_ID_V(id_emb))
        return F.silu(self.linear_ID_V(torch.cat([curr_id_v, id_emb], -1)))

    def forward(self, tgt, tgt_id, bank_k, bank_v, count, short_k, short_v,
                id_emb, cur_pe, slot_pe, hw, capacity):
        scale = self.datt ** -0.5
        _t = self.norm1(tgt)
        qv = self.linear_QV(_t)
        curr_u = self.linear_U(_t)
        curr_q = curr_k = qv[..., :self.dk]
        curr_v = F.silu(qv[..., self.dk:])
        if tgt_id is None:
            curr_id_v = None
            cat_u = torch.cat([F.silu(curr_u), torch.ones_like(curr_u)], -1)
        else:
            curr_id_v = self.id_norm1(tgt_id)
            cat_u = F.silu(torch.cat([curr_u, self.linear_ID_U(curr_id_v)],
                                     -1))
        if id_emb is not None:
            cat_v = torch.cat([curr_v, self.fuse_id(curr_id_v, id_emb)], -1)
            bank_k, bank_v, count = curr_k[None], cat_v[None], 1
            short_k, short_v = curr_k, cat_v
        q_t = curr_q + cur_pe
        rel = self.relative_emb_k(curr_q)
        bank_k = bank_k + slot_pe[:bank_k.shape[0], None, None, :]
        agg, rec = bank_attn(self.num, q_t, bank_k, bank_v, count,
                             self.att_heads, scale, capacity)
        agg3 = local_attn(self.num, curr_q, short_k, short_v, rel, hw,
                          self.att_heads, scale)
        t2, i2 = self.long_tail(agg, cat_u, hw).chunk(2, -1)
        t3, i3 = self.short_tail(agg3, cat_u, hw).chunk(2, -1)
        tgt = tgt + t2 + t3
        tgt_id = i2 + i3 if tgt_id is None else tgt_id + i2 + i3
        cat_in = torch.cat([self.norm2(tgt), self.id_norm2(tgt_id)], -1)
        t2, i2 = self.self_attn(cat_in, hw).chunk(2, -1)
        tgt, tgt_id = tgt + t2, tgt_id + i2
        mems = dict(curr_k=curr_k, curr_v=curr_v,
                    curr_id_v=(curr_id_v if curr_id_v is not None
                               else torch.zeros_like(tgt_id)))
        return tgt, tgt_id, mems, rec


class GPM(nn.Module):
    def __init__(self, num, layers, d, self_heads, att_heads, inter_norm):
        super().__init__()
        self.layers, self.inter_norm = layers, inter_norm
        for i in range(layers):
            setattr(self, f"block{i}",
                    GPMBlock(num, d, self_heads, att_heads, i))
        self.num_norms = (layers - 1 if inter_norm else 0) + 1
        for i in range(self.num_norms):
            setattr(self, f"decoder_norm{i}", GN(2, 2 * d))

    def forward(self, tgt, bank, count, short, id_emb, cur_pe, slot_pe, hw,
                pos, capacity):
        out_id, outs, mems, rec0 = None, [], [], None
        for i in range(self.layers):
            tgt, out_id, m, rec = getattr(self, f"block{i}")(
                tgt, out_id, None if bank is None else bank[0][i],
                None if bank is None else bank[1][i], count,
                None if short is None else short[0][i],
                None if short is None else short[1][i], id_emb, cur_pe,
                slot_pe, hw, capacity)
            rec0 = rec if i == 0 else rec0
            outs.append(torch.cat([tgt, out_id], -1))
            mems.append(m)
        norm = lambda j, x: getattr(self, f"decoder_norm{j}")(
            x, channels_last=True)
        outs[-1] = norm(self.num_norms - 1, outs[-1])
        if self.inter_norm:
            for i in range(len(outs) - 1):
                outs[i] = norm(i, outs[i])
        return outs, {k: torch.stack([m[k] for m in mems]) for k in mems[0]}, \
            rec0

    def project(self, mems, id_emb):
        """(V, ID_V) of every layer."""
        ids = [getattr(self, f"block{i}").fuse_id(mems["curr_id_v"][i],
                                                   id_emb)
               for i in range(self.layers)]
        return mems["curr_v"], torch.stack(ids)


# ---- the VOS model ----------------------------------------------------------

class VOSModel(nn.Module):
    """AOT (`vos` "aot": the LSTT) or DeAOT ("deaot": the GPM) on ResNet-50
    or the tiny encoder, with RMem's temporal PE. `cfg` is a dict of the
    configuration's fields."""

    def __init__(self, cfg: Dict, num: Optional[Numerics] = None):
        super().__init__()
        self.num = num = num or Numerics()
        self.cfg = cfg
        self.deaot = cfg["model_vos"] == "deaot"
        c = cfg["model_encoder_embedding_dim"]
        dims = cfg["model_encoder_dim"]
        layers = cfg["model_lstt_num"]
        heads = cfg["model_att_heads"]
        inter = cfg["model_decoder_intermediate_lstt"]
        self.max_obj = cfg["model_max_obj_num"]
        self.id_channels = self.max_obj + 2
        enc = cfg["model_encoder"]
        self.encoder = {"resnet50": ResNet50, "tiny": Tiny}[enc](num)
        self.encoder_projector = Conv(num, dims[-1], c, 1)
        if self.deaot:
            self.lstt = GPM(num, layers, c, cfg["model_self_heads"], heads,
                            inter)
            din = c * (layers * 2 + 1) if inter else c * 2
            pe_dim = c // 2 if heads == 1 else c // heads * heads
            self.id_norm = LN(c)
        else:
            self.lstt = LSTT(num, layers, c, cfg["model_self_heads"], heads,
                             inter)
            din = c * (layers + 1) if inter else c
            pe_dim = c
        self.decoder = FPN(num, din, self.max_obj + 1, inter, c, dims)
        self.patch_wise_id_bank = Conv(num, self.id_channels, c, 17,
                                       stride=16, padding=8)
        self.cur_pos_emb = nn.Parameter(torch.zeros(1, pe_dim))
        self.mem_pos_emb = nn.Parameter(torch.zeros(4, pe_dim))

    def encode(self, img):
        """[B, H, W, 3] -> NCHW pyramid, the 16x map projected."""
        xs = list(self.encoder(img))
        xs[-1] = self.encoder_projector(xs[-1])
        return xs

    def id_emb(self, label):
        """Channel-index plane [B, H, W] (ignore already mapped to obj+1)
        -> [B, HW, C]: the id bank's 17 x 17 / 16 conv of the one-hot
        planes, as patches times the kernel (cuDNN's own choice for this
        conv in f32 is an FFT of many small launches)."""
        ids = torch.arange(self.id_channels, device=label.device)
        onehot = (label[:, None] == ids[None, :, None, None]).float()
        conv = self.patch_wise_id_bank
        cols = F.unfold(self.num.q(onehot), 17, padding=8, stride=16)
        e = (self.num.q(conv.weight).flatten(1) @ cols).transpose(1, 2) \
            + conv.bias
        return self.id_norm(e) if self.deaot else e

    def pos(self, h, w):
        c = self.cfg["model_encoder_embedding_dim"]
        return self.num.on_device(("sine", h, w, c), self.cur_pos_emb.device,
                                  lambda: torch.from_numpy(
                                      _sine_pe(h, w, c)))[None]

    def propagate(self, feat, bank, count, short, id_emb, slot_pe, hw,
                  capacity):
        return self.lstt(feat, bank, count, short, id_emb, self.cur_pos_emb,
                         slot_pe, hw, self.pos(*hw), capacity)

    def write(self, mems, id_emb):
        """(long_k, long_v, short_k, short_v) to store, [L, B, HW, *]."""
        if self.deaot:
            v, idv = self.lstt.project(mems, id_emb)
            cat = torch.cat([v, idv], -1)
            return mems["curr_k"], cat, mems["curr_k"], cat
        lv, sv = self.lstt.project(mems, id_emb)
        return mems["curr_k"], lv, mems["short_k"], sv

    def decode(self, outs, xs):
        """f32 logits [B, H/4, W/4, obj+1], channel-last."""
        hw = xs[-1].shape[2:]
        inputs = [xs[-1]] + [seq_to_map(e, hw) for e in outs]
        return self.decoder(inputs, xs).permute(0, 2, 3, 1)


def mask_unused(logits, obj_nums, neg: float = -1e10):
    """Channels beyond each sample's object count set to neg."""
    ch = torch.arange(logits.shape[-1], device=logits.device)
    valid = ch[None, :] <= obj_nums[:, None].to(logits.device)
    return torch.where(valid[:, None, None, :], logits,
                       torch.full((), neg, device=logits.device))


def build(cfg: Dict, state_dict: Dict[str, torch.Tensor], device,
          precision: str = "float32") -> VOSModel:
    """The reference model in f32 on `device` with the given weights
    (loaded strictly)."""
    model = VOSModel(cfg, Numerics(precision))
    model.load_state_dict({k: v.float() for k, v in state_dict.items()},
                          strict=True)
    return model.to(device)

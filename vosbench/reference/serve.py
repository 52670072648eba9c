"""The plain reference of multi-scale + flip serving: one video's frames
through every (scale, flip) aug, the id groups merged, the augs averaged,
the memory written and RMem's bank evicted by score, as the package under
test serves a video (its `InferenceEngine.scan_steps_multi_raw`), written
out in plain PyTorch over `model.VOSModel`.

The reference is teacher-forced: each frame's memory is written with the
label the program served, and each eviction takes the victim the program
took, where that is known (`Stream.write`). What it computes itself, and
what the check compares, is each frame's merged probabilities (so the gap
by which the program's label lies below the reference's best) and each
eviction round's scores (so the gap by which the program's victim's
score lies above the reference's least).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vosbench.reference.model import VOSModel, mask_unused, temporal_pe

MEAN = torch.tensor([0.485, 0.456, 0.406]) * 255.0
STD = torch.tensor([0.229, 0.224, 0.225]) * 255.0
MOVING_MEAN = 0.8
UCB_ADD, UCB_MUL = 8.0, 1.5


def _cubic_taps(n_out: int, n_in: int):
    """cv2 INTER_CUBIC's taps and weights (A = -0.75, replicated border)."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
    i0 = np.floor(pos).astype(np.int64)
    t = (pos - i0).astype(np.float32)
    a = -0.75
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    idx = np.stack([np.clip(i0 + k, 0, n_in - 1) for k in (-1, 0, 1, 2)])
    return idx, np.stack([w0, w1, w2, w3]).astype(np.float32)


def resize_cubic(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[K, H, W, 3] -> [K, h, w, 3] f32, rows then columns."""
    y = x.float()
    for axis, n in ((1, hw[0]), (2, hw[1])):
        if y.shape[axis] == n:
            continue
        idx, wts = _cubic_taps(n, y.shape[axis])
        shape = [1] * y.dim()
        shape[axis] = n
        out = 0
        for k in range(4):
            i = torch.from_numpy(idx[k]).to(y.device)
            w = torch.from_numpy(wts[k]).to(y.device).view(shape)
            out = out + y.index_select(axis, i) * w
        y = out
    return y


def prep(raw: torch.Tensor, hw, flip: bool) -> torch.Tensor:
    """uint8 [K, H0, W0, 3] -> normalised f32 [K, h, w, 3]."""
    x = (resize_cubic(raw, hw) - MEAN.to(raw.device)) / STD.to(raw.device)
    return x.flip(2) if flip else x


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """[..., H, W] nearest resize, src = floor(i * in / out)."""
    h, w = x.shape[-2:]
    iy = np.clip(np.floor(np.arange(hw[0]) * h / hw[0]).astype(np.int64), 0,
                 h - 1)
    ix = np.clip(np.floor(np.arange(hw[1]) * w / hw[1]).astype(np.int64), 0,
                 w - 1)
    return x[..., torch.from_numpy(iy).to(x.device), :][
        ..., torch.from_numpy(ix).to(x.device)]


def split_groups(label: torch.Tensor, groups: int, max_obj: int):
    """[H, W] label -> [G, H, W]: group g holds objects g*max+1..(g+1)*max
    as 1..max."""
    out = []
    for g in range(groups):
        lo, hi = g * max_obj + 1, (g + 1) * max_obj
        fg = (label >= lo) & (label <= hi)
        out.append(torch.where(fg, label - lo + 1, torch.zeros_like(label)))
    return torch.stack(out)


def upsample(logits: torch.Tensor, hw) -> torch.Tensor:
    """Align-corners bilinear [B, h, w, C] -> [B, H, W, C] in f32."""
    return F.interpolate(logits.permute(0, 3, 1, 2).float(), size=tuple(hw),
                         mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)


def merge_groups(logits: torch.Tensor, max_obj: int) -> torch.Tensor:
    """[G, H, W, obj+1] -> [H, W, 1 + G*obj]: background probability the
    groups' product, each object its group's, as logits of the
    probabilities clamped to [1e-5, 1 - 1e-5]."""
    if logits.shape[0] == 1:
        return logits[0]
    p = torch.softmax(logits.float(), -1)
    bg = torch.prod(p[..., 0], 0)[..., None]
    m = torch.clamp(torch.cat([bg, *[p[g, ..., 1:1 + max_obj]
                                     for g in range(p.shape[0])]], -1),
                    1e-5, 1 - 1e-5)
    return torch.log(m) - torch.log1p(-m)


class Stream:
    """One video served at every aug by one reference model."""

    def __init__(self, model: VOSModel, cfg: Dict, in_hws, flips, out_hw,
                 gap: int):
        self.m, self.cfg = model, cfg
        self.in_hws, self.flips, self.out_hw = list(in_hws), list(flips), \
            tuple(out_hw)
        self.gap = gap
        self.former, self.latter = cfg["former_mem_len"], cfg["latter_mem_len"]
        self.capacity = self.former + self.latter + 1
        self.max_obj = cfg["model_max_obj_num"]
        self.states: List[Dict] = []
        self.frame = 0
        self.last_write = 0

    # -- the model's calls --------------------------------------------------
    def _encode(self, img, groups):
        xs = self.m.encode(img)
        xs = [torch.cat([x] * groups) for x in xs]
        hw = tuple(xs[-1].shape[2:])
        return xs, xs[-1].flatten(2).transpose(1, 2), hw

    def _id(self, label):
        lbl = torch.where(label == 255, self.max_obj + 1, label).long()
        return self.m.id_emb(lbl)

    @torch.no_grad()
    def reference(self, raw0: torch.Tensor, mask: torch.Tensor,
                  objects: int) -> None:
        """Frame 0: raw0 uint8 [H0, W0, 3], mask [H0, W0] int (0..objects)."""
        groups = -(-objects // self.max_obj)
        obj_nums = torch.tensor([min(self.max_obj, objects - g * self.max_obj)
                                 for g in range(groups)], device=raw0.device)
        for hw, flip in zip(self.in_hws, self.flips):
            img = prep(raw0[None], hw, flip)
            lab = resize_nearest((mask.flip(1) if flip else mask), hw)
            lab = split_groups(lab, groups, self.max_obj)
            xs, feat, ghw = self._encode(img, groups)
            ide = self._id(lab)
            pe0 = self.m.mem_pos_emb[0:1]
            outs, mems, _ = self.m.propagate(feat, None, None, None, ide, pe0,
                                             ghw, self.capacity)
            lk, lv, sk, sv = self.m.write(mems, ide)
            L, b, n = lk.shape[:3]
            st = dict(
                k=lk.new_zeros((L, self.capacity, b, n, lk.shape[-1])),
                v=lv.new_zeros((L, self.capacity, b, n, lv.shape[-1])),
                count=1, score=torch.zeros(self.capacity, device=lk.device),
                scored=torch.zeros(self.capacity, dtype=torch.bool,
                                   device=lk.device),
                times=torch.zeros(self.capacity, device=lk.device),
                order=torch.arange(self.capacity, device=lk.device),
                sk=sk, sv=sv, grid=ghw, obj_nums=obj_nums,
                logits=mask_unused(self.m.decode(outs, xs), obj_nums))
            st["k"][:, 0], st["v"][:, 0] = lk, lv
            self.states.append(st)

    @torch.no_grad()
    def probs(self, raw: torch.Tensor) -> torch.Tensor:
        """Propagate one frame (uint8 [H0, W0, 3]) at every aug; returns
        the merged probabilities [H, W, 1 + G*obj] averaged over the augs."""
        self.frame += 1
        out = 0
        for st, hw, flip in zip(self.states, self.in_hws, self.flips):
            groups = st["sk"].shape[1]
            xs, feat, ghw = self._encode(prep(raw[None], hw, flip), groups)
            c = st["count"]
            pe = temporal_pe(self.m.mem_pos_emb, c, self.capacity)
            pe = pe[st["order"]]
            outs, mems, rec = self.m.propagate(
                feat, (st["k"], st["v"]), c, (st["sk"], st["sv"]), None, pe,
                ghw, self.capacity)
            st["mems"], st["rec"] = mems, rec
            st["logits"] = mask_unused(self.m.decode(outs, xs),
                                       st["obj_nums"])
            merged = merge_groups(upsample(st["logits"], self.out_hw),
                                  self.max_obj)
            if flip:
                merged = merged.flip(1)
            out = out + torch.softmax(merged.float(), -1)
        return out / len(self.states)

    def write_due(self) -> bool:
        return self.frame - self.last_write >= self.gap

    def bank_full(self) -> bool:
        return self.states[0]["count"] >= self.former + self.latter

    @torch.no_grad()
    def totals(self) -> List[Optional[torch.Tensor]]:
        """Each aug's eviction totals this frame (score + UCB bonus, inf
        outside the candidates), and its statistics after the round; None
        where the bank is not full."""
        return [self._round(st) if st["count"] >= self.former + self.latter
                else None for st in self.states]

    def _round(self, st):
        s = self.capacity
        ids = torch.arange(s, device=st["score"].device)
        n_old = st["count"]
        valid = ids < n_old
        gh, gw = st["grid"]
        fg = 1.0 - torch.softmax(upsample(st["logits"], (gh, gw)), -1)[..., 0]
        fg = fg.reshape(fg.shape[0], -1)
        w = torch.einsum("bqs,bq->s", st["rec"].float(), fg) / fg.shape[0]
        w = torch.where(valid, w, 0.0)
        w = w / torch.clamp(w.sum(), min=1e-12)
        score = torch.where(st["scored"], (1 - MOVING_MEAN) * st["score"]
                            + MOVING_MEAN * w, w)
        score = torch.where(valid, score, st["score"])
        times = torch.where(valid, st["times"] + 1, st["times"])
        counts = torch.where(valid, times, 0.0)
        counts[0] = float(n_old)
        bonus = UCB_MUL * torch.sqrt(torch.log(counts.sum())
                                     / (counts + UCB_ADD))
        cand = (st["order"] >= 1) & valid
        total = torch.where(cand, score + bonus,
                            torch.full_like(score, math.inf))
        return dict(total=total, score=score, times=times)

    @torch.no_grad()
    def write(self, label: torch.Tensor,
              victims: Optional[Sequence[int]] = None,
              rounds: Optional[List] = None) -> List[int]:
        """Write the served label [H, W] (int) into every aug's memory: the
        short-term memory always, the bank on the write schedule (a victim
        per aug when full: `victims[a]` where given, else the least total
        of `rounds` or this model's own). Returns the victims taken."""
        due = self.write_due()
        rounds = rounds if rounds is not None else (
            self.totals() if due else None)
        taken = []
        for a, (st, hw, flip) in enumerate(zip(self.states, self.in_hws,
                                               self.flips)):
            groups = st["sk"].shape[1]
            lab = resize_nearest(label.flip(1) if flip else label, hw)
            ide = self._id(split_groups(lab, groups, self.max_obj))
            lk, lv, st["sk"], st["sv"] = self.m.write(st["mems"], ide)
            if not due:
                continue
            n_old = st["count"]
            if rounds[a] is None:
                target = n_old
                st["count"] = n_old + 1
            else:
                r = rounds[a]
                target = (int(victims[a]) if victims is not None
                          and victims[a] is not None
                          else int(torch.argmin(r["total"])))
                rank = int(st["order"][target])
                dec = (st["order"] > rank) & (st["order"] < n_old)
                st["order"] = torch.where(dec, st["order"] - 1, st["order"])
                st["order"][target] = n_old - 1
                fresh = torch.arange(self.capacity,
                                     device=lk.device) == target
                st["score"] = torch.where(fresh, 0.0, r["score"])
                st["scored"] = torch.where(
                    fresh, False, st["scored"] | (torch.arange(
                        self.capacity, device=lk.device) < n_old))
                st["times"] = torch.where(fresh, 1.0, r["times"])
            st["k"][:, target], st["v"][:, target] = lk, lv
            taken.append(target)
        if due:
            self.last_write = self.frame
        return taken


def label_gap(ref_probs: torch.Tensor, label: torch.Tensor) -> float:
    """The widest gap, over the frame's pixels, by which the probability
    the reference gives the served label lies below its best."""
    got = torch.gather(ref_probs, -1, label.long()[..., None])[..., 0]
    return float((ref_probs.amax(-1) - got).max())


def victim_gap(total: torch.Tensor, victim: int) -> float:
    """How far the program's victim's total lies above the least."""
    return float(total[victim] - total.min())

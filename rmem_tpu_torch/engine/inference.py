"""Per-video inference engine.

Counterpart of `rmem_tpu/engine/inference.py`: `add_reference`,
`propagate`, `update_memory`, the fused `step`, the multi-aug `step_multi`,
and their chunked forms (`scan_steps`, `scan_steps_multi`; the chunked scan
becomes a Python frame loop), also from raw uint8 frames prepared on the
device (`scan_steps_raw`, `scan_steps_multi_raw`). Videos with more objects
than the model's `model_max_obj_num` run as a leading id-group axis: the
frame is encoded once and its features broadcast to the groups, each group
labels its own objects, and the group logits merge by
`soft_logit_aggregation`. The bank capacity and image size are fixed per
video; the bank count, the memory-write flag and every eviction decision
stay on the device, so the host queues a frame's work without waiting for
the card. The state is updated in place: the returned state is the object
passed in.

The engine runs on the card unless the caller passes `device="cpu"`; with
no card and no device given it raises. On the card every kernel of the path
(stem, bank attention, local attention, and with the opt-ins the slot-split
bank attention and the gated depthwise conv; for AOT the stem and the
8-head bank attention) is the CUDA kernel; on the CPU
each is its plain PyTorch version. The opt-ins (`Config.use_pallas_dwconv`
and the environment variable `RMEM_BANK_QMINOR`) are read once, when the
engine is built.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from rmem_tpu_torch.memory import bank_append, init_bank, update_bank_inplace
from rmem_tpu_torch.memory.bank import MemoryBank
from rmem_tpu_torch.models.encoders import fold_bn_params
from rmem_tpu_torch.ops.layers import map_to_seq
from rmem_tpu_torch.ops.masks import mask_unused_ids
from rmem_tpu_torch.ops.resize import (resize_bilinear, resize_cubic,
                                       resize_nearest, upsample_argmax)
from rmem_tpu_torch.ops.temporal_pe import interpolate_temporal_pe


@dataclass
class EngineState:
    """State of one video."""

    bank: MemoryBank
    short_k: torch.Tensor                 # [L, B, HW, Ck]
    short_v: torch.Tensor                 # [L, B, HW, Cv] (V ++ ID_V)
    mems: Dict[str, torch.Tensor]         # pending emissions of propagate
    record: Optional[torch.Tensor]        # [B, HW, S] layer-0 slot mass
    logits4x: torch.Tensor                # [B, H/4, W/4, obj+1] masked
    frame_step: torch.Tensor              # int32 scalars from here on
    last_mem_step: torch.Tensor
    gap: torch.Tensor
    obj_nums: torch.Tensor                # [B] int32


def separate_mask(label: torch.Tensor, num_groups: int,
                  max_obj: int) -> torch.Tensor:
    """[1?, H, W] global label -> [G, H, W] per-group labels in
    [0, max_obj]: group g takes objects g*max_obj+1 .. (g+1)*max_obj."""
    if label.dim() == 3:
        label = label[0]
    outs = []
    for g in range(num_groups):
        start, end = g * max_obj + 1, (g + 1) * max_obj
        fg = (label >= start) & (label <= end)
        outs.append(torch.where(fg, label - start + 1,
                                torch.zeros_like(label)))
    return torch.stack(outs)


def soft_logit_aggregation(logits: torch.Tensor,
                           max_obj: int) -> torch.Tensor:
    """[G, H, W, obj+1] group logits -> [H, W, 1 + G*obj] merged logits:
    the background probability is the product of the groups', each
    object's is its group's, and the merged logit is torch.logit of the
    probability clamped to [1e-5, 1 - 1e-5]."""
    if logits.shape[0] == 1:
        return logits[0]
    probs = torch.softmax(logits.float(), dim=-1)
    bg = torch.prod(probs[..., 0], dim=0)[..., None]
    fg = [probs[g, ..., 1:1 + max_obj] for g in range(probs.shape[0])]
    merged = torch.clamp(torch.cat([bg, *fg], dim=-1), 1e-5, 1 - 1e-5)
    return torch.log(merged) - torch.log1p(-merged)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """None means the card; without one that is an error, never a silent
    fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class InferenceEngine:
    """Streaming per-frame inference; the state lives on the engine's
    device.

    The engine takes over `model`: it moves it to the device and, for a
    bf16 config, folds the encoder's frozen-BN scales into its convs and
    casts every weight to bf16 (as the JAX engine does with its params)."""

    def __init__(self, model: nn.Module, cfg: Config,
                 device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.compute_dtype == "bfloat16":
            model.load_state_dict(fold_bn_params(model.state_dict()))
            self.dtype = torch.bfloat16
        elif cfg.compute_dtype == "float32":
            self.dtype = torch.float32
        else:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        # the opt-in inference kernels, chosen once: K3 for bank attention,
        # K8 for the gated tails
        self.route = dict(qminor=bool(os.environ.get("RMEM_BANK_QMINOR")),
                          fused_dw=bool(cfg.use_pallas_dwconv))
        self._mean = torch.as_tensor(IMAGENET_MEAN * 255.0,
                                     device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD * 255.0, device=self.device)

    # -- helpers -------------------------------------------------------
    def _to_dev(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _id_emb(self, label: torch.Tensor) -> torch.Tensor:
        """Hard labels: 255 (ignore) maps to channel obj+1."""
        if label.dim() == 4:
            label = label[..., 0]
        lbl = torch.where(label == 255, self.cfg.model_max_obj_num + 1,
                          label).to(torch.int64)
        return self.model.get_id_emb(lbl)

    def _encode(self, img: torch.Tensor, groups: int):
        """Encode once and broadcast the features to the id-group batch."""
        xs = self.model.encode_image(img)
        if img.shape[0] == 1 and groups > 1:
            # cat keeps the maps' channels-last layout
            xs = tuple(torch.cat([x] * groups) for x in xs)
        b, c, eh, ew = xs[-1].shape
        return xs, map_to_seq(xs[-1]).contiguous(), (eh, ew)

    def _decode(self, intermediates, xs, obj_nums):
        logits = self.model.decode_id_logits(intermediates, xs)
        return mask_unused_ids(logits, obj_nums)

    def _enc_hw(self, state: EngineState) -> Tuple[int, int]:
        """16x grid dims from the 4x logits shape."""
        hw = state.short_k.shape[2]
        h4, w4 = state.logits4x.shape[1:3]
        if self.cfg.model_align_corners:
            eh, ew = (h4 - 1) // 4 + 1, (w4 - 1) // 4 + 1
        else:
            eh, ew = h4 // 4, w4 // 4
        if eh * ew != hw:
            raise ValueError(f"grid {eh}x{ew} does not match {hw} tokens")
        return eh, ew

    # -- public API ------------------------------------------------------
    @torch.inference_mode()
    def add_reference(self, img, label, obj_nums: Sequence[int],
                      frame_step: int = 0,
                      gap: int = 5) -> Tuple[EngineState, torch.Tensor]:
        """img [B,H,W,3] float (or [1,H,W,3] for G id groups); label
        [B,H,W] int (or [G,H,W], per group, from `separate_mask`); obj_nums
        [B] (or [G])."""
        cfg = self.cfg
        img = self._to_dev(img, torch.float32)
        label = self._to_dev(label)
        obj_nums = self._to_dev(obj_nums, torch.int32)
        xs, feat, (eh, ew) = self._encode(img, label.shape[0])
        id_emb = self._id_emb(label)
        cur_pe, mem_pe = self.model.temporal_pe()
        if mem_pe is not None:
            mem_pe = mem_pe[0:1]     # one slot: the first PE row
        intermediates, mems, _ = self.model.lstt_forward(
            feat, None, None, None, id_emb, cur_pe, mem_pe, (eh, ew),
            self_pos=self.model.get_pos_emb(eh, ew), **self.route)
        lk, lv, sk, sv = self.model.write_memories(mems, id_emb)
        b, hw = feat.shape[:2]
        bank = init_bank(num_layers=lk.shape[0], capacity=cfg.max_mem_slots,
                         batch=b, hw=hw, ck=lk.shape[-1], cv=lv.shape[-1],
                         dtype=lk.dtype, device=self.device)
        bank_append(bank, lk, lv)
        logits = self._decode(intermediates, xs, obj_nums)
        record0 = (torch.zeros((b, hw, cfg.max_mem_slots),
                               dtype=torch.float32, device=self.device)
                   if not cfg.no_long_memory else None)
        step = self._to_dev(frame_step, torch.int32)
        state = EngineState(
            bank=bank, short_k=sk, short_v=sv, mems=mems, record=record0,
            logits4x=logits, frame_step=step, last_mem_step=step.clone(),
            gap=self._to_dev(gap, torch.int32), obj_nums=obj_nums)
        return state, logits

    @torch.inference_mode()
    def propagate(self, state: EngineState, img
                  ) -> Tuple[EngineState, torch.Tensor]:
        img = self._to_dev(img, torch.float32)
        xs, feat, size_2d = self._encode(img, state.short_k.shape[1])
        bank = state.bank
        cur_pe, mem = self.model.temporal_pe()
        slot_pe = None
        if mem is not None:
            slot_pe = interpolate_temporal_pe(mem, bank.count, bank.capacity)
            # each physical slot takes the PE of its temporal rank
            slot_pe = slot_pe.index_select(0, bank.order.long())
        intermediates, mems, record = self.model.lstt_forward(
            feat, (bank.k, bank.v), bank.count,
            (state.short_k, state.short_v), None, cur_pe, slot_pe, size_2d,
            self_pos=self.model.get_pos_emb(*size_2d), **self.route)
        logits = self._decode(intermediates, xs, state.obj_nums)
        state.frame_step = state.frame_step + 1
        state.mems = mems
        state.record = record
        state.logits4x = logits
        return state, logits

    @torch.inference_mode()
    def update_memory(self, state: EngineState, label) -> EngineState:
        """label [B, H, W] int at the model's input size ([G, H, W] per
        group)."""
        cfg = self.cfg
        id_emb = self._id_emb(self._to_dev(label))
        lk, lv, sk, sv = self.model.write_memories(state.mems, id_emb)
        state.short_k, state.short_v = sk, sv
        if cfg.no_long_memory:
            return state
        do_long = state.frame_step - state.last_mem_step >= state.gap
        b, hw = lk.shape[1], lk.shape[2]
        up = resize_bilinear(state.logits4x, self._enc_hw(state),
                             cfg.model_align_corners)
        fg = 1.0 - torch.softmax(up.float(), dim=-1)[..., 0].reshape(b, hw)
        update_bank_inplace(state.bank, lk, lv, do_long, cfg.former_mem_len,
                            cfg.latter_mem_len, state.record, fg)
        state.last_mem_step = torch.where(do_long, state.frame_step,
                                          state.last_mem_step)
        return state

    def _merged_label(self, logits4: torch.Tensor,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
        """The merged label [H, W] int32 of the group logits at out_hw."""
        if logits4.shape[0] == 1:
            return upsample_argmax(logits4, out_hw,
                                   self.cfg.model_align_corners)
        merged = soft_logit_aggregation(self.predict_logits_at(logits4,
                                                               out_hw),
                                        self.cfg.model_max_obj_num)
        return torch.argmax(merged, dim=-1).to(torch.int32)

    def write_label(self, state: EngineState, label_full: torch.Tensor,
                    in_hw: Tuple[int, int], flip: bool = False
                    ) -> EngineState:
        """update_memory with a merged label [H, W] at the output size:
        flipped for a flipped aug, nearest-resized to the input size, split
        into the state's id groups."""
        if flip:
            label_full = label_full.flip(1)
        label_in = resize_nearest(label_full[None, ..., None], in_hw)[..., 0]
        groups = state.short_k.shape[1]
        if groups > 1:
            label_in = separate_mask(label_in, groups,
                                     self.cfg.model_max_obj_num)
        return self.update_memory(state, label_in)

    def aug_label(self, logits4s: Sequence[torch.Tensor],
                  out_hw: Tuple[int, int],
                  flips: Sequence[bool]) -> torch.Tensor:
        """The label [H, W] int32 of one frame's augs: each aug's group
        logits upsampled to out_hw and merged, unflipped, softmaxed; the
        argmax of the mean."""
        probs = []
        for logits4, flip in zip(logits4s, flips):
            merged = soft_logit_aggregation(
                self.predict_logits_at(logits4, out_hw),
                self.cfg.model_max_obj_num)
            if flip:
                merged = merged.flip(1)
            probs.append(torch.softmax(merged.float(), dim=-1))
        return torch.argmax(torch.stack(probs).mean(dim=0),
                            dim=-1).to(torch.int32)

    @torch.inference_mode()
    def step(self, state: EngineState, img, out_hw: Tuple[int, int]
             ) -> Tuple[EngineState, torch.Tensor]:
        """propagate -> upsample (+ group merge) + argmax at out_hw ->
        update_memory with the label nearest-resized back to the input
        size. img [1, H, W, 3]. Returns (state, label [H, W] int32)."""
        img = self._to_dev(img, torch.float32)
        state, logits4 = self.propagate(state, img)
        label_full = self._merged_label(logits4, out_hw)
        return self.write_label(state, label_full,
                                tuple(img.shape[1:3])), label_full

    def scan_steps(self, state: EngineState, imgs, out_hw: Tuple[int, int]
                   ) -> Tuple[EngineState, torch.Tensor]:
        """step over a [K, 1, H, W, 3] chunk; returns (state, labels
        [K, H, W])."""
        labels = []
        for img in imgs:
            state, label = self.step(state, img, out_hw)
            labels.append(label)
        return state, torch.stack(labels)

    @torch.inference_mode()
    def step_multi(self, states: Sequence[EngineState], imgs,
                   out_hw: Tuple[int, int], flips: Sequence[bool]
                   ) -> Tuple[List[EngineState], torch.Tensor]:
        """All (scale, flip) augs of one frame: propagate each aug, then
        `aug_label`, then give each aug's memory the label, re-flipped and
        nearest-resized to that aug's input size. states/imgs/flips: one
        per aug. Returns (states, label [H, W] int32)."""
        imgs = [self._to_dev(img, torch.float32) for img in imgs]
        logits4s = []
        for st, img in zip(states, imgs):
            logits4s.append(self.propagate(st, img)[1])
        label_full = self.aug_label(logits4s, out_hw, flips)
        return [self.write_label(st, label_full, tuple(img.shape[1:3]), flip)
                for st, img, flip in zip(states, imgs, flips)], label_full

    def scan_steps_multi(self, states: Sequence[EngineState], imgs,
                         out_hw: Tuple[int, int], flips: Sequence[bool]
                         ) -> Tuple[List[EngineState], torch.Tensor]:
        """step_multi over a chunk: imgs holds one [K, 1, H, W, 3] stack per
        aug. Returns (states, labels [K, H, W])."""
        states = list(states)
        labels = []
        for frame in zip(*imgs):
            states, label = self.step_multi(states, frame, out_hw, flips)
            labels.append(label)
        return states, torch.stack(labels)

    # -- raw frames, prepared on the device -------------------------------
    @torch.inference_mode()
    def prep(self, raw, in_hw: Tuple[int, int], flip: bool = False
             ) -> torch.Tensor:
        """[K, H0, W0, 3] uint8 RGB frames (host or device) -> [K, 1, h, w,
        3] f32 on the device: cast, cv2-INTER_CUBIC resize to in_hw,
        ImageNet normalisation, optional horizontal flip."""
        x = resize_cubic(self._to_dev(raw), in_hw)
        x = (x - self._mean) / self._std
        if flip:
            x = x.flip(2)
        return x[:, None]

    def scan_steps_raw(self, state: EngineState, raw,
                       in_hw: Tuple[int, int], out_hw: Tuple[int, int],
                       flip: bool = False
                       ) -> Tuple[EngineState, torch.Tensor]:
        """Single-aug chunk from raw [K, H0, W0, 3] uint8 frames, uploaded
        once. Returns (state, labels [K, H, W] uint8 on the device)."""
        state, labels = self.scan_steps(state, self.prep(raw, in_hw, flip),
                                        out_hw)
        return state, labels.to(torch.uint8)

    def scan_steps_multi_raw(self, states: Sequence[EngineState], raw,
                             in_hws: Sequence[Tuple[int, int]],
                             out_hw: Tuple[int, int], flips: Sequence[bool]
                             ) -> Tuple[List[EngineState], torch.Tensor]:
        """Multi-aug chunk from one upload of raw [K, H0, W0, 3] uint8
        frames: every (scale, flip) aug is prepared from them on the
        device. Returns (states, labels [K, H, W] uint8 on the device)."""
        raw = self._to_dev(raw)
        imgs = [self.prep(raw, in_hw, flip)
                for in_hw, flip in zip(in_hws, flips)]
        states, labels = self.scan_steps_multi(states, imgs, out_hw, flips)
        return states, labels.to(torch.uint8)

    def predict_logits_at(self, logits4x: torch.Tensor,
                          out_hw: Tuple[int, int]) -> torch.Tensor:
        """Bilinear upsample of the 4x logits to out_hw."""
        return resize_bilinear(logits4x, out_hw,
                               self.cfg.model_align_corners)

"""Per-video inference engine: one id group, one augmentation.

Counterpart of `rmem_tpu/engine/inference.py` (`add_reference`,
`propagate`, `update_memory` and the fused `_step_impl`, here `step`; the
chunked scan becomes a Python frame loop). The bank capacity and image size
are fixed per video; the bank count, the memory-write flag and every
eviction decision stay on the device, so the host queues a frame's work
without waiting for the card. The state is updated in place: the returned
state is the object passed in.

The engine runs on the card unless the caller passes `device="cpu"`; with
no card and no device given it raises. On the card every kernel of the path
(stem, bank attention, local attention) is the CUDA kernel; on the CPU each
is its plain PyTorch version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.memory import bank_append, init_bank, update_bank_inplace
from rmem_tpu_torch.memory.bank import MemoryBank
from rmem_tpu_torch.models.encoders import fold_bn_params
from rmem_tpu_torch.ops.layers import map_to_seq
from rmem_tpu_torch.ops.masks import mask_unused_ids
from rmem_tpu_torch.ops.resize import (resize_bilinear, resize_nearest,
                                       upsample_argmax)
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

    def _encode(self, img: torch.Tensor):
        xs = self.model.encode_image(img)
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
        """img [B,H,W,3] float; label [B,H,W] int; obj_nums [B]."""
        cfg = self.cfg
        img = self._to_dev(img, torch.float32)
        label = self._to_dev(label)
        obj_nums = self._to_dev(obj_nums, torch.int32)
        xs, feat, (eh, ew) = self._encode(img)
        id_emb = self._id_emb(label)
        cur_pe, mem_pe = self.model.temporal_pe()
        if mem_pe is not None:
            mem_pe = mem_pe[0:1]     # one slot: the first PE row
        intermediates, mems, _ = self.model.lstt_forward(
            feat, None, None, None, id_emb, cur_pe, mem_pe, (eh, ew))
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
        xs, feat, size_2d = self._encode(img)
        bank = state.bank
        cur_pe, mem = self.model.temporal_pe()
        slot_pe = None
        if mem is not None:
            slot_pe = interpolate_temporal_pe(mem, bank.count, bank.capacity)
            # each physical slot takes the PE of its temporal rank
            slot_pe = slot_pe.index_select(0, bank.order.long())
        intermediates, mems, record = self.model.lstt_forward(
            feat, (bank.k, bank.v), bank.count,
            (state.short_k, state.short_v), None, cur_pe, slot_pe, size_2d)
        logits = self._decode(intermediates, xs, state.obj_nums)
        state.frame_step = state.frame_step + 1
        state.mems = mems
        state.record = record
        state.logits4x = logits
        return state, logits

    @torch.inference_mode()
    def update_memory(self, state: EngineState, label) -> EngineState:
        """label [B, H, W] int at the model's input size."""
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

    @torch.inference_mode()
    def step(self, state: EngineState, img, out_hw: Tuple[int, int]
             ) -> Tuple[EngineState, torch.Tensor]:
        """propagate -> upsample + argmax at out_hw -> update_memory with
        the label nearest-resized back to the input size. Returns (state,
        label [H, W] int32)."""
        img = self._to_dev(img, torch.float32)
        state, logits4 = self.propagate(state, img)
        if logits4.shape[0] != 1:
            raise NotImplementedError("step runs one id group (batch 1)")
        label_full = upsample_argmax(logits4, out_hw,
                                     self.cfg.model_align_corners)
        label_in = resize_nearest(label_full[None, ..., None],
                                  tuple(img.shape[1:3]))[..., 0]
        return self.update_memory(state, label_in), label_full

    def scan_steps(self, state: EngineState, imgs, out_hw: Tuple[int, int]
                   ) -> Tuple[EngineState, torch.Tensor]:
        """step over a [K, B, H, W, 3] chunk; returns (state, labels
        [K, H, W])."""
        labels = []
        for img in imgs:
            state, label = self.step(state, img, out_hw)
            labels.append(label)
        return state, torch.stack(labels)

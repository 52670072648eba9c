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
video. The write schedule (the frame step, the last long-term write's
step, the gap and the count of writes) is the host's: whether a frame
writes follows from it, and the bank count and every eviction decision
stay on the device, so the host queues a frame's work without waiting for
the card. The state is updated in place: the returned state is the object
passed in.

With RMem's ConvGRU memory (`Config.gru_memory_active`, AOT only) a
long-term write appends to the bank in temporal order and, once the bank
is full (which the count of writes tells the host), folds the evicted slot
into slot 1 through each layer's GRU cells
(memory/eviction.py:evict_if_full_gru). The functional step
(`functional_step`, which tools/export.py traces) has no host schedule:
it takes the write as a `torch.cond` on the flag and the round from the
bank's count on the device (evict_if_full_gru_device).

While a profiler runs, each layer of a served frame is a span of its own
(utils/trace.py): `rmem.engine.chunk`, `.prep`, `.frame`, `.propagate`,
`.aug_label` and `.update_memory`, the model's `rmem.model.encode`,
`.propagation` and `.decode`, and the long-term write named by its
outcome, `rmem.memory.write.spare`, `.append` or `.evict`.

On the card `step` and `step_multi` serve a set of states by replaying
CUDA graphs of the frame's pieces once each state has served one frame
eagerly (engine/graphs.py): the encoder, the propagation stack cut at each
block's bank attention, which is called eagerly between them, the decoder,
the label and each aug's memory update, each replayed inside the span that
names it. The graphs live on the states (`EngineState.graphs`); the engine
counts them (`graph_captures`, `graph_replays`, and `eager_frames`, the
frames served without them). `propagate` and `update_memory` on a state
that has graphs replay them too, so the state's tensors keep their
addresses. Built with `graphs=False`, the engine serves every frame
eagerly; with `graphs=True` off the card it runs the same pieces as plain
calls.

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
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from rmem_tpu_torch.engine.graphs import AugGraphs, FrameGraphs
from rmem_tpu_torch.memory import bank_append, init_bank, update_bank_inplace
from rmem_tpu_torch.memory.eviction import (evict_if_full_gru,
                                            evict_if_full_gru_device)
from rmem_tpu_torch.memory.bank import MemoryBank, bank_appended
from rmem_tpu_torch.models.encoders import fold_bn_params
from rmem_tpu_torch.ops.layers import map_to_seq
from rmem_tpu_torch.ops.masks import mask_unused_ids
from rmem_tpu_torch.ops.resize import (resize_bilinear, resize_cubic,
                                       resize_nearest, upsample_argmax)
from rmem_tpu_torch.ops.temporal_pe import interpolate_temporal_pe
from rmem_tpu_torch.utils.trace import span, spanned


@dataclass
class EngineState:
    """State of one video."""

    bank: MemoryBank
    short_k: torch.Tensor                 # [L, B, HW, Ck]
    short_v: torch.Tensor                 # [L, B, HW, Cv] (V ++ ID_V)
    mems: Dict[str, torch.Tensor]         # pending emissions of propagate
    record: Optional[torch.Tensor]        # [B, HW, S] layer-0 slot mass
    logits4x: torch.Tensor                # [B, H/4, W/4, obj+1] masked
    obj_nums: torch.Tensor                # [B] int32
    frame_step: int                       # the write schedule, on the host
    last_mem_step: int
    gap: int
    long_writes: int = 0                  # long-term writes after the ref
    gru_hid_k: Optional[torch.Tensor] = None   # [L, B, H, W, C], GRU only
    gru_hid_v: Optional[torch.Tensor] = None
    warm: bool = False                    # served a frame by step/step_multi
    graphs: Optional[AugGraphs] = None    # its pieces, once captured


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


def check_id_grid(feat: torch.Tensor, id_emb: torch.Tensor,
                  grid: Tuple[int, int]) -> None:
    """The identity embedding must cover the encoder's 16x grid. Swin's
    VALID patch embed gives floor(side / 4) patches, so at a side 1-3 past
    a multiple of 16 (481 x 849: 30 x 53) its grid is a row or column
    short of the id bank's (31 x 54), as in the JAX package, whose engine
    fails there too."""
    if id_emb.shape[1] != feat.shape[1]:
        raise ValueError(
            f"the encoder's {grid[0]}x{grid[1]} grid ({feat.shape[1]} "
            f"tokens) and the id bank's ({id_emb.shape[1]} tokens) differ; "
            "for Swin give a side that is not 1-3 past a multiple of 16 "
            "(e.g. 480 x 848)")


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
    casts every weight to bf16 (as the JAX engine does with its params).
    `graphs` (None: on the card) serves frames through the pieces of
    engine/graphs.py; False serves every frame eagerly."""

    def __init__(self, model: nn.Module, cfg: Config,
                 device: Union[None, str, torch.device] = None,
                 graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        self.graph_captures = self.graph_replays = self.eager_frames = 0
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
        # update_bank_inplace's write flag, made once: no copy a frame
        self._write_flag = {b: torch.tensor(b, device=self.device)
                            for b in (False, True)}

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

    @spanned("rmem.model.encode")
    def _encode(self, img: torch.Tensor, groups: int):
        """Encode once and broadcast the features to the id-group batch."""
        xs = self.model.encode_image(img)
        if img.shape[0] == 1 and groups > 1:
            # cat keeps the maps' channels-last layout
            xs = tuple(torch.cat([x] * groups) for x in xs)
        b, c, eh, ew = xs[-1].shape
        return xs, map_to_seq(xs[-1]).contiguous(), (eh, ew)

    @spanned("rmem.model.decode")
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
        check_id_grid(feat, id_emb, (eh, ew))
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
        hid_k = hid_v = None
        if cfg.gru_memory_active:
            hid_k = torch.zeros((lk.shape[0], b, eh, ew, lk.shape[-1]),
                                dtype=lk.dtype, device=self.device)
            hid_v = torch.zeros((lv.shape[0], b, eh, ew, lv.shape[-1]),
                                dtype=lv.dtype, device=self.device)
        state = EngineState(
            bank=bank, short_k=sk, short_v=sv, mems=mems, record=record0,
            logits4x=logits, obj_nums=obj_nums, frame_step=int(frame_step),
            last_mem_step=int(frame_step), gap=int(gap), gru_hid_k=hid_k,
            gru_hid_v=hid_v)
        return state, logits

    @torch.inference_mode()
    def propagate(self, state: EngineState, img
                  ) -> Tuple[EngineState, torch.Tensor]:
        return self._propagate(state, img)

    def _temporal_pes(self, bank: MemoryBank):
        """(cur_pe, slot_pe) of a frame propagated from `bank`: each
        physical slot takes the PE of its temporal rank."""
        cur_pe, mem = self.model.temporal_pe()
        if mem is None:
            return cur_pe, None
        slot_pe = interpolate_temporal_pe(mem, bank.count, bank.capacity)
        return cur_pe, slot_pe.index_select(0, bank.order.long())

    @spanned("rmem.engine.propagate")
    def _propagate(self, state: EngineState, img
                   ) -> Tuple[EngineState, torch.Tensor]:
        img = self._to_dev(img, torch.float32)
        if state.graphs is not None:
            return state.graphs.propagate(state, img)
        xs, feat, size_2d = self._encode(img, state.short_k.shape[1])
        bank = state.bank
        intermediates, mems, record = self.model.lstt_forward(
            feat, (bank.k, bank.v), bank.count,
            (state.short_k, state.short_v), None,
            *self._temporal_pes(bank), size_2d,
            self_pos=self.model.get_pos_emb(*size_2d), **self.route)
        logits = self._decode(intermediates, xs, state.obj_nums)
        state.frame_step += 1
        state.mems = mems
        state.record = record
        state.logits4x = logits
        return state, logits

    @torch.inference_mode()
    def update_memory(self, state: EngineState, label) -> EngineState:
        """label [B, H, W] int at the model's input size ([G, H, W] per
        group)."""
        return self._update_memory(state, label)

    @spanned("rmem.engine.update_memory")
    def _update_memory(self, state: EngineState, label,
                       write_flag: Optional[torch.Tensor] = None
                       ) -> EngineState:
        """update_memory; a bool device scalar `write_flag` decides the
        long-term write in place of the host's schedule (which it then
        leaves as it is)."""
        cfg = self.cfg
        if state.graphs is not None and write_flag is None:
            return state.graphs.update_memory(state, self._to_dev(label))
        id_emb = self._id_emb(self._to_dev(label))
        lk, lv, sk, sv = self.model.write_memories(state.mems, id_emb)
        state.short_k, state.short_v = sk, sv
        if cfg.no_long_memory:
            return state
        if write_flag is not None:
            write = (self._write_gru_flagged if cfg.gru_memory_active
                     else self._write_long)
            write(state, lk, lv, write_flag)
            return state
        do_long = state.frame_step - state.last_mem_step >= state.gap
        if cfg.gru_memory_active and not do_long:
            return state
        with span(self._write_span(state, do_long)):
            if cfg.gru_memory_active:
                self._write_gru(state, lk, lv, self._fg_prob(
                    state.logits4x, self._enc_hw(state), lk))
            else:
                self._write_long(state, lk, lv, self._write_flag[do_long])
        if do_long:
            state.last_mem_step = state.frame_step
            state.long_writes += 1
        return state

    def _write_span(self, state: EngineState, do_long: bool) -> str:
        """The long-term write's span, named by its outcome, which the
        host's schedule tells: `spare` (no write is due: the spare slot
        takes it), `append` or `evict` (the bank holds the reference and
        the earlier writes, 1 + long_writes slots, up to former + latter).
        """
        if not do_long:
            return "rmem.memory.write.spare"
        full = (1 + state.long_writes
                >= self.cfg.former_mem_len + self.cfg.latter_mem_len)
        return "rmem.memory.write." + ("evict" if full else "append")

    def _fg_prob(self, logits4x: torch.Tensor, grid: Tuple[int, int],
                 lk) -> torch.Tensor:
        """[B, HW] foreground probability of the last logits on the 16x
        grid: the eviction score's weight."""
        b, hw = lk.shape[1], lk.shape[2]
        up = resize_bilinear(logits4x, grid, self.cfg.model_align_corners)
        return 1.0 - torch.softmax(up.float(), dim=-1)[..., 0].reshape(b, hw)

    def _write_long(self, state: EngineState, lk, lv,
                    write_flag: torch.Tensor) -> None:
        """The in-place route's long-term write, decided on the device by
        the bool scalar write_flag (a frame that stores nothing writes the
        spare slot)."""
        update_bank_inplace(state.bank, lk, lv, write_flag,
                            self.cfg.former_mem_len, self.cfg.latter_mem_len,
                            state.record, self._fg_prob(
                                state.logits4x, self._enc_hw(state), lk))

    def _write_gru(self, state: EngineState, lk, lv, fg) -> None:
        """The ConvGRU memory's write: append in temporal order, then,
        past former + latter slots, one GRU eviction round (slot 1 takes
        the compressed victim)."""
        cfg = self.cfg
        bank_append(state.bank, lk, lv)
        size_2d = self._enc_hw(state)

        def compress(k, v, hid_k, hid_v):
            return self.model.lstt.compress_evicted(k, v, hid_k, hid_v,
                                                    size_2d)

        state.bank, state.gru_hid_k, state.gru_hid_v = evict_if_full_gru(
            state.bank, cfg.former_mem_len, cfg.latter_mem_len, compress,
            # the slots written: the reference's, the earlier writes', this
            state.gru_hid_k, state.gru_hid_v, 2 + state.long_writes,
            state.record, fg)

    def _write_gru_flagged(self, state: EngineState, lk, lv,
                           write_flag: torch.Tensor) -> None:
        """The ConvGRU memory's write decided on the device, for a traced
        step: torch.cond on the bool scalar write_flag between an append
        followed by evict_if_full_gru_device and no write. The round is a
        torch.where select inside the branch, as JAX's is, and not a
        nested cond: it pays the ConvGRU on the writes before the bank is
        full too (a bank that is full rounds on every write), and keeps
        the traced program to one higher-order op."""
        cfg = self.cfg
        size_2d = self._enc_hw(state)

        def compress(k, v, hid_k, hid_v):
            return self.model.lstt.compress_evicted(k, v, hid_k, hid_v,
                                                    size_2d)

        def write(k, v, count, score, scored, times, order, hid_k, hid_v,
                  lk, lv, record, fg):
            bank = bank_appended(MemoryBank(k, v, count, score, scored,
                                            times, order), lk, lv)
            bank, hid_k, hid_v = evict_if_full_gru_device(
                bank, cfg.former_mem_len, cfg.latter_mem_len, compress,
                hid_k, hid_v, record, fg)
            return (bank.k, bank.v, bank.count, bank.score, bank.scored,
                    bank.times, bank.order, hid_k, hid_v)

        def keep(*operands):
            # a branch may not return an input as it is
            return tuple(x.clone() for x in operands[:9])

        b = state.bank
        out = torch.cond(write_flag, write, keep, (
            b.k, b.v, b.count, b.score, b.scored, b.times, b.order,
            state.gru_hid_k, state.gru_hid_v, lk, lv, state.record,
            self._fg_prob(state.logits4x, self._enc_hw(state), lk)))
        state.bank = MemoryBank(*out[:7])
        state.gru_hid_k, state.gru_hid_v = out[7:]

    @spanned("rmem.engine.aug_label")
    def _merged_label(self, logits4: torch.Tensor, out_hw: Tuple[int, int],
                      graphs: Optional[FrameGraphs] = None) -> torch.Tensor:
        """The merged label [H, W] int32 of the group logits at out_hw; by
        the label graph of `graphs`, the frame's, where given."""
        if graphs is not None:
            return graphs.label([logits4])
        if logits4.shape[0] == 1:
            return upsample_argmax(logits4, out_hw,
                                   self.cfg.model_align_corners)
        merged = soft_logit_aggregation(self.predict_logits_at(logits4,
                                                               out_hw),
                                        self.cfg.model_max_obj_num)
        return torch.argmax(merged, dim=-1).to(torch.int32)

    def _input_label(self, state: EngineState, label_full: torch.Tensor,
                     in_hw: Tuple[int, int], flip: bool = False
                     ) -> torch.Tensor:
        """A merged label [H, W] at the output size as update_memory takes
        it: flipped for a flipped aug, nearest-resized to the input size,
        split into the state's id groups."""
        return self._label_in(label_full, in_hw, flip, state.short_k.shape[1])

    def _label_in(self, label_full: torch.Tensor, in_hw: Tuple[int, int],
                  flip: bool, groups: int) -> torch.Tensor:
        """`_input_label` for a state of `groups` id groups."""
        if flip:
            label_full = label_full.flip(1)
        label_in = resize_nearest(label_full[None, ..., None], in_hw)[..., 0]
        if groups > 1:
            label_in = separate_mask(label_in, groups,
                                     self.cfg.model_max_obj_num)
        return label_in

    def write_label(self, state: EngineState, label_full: torch.Tensor,
                    in_hw: Tuple[int, int], flip: bool = False
                    ) -> EngineState:
        """update_memory with a merged label [H, W] at the output size
        (`_input_label`); the frame's own label, where the state's label
        graph made it, goes in as that graph made it for the state."""
        g = state.graphs
        if g is not None and label_full is g.frame.label_full():
            return self.update_memory(state, g.frame.label_in(g.index))
        return self.update_memory(
            state, self._input_label(state, label_full, in_hw, flip))

    @spanned("rmem.engine.aug_label")
    def aug_label(self, logits4s: Sequence[torch.Tensor],
                  out_hw: Tuple[int, int], flips: Sequence[bool],
                  graphs: Optional[FrameGraphs] = None) -> torch.Tensor:
        """The label [H, W] int32 of one frame's augs: each aug's group
        logits upsampled to out_hw and merged, unflipped, softmaxed; the
        argmax of the mean. By the label graph of `graphs`, the frame's,
        where given."""
        if graphs is not None:
            return graphs.label(logits4s)
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

    @spanned("rmem.engine.frame")
    @torch.inference_mode()
    def step(self, state: EngineState, img, out_hw: Tuple[int, int]
             ) -> Tuple[EngineState, torch.Tensor]:
        """propagate -> upsample (+ group merge) + argmax at out_hw ->
        update_memory with the label nearest-resized back to the input
        size. img [1, H, W, 3]. Returns (state, label [H, W] int32)."""
        img = self._to_dev(img, torch.float32)
        frame, capture = self._frame_graphs([state], [img], out_hw, [False],
                                            multi=False)
        with span("rmem.engine.capture") if capture else nullcontext():
            state, logits4 = self.propagate(state, img)
            label_full = self._merged_label(logits4, out_hw, graphs=frame)
            state = self.write_label(state, label_full, tuple(img.shape[1:3]))
        return state, self._served([state], frame, label_full)

    def _frame_graphs(self, states: Sequence[EngineState], imgs,
                      out_hw: Tuple[int, int], flips: Sequence[bool],
                      multi: bool) -> Tuple[Optional[FrameGraphs], bool]:
        """(the graphs that serve this frame of `states` or None, whether
        the frame captures them): the states' own graphs where they fit,
        else new ones once every state has served a frame (engine/
        graphs.py)."""
        if not self.graphs or torch.compiler.is_compiling():
            return None, False
        own = states[0].graphs
        if own is not None and own.frame.fits(states, imgs, out_hw, flips,
                                               multi):
            return own.frame, False
        if not all(st.warm for st in states):
            return None, False
        frame = FrameGraphs(self, [img.shape[1:3] for img in imgs], out_hw,
                            flips, multi, states[0].short_k.shape[1])
        for i, (st, img) in enumerate(zip(states, imgs)):
            st.graphs = AugGraphs(frame, i, st, img)
        return frame, True

    def _served(self, states: Sequence[EngineState],
                frame: Optional[FrameGraphs],
                label: torch.Tensor) -> torch.Tensor:
        """The frame's label as step and step_multi return it: a copy of
        the label graph's output, which the next frame rewrites."""
        if frame is not None:
            return label.clone()
        self.eager_frames += 1
        for st in states:
            st.warm = True
        return label

    # -- the step as a function of tensors, for torch.export ------------
    STATE_FIELDS = ("bank_k", "bank_v", "bank_count", "bank_score",
                    "bank_scored", "bank_times", "bank_order", "short_k",
                    "short_v", "record", "logits4x", "obj_nums")
    GRU_FIELDS = ("gru_hid_k", "gru_hid_v")

    def state_fields(self) -> Tuple[str, ...]:
        """The state's tensors for this engine's config, in order:
        STATE_FIELDS, without the record under no_long_memory (which
        scores no slot), then GRU_FIELDS with the ConvGRU memory."""
        names = self.STATE_FIELDS
        if self.cfg.no_long_memory:
            names = tuple(n for n in names if n != "record")
        if self.cfg.gru_memory_active:
            names += self.GRU_FIELDS
        return names

    def state_tensors(self, state: EngineState) -> Tuple[torch.Tensor, ...]:
        """The tensors of a state in state_fields' order."""
        b = state.bank
        have = dict(bank_k=b.k, bank_v=b.v, bank_count=b.count,
                    bank_score=b.score, bank_scored=b.scored,
                    bank_times=b.times, bank_order=b.order,
                    short_k=state.short_k, short_v=state.short_v,
                    record=state.record, logits4x=state.logits4x,
                    obj_nums=state.obj_nums, gru_hid_k=state.gru_hid_k,
                    gru_hid_v=state.gru_hid_v)
        return tuple(have[n] for n in self.state_fields())

    def functional_step(self, tensors: Sequence[torch.Tensor], img,
                        write_flag: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """`step` as a function: (the state's tensors in state_fields'
        order, img [1, H, W, 3], the long-term write flag as a bool device
        scalar) -> (the new state's tensors, label [H, W] int32). It
        copies the state first, so no output aliases an input. The write
        schedule is the caller's: the flag is what `update_memory` would
        decide on the host. With the ConvGRU memory the write is a
        torch.cond on the flag and the eviction round is decided from the
        bank's count on the device (`_write_gru_flagged`); with
        no_long_memory only the short-term memory is written and the flag
        is not read. Not under inference_mode, so that torch.export can
        trace it (under no_grad)."""
        t = dict(zip(self.state_fields(), (x.clone() for x in tensors)))
        state = EngineState(
            bank=MemoryBank(t["bank_k"], t["bank_v"], t["bank_count"],
                            t["bank_score"], t["bank_scored"],
                            t["bank_times"], t["bank_order"]),
            short_k=t["short_k"], short_v=t["short_v"], mems={},
            record=t.get("record"), logits4x=t["logits4x"],
            obj_nums=t["obj_nums"], frame_step=0, last_mem_step=0, gap=1,
            gru_hid_k=t.get("gru_hid_k"), gru_hid_v=t.get("gru_hid_v"))
        img = self._to_dev(img, torch.float32)
        state, logits4 = self._propagate(state, img)
        label = self._merged_label(logits4, out_hw)
        self._update_memory(state,
                            self._input_label(state, label,
                                              tuple(img.shape[1:3])),
                            write_flag)
        return self.state_tensors(state), label

    def write_due(self, state: EngineState) -> bool:
        """Whether the next step writes the long-term bank, by the host's
        schedule (the flag `functional_step` takes); advances the schedule
        as `step` would."""
        state.frame_step += 1
        due = state.frame_step - state.last_mem_step >= state.gap
        if due:
            state.last_mem_step = state.frame_step
            state.long_writes += 1
        return due

    def scan_steps(self, state: EngineState, imgs, out_hw: Tuple[int, int]
                   ) -> Tuple[EngineState, torch.Tensor]:
        """step over a [K, 1, H, W, 3] chunk; returns (state, labels
        [K, H, W])."""
        labels = []
        for img in imgs:
            state, label = self.step(state, img, out_hw)
            labels.append(label)
        return state, torch.stack(labels)

    @spanned("rmem.engine.frame")
    @torch.inference_mode()
    def step_multi(self, states: Sequence[EngineState], imgs,
                   out_hw: Tuple[int, int], flips: Sequence[bool]
                   ) -> Tuple[List[EngineState], torch.Tensor]:
        """All (scale, flip) augs of one frame: propagate each aug, then
        `aug_label`, then give each aug's memory the label, re-flipped and
        nearest-resized to that aug's input size. states/imgs/flips: one
        per aug. Returns (states, label [H, W] int32)."""
        imgs = [self._to_dev(img, torch.float32) for img in imgs]
        frame, capture = self._frame_graphs(states, imgs, out_hw, flips,
                                            multi=True)
        with span("rmem.engine.capture") if capture else nullcontext():
            logits4s = [self.propagate(st, img)[1]
                        for st, img in zip(states, imgs)]
            label_full = self.aug_label(logits4s, out_hw, flips,
                                        graphs=frame)
            states = [self.write_label(st, label_full, tuple(img.shape[1:3]),
                                       flip)
                      for st, img, flip in zip(states, imgs, flips)]
        return states, self._served(states, frame, label_full)

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
    @spanned("rmem.engine.prep")
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

    @spanned("rmem.engine.chunk")
    def scan_steps_raw(self, state: EngineState, raw,
                       in_hw: Tuple[int, int], out_hw: Tuple[int, int],
                       flip: bool = False
                       ) -> Tuple[EngineState, torch.Tensor]:
        """Single-aug chunk from raw [K, H0, W0, 3] uint8 frames, uploaded
        once. Returns (state, labels [K, H, W] uint8 on the device)."""
        state, labels = self.scan_steps(state, self.prep(raw, in_hw, flip),
                                        out_hw)
        return state, labels.to(torch.uint8)

    @spanned("rmem.engine.chunk")
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

"""The clip loss of one training step, with the frame loop in Python.

Counterpart of `rmem_tpu/engine/training.py:train_forward`:

1. one batched encoder pass over all B*T frames;
2. the reference frame with its ground-truth identity (id-shuffled), whose
   decode gives the aux loss;
3. frames 1..T-1 in order: propagate against the long-term bank and the
   previous frame's short-term memory, decode to the /4 logit grid, then
   write this frame's memories from its ground-truth labels or, under the
   `use_prev_pred` curriculum, from the argmax prediction with the id
   embedding's gradient stopped; every `train_long_term_mem_gap` frames the
   bank takes a slot and evicts FIFO when full (with RMem's ConvGRU
   memory, `gru_memory_active`, the evicted slot after the first two is
   folded into slot 1 through the GRU cells, whose hidden states start at
   zero and carry from frame to frame); with `reverse_infer`, after each
   such write frame 0 is decoded again from the bank without its first
   slot and frame 1's short-term memory, detached, and reverse_loss times
   its loss against frame 0's labels joins that frame's loss;
4. the upsample, loss and IoU once over all frames after the loop, and the
   loss aux_weight(step) * aux + mean(frame losses), plus, where
   `var_loss_weight` > 0, that weight times the top-down encoder's
   reconstruction loss from step 1's encoder pass (`metrics["var_loss"]`).

Every LSTT call takes the sine position embedding for its self-attention
(the GPM ignores it) and no drop-path generator, as the JAX step passes
no dp_rng. Each frame's propagate and decode run under
torch.utils.checkpoint (the JAX package's remat of its scan body), so the
backward recomputes them instead of keeping T sets of activations; so
does each reverse decode. The bank is rebuilt out of place at each write.
Everything the loop branches on (the frame index, the write schedule and
so the bank's fill, its evictions and the reverse decodes, the curriculum
flag, the step) is a host integer, and the bank's count stays on the
device, so the loop never reads back from the card. The clip loss runs in
the profiler span `rmem.train.forward`, and inside it the encoder pass,
each propagation and each decode in theirs (`rmem.model.encode`,
`.propagation`, `.decode`; under recomputation `*.recompute`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.engine.inference import check_id_grid
from rmem_tpu_torch.memory import bank_appended, evict_if_full, init_bank
from rmem_tpu_torch.memory.bank import bank_compact
from rmem_tpu_torch.memory.eviction import evict_if_full_gru
from rmem_tpu_torch.ops.layers import map_to_seq
from rmem_tpu_torch.ops.losses import segmentation_loss
from rmem_tpu_torch.ops.masks import (map_id_label, mask_unused_ids,
                                      unshuffle_logits)
from rmem_tpu_torch.ops.resize import resize_bilinear
from rmem_tpu_torch.ops.temporal_pe import interpolate_temporal_pe
from rmem_tpu_torch.utils.metric import pytorch_iou_batched
from rmem_tpu_torch.utils.trace import span, spanned


def check_supported(cfg: Config) -> None:
    """The settings the training step takes. The ConvGRU memory acts only
    where the JAX step acts on it, on the AOT path (`gru_memory_active`);
    DeAOT trains with the flag ignored, as there."""
    if cfg.train_remat not in ("full", "dots", "none"):
        raise ValueError(f"train_remat {cfg.train_remat!r}")
    if cfg.train_opt not in ("adamw", "sgd"):
        raise ValueError(f"train_opt {cfg.train_opt!r}")


def aux_weight(step: int, cfg: Config) -> float:
    """The reference frame's loss weight, annealed to 0 over the run (f32
    as in the JAX step)."""
    f = np.float32
    aux_step = f(cfg.train_total_steps * cfg.train_aux_loss_ratio + 1e-5)
    return float(f(cfg.train_aux_loss_weight)
                 * max(aux_step - f(step), f(0.0)) / aux_step)


@spanned("rmem.train.forward")
def train_forward(model, imgs: torch.Tensor, labels: torch.Tensor,
                  obj_nums: torch.Tensor, step: int,
                  shuffle: Optional[torch.Tensor], use_prev_pred: bool,
                  cfg: Config) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clip loss. imgs [B,T,H,W,3] float; labels [B,T,H,W] int (255 =
    ignore); obj_nums [B]; shuffle [B, obj+1, obj+1] permutation matrices
    or None. `model` trains (its kernels take their differentiable forms).
    Returns (loss, metrics), all on the device."""
    check_supported(cfg)
    b, t = imgs.shape[:2]
    hw_in = tuple(imgs.shape[2:4])
    align = cfg.model_align_corners
    max_obj = cfg.model_max_obj_num

    with span("rmem.model.encode"):
        xs_flat, var_loss = model.encode_image_aux(
            imgs.reshape(b * t, *imgs.shape[2:]))
    xs_bt = [x.reshape(b, t, *x.shape[1:]) for x in xs_flat]
    eh, ew = xs_bt[-1].shape[-2:]
    self_pos = model.get_pos_emb(eh, ew)
    cur_pe, mem_pe = model.temporal_pe()
    perm = None if shuffle is None else torch.argmax(shuffle, dim=-1)

    def frame(i):
        xs = tuple(x[:, i] for x in xs_bt)
        return xs, map_to_seq(xs[-1]).contiguous()

    def id_embed(label):
        e = model.get_id_emb(map_id_label(label, perm, max_obj))
        return e.detach() if use_prev_pred else e

    def decode4(intermediates, xs):
        with span("rmem.model.decode"):
            logits4 = model.decode_id_logits(intermediates, xs).float()
            if shuffle is not None:
                logits4 = unshuffle_logits(logits4, shuffle)
            return mask_unused_ids(logits4, obj_nums)

    def frame_losses(logits4, label):
        """[N, h, w, C] /4 logits, [N, H, W] labels -> [N] losses."""
        n = logits4.shape[0]
        return segmentation_loss(
            resize_bilinear(logits4, hw_in, align), label,
            obj_nums.repeat(n // b), step, cfg.train_top_k_percent_pixels,
            cfg.train_hard_mining_ratio * cfg.train_total_steps)

    # the reference frame
    xs0, feat0 = frame(0)
    ref_id = id_embed(labels[:, 0])
    check_id_grid(feat0, ref_id, (eh, ew))
    inter0, mems0, _ = model.lstt_forward(
        feat0, None, None, None, ref_id, cur_pe,
        None if mem_pe is None else mem_pe[0:1], (eh, ew), self_pos=self_pos)
    lk, lv, short_k, short_v = model.write_memories(mems0, ref_id)
    bank = init_bank(lk.shape[0], cfg.max_mem_slots, b, eh * ew,
                     lk.shape[-1], lv.shape[-1], dtype=lk.dtype,
                     device=lk.device)
    bank = bank_appended(bank, lk, lv)
    slots = 1                       # bank.count, as the host knows it
    aux_loss = frame_losses(decode4(inter0, xs0), labels[:, 0])

    def propagate(feat, bank_k, bank_v, count, short_k, short_v, *xs):
        slot_pe = (None if mem_pe is None else interpolate_temporal_pe(
            mem_pe, count, bank_k.shape[1]))
        inter, mems, _ = model.lstt_forward(
            feat, (bank_k, bank_v), count, (short_k, short_v), None, cur_pe,
            slot_pe, (eh, ew), self_pos=self_pos)
        return decode4(inter, xs), mems

    remat = cfg.train_remat != "none" and t > 2
    run = ((lambda fn, *a: checkpoint(fn, *a, use_reentrant=False))
           if remat else (lambda fn, *a: fn(*a)))

    gru = cfg.gru_memory_active
    hid_k = hid_v = None
    if gru:
        hid_k = torch.zeros((lk.shape[0], b, eh, ew, lk.shape[-1]),
                            dtype=lk.dtype, device=lk.device)
        hid_v = torch.zeros((lv.shape[0], b, eh, ew, lv.shape[-1]),
                            dtype=lv.dtype, device=lv.device)

    def compress(k, v, hk, hv):
        return model.lstt.compress_evicted(k, v, hk, hv, (eh, ew))

    def reverse_logits(bank_k, bank_v, count, short_k, short_v):
        """Frame 0 decoded from the bank without its first slot."""
        return propagate(feat0, bank_k, bank_v, count, short_k, short_v,
                         *xs0)[0]

    logits_seq, preds, reverse = [], [], []
    last_mem = 0
    # frame 1's short-term memory, detached: set before any write, which
    # comes at frame 1 at the earliest
    first_short = None
    for i in range(1, t):
        xs, feat = frame(i)
        args = (feat, bank.k, bank.v, bank.count, short_k, short_v, *xs)
        logits4, mems = run(propagate, *args)
        with torch.no_grad():
            pred = torch.argmax(resize_bilinear(logits4, hw_in, align),
                                dim=-1).to(torch.int32)
        lk, lv, short_k, short_v = model.write_memories(
            mems, id_embed(pred if use_prev_pred else labels[:, i]))
        if i == 1:
            first_short = (short_k.detach(), short_v.detach())
        write = (not cfg.no_long_memory
                 and i - last_mem >= cfg.train_long_term_mem_gap)
        if write:
            slots += 1
            bank = bank_appended(bank, lk, lv)
            if gru:
                bank, hid_k, hid_v = evict_if_full_gru(
                    bank, cfg.former_mem_len, cfg.latter_mem_len, compress,
                    hid_k, hid_v, slots)
            else:
                bank = evict_if_full(bank, cfg.former_mem_len,
                                     cfg.latter_mem_len, slots)
            slots = min(slots, cfg.former_mem_len + cfg.latter_mem_len)
            last_mem = i
        if write and cfg.reverse_infer:
            rb = bank_compact(bank, 0)
            reverse.append((i - 1, run(reverse_logits, rb.k, rb.v, rb.count,
                                       *first_short)))
        logits_seq.append(logits4)
        preds.append(pred)

    label_seq = labels[:, 1:].transpose(0, 1)                # [T-1, B, H, W]
    losses = frame_losses(torch.cat(logits_seq),
                          label_seq.reshape(-1, *hw_in)).reshape(t - 1, b)
    if reverse:
        rlosses = frame_losses(torch.cat([r for _, r in reverse]),
                               labels[:, 0].repeat(len(reverse), 1, 1))
        at = torch.tensor([j for j, _ in reverse], device=losses.device)
        losses = losses.index_add(
            0, at, cfg.reverse_loss * rlosses.reshape(len(reverse), b))
    ious = torch.stack([pytorch_iou_batched(p, lab, obj_nums, max_obj)
                        for p, lab in zip(preds, label_seq)])
    aux_w = aux_weight(step, cfg)
    pred_loss = losses.mean()
    loss = aux_w * aux_loss.mean() + pred_loss
    metrics = {"loss": loss.detach(), "aux_loss": aux_loss.mean().detach(),
               "pred_loss": pred_loss.detach(),
               "aux_weight": torch.tensor(aux_w),
               "loss_per_frame": losses.mean(-1).detach(),
               "iou_per_frame": ious, "iou": ious.mean(),
               "pred_label_last": preds[-1]}
    if cfg.var_loss_weight > 0:
        # the top-down encoder's reconstruction loss (0 for an encoder
        # without one, as the JAX step's empty mean of sown losses)
        if var_loss is None:
            var_loss = torch.zeros((), device=loss.device)
        loss = loss + cfg.var_loss_weight * var_loss
        metrics["loss"] = loss.detach()
        metrics["var_loss"] = var_loss.detach()
    return loss, metrics

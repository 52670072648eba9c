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
   bank takes a slot and evicts FIFO when full;
4. the upsample, loss and IoU once over all frames after the loop, and the
   loss aux_weight(step) * aux + mean(frame losses), plus, where
   `var_loss_weight` > 0, that weight times the top-down encoder's
   reconstruction loss from step 1's encoder pass (`metrics["var_loss"]`).

Every LSTT call takes the sine position embedding for its self-attention
(the GPM ignores it) and no drop-path generator, as the JAX step passes
no dp_rng. Each frame's propagate and decode run under
torch.utils.checkpoint (the JAX package's remat of its scan body), so the
backward recomputes them instead of keeping T sets of activations. The
bank is rebuilt out of place at each write. Everything the loop branches
on (the frame index, the write schedule and so the bank's fill and its
evictions, the curriculum flag, the step) is a host integer, and the
bank's count stays on the device, so the loop never reads back from the
card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.engine.inference import check_id_grid
from rmem_tpu_torch.memory import bank_appended, evict_if_full, init_bank
from rmem_tpu_torch.ops.layers import map_to_seq
from rmem_tpu_torch.ops.losses import segmentation_loss
from rmem_tpu_torch.ops.masks import (map_id_label, mask_unused_ids,
                                      unshuffle_logits)
from rmem_tpu_torch.ops.resize import resize_bilinear
from rmem_tpu_torch.ops.temporal_pe import interpolate_temporal_pe
from rmem_tpu_torch.utils.metric import pytorch_iou_batched


def check_supported(cfg: Config) -> None:
    """The JAX step's branches that the port does not take. The ConvGRU
    memory acts only where the JAX step acts on it, on the AOT path
    (`gru_memory_active`); DeAOT trains with the flag ignored, as there."""
    if cfg.reverse_infer:
        raise NotImplementedError("reverse_infer training is not ported")
    if cfg.gru_memory_active:
        raise NotImplementedError("gru_memory training is not ported")
    if cfg.train_remat not in ("full", "dots", "none"):
        raise ValueError(f"train_remat {cfg.train_remat!r}")


def aux_weight(step: int, cfg: Config) -> float:
    """The reference frame's loss weight, annealed to 0 over the run (f32
    as in the JAX step)."""
    f = np.float32
    aux_step = f(cfg.train_total_steps * cfg.train_aux_loss_ratio + 1e-5)
    return float(f(cfg.train_aux_loss_weight)
                 * max(aux_step - f(step), f(0.0)) / aux_step)


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
    logits_seq, preds = [], []
    last_mem = 0
    for i in range(1, t):
        xs, feat = frame(i)
        args = (feat, bank.k, bank.v, bank.count, short_k, short_v, *xs)
        logits4, mems = (checkpoint(propagate, *args, use_reentrant=False)
                         if remat else propagate(*args))
        with torch.no_grad():
            pred = torch.argmax(resize_bilinear(logits4, hw_in, align),
                                dim=-1).to(torch.int32)
        lk, lv, short_k, short_v = model.write_memories(
            mems, id_embed(pred if use_prev_pred else labels[:, i]))
        if not cfg.no_long_memory and \
                i - last_mem >= cfg.train_long_term_mem_gap:
            slots += 1
            bank = evict_if_full(bank_appended(bank, lk, lv),
                                 cfg.former_mem_len, cfg.latter_mem_len,
                                 slots)
            slots = min(slots, cfg.former_mem_len + cfg.latter_mem_len)
            last_mem = i
        logits_seq.append(logits4)
        preds.append(pred)

    label_seq = labels[:, 1:].transpose(0, 1)                # [T-1, B, H, W]
    losses = frame_losses(torch.cat(logits_seq),
                          label_seq.reshape(-1, *hw_in)).reshape(t - 1, b)
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

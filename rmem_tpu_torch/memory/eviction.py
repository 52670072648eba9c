"""RMem's importance x freshness eviction, on the device.

Counterpart of `rmem_tpu/memory/eviction.py:update_bank_inplace` (the rule
of scored_drop_index): importance is the layer-0 long-term attention mass
per slot weighted by the predicted foreground probability of each query;
it enters a moving mean (factor 0.8); a UCB bonus 1.5*sqrt(log(sum n) /
(n + 8)) rewards slots that survived few rounds; the victim is the argmin
over slots of temporal rank >= 1 (never the reference frame). The write
flag, the victim, the write index and `order` all stay tensors, so no frame
waits for the host. Ties resolve to the lowest slot, as jnp.argmin does.

Training evicts FIFO instead (`evict_if_full`, the JAX function with
use_attn_weight=False), out of place.
"""

from __future__ import annotations

import torch

from rmem_tpu_torch.memory.bank import MemoryBank, bank_compact, write_slot

MOVING_MEAN_FACTOR = 0.8
UCB_ADD = 8.0
UCB_MUL = 1.5
IGNORE_FORMER = 1


def update_bank_inplace(bank: MemoryBank, new_k: torch.Tensor,
                        new_v: torch.Tensor, do_write: torch.Tensor,
                        former_len: int, latter_len: int,
                        record_mass: torch.Tensor,
                        fg_prob: torch.Tensor) -> MemoryBank:
    """Append + evict as ONE single-slot write, in place.

    Slots never move: when the bank is full the new entry overwrites the
    victim and `order` tracks temporal rank. Frames with do_write False
    write into the spare slot S-1, which is never valid, instead of
    branching on the host. new_k/new_v [L, B, HW, *]; record_mass
    [B, HWq, S]; fg_prob [B, HWq]."""
    capacity = bank.capacity
    if capacity <= former_len + latter_len:
        raise ValueError("the bank needs a spare slot beyond former+latter")
    dev = bank.count.device
    slot_ids = torch.arange(capacity, device=dev)
    n_old = bank.count
    is_full = n_old >= (former_len + latter_len)
    valid = slot_ids < n_old

    w = torch.einsum("bqs,bq->s", record_mass.float(),
                     fg_prob.float()) / record_mass.shape[0]
    w = torch.where(valid, w, 0.0)
    w = w / torch.clamp(w.sum(), min=1e-12)
    new_score = torch.where(
        bank.scored, (1.0 - MOVING_MEAN_FACTOR) * bank.score
        + MOVING_MEAN_FACTOR * w, w)
    new_score = torch.where(valid, new_score, bank.score)
    new_scored = bank.scored | valid
    new_times = torch.where(valid, bank.times + 1, bank.times)
    counts = torch.where(valid, new_times.float(), 0.0)
    # the reference slot is pinned and never a candidate
    counts = torch.cat([n_old.float().reshape(1), counts[1:]])
    bonus = UCB_MUL * torch.sqrt(torch.log(counts.sum()) / (counts + UCB_ADD))
    candidates = (bank.order >= IGNORE_FORMER) & valid
    score_total = torch.where(candidates, new_score + bonus,
                              torch.full_like(new_score, float("inf")))
    victim = torch.argmin(score_total).to(torch.int32)

    target = torch.where(is_full, victim, n_old)
    write_idx = torch.where(do_write, target,
                            torch.full_like(target, capacity - 1))

    # a gather, not order[target]: indexing with a 0-d tensor reads it on
    # the host, which would stall every frame on the card
    victim_rank = bank.order.gather(0, target.long().reshape(1))[0]
    new_rank = torch.where(is_full, n_old - 1, n_old)
    dec = is_full & (bank.order > victim_rank) & (bank.order < n_old)
    order2 = torch.where(dec, bank.order - 1, bank.order)
    order2 = torch.where(slot_ids == target, new_rank, order2)
    new_order = torch.where(do_write, order2, bank.order)

    upd = do_write & is_full
    fresh = upd & (slot_ids == target)
    bank.score = torch.where(fresh, 0.0,
                             torch.where(upd, new_score, bank.score))
    bank.scored = torch.where(fresh, False,
                              torch.where(upd, new_scored, bank.scored))
    bank.times = torch.where(fresh, 1,
                             torch.where(upd, new_times, bank.times)
                             ).to(torch.int32)
    bank.order = new_order.to(torch.int32)
    write_slot(bank, write_idx, new_k, new_v)
    bank.count = torch.where(do_write & ~is_full, n_old + 1, n_old)
    return bank


def evict_if_full(bank: MemoryBank, former_len: int, latter_len: int,
                  count: int) -> MemoryBank:
    """Training's rule, out of place: when count > former + latter, drop
    the slot at `former_len` (FIFO after the former slots). `count` is the
    bank's count as the host knows it from the write schedule, so the
    decision reads nothing back from the device."""
    if count <= former_len + latter_len:
        return bank
    return bank_compact(bank, former_len)

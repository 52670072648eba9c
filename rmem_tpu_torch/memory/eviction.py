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

RMem's ConvGRU memory (`evict_if_full_gru`) keeps the bank in temporal
order instead: append, then fold the victim's keys and values into slot 1
through the GRU cells, then compact. Serving picks the victim by the same
rule with slot 1 pinned too (`scored_drop_index(gru_memory=True)`),
training FIFO at `former_len + 1`. Whether a round runs is known on the
host from the write schedule, so the eager route branches there and reads
nothing back; the victim stays a device tensor. The exported step has no
host schedule: `evict_if_full_gru_device` decides the round from the
bank's own count and selects, as the JAX function does.
"""

from __future__ import annotations

import torch

from dataclasses import replace
from typing import Callable, Optional

from rmem_tpu_torch.memory.bank import MemoryBank, bank_compact, write_slot

MOVING_MEAN_FACTOR = 0.8
UCB_ADD = 8.0
UCB_MUL = 1.5
IGNORE_FORMER = 1


def _moving_mean(bank: MemoryBank, record_mass: torch.Tensor,
                 fg_prob: torch.Tensor, mask: torch.Tensor):
    """(score, scored) after one round: the slots in `mask` take the
    moving mean of their foreground-weighted attention mass, normalised
    over them (a slot scored for the first time takes its mass)."""
    w = torch.einsum("bqs,bq->s", record_mass.float(),
                     fg_prob.float()) / record_mass.shape[0]
    w = torch.where(mask, w, 0.0)
    w = w / torch.clamp(w.sum(), min=1e-12)
    score = torch.where(
        bank.scored, (1.0 - MOVING_MEAN_FACTOR) * bank.score
        + MOVING_MEAN_FACTOR * w, w)
    return torch.where(mask, score, bank.score), bank.scored | mask


def _victim(score: torch.Tensor, counts: torch.Tensor,
            candidates: torch.Tensor) -> torch.Tensor:
    """The candidate slot of least score + UCB bonus 1.5 sqrt(log(sum n) /
    (n + 8)), the lowest on a tie (int32 device scalar)."""
    bonus = UCB_MUL * torch.sqrt(torch.log(counts.sum()) / (counts + UCB_ADD))
    total = torch.where(candidates, score + bonus,
                        torch.full_like(score, float("inf")))
    return torch.argmin(total).to(torch.int32)


def scored_drop_index(bank: MemoryBank, record_mass: torch.Tensor,
                      fg_prob: torch.Tensor, gru_memory: bool = False):
    """(drop_idx, new_score, new_scored, new_times) of a bank in temporal
    order just after an append (count slots, the newest not covered by
    record_mass). Slot 0's count in the UCB bonus is pinned to the old slot
    count, and with gru_memory slot 1's too; candidates are the old slots
    from 1 (from 2 with gru_memory). new_times counts every present slot,
    the newest too. record_mass [B, HWq, S]; fg_prob [B, HWq]."""
    slot_ids = torch.arange(bank.capacity, device=bank.count.device)
    n_old = bank.count - 1
    old_mask = slot_ids < n_old
    new_score, new_scored = _moving_mean(bank, record_mass, fg_prob,
                                         old_mask)
    new_times = torch.where(slot_ids < bank.count, bank.times + 1,
                            bank.times)
    counts = torch.where(old_mask, new_times.float(), 0.0)
    pinned = 2 if gru_memory else 1
    counts = torch.where(slot_ids < pinned, n_old.float(), counts)
    candidates = (slot_ids >= IGNORE_FORMER + int(gru_memory)) & old_mask
    return (_victim(new_score, counts, candidates), new_score, new_scored,
            new_times.to(torch.int32))


def _gru_round(bank: MemoryBank, former_len: int, compress_fn: Callable,
               hid_k: torch.Tensor, hid_v: torch.Tensor,
               record_mass: Optional[torch.Tensor] = None,
               fg_prob: Optional[torch.Tensor] = None):
    """One GRU eviction round, whatever the count: (bank, hid_k, hid_v)."""
    if record_mass is not None:
        drop, score, scored, times = scored_drop_index(
            bank, record_mass, fg_prob, gru_memory=True)
        bank = replace(bank, score=score, scored=scored, times=times)
    else:
        drop = torch.full((), former_len + 1, dtype=torch.int32,
                          device=bank.count.device)
    i = drop.reshape(1).long()
    ok, ov, hid_k, hid_v = compress_fn(bank.k.index_select(1, i)[:, 0],
                                       bank.v.index_select(1, i)[:, 0],
                                       hid_k, hid_v)
    one = torch.ones(1, dtype=torch.long, device=i.device)
    bank = replace(bank,
                   k=bank.k.index_copy(1, one, ok[:, None].to(bank.k.dtype)),
                   v=bank.v.index_copy(1, one, ov[:, None].to(bank.v.dtype)))
    return bank_compact(bank, drop), hid_k, hid_v


def evict_if_full_gru(bank: MemoryBank, former_len: int, latter_len: int,
                      compress_fn: Callable, hid_k: torch.Tensor,
                      hid_v: torch.Tensor, count: int,
                      record_mass: Optional[torch.Tensor] = None,
                      fg_prob: Optional[torch.Tensor] = None):
    """One GRU eviction round on a bank just appended to, iff `count` (the
    slots written into it, as the host counts them) exceeds former +
    latter. The victim's keys
    and values [L, B, HW, C] go through compress_fn(k, v, hid_k, hid_v) ->
    (out_k, out_v, hid_k, hid_v); the outputs replace slot 1, then the
    victim is compacted away. With record_mass and fg_prob (serving) the
    victim is scored_drop_index's with slot 1 pinned, and the statistics
    update; without (training) it is slot former_len + 1, FIFO. Out of
    place: autograd sees every bank it saved. Returns (bank, hid_k,
    hid_v); the hidden states change only on a round."""
    if count <= former_len + latter_len:
        return bank, hid_k, hid_v
    return _gru_round(bank, former_len, compress_fn, hid_k, hid_v,
                      record_mass, fg_prob)


def evict_if_full_gru_device(bank: MemoryBank, former_len: int,
                             latter_len: int, compress_fn: Callable,
                             hid_k: torch.Tensor, hid_v: torch.Tensor,
                             record_mass: Optional[torch.Tensor] = None,
                             fg_prob: Optional[torch.Tensor] = None):
    """evict_if_full_gru with the decision on the device, for a traced
    step: the round runs whatever the count, and every output is selected
    by `bank.count > former + latter` (JAX's `should`), so the ConvGRU is
    paid on every call. Out of place; no output is an input."""
    should = bank.count > former_len + latter_len
    new, new_k, new_v = _gru_round(bank, former_len, compress_fn, hid_k,
                                   hid_v, record_mass, fg_prob)
    # the names spelled out: torch.cond's tracer does not read
    # dataclasses.fields
    picked = {n: torch.where(should, getattr(new, n), getattr(bank, n))
              for n in ("k", "v", "count", "score", "scored", "times",
                        "order")}
    return (MemoryBank(**picked), torch.where(should, new_k, hid_k),
            torch.where(should, new_v, hid_v))


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

    new_score, new_scored = _moving_mean(bank, record_mass, fg_prob, valid)
    new_times = torch.where(valid, bank.times + 1, bank.times)
    counts = torch.where(valid, new_times.float(), 0.0)
    # the reference slot is pinned and never a candidate
    counts = torch.cat([n_old.float().reshape(1), counts[1:]])
    victim = _victim(new_score, counts,
                     (bank.order >= IGNORE_FORMER) & valid)

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

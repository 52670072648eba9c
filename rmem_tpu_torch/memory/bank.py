"""Fixed-capacity long-term memory bank.

Counterpart of `rmem_tpu/memory/bank.py`: S = former + latter + 1 slots are
allocated once, [L, S, B, HW, C] per plane, with a validity `count` held as
a device tensor, so no frame waits for the host to learn how full the bank
is. The JAX bank is immutable; the inference engine's is written in place
(one slot per write), which is what the JAX package gets from buffer
donation, and training's is rebuilt out of place (see below).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class MemoryBank:
    """k [L, S, B, HW, Ck]; v [L, S, B, HW, Cv] (DeAOT: V ++ ID_V).

    count: int32 scalar, valid slots. Eviction statistics per physical
    slot: score (moving-mean attention mass), scored (score holds a value),
    times (eviction rounds survived). order: physical slot -> temporal rank
    (a permutation of 0..S-1; valid slots hold ranks 0..count-1)."""

    k: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor
    score: torch.Tensor
    scored: torch.Tensor
    times: torch.Tensor
    order: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_bank(num_layers: int, capacity: int, batch: int, hw: int, ck: int,
              cv: int, dtype=torch.float32, device="cpu") -> MemoryBank:
    def zeros(c):
        return torch.zeros((num_layers, capacity, batch, hw, c), dtype=dtype,
                           device=device)

    return MemoryBank(
        k=zeros(ck), v=zeros(cv),
        count=torch.zeros((), dtype=torch.int32, device=device),
        score=torch.zeros((capacity,), dtype=torch.float32, device=device),
        scored=torch.zeros((capacity,), dtype=torch.bool, device=device),
        times=torch.zeros((capacity,), dtype=torch.int32, device=device),
        order=torch.arange(capacity, dtype=torch.int32, device=device),
    )


def valid_slot_mask(bank: MemoryBank) -> torch.Tensor:
    """[S] bool: slots < count hold data."""
    return torch.arange(bank.capacity, device=bank.count.device) < bank.count


def write_slot(bank: MemoryBank, idx: torch.Tensor, new_k: torch.Tensor,
               new_v: torch.Tensor) -> None:
    """Write [L, B, HW, *] into physical slot `idx` (a device scalar)."""
    i = idx.reshape(1).long()
    bank.k.index_copy_(1, i, new_k[:, None].to(bank.k.dtype))
    bank.v.index_copy_(1, i, new_v[:, None].to(bank.v.dtype))


def bank_append(bank: MemoryBank, new_k: torch.Tensor,
                new_v: torch.Tensor) -> MemoryBank:
    """Write a new slot at index `count` (physical order == temporal order,
    as in a fresh bank)."""
    write_slot(bank, bank.count, new_k, new_v)
    bank.count = bank.count + 1
    return bank


# ---- out of place, for training ------------------------------------------
# Autograd and the per-frame checkpoint recompute must see every bank they
# saved unchanged, so training builds each new bank as a new tensor; the
# count stays on the device.

def bank_appended(bank: MemoryBank, new_k: torch.Tensor,
                  new_v: torch.Tensor) -> MemoryBank:
    """A new bank with [L, B, HW, *] written at slot `count` (physical
    order == temporal order)."""
    i = bank.count.reshape(1).long()
    return replace(bank,
                   k=bank.k.index_copy(1, i, new_k[:, None].to(bank.k.dtype)),
                   v=bank.v.index_copy(1, i, new_v[:, None].to(bank.v.dtype)),
                   count=bank.count + 1)


def bank_compact(bank: MemoryBank, drop_idx) -> MemoryBank:
    """A new bank without slot `drop_idx` (an int or a device scalar): later
    slots shift down, temporal order kept, the statistics move with the
    data and those of vacated slots reset."""
    s = bank.capacity
    i = torch.arange(s, device=bank.count.device)
    src = torch.where(i < drop_idx, i, torch.clamp(i + 1, max=s - 1))
    new_count = bank.count - 1
    fresh = i < new_count
    return replace(
        bank, k=bank.k.index_select(1, src), v=bank.v.index_select(1, src),
        count=new_count,
        score=torch.where(fresh, bank.score[src], 0.0),
        scored=fresh & bank.scored[src],
        times=torch.where(fresh, bank.times[src], 0).to(torch.int32))

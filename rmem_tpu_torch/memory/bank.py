"""Fixed-capacity long-term memory bank.

Counterpart of `rmem_tpu/memory/bank.py`: S = former + latter + 1 slots are
allocated once, [L, S, B, HW, C] per plane, with a validity `count` held as
a device tensor, so no frame waits for the host to learn how full the bank
is. The JAX bank is immutable; this one is written in place (one slot per
write), which is what the JAX package gets from buffer donation.
"""

from __future__ import annotations

from dataclasses import dataclass

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

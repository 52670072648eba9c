"""Temporal positional embedding over memory slots (RMem's Temp_pe_Slot_4).

The learned [P, C] slot table stretches to the bank's current length t:
for t <= P slot i takes row i (the reference truncates the table to t rows
and its align-corners linear resize t -> t is the identity); for t > P the
table is flipped, nearest-expanded to t and flipped back, so the last rows
meet the newest slots: output i takes row P-1 - floor((t-1-i) * P / t).
`t` is a device tensor (the bank count), so both formulas are evaluated per
slot and one is selected: no host sync.
"""

from __future__ import annotations

import torch


def interpolate_temporal_pe(mem_pos_emb: torch.Tensor, t: torch.Tensor,
                            capacity: int) -> torch.Tensor:
    """[P, C] table -> [capacity, C]; rows >= t are unspecified."""
    P = mem_pos_emb.shape[0]
    dev = mem_pos_emb.device
    s = torch.arange(capacity, dtype=torch.float32, device=dev)
    t_f = torch.as_tensor(t, device=dev).to(torch.float32)
    lo = torch.clamp(s.to(torch.long), max=P - 1)
    src = (P - 1) - torch.floor((t_f - 1.0 - s) * P / torch.clamp(t_f,
                                                                  min=1.0))
    src = torch.clamp(src, 0, P - 1).to(torch.long)
    use_linear = (t_f <= P)
    idx = torch.where(use_linear, lo, src)
    return mem_pos_emb.index_select(0, idx)

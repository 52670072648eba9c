"""The propagation stacks cut at each block's long-term bank attention.

A block runs in three parts: `pre_bank` (everything before the bank
attention, the slot temporal PE's logit bias included), the bank-attention
call itself, described by a `BankQuery`, and `post_bank` (everything
after). A stack's `stages` is a generator over its blocks that yields each
block's `BankQuery` and takes back the call's `(out, record)`; it returns
what the stack's forward returns. The forward is `run_stages` of it, which
answers every query with `BankQuery.attend`. The serving engine drives the
same generator itself, so that the code between two bank attentions can
run as one CUDA graph while the kernel wrapper is called eagerly
(engine/graphs.py).
"""

from __future__ import annotations

from typing import Generator, NamedTuple, Optional, Tuple

import torch

from rmem_tpu_torch.kernels import bank_attention as bank_kernel
from rmem_tpu_torch.utils.trace import span


class BankQuery(NamedTuple):
    """One block's long-term bank attention: the kernel wrapper `route`
    names ("infer", "qminor" or "train") and its arguments. q [B, Lq,
    h*dh]; bank_k, bank_v [S, B, Lk, *]; count the int32 device scalar of
    valid slots; keys >= true_lk masked; qbias [B, h, Lq, S] f32 or None
    (only the "infer" route takes the last two)."""

    route: str
    q: torch.Tensor
    bank_k: torch.Tensor
    bank_v: torch.Tensor
    count: torch.Tensor
    num_heads: int
    scale: float
    true_lk: Optional[int] = None
    qbias: Optional[torch.Tensor] = None

    def attend(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out [B, Lq, h*dv], record [B, Lq, S]) of the call, in the
        span `rmem.model.block.long`, through the wrapper that the kernels
        module holds at the time of the call."""
        with span("rmem.model.block.long"):
            if self.route == "train":
                return bank_kernel.bank_attention_train(
                    self.q, self.bank_k, self.bank_v, self.count, self.scale,
                    num_heads=self.num_heads)
            if self.route == "qminor":
                return bank_kernel.bank_attention_qminor(
                    self.q, self.bank_k, self.bank_v, self.count,
                    self.num_heads, self.scale)
            return bank_kernel.bank_attention_infer(
                self.q, self.bank_k, self.bank_v, self.count, self.num_heads,
                self.scale, true_lk=self.true_lk, qbias=self.qbias)


Stages = Generator[BankQuery, Tuple[torch.Tensor, Optional[torch.Tensor]],
                   tuple]


def run_stages(stages: Stages) -> tuple:
    """A stack's forward from its stages: each yielded query answered with
    its own `attend`; returns the generator's return value."""
    try:
        query = next(stages)
        while True:
            query = stages.send(query.attend())
    except StopIteration as done:
        return done.value

"""The serving kernels as `torch.library` custom ops (namespace `rmem`), so
that `torch.export` (tools/export.py) records each as one node of the
serving step's graph.

Each op's implementation is its wrapper: on a CUDA tensor it launches the
kernel and adds one to the wrapper's `.launches`, on a CPU tensor it runs
the plain version. Each has a fake (meta) implementation that gives its
output shapes, and its outputs are new contiguous tensors, none an input
(the wrappers' workspaces stay inside them). The wrappers route through
these ops only while a graph is being traced
(`torch.compiler.is_compiling()`, which `torch.export` sets); eager calls
take the direct ctypes launch, whose host cost the dispatcher would add
to (PERF.md).

- rmem::bank_attention_infer: K1 at one or two heads of 128, K1ʰ at 8
  heads of 32, K1×2ᵛ¹²⁸ (kernels/bank_attention.py:bank_attention_infer);
- rmem::bank_attention_qminor: K3 and K3ʰ (bank_attention_qminor);
- rmem::local_attention: K4 (kernels/local_attention.py:local_attention);
- rmem::stem: K6 (kernels/stem.py:stem);
- rmem::gated_dwconv: K8 (kernels/dwconv.py:gated_dwconv).

An exported program that holds these ops needs this module imported
(`import rmem_tpu_torch.kernels.ops`) before `torch.export.load`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor

from rmem_tpu_torch.kernels import bank_attention as _bank
from rmem_tpu_torch.kernels import dwconv as _dw
from rmem_tpu_torch.kernels import local_attention as _local
from rmem_tpu_torch.kernels import stem as _stem


@torch.library.custom_op("rmem::bank_attention_infer", mutates_args=())
def bank_attention_infer(q: Tensor, bank_k: Tensor, bank_v: Tensor,
                         count: Tensor, num_heads: int, scale: float,
                         true_lk: Optional[int] = None,
                         qbias: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor]:
    out, rec = _bank.bank_attention_infer(q, bank_k, bank_v, count,
                                          num_heads, scale, true_lk, qbias)
    return out.contiguous(), rec.contiguous()


@bank_attention_infer.register_fake
def _(q, bank_k, bank_v, count, num_heads, scale, true_lk=None,
      qbias=None):
    b, lq = q.shape[:2]
    return (q.new_empty((b, lq, bank_v.shape[-1])),
            q.new_empty((b, lq, bank_k.shape[0]), dtype=torch.float32))


@torch.library.custom_op("rmem::bank_attention_qminor", mutates_args=())
def bank_attention_qminor(q: Tensor, bank_k: Tensor, bank_v: Tensor,
                          count: Tensor, num_heads: int, scale: float
                          ) -> Tuple[Tensor, Tensor]:
    out, rec = _bank.bank_attention_qminor(q, bank_k, bank_v, count,
                                           num_heads, scale)
    return out.contiguous(), rec.contiguous()


@bank_attention_qminor.register_fake
def _(q, bank_k, bank_v, count, num_heads, scale):
    b, lq = q.shape[:2]
    return (q.new_empty((b, lq, bank_v.shape[-1])),
            q.new_empty((b, lq, bank_k.shape[0]), dtype=torch.float32))


@torch.library.custom_op("rmem::local_attention", mutates_args=())
def local_attention(q: Tensor, k: Tensor, v: Tensor, rel_emb: Tensor,
                    size_2d: List[int], num_heads: int, max_dis: int,
                    scale: float) -> Tensor:
    return _local.local_attention(q, k, v, rel_emb, tuple(size_2d),
                                  num_heads, max_dis, scale).contiguous()


@local_attention.register_fake
def _(q, k, v, rel_emb, size_2d, num_heads, max_dis, scale):
    return v.new_empty(v.shape)


@torch.library.custom_op("rmem::stem", mutates_args=())
def stem(x: Tensor, weight: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    return _stem.stem(x, weight, scale, bias).contiguous()


@stem.register_fake
def _(x, weight, scale, bias):
    b, h, w = x.shape[:3]
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return weight.new_empty((b, (ho - 1) // 2 + 1, (wo - 1) // 2 + 1, 64))


@torch.library.custom_op("rmem::gated_dwconv", mutates_args=())
def gated_dwconv(x: Tensor, gate: Tensor, weight: Tensor,
                 size_2d: List[int]) -> Tensor:
    return _dw.gated_dwconv(x, gate, weight, tuple(size_2d)).contiguous()


@gated_dwconv.register_fake
def _(x, gate, weight, size_2d):
    return x.new_empty(x.shape)

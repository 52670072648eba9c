"""VOS model registry and seeded random weights."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.models.aot import AOT
from rmem_tpu_torch.models.deaot import DeAOT


def build_vos_model(name: str, cfg: Config) -> nn.Module:
    if name == "aot":
        return AOT(cfg)
    if name == "deaot":
        return DeAOT(cfg)
    raise NotImplementedError(f"model {name!r} not ported (have: aot, "
                              "deaot)")


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from `seed`, drawn as the flax initialisers of the JAX
    package draw them (not the same numbers): lecun-normal conv and dense
    weights, zero biases, unit norm scales, an orthogonal id-bank kernel
    scaled by k^-2, and N(0, 0.05) truncated at 2 sigma for the temporal
    PEs."""
    g = torch.Generator().manual_seed(seed)

    def trunc_normal_(t, std):
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("patch_wise_id_bank.") and leaf == "weight":
            k = p.shape[-1]
            flat = torch.randn(p.shape[0], p[0].numel(), generator=g)
            q, r = torch.linalg.qr(flat.T)             # orthonormal columns
            q = q * torch.sign(torch.diagonal(r))
            p.copy_((q.T * k ** -2.0).reshape(p.shape))
        elif leaf == "weight":
            fan_in = p[0].numel()
            # lecun_normal: truncated normal, std 1/sqrt(fan_in) after the
            # truncation's variance correction
            trunc_normal_(p, math.sqrt(1.0 / fan_in) / .87962566103423978)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf in ("cur_pos_emb", "mem_pos_emb"):
            trunc_normal_(p, 0.05)
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    return model

"""VOS model registry, seeded random weights and checkpoint loading."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.models.aot import AOT
from rmem_tpu_torch.models.deaot import DeAOT
from rmem_tpu_torch.utils.checkpoint import (load_file, load_msgpack,
                                             load_pretrained, params_from_jax)


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
    PEs; Swin's relative-position tables N(0, 0.02) truncated at 2 sigma,
    the top-down encoder's prompt N(0, 1) and its transform the
    identity."""
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
        elif leaf == "relative_position_bias_table":
            trunc_normal_(p, 0.02)
        elif leaf == "prompt":
            p.normal_(0.0, 1.0, generator=g)
        elif leaf == "top_down_transform":
            p.copy_(torch.eye(p.shape[0]))
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    return model


def load_model_params(model: nn.Module, path: Optional[str],
                      ema: bool = True, log=print,
                      report: Optional[dict] = None) -> nn.Module:
    """The weights the evaluator runs. None or "test" gives random weights
    from init_params(model, 42); else `path` is told apart by its content,
    then its suffix:

    - a torch.save file holding this package's `state` dict (a file of
      the trainer's checkpoint stream): its EMA weights with `ema` (the
      JAX package evaluates its EMA checkpoints), else its trained ones; a
      file of the EMA stream holds only EMA weights, and asking it for
      the trained ones raises;
    - any other torch.save zip or `.pth` file: a reference checkpoint,
      merged shape-tolerantly into init_params(model, 0) as the JAX package
      merges it into its PRNGKey(0) init (utils/checkpoint.py:
      load_pretrained; `report` takes its skipped, extra, dead and
      unexpected keys);
    - anything else: a flax msgpack params tree written by the JAX package
      (its EMA stream's `ema_step_N.msgpack` or any params-only file), as
      rmem_tpu/models/__init__.py:load_model_params reads it."""
    if path in (None, "test"):
        return init_params(model, 42)
    with open(path, "rb") as f:
        zipped = f.read(4) == b"PK\x03\x04"     # torch.save's format
    if zipped or str(path).endswith(".pth"):
        d = load_file(path)
        state = d.get("state") if isinstance(d, dict) else None
        if isinstance(state, dict) and ({"params", "ema"} & set(state)):
            key = "ema" if ema else "params"
            if key not in state:
                raise ValueError(f"{path} holds only EMA weights; ask for "
                                 "them (ema=True, test_ema) or give a file "
                                 "of the trainer's save stream")
            model.load_state_dict(state[key], strict=True)
            log(f"loaded the {key} weights of {path} (step "
                f"{state['step']})")
            return model
        init_params(model, 0)
        skipped, _ = load_pretrained(model, d, model.cfg.model_vos,
                                     model.cfg.id_channels, report=report,
                                     log=log)
        if skipped:
            log(f"checkpoint merge skipped {len(skipped)} entries")
        log(f"loaded the reference checkpoint {path}")
        return model
    model.load_state_dict(params_from_jax(load_msgpack(path)), strict=True)
    log(f"loaded the JAX params tree {path}")
    return model

"""Train state and one optimizer step: clip by global norm, Adam moments
or SGD's momentum, decoupled weight decay, a learning rate per parameter
group, and the EMA.

Counterpart of `rmem_tpu/engine/train_state.py` (its optax chain
clip_by_global_norm -> scale_by_adam(eps 1e-8), or with train_opt "sgd"
trace(decay=train_sgd_momentum) -> add_decayed_weights (masked) ->
-lr(group, step), then the EMA with warm-up decay), written out over the
model's parameters. SGD's trace is m = g + momentum * m, with no
dampening and no Nesterov term. The global norm takes every gradient, the
frozen parameters' too, as the JAX step's does: frozen parameters keep
`requires_grad` and their gradients, and only their learning rate is 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.ops.schedule import encoder_lr, make_lr_schedule
from rmem_tpu_torch.utils.trace import spanned

FROZEN_STAGES = ("conv1", "bn1", "layer1")   # train_encoder_freeze_at 2
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def param_label(name: str, cfg: Config) -> str:
    """frozen | encoder | idbank | base for a parameter name (its module
    path is the flax path, so the JAX package's rule reads it as is)."""
    path = name.split(".")
    in_encoder = path[0] == "encoder"
    is_bn = any(p.startswith("bn") or "downsample_bn" in p for p in path)
    if in_encoder and is_bn:
        return "frozen"            # the folded frozen-BN affines
    if in_encoder and cfg.train_encoder_freeze_at >= 2 and any(
            path[1].startswith(s) for s in FROZEN_STAGES):
        return "frozen"
    if "patch_wise_id_bank" in name:
        return "idbank"
    return "encoder" if in_encoder else "base"


def wd_applies(name: str, param: torch.Tensor, cfg: Config) -> bool:
    """Weight decay on matrices and kernels that are neither frozen nor
    exempt; never on vectors."""
    if param_label(name, cfg) == "frozen" or param.dim() == 1:
        return False
    return not any(key in name for key in cfg.train_weight_decay_exemption)


def ema_decay(step: int, cfg: Config) -> float:
    """min(1 - 1/(total*ratio), (1+n)/(10+n)) at n = step, in f32."""
    f = np.float32
    decay = f(1.0) - f(1.0) / f(cfg.train_total_steps * cfg.train_ema_ratio)
    n = f(step)
    return float(min(decay, (f(1.0) + n) / (f(10.0) + n)))


@dataclass
class TrainState:
    """The model (f32 parameters) and everything the next step needs: mu
    is Adam's first moment, or with opt "sgd" the momentum trace (nu then
    stays empty)."""

    model: nn.Module
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    step: int
    opt: str = "adamw"

    @staticmethod
    def create(model: nn.Module, opt: str = "adamw") -> "TrainState":
        if opt not in ("adamw", "sgd"):
            raise ValueError(f"train_opt {opt!r}")
        params = dict(model.named_parameters())
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return TrainState(model=model, mu=zeros(),
                          nu=zeros() if opt == "adamw" else {},
                          ema={n: p.detach().clone()
                               for n, p in params.items()}, step=0, opt=opt)

    def _slots(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The optimizer's state by its name in a save."""
        if self.opt == "sgd":
            return {"trace": self.mu}
        return {"mu": self.mu, "nu": self.nu}

    def state_dict(self) -> dict:
        return {"params": {n: p.detach() for n, p in
                           self.model.named_parameters()},
                **self._slots(), "ema": self.ema, "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        slots = self._slots()
        if not set(slots) <= set(d):
            raise ValueError(f"the save holds no {self.opt} state "
                             f"({sorted(slots)})")
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(d["params"][n])
        for key, tensors in (*slots.items(), ("ema", self.ema)):
            for n, t in tensors.items():
                t.copy_(d[key][n])
        self.step = int(d["step"])


def group_lrs(step: int, cfg: Config) -> Dict[str, float]:
    sched = make_lr_schedule(cfg.train_lr, cfg.train_lr_min,
                             cfg.train_total_steps, cfg.train_lr_power,
                             cfg.train_lr_warm_up_ratio,
                             cfg.train_lr_cosine_decay, cfg.train_lr_restart)
    base = sched(step)
    seq_start = cfg.train_seq_training_start_ratio * cfg.train_total_steps
    return {"frozen": 0.0,
            "encoder": encoder_lr(base, cfg.train_lr_min,
                                  cfg.train_lr_encoder_ratio),
            # the id bank freezes once sequence training starts
            "idbank": 0.0 if step >= seq_start else base,
            "base": base}


def _norm_sq(model: nn.Module, params, grads) -> torch.Tensor:
    """The squared global norm of the gradients. Where the model is split
    across a "model" axis (parallel/tp.py: model.tp_split) the split
    parameters' squares are summed over the axis, so that every rank
    clips by the whole model's norm."""
    split = getattr(model, "tp_split", None)
    if split is None:
        return sum(g.float().pow(2).sum() for g in grads)
    parts = [g.float().pow(2).sum() for (n, _), g in zip(params, grads)
             if n in split.index]
    local = torch.stack(parts).sum()
    torch.distributed.all_reduce(local, group=split.group)
    return local + sum(g.float().pow(2).sum()
                       for (n, _), g in zip(params, grads)
                       if n not in split.index)


@spanned("rmem.train.optimizer")
@torch.no_grad()
def apply_gradients(state: TrainState, cfg: Config) -> torch.Tensor:
    """One optimizer step from the parameters' .grad, then the EMA; the
    step count advances. Returns the global gradient norm (a device
    scalar: nothing is read back)."""
    params = [(n, p) for n, p in state.model.named_parameters()]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for _, p in params]
    gnorm = torch.sqrt(_norm_sq(state.model, params, grads))
    keep = gnorm < cfg.train_clip_grad_norm
    lrs = group_lrs(state.step, cfg)
    f = np.float32
    count = f(state.step + 1)
    bc1 = float(f(1.0) - f(ADAM_B1) ** count)
    bc2 = float(f(1.0) - f(ADAM_B2) ** count)
    d = ema_decay(state.step, cfg)
    for (name, p), g in zip(params, grads):
        g = torch.where(keep, g, g / gnorm * cfg.train_clip_grad_norm)
        mu = state.mu[name]
        if state.opt == "sgd":
            u = mu.copy_(g + cfg.train_sgd_momentum * mu)
        else:
            nu = state.nu[name]
            mu.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        if wd_applies(name, p, cfg):
            u = u + cfg.train_weight_decay * p
        p.add_(u * -lrs[param_label(name, cfg)])
        ema = state.ema[name]
        ema.copy_(d * ema + (1.0 - d) * p)
    state.step += 1
    return gnorm

"""The plain reference of one training step of RMem's VOST job: the clip
loss of AOT/DeAOT training (the reference frame's aux loss, frames 1..T-1
propagated against a FIFO bank written every `train_long_term_mem_gap`
frames and the previous frame's short-term memory, the use-prev-pred
curriculum, bootstrapped cross-entropy + soft Jaccard), its gradients,
clipping by global norm, AdamW with decoupled weight decay and the
per-group learning rates, in plain PyTorch over `model.VOSModel`.

The batch's loss is the mean over its clips, so the step takes each
clip's share of it and its gradient in turn (the gradients add up to the
batch's), which bounds the memory to one clip's activations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vosbench.reference.model import VOSModel, mask_unused, temporal_pe

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FROZEN_STAGES = ("conv1", "bn1", "layer1")
IGNORE = 255


# ---- loss -----------------------------------------------------------------

def topk_count(n: int, step: float, pct: float, hard_steps: float) -> int:
    f = np.float32
    ratio = np.minimum(f(1.0), f(step) / f(hard_steps))
    return int(max(np.floor((ratio * f(pct) + (f(1.0) - ratio)) * f(n)),
                   f(1.0)))


def seg_loss(logits, label, obj_nums, step, pct, hard_steps):
    """0.5 bootstrapped CE (the top k pixels, ties to the lowest index) +
    0.5 soft Jaccard over the classes present, per sample: [N,H,W,C],
    [N,H,W] -> [N]."""
    n, h, w, c = logits.shape
    valid = torch.arange(c, device=logits.device)[None] <= obj_nums[:, None]
    lg = torch.where(valid[:, None, None], logits.float(),
                     torch.full((), -1e30, device=logits.device))
    logp = torch.log_softmax(lg, -1)
    pix = -torch.gather(logp, -1, label.clamp(0, c - 1).long()[..., None]
                        )[..., 0]
    pix = torch.where(label == IGNORE, 0.0, pix).reshape(n, -1)
    k = topk_count(h * w, step, pct, hard_steps)
    idx = torch.sort(pix.detach(), dim=-1, descending=True, stable=True
                     ).indices[:, :k]
    ce = torch.gather(pix, 1, idx).sum(-1) / k
    probs = torch.softmax(lg, -1)
    pv = (label != IGNORE)[..., None].float()
    gt = (label[..., None] == torch.arange(c, device=label.device)).float() \
        * pv
    probs = probs * pv
    num = (probs * gt).sum((1, 2))
    gsum = gt.sum((1, 2))
    jac = 1.0 - num / (probs.sum((1, 2)) + gsum - num + 1e-6)
    present = ((gsum > 0) & valid).float()
    jac = (jac * present).sum(-1) / present.sum(-1).clamp(min=1.0)
    return 0.5 * ce + 0.5 * jac


def aux_weight(step: int, cfg: Dict) -> float:
    f = np.float32
    aux_step = f(cfg["train_total_steps"] * cfg["train_aux_loss_ratio"] + 1e-5)
    return float(f(cfg["train_aux_loss_weight"])
                 * max(aux_step - f(step), f(0.0)) / aux_step)


def clip_loss(model: VOSModel, imgs, labels, obj_num, shuffle, step: int,
              cfg: Dict) -> torch.Tensor:
    """One clip's loss: imgs [T, H, W, 3], labels [T, H, W], obj_num [1],
    shuffle [obj+1, obj+1] (a permutation matrix)."""
    t = imgs.shape[0]
    hw_in = tuple(imgs.shape[1:3])
    max_obj = cfg["model_max_obj_num"]
    cap = cfg["former_mem_len"] + cfg["latter_mem_len"] + 1
    use_prev = step >= (cfg["train_seq_training_start_ratio"]
                        * cfg["train_total_steps"])
    pct = cfg["train_top_k_percent_pixels"]
    hard = cfg["train_hard_mining_ratio"] * cfg["train_total_steps"]
    perm = torch.argmax(shuffle, -1)
    xs_all = model.encode(imgs)
    gh, gw = xs_all[-1].shape[2:]

    def up(lg):
        return F.interpolate(lg.permute(0, 3, 1, 2), size=hw_in,
                             mode="bilinear",
                             align_corners=True).permute(0, 2, 3, 1)

    def frame(i):
        xs = [x[i:i + 1] for x in xs_all]
        return xs, xs[-1].flatten(2).transpose(1, 2)

    def id_embed(label):
        lbl = torch.where(label == IGNORE, max_obj + 1,
                          perm[label.clamp(0, max_obj).long()])
        e = model.id_emb(lbl)
        return e.detach() if use_prev else e

    def decode(outs, xs):
        lg = torch.einsum("bhwo,to->bhwt", model.decode(outs, xs).float(),
                          shuffle.float())
        return mask_unused(lg, obj_num)

    def loss(lg, label):
        return seg_loss(up(lg), label[None], obj_num, step, pct, hard)[0]

    xs, feat = frame(0)
    ref = id_embed(labels[0:1])
    outs, mems, _ = model.propagate(feat, None, None, None, ref,
                                    model.mem_pos_emb[0:1], (gh, gw), cap)
    lk, lv, sk, sv = model.write(mems, ref)
    bank_k, bank_v = [lk], [lv]
    aux = loss(decode(outs, xs), labels[0])
    last, frame_losses = 0, []
    for i in range(1, t):
        xs, feat = frame(i)
        n = len(bank_k)
        pe = temporal_pe(model.mem_pos_emb, n, cap)
        outs, mems, _ = model.propagate(
            feat, (torch.stack(bank_k, 1), torch.stack(bank_v, 1)), n,
            (sk, sv), None, pe, (gh, gw), cap)
        lg = decode(outs, xs)
        with torch.no_grad():
            pred = torch.argmax(up(lg), -1)
        lk, lv, sk, sv = model.write(
            mems, id_embed(pred if use_prev else labels[i:i + 1]))
        if (not cfg["no_long_memory"]
                and i - last >= cfg["train_long_term_mem_gap"]):
            bank_k.append(lk)
            bank_v.append(lv)
            if len(bank_k) > cfg["former_mem_len"] + cfg["latter_mem_len"]:
                del bank_k[cfg["former_mem_len"]], bank_v[cfg["former_mem_len"]]
            last = i
        frame_losses.append(loss(lg, labels[i]))
    return aux_weight(step, cfg) * aux + torch.stack(frame_losses).mean()


# ---- the optimizer --------------------------------------------------------

def param_label(name: str, cfg: Dict) -> str:
    path = name.split(".")
    enc = path[0] == "encoder"
    if enc and any(p.startswith("bn") or "downsample_bn" in p for p in path):
        return "frozen"
    if enc and cfg["train_encoder_freeze_at"] >= 2 and any(
            path[1].startswith(s) for s in FROZEN_STAGES):
        return "frozen"
    if "patch_wise_id_bank" in name:
        return "idbank"
    return "encoder" if enc else "base"


def lr_at(step: int, cfg: Dict) -> Dict[str, float]:
    """Poly decay (power 0.9) after a linear warm-up, in f32; the encoder's
    rate (lr - min) * ratio + min; the id bank frozen from the start of
    sequence training."""
    f = np.float32
    base, lo = cfg["train_lr"], cfg["train_lr_min"]
    total = cfg["train_total_steps"]
    wu = f(total * cfg["train_lr_warm_up_ratio"])
    s = f(step)
    if cfg["train_lr_cosine_decay"] or cfg["train_lr_restart"] != 1:
        raise NotImplementedError("poly decay without restarts only")
    if s < wu:
        lr = float(f(lo) + f(base - lo) * s / max(wu, f(1.0)))
    else:
        it, mx = s - wu, f(total) - wu
        lr = float(f(lo) + f(base - lo) * (
            max(f(1.0) - it / (mx + f(1.0)), f(0.0)) ** f(cfg["train_lr_power"])))
    enc = float((f(lr) - f(lo)) * f(cfg["train_lr_encoder_ratio"]) + f(lo))
    seq = cfg["train_seq_training_start_ratio"] * total
    return {"frozen": 0.0, "encoder": enc,
            "idbank": 0.0 if step >= seq else lr, "base": lr}


class RefTrainer:
    """The reference's parameters (f32) and AdamW state, stepped on the
    program's batches; the moments start at `mu` and `nu` (by parameter
    name, on any device) where given, else at 0."""

    def __init__(self, model: VOSModel, cfg: Dict, step: int,
                 mu: Optional[Dict] = None, nu: Optional[Dict] = None):
        if cfg["train_opt"] != "adamw":
            raise NotImplementedError("AdamW only")
        self.model, self.cfg, self.step = model, cfg, step
        self.params = dict(model.named_parameters())

        def moment(given):
            return {n: (given[n].to(p.device, torch.float32, copy=True)
                        if given is not None else torch.zeros_like(p))
                    for n, p in self.params.items()}

        self.mu, self.nu = moment(mu), moment(nu)
        self.last_grads: Dict[str, torch.Tensor] = {}

    def train_step(self, imgs, labels, obj_nums, shuffle) -> float:
        """One step on a batch (imgs [B,T,H,W,3], labels [B,T,H,W],
        obj_nums [B], shuffle [B,obj+1,obj+1]). Returns the batch's loss;
        `last_grads` holds the gradients as the optimizer took them
        (clipped)."""
        for p in self.params.values():
            p.grad = None
        b = imgs.shape[0]
        total = 0.0
        for c in range(b):
            loss = clip_loss(self.model, imgs[c], labels[c],
                             obj_nums[c:c + 1], shuffle[c], self.step,
                             self.cfg) / b
            loss.backward()
            total += float(loss.detach())
        self._apply()
        return total

    @torch.no_grad()
    def _apply(self) -> None:
        cfg = self.cfg
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                              for g in grads.values()))
        clip = cfg["train_clip_grad_norm"]
        factor = 1.0 if gnorm < clip else clip / gnorm
        lrs = lr_at(self.step, cfg)
        f = np.float32
        count = f(self.step + 1)
        bc1 = float(f(1.0) - f(ADAM_B1) ** count)
        bc2 = float(f(1.0) - f(ADAM_B2) ** count)
        self.last_grads = {}
        for n, p in self.params.items():
            g = grads[n] * factor
            self.last_grads[n] = g.clone()
            self.mu[n].mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
            self.nu[n].mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + ADAM_EPS)
            label = param_label(n, cfg)
            if label != "frozen" and p.dim() > 1 and not any(
                    k in n for k in cfg["train_weight_decay_exemption"]):
                u = u + cfg["train_weight_decay"] * p
            p.add_(u * -lrs[label])
        self.step += 1


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: List[str]):
    """max over `leaves` of |prog norm - ref norm| / max(ref norm, the
    median ref norm over `leaves`), and the leaf that gives it."""
    med = float(np.median([ref[n] for n in leaves]))
    worst, at = 0.0, None
    for n in leaves:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at

"""Model FLOPs counted on the plain reference on the meta device: no
memory, no device, the same shapes as the timed path. torch's FLOP counter
counts every matmul and conv (forward, and backward where autograd runs);
the local attention, whose reference form is dense, adds its windowed
products itself (`Numerics.counting`)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from vosbench.reference.model import VOSModel
from vosbench.reference.numerics import Numerics
from vosbench.reference.train import clip_loss

META = torch.device("meta")


def _meta_model(cfg: Dict, training: bool) -> VOSModel:
    num = Numerics()
    num.counting, num.training_count = True, training
    with META:
        return VOSModel(cfg, num)


def _zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=META)


def serve_flops(cfg: Dict, in_hws: Sequence[Tuple[int, int]],
                groups: int) -> float:
    """One served frame over a full bank at every aug: the encoder at
    batch 1, the propagation, decoder and memory write at the groups'
    batch."""
    model = _meta_model(cfg, False)
    cap = cfg["former_mem_len"] + cfg["latter_mem_len"] + 1
    full = cap - 1
    total = 0.0
    with torch.no_grad():
        for h, w in in_hws:
            xs = [torch.cat([x] * groups)
                  for x in model.encode(_zeros(1, h, w, 3))]
            gh, gw = xs[-1].shape[2:]
            feat = xs[-1].flatten(2).transpose(1, 2)
            ide = model.id_emb(_zeros(groups, h, w, dtype=torch.long))
            # the memories' widths, from the reference frame's write
            _, mems, _ = model.propagate(feat, None, None, None, ide,
                                         model.mem_pos_emb[0:1], (gh, gw),
                                         cap)
            lk, lv, sk, sv = model.write(mems, ide)
            bank = (_zeros(lk.shape[0], full, *lk.shape[1:]),
                    _zeros(lv.shape[0], full, *lv.shape[1:]))
            pe = _zeros(cap, model.cur_pos_emb.shape[-1])
            model.num.extra_flops = 0.0
            with FlopCounterMode(display=False) as fc:
                xs = [torch.cat([x] * groups)
                      for x in model.encode(_zeros(1, h, w, 3))]
                feat = xs[-1].flatten(2).transpose(1, 2)
                outs, mems, _ = model.propagate(feat, bank, full, (sk, sv),
                                                None, pe, (gh, gw), cap)
                model.decode(outs, xs)
                ide = model.id_emb(_zeros(groups, h, w, dtype=torch.long))
                model.write(mems, ide)
            total += fc.get_total_flops() + model.num.extra_flops
    return float(total)


def train_flops(cfg: Dict, batch: int, seq: int,
                hw: Tuple[int, int]) -> float:
    """One step: each clip's forward and backward, times the batch."""
    model = _meta_model(cfg, True)
    c = cfg["model_max_obj_num"] + 1
    step = int(cfg["train_seq_training_start_ratio"]
               * cfg["train_total_steps"])
    with FlopCounterMode(display=False) as fc:
        loss = clip_loss(model, _zeros(seq, *hw, 3),
                         _zeros(seq, *hw, dtype=torch.long),
                         _zeros(1, dtype=torch.long) + 1, _zeros(c, c), step,
                         cfg)
        loss.backward()
    return float((fc.get_total_flops() + model.num.extra_flops) * batch)

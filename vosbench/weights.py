"""Seeded random weights, made on the device in a few large calls.

The same families of draws as a flax initialiser gives these models
(lecun-normal conv and dense kernels, zero biases, unit norm scales, an
orthogonal id-bank kernel scaled by k^-2, N(0, 0.05) temporal PEs,
truncated at 2 sigma), but every truncated-normal leaf comes out of one
draw on the device's generator, scaled per element, and is then cut into
the leaves: no leaf-by-leaf draws and nothing made on the host.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated at +-2


def seeded_state_dict(shapes: Iterable[Tuple[str, torch.Size]], seed: int,
                      device) -> Dict[str, torch.Tensor]:
    """f32 weights on `device` for the (name, shape) leaves of a model."""
    shapes = list(shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    drawn, stds = [], []
    for name, shape in shapes:
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("patch_wise_id_bank.") and leaf == "weight":
            continue
        if leaf == "weight":
            fan_in = math.prod(shape[1:])
            drawn.append((name, shape))
            stds.append(math.sqrt(1.0 / fan_in) / TRUNC_STD)
        elif leaf in ("cur_pos_emb", "mem_pos_emb"):
            drawn.append((name, shape))
            stds.append(0.05)
        elif leaf == "scale":
            out[name] = torch.ones(shape, device=device)
        elif leaf == "bias":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"no initialiser for {name}")
    sizes = [math.prod(s) for _, s in drawn]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    flat *= torch.repeat_interleave(
        torch.tensor(stds, device=device),
        torch.tensor(sizes, device=device), output_size=sum(sizes))
    for (name, shape), part in zip(drawn, flat.split(sizes)):
        out[name] = part.view(shape)
    for name, shape in shapes:
        if name.startswith("patch_wise_id_bank.") and name.endswith("weight"):
            k = shape[-1]
            m = torch.randn((shape[0], math.prod(shape[1:])), generator=g,
                            device=device)
            q, r = torch.linalg.qr(m.T)
            q = q * torch.sign(torch.diagonal(r))
            out[name] = (q.T * k ** -2.0).reshape(shape).contiguous()
    return {name: out[name] for name, _ in shapes}

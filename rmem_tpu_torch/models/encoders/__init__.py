"""Encoder registry and the inference-time BN fold."""

from __future__ import annotations

from typing import Dict

import torch

from rmem_tpu_torch.models.encoders.mobilenet import MobileNetV2
from rmem_tpu_torch.models.encoders.mobilenetv3 import MobileNetV3Large
from rmem_tpu_torch.models.encoders.resnest import ResNeSt50, ResNeSt101
from rmem_tpu_torch.models.encoders.resnet import ResNet50, ResNet101
from rmem_tpu_torch.models.encoders.swin import SwinB
from rmem_tpu_torch.models.encoders.tiny import (TinyEncoder,
                                                 TinyTopDownEncoder)
from rmem_tpu_torch.models.encoders.topdown import ResNet50TopDown

ENCODERS = {
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "mobilenetv2": MobileNetV2,
    "tiny": TinyEncoder,
    "tiny_topdown": TinyTopDownEncoder,
    "swin_base": SwinB,
    "swinb": SwinB,
    "mobilenetv3": MobileNetV3Large,
    "resnest50": ResNeSt50,
    "resnest101": ResNeSt101,
    "resnet50_topdown": ResNet50TopDown,
}


def build_encoder(name: str):
    """The encoder of a `Config.model_encoder` name. The top-down encoders
    (`tiny_topdown`, `resnet50_topdown`) return (pyramid, var_loss)."""
    if name not in ENCODERS:
        raise NotImplementedError(f"encoder {name!r} not implemented "
                                  f"(have: {', '.join(ENCODERS)})")
    return ENCODERS[name]()


# FoldedBN name -> the convs it may follow, first match of the BN's width
# wins: the JAX package's fold_bn_params pairing table. "bn1" follows a
# bottleneck's or the stem's conv1, ResNeSt's split-attention fc1 or its
# deep stem's stem2.
_BN_CONV = {
    "bn": ("conv",),
    "bn0": ("conv",),
    "bn1": ("conv1", "fc1", "stem2"),
    "bn2": ("conv2",),
    "bn3": ("conv3",),
    "downsample_bn": ("downsample_conv",),
    "bn_out": ("pw_linear",),
    "out_bn": ("pw_linear",),
    "pw_bn": ("pw",),
    "dw_bn": ("dw",),
    "stem_bn": ("stem",),
    "stem0_bn": ("stem0",),
    "stem1_bn": ("stem1",),
    "head_bn": ("head",),
}


def fold_bn_params(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Fold each encoder FoldedBN scale into the conv before it:
    (conv(x, W) + c) * s + b == conv(x, W * s) + c * s + b. The fold runs in
    f32 on the state dict; the BN keeps scale 1 and its bias. Returns a new
    dict.

    The pairs are the JAX package's. Where the conv has a bias (ResNeSt's
    fc1) the port scales it too: the JAX fold leaves it unscaled, which
    changes the encoder's output once that bias is not zero."""
    out = dict(state_dict)
    for key, scale in state_dict.items():
        if not (key.startswith("encoder.") and key.endswith(".scale")):
            continue
        parent, bn = key[:-len(".scale")].rsplit(".", 1)
        for cand in _BN_CONV.get(bn, ()):
            w = state_dict.get(f"{parent}.{cand}.weight")
            if w is None or w.dim() < 2 or w.shape[0] != scale.shape[0]:
                continue
            s = scale.float()
            out[f"{parent}.{cand}.weight"] = (
                w.float() * s.reshape(-1, *[1] * (w.dim() - 1))).to(w.dtype)
            c = state_dict.get(f"{parent}.{cand}.bias")
            if c is not None:
                out[f"{parent}.{cand}.bias"] = (c.float() * s).to(c.dtype)
            out[key] = torch.ones_like(scale)
            break
    return out

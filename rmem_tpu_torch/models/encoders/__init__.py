"""Encoder registry and the inference-time BN fold."""

from __future__ import annotations

from typing import Dict

import torch

from rmem_tpu_torch.models.encoders.resnet import ResNet50  # noqa: F401
from rmem_tpu_torch.models.encoders.tiny import TinyEncoder  # noqa: F401


def build_encoder(name: str):
    if name == "resnet50":
        return ResNet50()
    if name == "tiny":
        return TinyEncoder()
    raise NotImplementedError(f"encoder {name!r} not ported (have: resnet50, "
                              "tiny)")


# FoldedBN name -> the conv it follows: the ResNet rows of the JAX package's
# fold_bn_params pairing table (the tiny encoder has no BN)
_BN_CONV = {"bn1": "conv1", "bn2": "conv2", "bn3": "conv3",
            "downsample_bn": "downsample_conv"}


def fold_bn_params(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Fold each encoder FoldedBN scale into the conv before it:
    conv(x, W) * s + b == conv(x, W * s) + b. The fold runs in f32 on the
    state dict; the BN keeps scale 1 and its bias. Returns a new dict."""
    out = dict(state_dict)
    for key, scale in state_dict.items():
        if not (key.startswith("encoder.") and key.endswith(".scale")):
            continue
        parent, bn = key[:-len(".scale")].rsplit(".", 1)
        wkey = f"{parent}.{_BN_CONV.get(bn)}.weight"
        w = state_dict.get(wkey)
        if w is not None and w.dim() == 4 and w.shape[0] == scale.shape[0]:
            out[wkey] = (w.float() * scale.float()[:, None, None, None]
                         ).to(w.dtype)
            out[key] = torch.ones_like(scale)
    return out

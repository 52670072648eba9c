"""Weights from the JAX package: its flax parameter tree, as numpy arrays,
becomes this package's state dict.

The port names its modules after the flax paths, so the mapping is a fixed
rule: the path joined with dots; a `kernel` leaf becomes `weight`, a Dense
kernel [in, out] transposed to Linear's [out, in] and a conv kernel HWIO
permuted to OIHW; every other leaf keeps its name and layout.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params tree (nested mappings of arrays) -> f32 state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        arr = np.asarray(arr, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank "
                                 f"{arr.ndim}")
            leaf = "weight"
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
            np.array(arr, order="C", copy=True))
    return out

"""A per-process cache of tensors made on a device."""

from __future__ import annotations

import functools

import torch


def device_cache(maxsize: int):
    """functools.lru_cache for a function that makes tensors, bypassed
    while a graph is traced (`torch.compiler.is_compiling()`): a tensor
    made under torch.export's fake mode is a fake tensor and must not
    reach later eager calls."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch.compiler.is_compiling():
                return fn(*args, **kwargs)
            return cached(*args, **kwargs)

        call.cache_clear = cached.cache_clear
        return call
    return wrap

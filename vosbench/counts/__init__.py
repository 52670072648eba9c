"""The yardstick's arithmetic: the card's published peaks, a kernel call's
least time (its roofline bound) and the operations and bytes of the bank
attention's forward and backward from a call's shapes; the model FLOPs of
a served frame or a training step are counted in `model_flops`.

Peaks: NVIDIA H100 SXM5 data sheet, dense rates at the 700 W power limit:
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3. A card set below
700 W runs slower under load; PERF.md gives the card's limit beside every
share of these peaks.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of a call: the larger of its operations at the peak
    rate and its bytes at the peak bandwidth, in seconds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def bank_attn_fwd(b: int, lq: int, count: int, lk: int, ck: int, cv: int,
                  slots: int, bias: bool, heads: int) -> Tuple[float, float]:
    """(operations, bytes) of one inference bank-attention call (K1, K1ʰ):
    every head's q.k and p.v over the valid slots' keys; q, the valid keys
    and values (bf16) and the logit bias (f32 [B, h, Lq, S]) read once,
    the output (bf16) and the slot mass (f32 [B, Lq, S]) written once."""
    kv = count * lk
    flops = 2.0 * b * lq * kv * (ck + cv)
    nbytes = (b * lq * ck + b * kv * (ck + cv) + b * lq * cv) * 2 \
        + (b * heads * lq * slots if bias else 0) * 4 + b * lq * slots * 4
    return flops, nbytes


def bank_attn_bwd(b: int, lq: int, count: int, lk: int, ck: int, cv: int,
                  slots: int, heads: int) -> Tuple[float, float]:
    """(operations, bytes) of one backward call (K2, K2ʰ) as training makes
    it: S recomputed and G = dout.V^T once each, then dQ, dK and dV
    (3 ck + 2 cv products a pair); q, k, v, dout (bf16), the f32 output,
    each head's lse and slot mass and drec read, dq and every slot's dk,
    dv written (bf16)."""
    kv = count * lk
    flops = 2.0 * b * lq * kv * (3 * ck + 2 * cv)
    qb, kb, vb = b * lq * ck * 2, kv * b * ck * 2, kv * b * cv * 2
    ob = b * lq * cv * 2
    nbytes = (2 * qb + kb + vb + 3 * ob + b * heads * lq * 4
              + b * lq * slots * 4 + b * heads * lq * slots * 4
              + slots * b * lk * (ck + cv) * 2)
    return flops, nbytes


def share(bound_seconds: float, device_seconds: float):
    """A roofline share in %, or None where nothing ran."""
    if device_seconds <= 0 or bound_seconds <= 0:
        return None
    return 100.0 * bound_seconds / device_seconds

"""The yardstick's counts against hand counts at small shapes."""

from __future__ import annotations

import itertools

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vosbench import counts
from vosbench.counts.model_flops import serve_flops, train_flops
from vosbench.reference.model import local_attn, window_pairs
from vosbench.reference.numerics import Numerics


def test_bound_takes_the_larger_time():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_bank_attention_forward_hand_count():
    # 1 query row of width 4 over 2 valid slots of 3 keys, values 8:
    # q.k and p.v, 2 flops a multiply-add
    flops, nbytes = counts.bank_attn_fwd(b=1, lq=1, count=2, lk=3, ck=4,
                                         cv=8, slots=5, bias=True, heads=1)
    assert flops == 2 * 6 * (4 + 8)
    # q, the 6 keys and values, the output (bf16); the bias [1,1,1,5] and
    # the mass [1,1,5] (f32)
    assert nbytes == (4 + 6 * 12 + 8) * 2 + 5 * 4 + 5 * 4


def test_bank_attention_backward_hand_count():
    flops, nbytes = counts.bank_attn_bwd(b=1, lq=2, count=1, lk=3, ck=4,
                                         cv=8, slots=2, heads=1)
    # S (ck), G (cv), dQ (ck), dK (ck), dV (cv) over 2 x 3 pairs
    assert flops == 2 * 2 * 3 * (3 * 4 + 2 * 8)
    qb, kb, vb, ob = 2 * 4 * 2, 3 * 4 * 2, 3 * 8 * 2, 2 * 8 * 2
    assert nbytes == (2 * qb + kb + vb + 3 * ob + 2 * 4 + 2 * 2 * 4
                      + 2 * 2 * 4 + 2 * 3 * 12 * 2)


@pytest.mark.parametrize("h,w", [(3, 4), (9, 20), (16, 16)])
def test_window_pairs_brute_force(h, w):
    n = sum(1 for (y, x), (yy, xx) in itertools.product(
        itertools.product(range(h), range(w)), repeat=2)
        if abs(y - yy) <= 7 and abs(x - xx) <= 7)
    assert window_pairs(h, w) == n


def test_local_attention_counts_its_window_not_the_dense_form():
    num = Numerics()
    num.counting = True
    b, h, w, heads, dh, dv = 2, 9, 20, 1, 4, 8
    q = torch.zeros(b, h * w, heads * dh)
    v = torch.zeros(b, h * w, heads * dv)
    rel = torch.zeros(b, h * w, heads * 225)
    with FlopCounterMode(display=False) as fc:
        local_attn(num, q, q, v, rel, (h, w), heads, 0.5)
    assert fc.get_total_flops() == 0
    assert num.extra_flops == 2 * b * heads * window_pairs(h, w) * (dh + dv)


def test_model_flops_count_the_tiny_models():
    import dataclasses
    from rmem_tpu_torch.config import get_config
    for model in ("tiny_deaotl", "tiny_aotl"):
        cfg = dataclasses.asdict(get_config("pre_vost_2", model=model))
        one = serve_flops(cfg, [(97, 161)], 1)
        two = serve_flops(cfg, [(97, 161), (97, 161)], 1)
        assert one > 0 and two == pytest.approx(2 * one)
        step = train_flops(cfg, 2, 3, (65, 65))
        assert step == pytest.approx(2 * train_flops(cfg, 1, 3, (65, 65)))

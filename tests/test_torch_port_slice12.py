"""The plain versions of the two redesigned bank-attention kernels in their
own arithmetic, against the JAX package (Pallas in interpret mode): the
slot-group partial + merge form of the 8-head kernel (K1ʰ, K3ʰ, K1'ʰ), and
the fused backward at 2 heads of 128 with values 128 a head (K2×2ᵛ¹²⁸: the
recompute-from-lse dkv and dq kernels, dq summed over slot groups), with
where its dq's miss on keys that nearly cancel comes from; and the
wrappers' route by head shape. The CUDA kernels themselves are held to these
on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import (_forward, pallas_bank_attention,
                                             pallas_bank_attention_infer)
from rmem_tpu_torch.kernels import bank_attention as kb

# f32 on both sides; the kernels' forms sum in another order than Pallas
# (slot groups merged after, the online softmax over other tiles): a few
# f32 ulps of O(1) values
FWD_TOL = 2e-5
# the backward's products sum over every valid key or query: a few f32
# ulps of the gradients' scale
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, ref, rel):
    """max |got - ref| <= rel * max |ref|, shapes equal."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _mh_inputs(seed, count, b=1, s=5, lq=70, lk=60, pad=0):
    """q, bank_k, bank_v at 8 heads of 32, `count` of `s` slots valid,
    `lk` real keys a slot and `pad` more past them."""
    rng = np.random.RandomState(seed)
    return (_rand(rng, b, lq, 256), _rand(rng, s, b, lk + pad, 256),
            _rand(rng, s, b, lk + pad, 256), rng)


# ---- K1ʰ, K3ʰ, K1'ʰ: the slot-group partial + merge form -----------------

@pytest.mark.parametrize("count,bias,pad,b", [
    # 3 of 5 valid: two groups, the second with one slot; bias, keys padded
    # 13 past true_lk, two id groups
    pytest.param(3, True, 13, 2, id="k1h-3-bias-padded-b2"),
    # K3ʰ's call: no bias, every key valid, every slot valid
    pytest.param(5, False, 0, 1, id="k3h-5")])
def test_mh_partial_merge_matches_pallas_infer(count, bias, pad, b):
    """The 8-head kernel's form (`bank_attention_lse_plain` at 8 heads with
    groups of MH_SLOTS_PER_BLOCK: each group's row maximum, per-slot sums
    and normalised output, merged) against pallas_bank_attention_infer in
    interpret mode: the output and the head-mean slot mass, with and
    without the slot-PE bias, keys padded past true_lk, count < S; and
    against the whole softmax (`bank_attention_plain`)."""
    q, bk, bv, rng = _mh_inputs(10 + count, count, b=b, pad=pad)
    lq, s, true_lk = q.shape[1], bk.shape[0], bk.shape[2] - pad
    qbias = _rand(rng, b, 8, lq, s) if bias else None
    with pltpu.force_tpu_interpret_mode():
        ref, rrec = pallas_bank_attention_infer(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), 8,
            scale=32 ** -0.5, true_lk=true_lk,
            qbias=None if qbias is None
            else jnp.asarray(qbias.reshape(b * 8, lq, s)))
    cnt = torch.tensor(count, dtype=torch.int32)
    tb = None if qbias is None else _t(qbias)
    out, rec_h, _ = kb.bank_attention_lse_plain(
        _t(q), _t(bk), _t(bv), cnt, 32 ** -0.5, 8, true_lk, tb)
    _close(out, ref, FWD_TOL)
    np.testing.assert_allclose(rec_h.mean(1).numpy(), np.asarray(rrec),
                               atol=FWD_TOL)
    assert torch.all(rec_h[..., count:] == 0)
    whole, whole_rec = kb.bank_attention_plain(
        _t(q), _t(bk), _t(bv), cnt, 8, 32 ** -0.5, true_lk, tb)
    _close(out, whole, FWD_TOL)
    np.testing.assert_allclose(rec_h.mean(1).numpy(), whole_rec.numpy(),
                               atol=FWD_TOL)


@pytest.mark.parametrize("count", [1, 4])
def test_mh_partial_merge_lse_matches_pallas_forward(count):
    """K1'ʰ's form (groups of MH_SLOTS_PER_BLOCK, every key valid, no bias)
    against the Pallas forward with its lse at 8 heads, at one slot group
    and at two: the output, each head's slot mass and each head's lse; the
    wrapper takes the whole-softmax plain version on the CPU, which
    agrees."""
    q, bk, bv, _ = _mh_inputs(20 + count, count, b=2, s=4, lq=50)
    b, lq = q.shape[:2]
    with pltpu.force_tpu_interpret_mode():
        out_bh, rec_bh, lse_bh, _ = _forward(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), 8, 32 ** -0.5,
            256, 2048, want_lse=True)
    cnt = torch.tensor(count, dtype=torch.int32)
    got = kb.bank_attention_lse_plain(_t(q), _t(bk), _t(bv), cnt, 32 ** -0.5,
                                      8)
    ref_out = np.asarray(out_bh)[:, :lq].reshape(b, 8, lq, 32)
    refs = (ref_out.transpose(0, 2, 1, 3).reshape(b, lq, 256),
            np.asarray(rec_bh)[:, :lq].reshape(b, 8, lq, -1),
            np.asarray(lse_bh)[:, :lq, 0].reshape(b, 8, lq))
    for g, r in zip(got, refs):
        _close(g, r, FWD_TOL)
    assert torch.all(got[1][..., count:] == 0)
    for g, w in zip(got, kb.bank_attention_lse_mh(_t(q), _t(bk), _t(bv), cnt,
                                                 32 ** -0.5)):
        _close(g, w, FWD_TOL)


# ---- K2×2ᵛ¹²⁸: the fused backward at 2 heads of 128, values 128 a head ----

@pytest.mark.parametrize("count", [3, 5])
def test_fused_bwd_plain_matches_pallas_vjp(count):
    """K2×2ᵛ¹²⁸'s kernels in their own form (`bank_attention_bwd_fused_plain`:
    p and ds recomputed from the lse, dk and dv the dkv kernel's, dq the sum
    of the slot groups' partials), fed the plain forward's lse and each
    head's row term, against jax.vjp of pallas_bank_attention (interpret
    mode) at 2 heads of 128 with values 128 a head, nonzero cotangents of
    the output and of the head-mean record: dq, dk, dv, and dk, dv exactly 0
    in the invalid slots; autograd of the plain forward agrees. 3 of 5
    slots valid (two dq groups, the second with one slot) and all 5."""
    rng = np.random.RandomState(30 + count)
    s, b, lq, lk = 5, 1, 40, 50
    q, bk = _rand(rng, b, lq, 256) * 0.3, _rand(rng, s, b, lk, 256) * 0.3
    bv = _rand(rng, s, b, lk, 256)
    dout, drec = _rand(rng, b, lq, 256), _rand(rng, b, lq, s)
    scale = 128 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: pallas_bank_attention(
            *a, jnp.int32(count), 2, scale=scale),
            *map(jnp.asarray, (q, bk, bv)))
        refs = vjp((jnp.asarray(dout), jnp.asarray(drec)))
    cnt = torch.tensor(count, dtype=torch.int32)
    ins = (_t(q), _t(bk), _t(bv), cnt)
    out, rec_h, lse_h = kb.bank_attention_lse_plain(*ins, scale, 2)
    delta_h = kb.bwd_delta_mh(_t(dout), out, _t(drec), rec_h)
    args = (*ins, _t(dout), lse_h, delta_h, _t(drec), scale)
    got = kb.bank_attention_bwd_fused_plain(*args)
    auto = kb.bank_attention_bwd_plain(*ins, _t(dout), _t(drec), scale, 2)
    for g, a, r in zip(got, auto, refs):
        _close(g, r, GRAD_TOL)
        _close(a, r, GRAD_TOL)
    assert torch.all(got[1][count:] == 0) and torch.all(got[2][count:] == 0)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = kb.bank_attention_bwd_fused.launches
    assert all(torch.equal(w, g) for w, g in
               zip(kb.bank_attention_bwd_fused(*args), got))
    assert kb.bank_attention_bwd_fused.launches == before


def test_fused_dq_groups_and_rows():
    """The dq kernel's slot-group sum is the sum over the valid slots (the
    groups of FUSED_DQ_SLOTS partition them, 0 past count), and the two row
    arrays the kernels read: lse2 = lse log2(e) with +inf past Lq (a padded
    query's p is exactly 0) and rterm = drec / 2 - delta with 0 past Lq."""
    rng = np.random.RandomState(40)
    s, b, lq, lk, count = 5, 2, 37, 20, 3
    q, bk = _t(_rand(rng, b, lq, 256)), _t(_rand(rng, s, b, lk, 256))
    bv, dout = _t(_rand(rng, s, b, lk, 256)), _t(_rand(rng, b, lq, 256))
    drec = _t(_rand(rng, b, lq, s))
    cnt = torch.tensor(count, dtype=torch.int32)
    scale = 128 ** -0.5
    out, rec_h, lse_h = kb.bank_attention_lse_plain(q, bk, bv, cnt, scale, 2)
    delta_h = kb.bwd_delta_mh(dout, out, drec, rec_h)
    args = (q, bk, bv, cnt, dout, lse_h, delta_h, drec, scale)
    dq = kb.bank_attention_bwd_fused_plain(*args)[0]
    _close(dq, kb.bank_attention_bwd_mh_dq_plain(*args), 1e-6)
    lse2, rterm = kb.fused_rows(lse_h, delta_h, drec)
    assert lse2.shape == (b, 2, 64) and rterm.shape == (b, 2, s, 64)
    assert torch.all(torch.isinf(lse2[..., lq:])) and torch.all(
        rterm[..., lq:] == 0)
    _close(lse2[..., :lq], lse_h / np.log(2.0), 1e-7)
    _close(rterm[..., :lq],
           drec.transpose(1, 2)[:, None] / 2 - delta_h[:, :, None], 1e-7)
    assert torch.exp2(torch.tensor(0.0) - lse2[..., lq:]).eq(0).all()


def test_cancelling_keys_dq_follows_the_forwards_rounding():
    """On keys that nearly cancel in ds K (one shared row plus 0.03 of
    noise, as the slot PE adds one row to a slot's keys), dq = ds K is a
    small difference of large terms, and any error in the row term delta
    reaches it amplified. The fused backward's plain form fed the f32 plain
    forward's output agrees with autograd of the plain forward; fed the
    output of a forward that rounds p to bf16 for P V while summing the f32
    p, as the K1 template does, it misses dq by more than 2e-2 of its max
    (the card's tolerance), while dk and dv stay close: the miss comes from
    the forward's output, not from the backward."""
    rng = np.random.RandomState(50)
    s, b, lq, lk, count = 4, 1, 64, 96, 3

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float()

    q = bf16(_rand(rng, b, lq, 256) * 2.0)
    bk = bf16(_rand(rng, 1, 1, 1, 256) + _rand(rng, s, b, lk, 256) * 0.03)
    bv, dout = bf16(_rand(rng, s, b, lk, 256)), bf16(_rand(rng, b, lq, 256))
    drec = _t(_rand(rng, b, lq, s))
    cnt = torch.tensor(count, dtype=torch.int32)
    scale = 128 ** -0.5
    out, rec_h, lse_h = kb.bank_attention_lse_plain(q, bk, bv, cnt, scale, 2)
    auto = kb.bank_attention_bwd_plain(q, bk, bv, cnt, dout, drec, scale, 2)

    def rel_errs(fwd_out):
        delta_h = kb.bwd_delta_mh(dout, fwd_out, drec, rec_h)
        got = kb.bank_attention_bwd_fused_plain(q, bk, bv, cnt, dout, lse_h,
                                                delta_h, drec, scale)
        return [float((g - a).abs().max() / a.abs().max())
                for g, a in zip(got, auto)]

    # f32 rounding, amplified as above: ~1e-4 of dq's max
    assert max(rel_errs(out)) <= 1e-3
    logits = torch.einsum("bqhd,sbkhd->bhqsk", q.reshape(b, lq, 2, 128),
                          bk[:count].reshape(count, b, lk, 2, 128)) * scale
    p = torch.exp(logits - logits.amax(dim=(-2, -1), keepdim=True))
    rounded = torch.einsum(
        "bhqsk,sbkhd->bqhd", p.to(torch.bfloat16).float(),
        bv[:count].reshape(count, b, lk, 2, 128)) / p.sum(
            dim=(-2, -1)).transpose(1, 2)[..., None]
    dq_err, dk_err, dv_err = rel_errs(rounded.reshape(b, lq, 256))
    assert dq_err > 2e-2 and dk_err <= 1e-3 and dv_err <= 1e-3, (
        dq_err, dk_err, dv_err)


# ---- the route by head shape ----------------------------------------------

def test_bwd_route_by_head_shape():
    """The backward's kernels by head shape: 2 heads of 128 with values 128
    a head to the fused pair, one or two heads of 128 with values 512 or
    1024 a head to K2's split kernels (dV split by value columns), 8 heads
    of 32 to K2ʰ; any other shape raises. The forward's rule is
    unchanged."""
    assert kb.bwd_route(2, 128, 128) == "fused"
    for shape in ((1, 128, 512), (1, 128, 1024), (2, 128, 512),
                  (2, 128, 1024)):
        assert kb.bwd_route(*shape) == "split"
    assert kb.bwd_route(8, 32, 32) == "heads"
    for shape in ((1, 128, 128), (8, 32, 64), (2, 64, 64), (4, 64, 64),
                  (2, 128, 384)):
        with pytest.raises(ValueError, match="heads of width"):
            kb.bwd_route(*shape)
    assert kb.train_route(2, 128, 128) == "slots"
    assert kb.train_route(8, 32, 32) == "heads"

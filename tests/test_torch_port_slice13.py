"""The plain versions of the two bank-attention kernels redesigned for
AOT's training, in their own arithmetic, against the JAX package (Pallas in
interpret mode): K1'×2ᵛ¹²⁸, the forward with lse at 2 heads of 128 with
values 128 a head (64-key chunks taken in turn by two consumers, merged in
the block), and K2ʰ, the backward at 8 heads of 32 (the rows kernel's lse2
and rterm, the dkv kernel's dk and dv, the dq kernel's slot-group partials
summed in order); the wrappers' CPU paths and routes by head shape. The
CUDA kernels themselves are held to these on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import _forward, pallas_bank_attention
from rmem_tpu_torch.kernels import bank_attention as kb

# f32 on both sides; the kernels' forms sum in another order than Pallas
# (two consumers' softmax states merged after, slot groups summed after): a
# few f32 ulps of O(1) values
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


# ---- K1'×2ᵛ¹²⁸: one block a query tile, two consumers, merged ------------

@pytest.mark.parametrize("count,lk", [
    # one slot of two chunks (64 keys and a 6-key tail): one chunk each
    pytest.param(1, 70, id="one-slot"),
    # 3 of 4 slots valid, 2 chunks a slot: each consumer walks every slot
    pytest.param(3, 70, id="three-slots"),
    # one chunk a slot: consumer 0 takes slots 0 and 2, consumer 1 slot 1
    pytest.param(3, 40, id="chunk-a-slot")])
def test_k1p_v128_form_matches_pallas_forward(count, lk):
    """K1'×2ᵛ¹²⁸'s form (`bank_attention_lse_v128_plain`: each consumer's
    maximum, per-slot sums and output over its chunks, merged) against the
    Pallas forward with its lse at 2 heads of 128, values 128 a head: the
    output, each head's slot mass (0 past count) and each head's lse; the
    slot-group form the card ran before (`bank_attention_lse_plain`)
    agrees."""
    rng = np.random.RandomState(60 + count + lk)
    s, b, lq = 4, 2, 50
    q = _rand(rng, b, lq, 256) * 0.5
    bk, bv = _rand(rng, s, b, lk, 256) * 0.5, _rand(rng, s, b, lk, 256)
    scale = 128 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out_bh, rec_bh, lse_bh, _ = _forward(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), 2, scale,
            256, 2048, want_lse=True)
    cnt = torch.tensor(count, dtype=torch.int32)
    got = kb.bank_attention_lse_v128_plain(_t(q), _t(bk), _t(bv), cnt, scale)
    ref_out = np.asarray(out_bh)[:, :lq].reshape(b, 2, lq, 128)
    refs = (ref_out.transpose(0, 2, 1, 3).reshape(b, lq, 256),
            np.asarray(rec_bh)[:, :lq].reshape(b, 2, lq, s),
            np.asarray(lse_bh)[:, :lq, 0].reshape(b, 2, lq))
    for g, r in zip(got, refs):
        _close(g, r, FWD_TOL)
    assert torch.all(got[1][..., count:] == 0)
    for g, w in zip(got, kb.bank_attention_lse_plain(
            _t(q), _t(bk), _t(bv), cnt, scale, 2)):
        _close(g, w, FWD_TOL)


def test_k1p_v128_chunks_alternate_between_consumers():
    """The chunk walk the kernel takes: slot major, ceil(Lk / 64) chunks a
    slot, chunk j to consumer j % 2; with one consumer's chunks empty (one
    slot of one chunk) the merge still gives the whole softmax, and the
    wrapper takes K1'×2ᵛ¹²⁸ for this head shape on the card only."""
    assert (kb.V128_CHUNK, kb.V128_CONSUMERS) == (64, 2)
    rng = np.random.RandomState(70)
    q, bk = _t(_rand(rng, 1, 30, 256)), _t(_rand(rng, 1, 1, 20, 256))
    bv = _t(_rand(rng, 1, 1, 20, 256))
    cnt = torch.tensor(1, dtype=torch.int32)
    got = kb.bank_attention_lse_v128_plain(q, bk, bv, cnt, 0.1)
    whole = kb.bank_attention_lse_mh_plain(q, bk, bv, cnt, 0.1, 2)
    for g, w in zip(got, whole):
        _close(g, w, 1e-6)
    with pytest.raises(ValueError, match="not on"):
        kb.bank_attention_lse(q.bfloat16(), bk.bfloat16(), bv.bfloat16(),
                              cnt, 0.1, num_heads=2)


# ---- K2ʰ: the rows kernel, dkv, dq over slot groups ------------------------

@pytest.mark.parametrize("count", [1, 3])
def test_k2h_form_matches_pallas_vjp(count):
    """K2ʰ's kernels in their own form (`fused_rows` of the row term the
    rows kernel computes from the forward's output and slot mass, then
    `bank_attention_bwd_mh_form_plain`: p = 2^(x - lse2), ds = p (g +
    rterm), dk and dv, dq the sum of the slot groups' partials), fed the
    plain forward, against jax.vjp of pallas_bank_attention (interpret
    mode) at 8 heads of 32, nonzero cotangents of the output and of the
    head-mean record, 1 and 3 of 5 slots valid (one dq group; two, the
    second with one slot): dq, dk, dv, and dk, dv exactly 0 past count;
    autograd of the plain forward agrees."""
    rng = np.random.RandomState(80 + count)
    s, b, lq, lk = 5, 1, 45, 70
    q, bk = _rand(rng, b, lq, 256), _rand(rng, s, b, lk, 256)
    bv = _rand(rng, s, b, lk, 256)
    dout, drec = _rand(rng, b, lq, 256), _rand(rng, b, lq, s)
    scale = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: pallas_bank_attention(
            *a, jnp.int32(count), 8, scale=scale),
            *map(jnp.asarray, (q, bk, bv)))
        refs = vjp((jnp.asarray(dout), jnp.asarray(drec)))
    cnt = torch.tensor(count, dtype=torch.int32)
    ins = (_t(q), _t(bk), _t(bv), cnt)
    out, rec_h, lse_h = kb.bank_attention_lse_mh_plain(*ins, scale)
    delta_h = kb.bwd_delta_mh(_t(dout), out, _t(drec), rec_h)
    lse2, rterm = kb.fused_rows(lse_h, delta_h, _t(drec))
    assert lse2.shape == (b, 8, 64) and rterm.shape == (b, 8, s, 64)
    got = kb.bank_attention_bwd_mh_form_plain(*ins, _t(dout), lse2, rterm,
                                              scale)
    auto = kb.bank_attention_bwd_plain(*ins, _t(dout), _t(drec), scale, 8)
    for g, a, r in zip(got, auto, refs):
        _close(g, r, GRAD_TOL)
        _close(a, r, GRAD_TOL)
    assert torch.all(got[1][count:] == 0) and torch.all(got[2][count:] == 0)


def test_k2h_dq_groups_and_the_row_term_on_the_card():
    """The dq kernel's slot-group sum is the sum over the valid slots (the
    groups of MH_BWD_DQ_SLOTS partition them), and the wrapper, handed the
    forward's f32 output and slot mass to compute the row term from, gives
    the plain stages' gradients on the CPU and launches nothing."""
    rng = np.random.RandomState(90)
    s, b, lq, lk, count = 5, 1, 33, 20, 3
    q, bk = _t(_rand(rng, b, lq, 256)), _t(_rand(rng, s, b, lk, 256))
    bv, dout = _t(_rand(rng, s, b, lk, 256)), _t(_rand(rng, b, lq, 256))
    drec = _t(_rand(rng, b, lq, s))
    cnt = torch.tensor(count, dtype=torch.int32)
    scale = 32 ** -0.5
    out, rec_h, lse_h = kb.bank_attention_lse_mh_plain(q, bk, bv, cnt, scale)
    delta_h = kb.bwd_delta_mh(dout, out, drec, rec_h)
    args = (q, bk, bv, cnt, dout, lse_h, delta_h, drec, scale)
    lse2, rterm = kb.fused_rows(lse_h, delta_h, drec)
    form = kb.bank_attention_bwd_mh_form_plain(q, bk, bv, cnt, dout, lse2,
                                               rterm, scale)
    stages = (kb.bank_attention_bwd_mh_dq_plain(*args),
              *kb.bank_attention_bwd_mh_dkv_plain(*args))
    for f, st in zip(form, stages):
        _close(f, st, 1e-5)
    before = kb.bank_attention_bwd_mh.launches
    got = kb.bank_attention_bwd_mh(q, bk, bv, cnt, out, rec_h, lse_h, dout,
                                   drec, scale)
    assert all(torch.equal(g, st) for g, st in zip(got, stages))
    assert kb.bank_attention_bwd_mh.launches == before


def test_training_routes_by_head_shape():
    """The training kernels by head shape: 8 heads of 32 to K1'ʰ and K2ʰ
    ("heads"), 2 heads of 128 with values 128 a head to K1'×2ᵛ¹²⁸ and the
    fused backward, one or two heads of 128 with values 512 or 1024 a head
    to K1''s template and K2's scratch kernels; any other shape raises."""
    assert kb.train_route(8, 32, 32) == kb.bwd_route(8, 32, 32) == "heads"
    assert kb.train_route(2, 128, 128) == "slots"
    assert kb.NARROW_VALUES == (2, 128, 128)
    assert kb.bwd_route(2, 128, 128) == "fused"
    for shape in ((1, 128, 1024), (2, 128, 512)):
        assert kb.train_route(*shape) == "slots"
        assert kb.bwd_route(*shape) == "scratch"
    for shape in ((1, 128, 128), (8, 32, 64), (4, 64, 64)):
        with pytest.raises(ValueError, match="heads of width"):
            kb.bwd_route(*shape)

"""The plain versions behind the redesigned stem and training bank
attention, against the JAX package: K7's backward from the forward's saved
state (`stem_bwd`) against the VJP of xla_stem_chain, and K1''s partial + merge
form (`bank_attention_lse_plain`) against the Pallas forward with its
log-sum-exp in interpret mode. The CUDA kernels themselves are held to
these on the card by chip_smoke.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import _forward
from rmem_tpu.kernels.stem import xla_stem_chain
from rmem_tpu_torch.kernels import bank_attention as kbank
from rmem_tpu_torch.kernels import stem as kstem

BF = torch.bfloat16


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


def _stem_inputs(seed, b, h, w):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w, 3).astype(np.float32)
    wt = _rand(rng, 7, 7, 3, 64) * 0.2
    scale, bias = 1.0 + 0.1 * _rand(rng, 64), 0.1 * _rand(rng, 64)
    ph, pw = ((h - 1) // 2) // 2 + 1, ((w - 1) // 2) // 2 + 1
    return x, wt, scale, bias, _rand(rng, b, ph, pw, 64)


@pytest.mark.parametrize("b,h,w", [(1, 29, 30), (2, 21, 25)],
                         ids=["29x30", "b2-21x25"])
def test_stem_bwd_matches_xla_chain_vjp(b, h, w):
    """K7's backward in bf16, as xla_stem_chain's VJP is: stem_bwd fed the
    plain chain's saved state (the bf16 conv map, the output and its argmax,
    what the kernel writes) against jax.vjp of xla_stem_chain with a bf16
    cotangent, on odd image sizes so that the pool's edge windows lie partly
    outside the conv grid. Both sum in f32 in their own order and round to
    bf16, so they agree to a few bf16 ulps (2^-8) of each gradient's largest
    value."""
    x, wt, scale, bias, g = _stem_inputs(5, b, h, w)

    @jax.jit
    def vjp(*a):
        _, fn = jax.vjp(xla_stem_chain, *a)
        return fn(jnp.asarray(g, jnp.bfloat16))[1:]

    refs = [np.asarray(r.astype(jnp.float32))
            for r in vjp(x, wt, scale, bias)]
    refs[0] = refs[0].transpose(3, 2, 0, 1)
    w_oihw = _t(wt.transpose(3, 2, 0, 1)).to(BF)
    sb = (_t(scale).to(BF), _t(bias).to(BF))
    out, conv, argmax = kstem.stem_saved_plain(_t(x), w_oihw, *sb)
    got = kstem.stem_bwd(_t(x), conv, argmax, out, w_oihw, sb[0],
                         _t(g).to(BF))
    for name, t, r in zip(("dweight", "dscale", "dbias"), got, refs):
        assert t.dtype == BF and t.shape == r.shape, name
        err = np.abs(t.float().numpy() - r).max()
        assert err <= 2 ** -6 * np.abs(r).max(), (name, err)


def test_stem_bwd_matches_autograd_of_stem_plain():
    """stem_bwd is autograd of stem_plain in bf16 written out: the same
    gradients on the same inputs, within a bf16 ulp of each gradient's
    largest value (the reductions may run in another order, and dbias sums
    before the pool's backward adds overlapping windows)."""
    x, wt, scale, bias, g = _stem_inputs(6, 1, 27, 33)
    ins = [_t(a).to(BF).requires_grad_()
           for a in (wt.transpose(3, 2, 0, 1), scale, bias)]
    kstem.stem_plain(_t(x), *ins).backward(_t(g).to(BF))
    w, s, b = (t.detach() for t in ins)
    out, conv, argmax = kstem.stem_saved_plain(_t(x), w, s, b)
    got = kstem.stem_bwd(_t(x), conv, argmax, out, w, s, _t(g).to(BF))
    for name, t, r in zip(("dweight", "dscale", "dbias"), got, ins):
        ref = r.grad.float()
        err = (t.float() - ref).abs().max().item()
        assert err <= 2 ** -7 * ref.abs().max().item(), (name, err)


def test_stem_on_cpu_saves_the_plain_state():
    """On CPU tensors `stem(..., save=True)`, the forward of K7, gives the
    plain version's output, conv map and argmax, and launches nothing; the
    argmax picks a position of each window holding the output's value."""
    x, wt, scale, bias, _ = _stem_inputs(7, 1, 19, 23)
    args = (_t(x), _t(wt.transpose(3, 2, 0, 1)).to(BF), _t(scale),
            _t(bias))
    before = kstem.stem.launches
    out, conv, argmax = kstem.stem(*args, save=True)
    assert torch.equal(out, kstem.stem_plain(*args))
    assert torch.equal(conv, kstem.stem_conv_plain(*args[:2]))
    assert conv.shape == (1, 10, 12, 64) and conv.dtype == BF
    assert argmax.shape == out.shape and argmax.dtype == torch.int64
    y = torch.relu(conv * args[2].to(BF) + args[3].to(BF))
    picked = y.reshape(1, -1, 64).gather(1, argmax.reshape(1, -1, 64))
    assert torch.equal(picked.reshape(out.shape), out)
    assert kstem.stem.launches == before


def _bank_inputs(seed, count):
    rng = np.random.RandomState(seed)
    s, b, lq, lk, dh, dv = 10, 2, 40, 36, 32, 64
    return (_rand(rng, b, lq, dh), _rand(rng, s, b, lk, dh),
            _rand(rng, s, b, lk, dv), dh ** -0.5)


@pytest.mark.parametrize("count", [1, 3, 4])
def test_lse_split_plain_matches_pallas_forward(count):
    """K1''s partial + merge form (slot groups of SLOTS_PER_BLOCK, per-group
    maxima and sums in log2 units, the lse in natural units) against the
    Pallas forward with its lse (`_forward(..., want_lse=True)`, interpret
    mode) at 1, 3 and 4 valid slots of 10: one group, then two groups
    merged. f32 on both sides: a few f32 ulps of O(1) values."""
    q, bk, bv, scale = _bank_inputs(count, count)
    with pltpu.force_tpu_interpret_mode():
        out, rec, lse, geom = _forward(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), 1, scale,
            128, 128, want_lse=True)
    lq = q.shape[1]
    got = kbank.bank_attention_lse_plain(
        _t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32),
        scale)
    refs = (np.asarray(out)[:, :lq], np.asarray(rec)[:, :lq],
            np.asarray(lse)[:, :lq, 0])
    for name, g, r in zip(("out", "rec", "lse"), got, refs):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    assert torch.all(got[1][..., count:] == 0)


@pytest.mark.parametrize("count", [2, 5])
def test_lse_split_plain_is_the_whole_softmax(count):
    """The merge makes the decomposition the whole softmax: out and rec
    equal the plain bank attention's and lse the log-sum-exp of all valid
    scaled logits, for one slot group and for three (the last partly
    filled)."""
    q, bk, bv, scale = _bank_inputs(9, count)
    cnt = torch.tensor(count, dtype=torch.int32)
    out, rec, lse = kbank.bank_attention_lse_plain(
        _t(q), _t(bk), _t(bv), cnt, scale)
    ref_out, ref_rec = kbank.bank_attention_plain(_t(q), _t(bk), _t(bv),
                                                  cnt, 1, scale)
    logits = torch.einsum("bqd,sbkd->bqsk", _t(q), _t(bk)[:count]) * scale
    ref_lse = logits.reshape(*logits.shape[:2], -1).logsumexp(-1)
    for g, r in ((out, ref_out), (rec, ref_rec), (lse, ref_lse)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
    assert math.isclose(rec.sum(-1).mean().item(), 1.0, rel_tol=1e-5)

"""The plain versions of the training kernels against the JAX kernels they
replace, and their CPU-side rules: K2 (the bank-attention backward) through
autograd of the plain forward against jax.grad of pallas_bank_attention in
interpret mode, K5's and K7's gradients against the JAX VJPs, and K2's
three plain stages against autograd. f32 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import pallas_bank_attention
from rmem_tpu.kernels.local_attention import _trainable_bwd
from rmem_tpu.kernels.stem import xla_stem_chain
from rmem_tpu_torch.kernels import bank_attention as kbank
from rmem_tpu_torch.kernels import local_attention as klocal
from rmem_tpu_torch.kernels import stem as kstem

# f32 on both sides; the Pallas kernels sum in another order (online
# softmax and flash backward over key tiles): a few f32 ulps of O(1) values
TOL = dict(rtol=1e-4, atol=1e-4)


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


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=grad)


def test_bank_attention_grad_matches_pallas_vjp():
    """Gradients of sum(out * w_out) + sum(rec * w_rec) (a nonzero drec)
    with 3 of 5 slots valid: the port's differentiable bank attention on the
    CPU (autograd of its plain version) against jax.grad through
    pallas_bank_attention's custom VJP (the TPU kernels K1' and K2)."""
    rng = np.random.RandomState(0)
    s, b, lq, lk, dh, dv, count = 5, 1, 70, 60, 32, 64, 3
    q, bk = _rand(rng, b, lq, dh), _rand(rng, s, b, lk, dh)
    bv = _rand(rng, s, b, lk, dv)
    w_out, w_rec = _rand(rng, b, lq, dv), _rand(rng, b, lq, s)
    scale = dh ** -0.5

    def loss(q_, k_, v_):
        out, rec = pallas_bank_attention(q_, k_, v_, jnp.int32(count), 1,
                                         scale=scale)
        return jnp.sum(out * w_out) + jnp.sum(rec * w_rec)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                     (q, bk, bv)))
    ins = [_t(a, grad=True) for a in (q, bk, bv)]
    out, rec = kbank.bank_attention_train(
        *ins, torch.tensor(count, dtype=torch.int32), scale)
    (out * _t(w_out)).sum().add((rec * _t(w_rec)).sum()).backward()
    for name, t, r in zip(("dq", "dk", "dv"), ins, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL,
                                   err_msg=name)
    assert np.all(ins[1].grad.numpy()[count:] == 0)
    assert np.all(ins[2].grad.numpy()[count:] == 0)


def test_k2_plain_stages_compose_to_autograd():
    """The three plain stages the CUDA kernels are held to on the card
    (p and ds; dq; dk and dv) give autograd's gradients of the plain
    forward, with a nonzero drec and 2 of 4 slots valid."""
    rng = np.random.RandomState(1)
    s, b, lq, lk, dh, dv, count = 4, 2, 30, 27, 16, 32, 2
    q, bk, bv = _t(_rand(rng, b, lq, dh)), _t(_rand(rng, s, b, lk, dh)), \
        _t(_rand(rng, s, b, lk, dv))
    dout, drec = _t(_rand(rng, b, lq, dv)), _t(_rand(rng, b, lq, s))
    cnt = torch.tensor(count, dtype=torch.int32)
    scale = dh ** -0.5
    ref = kbank.bank_attention_bwd_plain(q, bk, bv, cnt, dout, drec, scale)
    out, rec = kbank.bank_attention_plain(q, bk, bv, cnt, 1, scale)
    logits = torch.einsum("bqd,sbkd->bqsk", q, bk[:count]) * scale
    lse = logits.reshape(b, lq, -1).logsumexp(-1)
    p, ds = kbank.bank_attention_bwd_ds_plain(
        q, bk, bv, cnt, dout, lse, kbank.bwd_delta(dout, out, drec, rec),
        drec, scale)
    got = (kbank.bank_attention_bwd_dq_plain(ds, bk, scale),
           *kbank.bank_attention_bwd_dkv_plain(p, ds, q, dout, scale))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert torch.all(got[1][count:] == 0) and torch.all(got[2][count:] == 0)


def test_local_attention_trainable_grad_matches_pallas_vjp():
    """K5: the port's gradients (autograd of the plain version, what the
    card's backward runs) against the backward rule of
    pallas_local_attention_trainable (the VJP of the XLA tiled form at the
    saved inputs) on an 8 x 9 grid. Its Pallas forward, the K4 kernel, is
    held to the plain version by test_torch_port_kernels_plain."""
    rng = np.random.RandomState(2)
    size = (8, 9)
    hw = size[0] * size[1]
    args = [_rand(rng, 1, hw, 32), _rand(rng, 1, hw, 32),
            _rand(rng, 1, hw, 64), _rand(rng, 1, hw, 225)]
    g = _rand(rng, 1, hw, 64)
    scale = 32 ** -0.5
    refs = jax.jit(lambda *a: _trainable_bwd(size, 1, 7, scale, True, a[:4],
                                             a[4]))(*args, g)
    ins = [_t(a, grad=True) for a in args]
    klocal.local_attention_trainable(*ins, size, 1, 7, scale).backward(_t(g))
    for name, t, r in zip(("dq", "dk", "dv", "drel"), ins, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL,
                                   err_msg=name)


def test_stem_trainable_grad_matches_xla_chain_vjp():
    """K7 in bf16, as xla_stem_chain is: the port's gradients of weight,
    scale and bias (autograd of stem_plain at bf16 inputs, what the card's
    backward runs) against the VJP of xla_stem_chain with a bf16 cotangent.
    Both sum in f32 in their own order and round to bf16, so they agree to
    a few bf16 ulps (2^-8) of each gradient's largest value."""
    rng = np.random.RandomState(3)
    x = rng.rand(2, 21, 25, 3).astype(np.float32)
    w = _rand(rng, 7, 7, 3, 64) * 0.2
    scale, bias = 1.0 + 0.1 * _rand(rng, 64), 0.1 * _rand(rng, 64)
    g = _rand(rng, 2, 6, 7, 64)

    @jax.jit
    def fwd_bwd(*a):
        out, vjp = jax.vjp(xla_stem_chain, *a)
        return (out, *vjp(jnp.asarray(g, jnp.bfloat16))[1:])

    out_ref, dw, ds, db = fwd_bwd(x, w, scale, bias)
    bf = torch.bfloat16
    ins = [_t(w.transpose(3, 2, 0, 1)).to(bf).requires_grad_(),
           _t(scale).to(bf).requires_grad_(), _t(bias).to(bf).requires_grad_()]
    out = kstem.stem_trainable(_t(x), *ins)
    out.backward(_t(g).to(bf))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)
    refs = (np.asarray(dw.astype(jnp.float32)).transpose(3, 2, 0, 1),
            np.asarray(ds.astype(jnp.float32)),
            np.asarray(db.astype(jnp.float32)))
    for name, t, r in zip(("dweight", "dscale", "dbias"), ins, refs):
        err = np.abs(t.grad.float().numpy() - r).max()
        assert err <= 2 ** -6 * np.abs(r).max(), (name, err)


def test_trainable_wrappers_on_cpu_take_the_plain_version():
    """On CPU tensors each training wrapper is autograd through its plain
    version and launches nothing; the card-only launch wrappers refuse CPU
    tensors instead of falling back."""
    rng = np.random.RandomState(4)
    counters = (kbank.bank_attention_infer, kbank.bank_attention_lse,
                kbank.bank_attention_bwd_ds, kbank.bank_attention_bwd_dq,
                kbank.bank_attention_bwd_dkv, klocal.local_attention,
                kstem.stem)
    before = [fn.launches for fn in counters]
    q, bk, bv = _t(_rand(rng, 1, 16, 128)), _t(_rand(rng, 3, 1, 16, 128)), \
        _t(_rand(rng, 3, 1, 16, 256))
    cnt = torch.tensor(2, dtype=torch.int32)
    out, rec = kbank.bank_attention_train(q, bk, bv, cnt, 0.1)
    ref = kbank.bank_attention_plain(q, bk, bv, cnt, 1, 0.1)
    assert torch.equal(out, ref[0]) and torch.equal(rec, ref[1])
    rel = _t(_rand(rng, 1, 16, 225))
    assert torch.equal(
        klocal.local_attention_trainable(q, q, bv[0], rel, (4, 4), 1, 7, .1),
        klocal.local_attention_plain(q, q, bv[0], rel, (4, 4), 1, 7, .1))
    x = _t(rng.rand(1, 9, 9, 3))
    w, s, b = _t(_rand(rng, 64, 3, 7, 7)), _t(np.ones(64)), _t(np.zeros(64))
    assert torch.equal(kstem.stem_trainable(x, w, s, b),
                       kstem.stem_plain(x, w, s, b))
    assert [fn.launches for fn in counters] == before
    with pytest.raises(ValueError, match="not on"):
        kbank.bank_attention_lse(q.bfloat16(), bk.bfloat16(), bv.bfloat16(),
                                 cnt, 0.1)

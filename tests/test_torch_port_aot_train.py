"""AOT training in the port against the JAX package, f32 on both sides on
the CPU, with the same inputs made from numpy seeds: the differentiable
bank attention at 8 heads against jax.grad through pallas_bank_attention
(the TPU kernels K1' and K2 at num_heads = 8, interpret mode), the plain
versions of K1'ʰ and K2ʰ (the forward with lse against the Pallas forward,
the backward's stages against autograd), the training route rule, the LSTT
stack in training mode, drop-path, and one whole tiny_aotl training step
against make_train_step with the use_prev_pred curriculum off and on."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine.train_state import TrainState as JTrainState
from rmem_tpu.engine.train_state import make_optimizer, make_train_step
from rmem_tpu.kernels.bank_attention import _forward, pallas_bank_attention
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.models.lstt import LSTT as JLSTT
from rmem_tpu.ops import masks as jmasks
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine.train_state import TrainState
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.managers.trainer import train_step
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.models.lstt import LSTT, LSTTBlock
from rmem_tpu_torch.ops.layers import drop_path
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# f32 on both sides; the Pallas kernels sum in another order (online
# softmax and flash backward over key tiles): a few f32 ulps of O(1) values
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# the LSTT stack: a dozen matmuls a block, summed in another order (XLA vs
# ATen), outputs and gradients to ~1e-6 of their scale
STACK_TOL = 1e-5
# the whole step, as tests/test_torch_port_training.py holds DeAOT's: the
# loss to ~1e-6 relative, each gradient leaf to ~1e-5 of its largest value,
# the update at most lr (1e-5 at step 0, 1.1e-4 at step 50) per element
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # max |port - jax| / max |jax| per leaf
# the self-attention's key bias has a zero gradient (it adds a constant to
# every logit of a row, which the softmax cancels): both sides hold f32
# roundoff there, ~1e-9
GRAD_ATOL = 1e-8
PARAM_ATOL = 1e-6


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


def _close(out, ref, rel):
    """max |out - ref| <= rel * max |ref|."""
    out = out.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_bank_attention_grad_matches_pallas_vjp_8_heads():
    """Gradients of sum(out * w_out) + sum(rec * w_rec) (a nonzero drec)
    at 8 heads of 8 with 3 of 5 slots valid and 60 keys a slot (not a
    multiple of 64): the port's differentiable bank attention on the CPU
    (autograd of its plain version) against jax.grad through
    pallas_bank_attention's custom VJP (K1' and K2 at num_heads = 8)."""
    rng = np.random.RandomState(0)
    s, b, lq, lk, heads, dh, count = 5, 1, 70, 60, 8, 8, 3
    q, bk = _rand(rng, b, lq, heads * dh), _rand(rng, s, b, lk, heads * dh)
    bv = _rand(rng, s, b, lk, heads * dh)
    w_out, w_rec = _rand(rng, b, lq, heads * dh), _rand(rng, b, lq, s)
    scale = dh ** -0.5

    def loss(q_, k_, v_):
        out, rec = pallas_bank_attention(q_, k_, v_, jnp.int32(count), heads,
                                         scale=scale)
        return jnp.sum(out * w_out) + jnp.sum(rec * w_rec)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                     (q, bk, bv)))
    ins = [_t(a, grad=True) for a in (q, bk, bv)]
    out, rec = kb.bank_attention_train(
        *ins, torch.tensor(count, dtype=torch.int32), scale, num_heads=heads)
    (out * _t(w_out)).sum().add((rec * _t(w_rec)).sum()).backward()
    for name, t, r in zip(("dq", "dk", "dv"), ins, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   **KERNEL_TOL, err_msg=name)
    assert np.all(ins[1].grad.numpy()[count:] == 0)
    assert np.all(ins[2].grad.numpy()[count:] == 0)


def test_lse_mh_plain_matches_pallas_forward():
    """K1'ʰ's plain version (out, each head's slot mass and lse) against
    the Pallas forward with want_lse at 8 heads, unfolded from its
    [B * 8, Lq_pad, .] layout: 2 of 4 slots valid, 60 keys a slot."""
    rng = np.random.RandomState(1)
    s, b, lq, lk, heads, dh, count = 4, 2, 50, 60, 8, 4, 2
    q, bk = _rand(rng, b, lq, heads * dh), _rand(rng, s, b, lk, heads * dh)
    bv = _rand(rng, s, b, lk, heads * dh)
    scale = dh ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out_bh, rec_bh, lse_bh, _ = _forward(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), heads, scale,
            256, 2048, want_lse=True)
    ref_out = np.asarray(out_bh)[:, :lq].reshape(b, heads, lq, dh)
    ref_out = ref_out.transpose(0, 2, 1, 3).reshape(b, lq, heads * dh)
    ref_rec = np.asarray(rec_bh)[:, :lq].reshape(b, heads, lq, s)
    ref_lse = np.asarray(lse_bh)[:, :lq, 0].reshape(b, heads, lq)
    out, rec_h, lse_h = kb.bank_attention_lse_mh_plain(
        _t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32), scale)
    for name, got, ref in (("out", out, ref_out), ("rec_h", rec_h, ref_rec),
                           ("lse_h", lse_h, ref_lse)):
        np.testing.assert_allclose(got.numpy(), ref, **KERNEL_TOL,
                                   err_msg=name)
    assert np.all(rec_h.numpy()[..., count:] == 0)
    # the wrapper takes the plain version for CPU tensors
    got = kb.bank_attention_lse_mh(_t(q), _t(bk), _t(bv),
                                   torch.tensor(count, dtype=torch.int32),
                                   scale)
    assert all(torch.equal(a, r) for a, r in zip(got, (out, rec_h, lse_h)))


def test_k2h_plain_stages_compose_to_autograd():
    """K2ʰ's two plain stages (the dq kernel's and the dkv kernel's, each
    recomputing p from the lse), fed the plain forward's lse and the row
    term delta_h, give autograd's gradients of the plain forward at 8 heads
    of 32, with a nonzero drec of the head-mean record and 2 of 4 slots
    valid; dk and dv are exact zeros in the invalid slots."""
    rng = np.random.RandomState(2)
    s, b, lq, lk, count = 4, 2, 30, 70, 2
    q, bk = _rand(rng, b, lq, 256), _rand(rng, s, b, lk, 256)
    bv = _rand(rng, s, b, lk, 256)
    dout, drec = _rand(rng, b, lq, 256), _rand(rng, b, lq, s)
    cnt = torch.tensor(count, dtype=torch.int32)
    scale = 32 ** -0.5
    ins = [_t(a, grad=True) for a in (q, bk, bv)]
    out, rec = kb.bank_attention_plain(*ins, cnt, 8, scale)
    auto = torch.autograd.grad((out, rec), ins, (_t(dout), _t(drec)))

    out, rec_h, lse_h = kb.bank_attention_lse_mh_plain(
        _t(q), _t(bk), _t(bv), cnt, scale)
    delta_h = kb.bwd_delta_mh(_t(dout), out, _t(drec), rec_h)
    args = (_t(q), _t(bk), _t(bv), cnt, _t(dout), lse_h, delta_h, _t(drec),
            scale)
    dq = kb.bank_attention_bwd_mh_dq_plain(*args)
    dk, dv = kb.bank_attention_bwd_mh_dkv_plain(*args)
    for name, got, ref in (("dq", dq, auto[0]), ("dk", dk, auto[1]),
                           ("dv", dv, auto[2])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **KERNEL_TOL,
                                   err_msg=name)
    assert torch.all(dk[count:] == 0) and torch.all(dv[count:] == 0)
    # the wrapper takes the stages for CPU tensors, delta_h from out, rec_h
    got = kb.bank_attention_bwd_mh(_t(q), _t(bk), _t(bv), cnt, out, rec_h,
                                   lse_h, _t(dout), _t(drec), scale)
    assert all(torch.equal(a, r) for a, r in zip(got, (dq, dk, dv)))


def test_bank_attention_train_route_by_head_shape():
    """The rule the card's training bank attention dispatches on: one head
    of 128 (values a multiple of 256) to K1' and K2, as two heads of 128
    (no_memory_gap, values 512 or 128 a head), 8 heads of 32 to K1'ʰ and
    K2ʰ, any other head shape raises."""
    assert kb.train_route(1, 128, 1024) == "slots"
    assert kb.train_route(2, 128, 512) == "slots"
    assert kb.train_route(2, 128, 128) == "slots"
    assert kb.train_route(8, 32, 32) == "heads"
    for shape in ((1, 128, 128), (8, 32, 64), (8, 8, 8),
                  (4, 64, 64)):
        with pytest.raises(ValueError, match="heads of width"):
            kb.train_route(*shape)


def test_drop_path():
    """The identity without a generator, at rate 0 and outside training;
    otherwise each sample is 0 or x / keep, drawn per sample. An LSTT block
    given a generator drops paths in training mode only."""
    x = torch.randn(64, 5, 3, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    assert drop_path(x, 0.1, None, True) is x
    assert drop_path(x, 0.0, gen, True) is x
    assert drop_path(x, 0.1, gen, False) is x
    y = drop_path(x, 0.25, gen, True)
    kept = torch.isclose(y, x / 0.75).flatten(1).all(-1)
    dropped = (y == 0).flatten(1).all(-1)
    assert torch.all(kept | dropped)
    assert 0 < int(dropped.sum()) < 64
    # the same formula as the JAX package's, fed the same uniform draws
    u = torch.rand((64, 1, 1), generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, x / 0.75 * torch.floor(0.75 + u))
    # an LSTT block applies it in training mode only, given a generator
    block = LSTTBlock(16, 2, 2, 32, droppath=0.5)
    args = (torch.randn(8, 6, 16, generator=torch.Generator().manual_seed(2)),
            None, None, None, None, None, torch.zeros(8, 6, 16), None, None,
            None, (2, 3))
    with torch.no_grad():
        plain = block(*args)[0]
        assert not torch.equal(block(*args, dp_gen=gen)[0], plain)
        block.eval()
        assert torch.equal(block(*args, dp_gen=gen)[0], block(*args)[0])


def test_lstt_stack_training_matches_jax():
    """Two LSTT layers in training mode (the slot PE added to the bank's
    keys, the differentiable bank attention) on a memory frame reading 3
    valid slots of 4, against the JAX LSTT with deterministic=True (the
    slot PE as its XLA logit bias): the intermediates, and the gradients
    of a weighted sum of them with respect to the frame, the bank's keys
    and values, the short-term memory and the slot PE, within STACK_TOL of
    scale."""
    rng = np.random.RandomState(7)
    d, size, L, s, count = 64, (4, 5), 2, 4, 3
    hw = size[0] * size[1]
    r = lambda *sh: _rand(rng, *sh)
    tgt, id_emb, self_pos = r(1, hw, d), r(1, hw, d), r(1, hw, d)
    cur_pe, slot_pe = r(1, d), r(s, d)
    bank_k, bank_v = r(L, s, 1, hw, d), r(L, s, 1, hw, d)
    short_k, short_v = r(L, 1, hw, d), r(L, 1, hw, d)
    w = [r(1, hw, d) for _ in range(L)]
    jl = JLSTT(L, d, 8, 8)

    def forward_and_write(m, *a):
        out = m(*a)
        m.project_memories(out[1], a[4])
        return out

    var = jl.init(jax.random.PRNGKey(0), tgt, None, None, None, id_emb,
                  self_pos, cur_pe, slot_pe[:1], size,
                  method=forward_and_write)
    var = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.02 * rng.randn(*x.shape)
                              .astype(np.float32)), var)

    def jloss(t_, k_, v_, sk_, sv_, pe_):
        inter, _, _ = jl.apply(var, t_, (k_, v_), jnp.arange(s) < count,
                               (sk_, sv_), None, self_pos, cur_pe, pe_,
                               size, deterministic=True)
        return sum(jnp.sum(x * wi) for x, wi in zip(inter, w)), inter

    jins = tuple(map(jnp.asarray, (tgt, bank_k, bank_v, short_k, short_v,
                                   slot_pe)))
    (_, jinter), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(*jins)

    tl = LSTT(L, d, 8, 8).train()
    tl.load_state_dict(params_from_jax(var["params"]), strict=True)
    ins = [_t(a, grad=True) for a in (tgt, bank_k, bank_v, short_k, short_v,
                                      slot_pe)]
    tinter, _, _ = tl(ins[0], (ins[1], ins[2]),
                      torch.tensor(count, dtype=torch.int32),
                      (ins[3], ins[4]), None, _t(cur_pe), ins[5], size,
                      self_pos=_t(self_pos))
    sum((x * _t(wi)).sum() for x, wi in zip(tinter, w)).backward()
    for a, b in zip(tinter, jinter):
        _close(a, b, STACK_TOL)
    for name, t, g in zip(("tgt", "bank_k", "bank_v", "short_k", "short_v",
                           "slot_pe"), ins, jgrads):
        assert np.abs(np.asarray(g)).max() > 0, name
        _close(t.grad, g, STACK_TOL)


# ---- the slice as a whole: one tiny_aotl training step ------------------

HW = (129, 129)
B, T = 2, 4
OVER = dict(compute_dtype="float32", data_seq_len=T, latter_mem_len=1,
            train_long_term_mem_gap=1, train_clip_grad_norm=1.0)


def _capture_grads():
    """An optax stage whose state keeps the raw gradients it is given, put
    before the JAX optimizer so the step exposes its gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_params(jmodel, rng):
    """flax-initialiser-like weights drawn with numpy on jax.eval_shape's
    shapes, with a 0.05 N(0, 1) offset on every leaf."""
    img = jnp.zeros((1, *HW, 3))
    idoh = jnp.zeros((1, *HW, jmodel.cfg.id_channels))
    shapes = jax.eval_shape(
        lambda r: jmodel.init(r, img, idoh, method=init_forward),
        jax.random.PRNGKey(0))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            base = rng.randn(*s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif name == "scale":
            base = np.ones(s.shape)
        else:
            base = np.zeros(s.shape)
        return (base + 0.05 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(rng):
    """Two clips: moving rectangles (2 objects, then 1), an ignore band."""
    imgs = rng.rand(B, T, *HW, 3).astype(np.float32)
    labels = np.zeros((B, T, *HW), np.int32)
    for t in range(T):
        labels[:, t, 20 + 4 * t:70 + 4 * t, 15:60] = 1
        labels[0, t, 80:120, 60 + 5 * t:110 + 5 * t] = 2
        labels[:, t, :6] = 255
    return dict(imgs=imgs, labels=labels,
                obj_nums=np.array([2, 1], np.int32))


@pytest.fixture(scope="module")
def steps():
    """tiny_aotl (2 LSTT layers, 8 heads of 8) at the `test` stage: the
    JAX step and the port's step from the same state, at step 0 and at
    step 50 of 100. One former + one latter slot and a long-term write
    every frame, so the FIFO eviction runs; the gradient clip binds."""
    rng = np.random.RandomState(0)
    jcfg = jget_config("test", model="tiny_aotl", **OVER)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = _jax_params(jmodel, rng)
    batch = _batch(rng)
    shuffle = jmasks.host_id_shuffle_matrix(np.random.RandomState(7),
                                            jcfg.model_max_obj_num + 1, B)
    tx = optax.chain(_capture_grads(), make_optimizer(params, jcfg))
    jstep = jax.jit(make_train_step(jmodel, jcfg, tx))
    cfg = get_config("test", model="tiny_aotl", **OVER)
    out = {}
    for start in (0, 50):
        opt_state = jax.tree_util.tree_map_with_path(
            lambda p, x: (jnp.int32(start) if getattr(p[-1], "name", None)
                          == "count" else x), tx.init(params))
        jstate = JTrainState(params=params, opt_state=opt_state,
                             ema_params=jax.tree_util.tree_map(jnp.array,
                                                               params),
                             step=jnp.int32(start))
        jnew, jmetrics = jstep(jstate, jax.tree_util.tree_map(
            jnp.asarray, batch), jnp.asarray(shuffle))

        model = build_vos_model("aot", cfg)
        model.load_state_dict(params_from_jax(params), strict=True)
        state = TrainState.create(model)
        state.step = start
        metrics = train_step(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                             torch.from_numpy(shuffle), cfg)
        out[start] = (jnew, jmetrics, state, metrics)
    return out


@pytest.mark.parametrize("start", [0, 50], ids=["curriculum_off",
                                                "curriculum_on"])
def test_aot_train_step_matches_jax(steps, start):
    """The loss, per-frame losses and IoU, the grad norm, every gradient
    leaf (mapped by params_from_jax's rule), the parameters after the
    update and the EMA."""
    jnew, jm, state, m = steps[start]
    assert state.step == start + 1 == int(jnew.step)
    np.testing.assert_array_equal(m["pred_label_last"].numpy(),
                                  np.asarray(jm["pred_label_last"]))
    for key in ("loss", "aux_loss", "pred_loss", "aux_weight",
                "loss_per_frame", "iou_per_frame", "grad_norm"):
        np.testing.assert_allclose(m[key].detach().numpy(),
                                   np.asarray(jm[key]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    assert float(jm["grad_norm"]) > 1.0      # the clip binds
    grads = params_from_jax(jnew.opt_state[0])
    after = params_from_jax(jnew.params)
    ema = params_from_jax(jnew.ema_params)
    named = dict(state.model.named_parameters())
    assert set(named) == set(grads)
    for name, p in named.items():
        # under the curriculum the id bank takes no gradient: None here,
        # zeros in JAX
        g = np.zeros_like(p.detach().numpy()) if p.grad is None \
            else p.grad.numpy()
        r = grads[name].numpy()
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max() + \
            GRAD_ATOL, \
            (name, np.abs(g - r).max(), np.abs(r).max())
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(),
                                   ema[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)

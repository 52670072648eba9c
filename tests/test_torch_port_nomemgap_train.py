"""Training DeAOT with `no_memory_gap` (2 heads of 128 on the card) in the
port against the JAX package, f32 on the CPU, on the same inputs made from
numpy seeds: the plain versions of the training kernels at 2 heads (K1''s
partial + merge form against the Pallas forward with its lse, K2's
head-generic plain stages against the Pallas VJP with a nonzero slot-mass
cotangent, K5's backward against the XLA VJP of the trainable local
attention), the routes and the CPU side of the trainable wrappers at 2
heads, and one whole training step of tiny_deaotl with a long-term write
every frame, so the FIFO eviction runs, leaf by leaf against
make_train_step."""

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
from rmem_tpu.kernels.local_attention import _trainable_bwd
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.ops import masks as jmasks
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine.train_state import TrainState
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.kernels import local_attention as kl
from rmem_tpu_torch.managers.trainer import train_step
from rmem_tpu_torch.memory import eviction
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.tools.train import _parse_opts
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEADS = 2
# f32 on both sides; the Pallas kernels (interpret mode) and XLA sum in
# another order: the forward to a few f32 ulps of O(1) values, the
# gradients to ~1e-6 of their scale
FWD_TOL = 1e-5          # max |port - jax| / max |jax|
GRAD_TOL = 1e-4
# the training step, as tests/test_torch_port_training.py holds it: the
# loss to ~1e-6 relative, each gradient leaf to ~1e-5 of its largest value,
# parameters and EMA far below their scale (the update is at most lr)
HW = (129, 129)
B, T = 2, 5
OVER = dict(compute_dtype="float32", data_seq_len=T, latter_mem_len=2,
            no_memory_gap=True, use_temporal_positional_embedding=False,
            train_clip_grad_norm=1.0)
LOSS_RTOL = 1e-5
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


def _close(got, ref, rel):
    """max |got - ref| <= rel * max |ref|, shapes equal."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _bank_inputs(seed, count, slots=5):
    """q, bank_k, bank_v at 2 heads of 32 (values 64 a head), 70 queries,
    60 keys a slot, `count` of `slots` valid; the scale."""
    rng = np.random.RandomState(seed)
    b, lq, lk, dh, dv = 1, 70, 60, 32, 64
    return (_rand(rng, b, lq, HEADS * dh),
            _rand(rng, slots, b, lk, HEADS * dh),
            _rand(rng, slots, b, lk, HEADS * dv), dh ** -0.5, rng)


def _heads_first(x, b, lq):
    """Pallas's [B*h, Lq_pad, d] rows, (batch, head) major, as [B, h, Lq,
    d]."""
    return np.asarray(x)[:, :lq].reshape(b, HEADS, lq, -1)


@pytest.mark.parametrize("count", [1, 4])
def test_lse_plain_two_heads_matches_pallas_forward(count):
    """K1' at 2 heads: its plain version (the kernel's partial + merge form,
    one head's form on each head's columns) against the Pallas forward with
    its lse (`_forward(..., want_lse=True)`, interpret mode) at one slot
    group and at two: the output, each head's slot mass and their mean (the
    record), each head's lse."""
    q, bk, bv, scale, _ = _bank_inputs(10 + count, count)
    b, lq = q.shape[:2]
    with pltpu.force_tpu_interpret_mode():
        out_bh, rec_bh, lse_bh, _ = _forward(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), HEADS, scale,
            128, 128, want_lse=True)
    out, rec_h, lse_h = kb.bank_attention_lse_plain(
        _t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32), scale,
        num_heads=HEADS)
    ref_out = _heads_first(out_bh, b, lq).transpose(0, 2, 1, 3).reshape(
        b, lq, -1)
    ref_rec = _heads_first(rec_bh, b, lq)
    _close(out, ref_out, FWD_TOL)
    _close(rec_h, ref_rec, FWD_TOL)
    _close(rec_h.mean(dim=1), ref_rec.mean(axis=1), FWD_TOL)
    _close(lse_h, _heads_first(lse_bh, b, lq)[..., 0], FWD_TOL)
    assert torch.all(rec_h[..., count:] == 0)


def test_k2_plain_stages_two_heads_match_pallas_vjp():
    """K2 at 2 heads: K1''s plain version, each head's row term from
    `bwd_delta_mh` and the head-generic plain stages (the card's dq and
    dk/dv kernels' plain versions) against jax.vjp of pallas_bank_attention
    (interpret mode) with nonzero cotangents of the output and of the
    head-mean record, 3 of 5 slots valid: dq, dk, dv, and dk, dv exactly 0
    in the invalid slots."""
    count = 3
    q, bk, bv, scale, rng = _bank_inputs(20, count)
    dout = _rand(rng, *q.shape[:2], bv.shape[-1])
    drec = _rand(rng, *q.shape[:2], bk.shape[0])
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: pallas_bank_attention(
            *a, jnp.int32(count), HEADS, scale=scale),
            *map(jnp.asarray, (q, bk, bv)))
        refs = vjp((jnp.asarray(dout), jnp.asarray(drec)))
    cnt = torch.tensor(count, dtype=torch.int32)
    ins = (_t(q), _t(bk), _t(bv), cnt)
    out, rec_h, lse_h = kb.bank_attention_lse_plain(*ins, scale,
                                                    num_heads=HEADS)
    delta_h = kb.bwd_delta_mh(_t(dout), out, _t(drec), rec_h)
    args = (*ins, _t(dout), lse_h, delta_h, _t(drec), scale)
    got = (kb.bank_attention_bwd_mh_dq_plain(*args),
           *kb.bank_attention_bwd_mh_dkv_plain(*args))
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        _close(g, r, GRAD_TOL)
    assert torch.all(got[1][count:] == 0) and torch.all(got[2][count:] == 0)


@pytest.mark.parametrize("size", [(8, 9), (10, 12)])
def test_local_attention_bwd_plain_two_heads_matches_jax_vjp(size):
    """K5's backward at 2 heads of 32 (values 64 a head, the bias 2 x 225):
    its plain version against the backward rule of
    pallas_local_attention_trainable (the VJP of the XLA tiled form), on
    grids of at least 8 a side, where the tiled form keeps the full 15 x 15
    window: dq, dk, dv and drel."""
    rng = np.random.RandomState(30 + size[1])
    hw = size[0] * size[1]
    args = [_rand(rng, 1, hw, HEADS * 32), _rand(rng, 1, hw, HEADS * 32),
            _rand(rng, 1, hw, HEADS * 64), _rand(rng, 1, hw, HEADS * 225)]
    g = _rand(rng, 1, hw, HEADS * 64)
    scale = 32 ** -0.5
    refs = jax.jit(lambda *a: _trainable_bwd(size, HEADS, 7, scale, True,
                                             a[:4], a[4]))(*args, g)
    got = kl.local_attention_bwd_plain(*map(_t, args), _t(g), size, HEADS,
                                       7, scale)
    for name, a, r in zip(("dq", "dk", "dv", "drel"), got, refs):
        _close(a, r, GRAD_TOL)


def test_train_routes_at_two_heads():
    """On the card a training call at 2 heads of 128 with values a multiple
    of 256 a head, or 128 a head (AOT's no_memory_gap), takes K1' and K2
    (the "slots" route); any other 2-head shape still raises."""
    assert kb.train_route(2, 128, 512) == "slots"
    assert kb.train_route(2, 128, 256) == "slots"
    assert kb.train_route(2, 128, 128) == "slots"
    for shape in ((2, 64, 512), (3, 128, 512)):
        with pytest.raises(ValueError, match="heads of width"):
            kb.train_route(*shape)


def test_trainable_wrappers_at_two_heads_on_cpu():
    """At 2 heads, CPU tensors take the plain versions and launch nothing:
    the differentiable bank and local attentions and K5's backward; the
    card-only wrappers of K1' and K2 refuse them instead of falling
    back."""
    rng = np.random.RandomState(40)
    counters = (kb.bank_attention_lse, kb.bank_attention_bwd_ds,
                kb.bank_attention_bwd_dq, kb.bank_attention_bwd_dkv,
                kl.local_attention, kl.local_attention_bwd)
    before = [fn.launches for fn in counters]
    q, bk = _t(_rand(rng, 1, 16, 256)), _t(_rand(rng, 3, 1, 16, 256))
    bv = _t(_rand(rng, 3, 1, 16, 1024))
    cnt = torch.tensor(2, dtype=torch.int32)
    got = kb.bank_attention_train(q, bk, bv, cnt, 0.1, num_heads=HEADS)
    ref = kb.bank_attention_plain(q, bk, bv, cnt, HEADS, 0.1)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    rel, g = _t(_rand(rng, 1, 16, 450)), _t(_rand(rng, 1, 16, 1024))
    largs = ((4, 4), HEADS, 7, 0.1)
    assert torch.equal(kl.local_attention_trainable(q, q, bv[0], rel, *largs),
                       kl.local_attention_plain(q, q, bv[0], rel, *largs))
    assert all(torch.equal(a, r) for a, r in zip(
        kl.local_attention_bwd(q, q, bv[0], rel, g, *largs),
        kl.local_attention_bwd_plain(q, q, bv[0], rel, g, *largs)))
    assert [fn.launches for fn in counters] == before
    bf = [t.bfloat16() for t in (q, bk, bv)]
    lse = torch.zeros(1, HEADS, 16)
    with pytest.raises(ValueError, match="not on"):
        kb.bank_attention_lse(*bf, cnt, 0.1, num_heads=HEADS)
    with pytest.raises(ValueError, match="not on"):
        kb.bank_attention_bwd_ds(*bf, cnt, bf[0].new_zeros(1, 16, 1024), lse,
                                 lse, torch.zeros(1, 16, 3), 0.1,
                                 num_heads=HEADS)


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
def step():
    """One step of tiny_deaotl with no_memory_gap (2 heads, a long-term
    write every frame into 1 + 2 slots, so frames 3 and 4 evict) in JAX
    and in the port from the same parameters, batch and id shuffle.
    Returns (jax new state, jax metrics, port state after, port metrics,
    the port's FIFO evictions)."""
    rng = np.random.RandomState(0)
    jcfg = jget_config("test", model="tiny_deaotl", **OVER)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = _jax_params(jmodel, rng)
    batch = _batch(rng)
    shuffle = jmasks.host_id_shuffle_matrix(np.random.RandomState(7),
                                            jcfg.model_max_obj_num + 1, B)
    # an optax stage whose state keeps the raw gradients, before the
    # optimizer, so the JAX step exposes them
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(capture, make_optimizer(params, jcfg))
    jstate = JTrainState(params=params, opt_state=tx.init(params),
                         ema_params=jax.tree_util.tree_map(jnp.array, params),
                         step=jnp.int32(0))
    jnew, jm = jax.jit(make_train_step(jmodel, jcfg, tx))(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch),
        jnp.asarray(shuffle))

    cfg = get_config("test", model="tiny_deaotl", **OVER)
    model = build_vos_model("deaot", cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState.create(model)
    compact, evictions = eviction.bank_compact, []

    def counted(*a, **kw):
        evictions.append(a[1])
        return compact(*a, **kw)

    eviction.bank_compact = counted
    try:
        m = train_step(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                       torch.from_numpy(shuffle), cfg)
    finally:
        eviction.bank_compact = compact
    return jnew, jm, state, m, evictions


def test_nomemgap_config_trains_two_heads_every_frame():
    """The configuration the step takes: 2 heads in the GPM, a long-term
    write every training frame, 1 + 2 slots, on both sides."""
    cfg = get_config("test", model="tiny_deaotl", **OVER)
    jcfg = jget_config("test", model="tiny_deaotl", **OVER)
    for c in (cfg, jcfg):
        assert (c.model_att_heads, c.train_long_term_mem_gap) == (2, 1)
        assert (c.former_mem_len, c.latter_mem_len, c.data_seq_len) == \
            (1, 2, T)
    assert build_vos_model("deaot", cfg).lstt.block(0).att_heads == HEADS


def test_train_cli_reads_no_memory_gap_true():
    """`python -m rmem_tpu_torch.tools.train --opt no_memory_gap=true`:
    true and false reach the config as bools (the string "false" would
    switch an option on)."""
    over = _parse_opts(["no_memory_gap=true",
                        "use_temporal_positional_embedding=false",
                        "train_log_step=1"])
    assert over == dict(no_memory_gap=True,
                        use_temporal_positional_embedding=False,
                        train_log_step=1)
    cfg = get_config("pre_vost", model="r50_deaotl", **over)
    assert (cfg.model_att_heads, cfg.train_long_term_mem_gap) == (2, 1)
    assert cfg.use_temporal_positional_embedding is False


def test_nomemgap_step_loss_matches_jax(step):
    """The loss and the metrics of the step, and the FIFO evictions the
    port's loop made (host-side, at the slot after the former one): frames
    1..4 write, the bank of 1 + 2 slots is full after frame 2, so frames 3
    and 4 evict."""
    jnew, jm, state, m, evictions = step
    assert state.step == 1 == int(jnew.step)
    assert evictions == [1, 1]
    np.testing.assert_array_equal(m["pred_label_last"].numpy(),
                                  np.asarray(jm["pred_label_last"]))
    for key in ("loss", "aux_loss", "pred_loss", "aux_weight",
                "loss_per_frame", "iou_per_frame", "grad_norm"):
        np.testing.assert_allclose(m[key].detach().numpy(),
                                   np.asarray(jm[key]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    assert float(jm["grad_norm"]) > 1.0      # the clip binds


def test_nomemgap_step_gradients_match_jax(step):
    """Every gradient leaf of the step, mapped by params_from_jax's rule,
    within GRAD_TOL of its largest value."""
    jnew, _, state, _, _ = step
    grads = params_from_jax(jnew.opt_state[0])
    named = dict(state.model.named_parameters())
    assert set(named) == set(grads)
    for name, p in named.items():
        g = np.zeros_like(p.detach().numpy()) if p.grad is None \
            else p.grad.numpy()
        r = grads[name].numpy()
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max() + 1e-9, \
            (name, np.abs(g - r).max(), np.abs(r).max())


def test_nomemgap_step_parameters_and_ema_match_jax(step):
    """The parameters after the update and their EMA, leaf by leaf."""
    jnew, _, state, _, _ = step
    after = params_from_jax(jnew.params)
    ema = params_from_jax(jnew.ema_params)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(),
                                   ema[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)

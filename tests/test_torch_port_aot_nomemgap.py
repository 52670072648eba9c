"""AOT with `no_memory_gap` (the LSTT's long- and short-term attention at 2
heads, values as wide as the keys, a long-term write every frame) in the
port against the JAX package, f32 on the CPU, on the same inputs made from
numpy seeds: the stage presets field by field and the training CLI's
default stage; the plain versions of the bank-attention kernels at 2 heads
with values as wide as the keys (K1 with the slot-PE bias and padded keys,
K1''s forward with its lse, K2's stages) against the Pallas kernels in
interpret mode, and K3's at 8 heads; the weight bridge on the r50_aotl
tree; the tiny_aotl engine teacher-forced through evictions; and one whole
tiny_aotl training step leaf by leaf, the curriculum off and on."""

import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.traverse_util as trav
from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.config import STAGE_PRESETS as JSTAGES
from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.engine.train_state import TrainState as JTrainState
from rmem_tpu.engine.train_state import make_optimizer, make_train_step
from rmem_tpu.kernels.bank_attention import (_forward, pallas_bank_attention,
                                             pallas_bank_attention_infer,
                                             pallas_bank_attention_qminor)
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.models import init_params as jinit
from rmem_tpu.ops import masks as jmasks
from rmem_tpu.ops.resize import resize_bilinear as jresize_bilinear
from rmem_tpu.ops.resize import resize_nearest as jresize_nearest
from rmem_tpu.ops.resize import upsample_argmax as jupsample_argmax
from rmem_tpu_torch import config as port_config
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.engine.train_state import (ADAM_B2, ADAM_EPS, TrainState,
                                               group_lrs)
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.managers import trainer as port_trainer
from rmem_tpu_torch.managers.trainer import train_step
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.ops.resize import upsample_argmax
from rmem_tpu_torch.tools import train as train_cli
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEADS = 2
# f32 on both sides; the Pallas kernels (interpret mode) and XLA sum in
# another order: the forward to a few f32 ulps of O(1) values, the
# gradients to ~1e-6 of their scale
FWD_TOL = 1e-5          # max |port - jax| / max |jax|
GRAD_TOL = 1e-4
# the engine's logits pass the encoder, the stack and the FPN
LOGIT_TOL = 1e-4
# labels may differ only where the top-2 upsampled logits are this close
TIE_EPS = 1e-3
# the training step, as tests/test_torch_port_aot_train.py holds it: the
# loss to ~1e-6 relative, each gradient leaf to GRAD_TOL of its largest
# value; the parameters after the update and the EMA to PARAM_ATOL where
# Adam's denominator stands clear of its epsilon (see
# test_aot_nomemgap_train_step_matches_jax)
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-8
PARAM_ATOL = 1e-6
# every stage both packages have, by name: the port has no others
STAGES = ("default", "pre_vost", "pre_vost_2", "pre_vost_25q", "test")
MODELS = ("r50_deaotl", "r50_aotl", "tiny_deaotl", "tiny_aotl")


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


# ---- the stage presets and the training CLI's default -------------------

@pytest.mark.parametrize("nmg", [False, True],
                         ids=["memory_gap", "no_memory_gap"])
def test_stage_presets_match_jax(nmg):
    """Every field of the port's Config reads as in rmem_tpu's for every
    stage and model, with and without no_memory_gap; the port has no stage
    the JAX package lacks."""
    assert set(port_config.STAGE_PRESETS) == set(STAGES) <= set(JSTAGES)
    for stage in STAGES:
        for model in MODELS:
            port = get_config(stage, model=model, no_memory_gap=nmg)
            ref = jget_config(stage, model=model, no_memory_gap=nmg)
            for f in dataclasses.fields(port):
                assert getattr(port, f.name) == getattr(ref, f.name), (
                    stage, model, f.name)


def test_train_cli_defaults_to_pre_vost_2():
    """`python -m rmem_tpu_torch.tools.train` with no --stage trains
    rmem_tpu's default stage, pre_vost_2: clips of 17 frames."""
    built = []

    class Recorder:
        def __init__(self, cfg, device=None, seed=0):
            built.append(cfg)

        def train(self, max_steps=None):
            return {}

    with mock.patch.object(port_trainer, "Trainer", Recorder):
        train_cli.main(["--device", "cpu", "--max_steps", "1"])
    (cfg,) = built
    assert cfg.data_seq_len == 17
    ref = jget_config("pre_vost_2", model="r50_deaotl")
    for f in dataclasses.fields(cfg):
        if f.name != "compute_dtype":         # f32 on the CPU
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name


# ---- the kernels' plain versions at 2 heads, values as wide as the keys --

def _bank_inputs(seed, count, slots=5, lk=60):
    """q, bank_k, bank_v at 2 heads of 32 with values 32 a head (AOT's
    no_memory_gap ratio), 70 queries, `lk` keys a slot, `count` of `slots`
    valid; the scale and the generator."""
    rng = np.random.RandomState(seed)
    b, lq, d = 1, 70, 32
    return (_rand(rng, b, lq, HEADS * d), _rand(rng, slots, b, lk, HEADS * d),
            _rand(rng, slots, b, lk, HEADS * d), d ** -0.5, rng)


def _heads_first(x, b, lq):
    """Pallas's [B*h, Lq_pad, d] rows, (batch, head) major, as [B, h, Lq,
    d]."""
    return np.asarray(x)[:, :lq].reshape(b, HEADS, lq, -1)


def test_bank_attention_plain_values_as_wide_as_keys_matches_pallas_infer():
    """K1's plain version at 2 heads of 32 with values 32 a head, the
    per-(head, query, slot) slot-PE bias and keys padded 12 past true_lk,
    against pallas_bank_attention_infer in interpret mode: the output, and
    the slot mass as the head mean; the wrapper launches nothing on the
    CPU."""
    count, true_lk = 4, 48
    q, bk, bv, scale, rng = _bank_inputs(50, count)
    b, lq, s = q.shape[0], q.shape[1], bk.shape[0]
    bias = _rand(rng, b, HEADS, lq, s)
    with pltpu.force_tpu_interpret_mode():
        ref, rrec = pallas_bank_attention_infer(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), HEADS,
            scale=scale, true_lk=true_lk,
            qbias=jnp.asarray(bias.reshape(b * HEADS, lq, s)))
    before = kb.bank_attention_infer.launches
    out, rec = kb.bank_attention_infer(
        _t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32), HEADS,
        scale, true_lk=true_lk, qbias=_t(bias))
    _close(out, ref, FWD_TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rrec), atol=FWD_TOL)
    assert np.all(rec.numpy()[..., count:] == 0.0)
    assert kb.bank_attention_infer.launches == before


@pytest.mark.parametrize("count", [1, 4])
def test_lse_plain_values_as_wide_as_keys_matches_pallas_forward(count):
    """K1''s plain version at 2 heads with values as wide as the keys (the
    kernel's partial + merge form on each head's columns) against the
    Pallas forward with its lse, at one slot group and at two: the output,
    each head's slot mass and each head's lse."""
    q, bk, bv, scale, _ = _bank_inputs(60 + count, count)
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
    _close(out, ref_out, FWD_TOL)
    _close(rec_h, _heads_first(rec_bh, b, lq), FWD_TOL)
    _close(lse_h, _heads_first(lse_bh, b, lq)[..., 0], FWD_TOL)
    assert torch.all(rec_h[..., count:] == 0)


def test_k2_plain_stages_values_as_wide_as_keys_match_pallas_vjp():
    """K2 at 2 heads with values as wide as the keys: K1''s plain version,
    each head's row term (`bwd_delta_mh`) and the head-generic plain stages
    against jax.vjp of pallas_bank_attention (interpret mode) with nonzero
    cotangents of the output and of the head-mean record, 3 of 5 slots
    valid: dq, dk, dv, and dk, dv exactly 0 in the invalid slots; autograd
    of the plain forward agrees."""
    count = 3
    q, bk, bv, scale, rng = _bank_inputs(70, count)
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
    auto = kb.bank_attention_bwd_plain(*ins, _t(dout), _t(drec), scale,
                                       HEADS)
    for g, a, r in zip(got, auto, refs):
        _close(g, r, GRAD_TOL)
        _close(a, r, GRAD_TOL)
    assert torch.all(got[1][count:] == 0) and torch.all(got[2][count:] == 0)


def test_bank_attention_qminor_plain_8_heads_matches_pallas():
    """K3ʰ's plain version, `bank_attention_qminor_plain` at 8 heads of 32
    (AOT's LSTT shape), against pallas_bank_attention_qminor in interpret
    mode, ragged against its tiles: the output within 2e-4 and the slot
    mass within 2e-5, the JAX test's tolerances (f32 sums in another
    order); the wrapper takes it on the CPU and launches nothing."""
    rng = np.random.RandomState(80)
    s, lq, lk, heads, dh, count = 4, 300, 270, 8, 32, 3
    q = _rand(rng, 1, lq, heads * dh)
    bk = _rand(rng, s, 1, lk, heads * dh)
    bv = _rand(rng, s, 1, lk, heads * dh)
    with pltpu.force_tpu_interpret_mode():
        jout, jrec = pallas_bank_attention_qminor(
            *map(jnp.asarray, (q, bk, bv)), jnp.int32(count), heads)
    args = (_t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32),
            heads, dh ** -0.5)
    out, rec = kb.bank_attention_qminor_plain(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=2e-5)
    assert np.all(rec.numpy()[..., count:] == 0)
    before = kb.bank_attention_qminor.launches
    got = kb.bank_attention_qminor(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, (out, rec)))
    assert kb.bank_attention_qminor.launches == before
    assert kb.infer_route(heads, dh, dh) == "heads"


# ---- the model: weights, serving, training ------------------------------

def test_params_from_jax_covers_the_aot_two_head_tree():
    """r50_aotl with no_memory_gap: 2 long- and short-term heads of 128,
    the self-attention at 8; every JAX leaf lands on a port parameter of
    its shape and every port parameter is set (strict load)."""
    cfg = jget_config("pre_vost", model="r50_aotl", compute_dtype="float32",
                      no_memory_gap=True)
    jm = jbuild(cfg.model_vos, cfg)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, cfg.id_channels), jnp.float32)
    shapes = jax.eval_shape(
        lambda r: jm.init(r, img, oh, method=init_forward),
        jax.random.PRNGKey(0))["params"]
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    sd = params_from_jax(tree)
    assert len(sd) == len(trav.flatten_dict(tree))
    port = build_vos_model("aot", get_config("pre_vost", model="r50_aotl",
                                             no_memory_gap=True))
    port.load_state_dict(sd, strict=True)
    for name, p in port.state_dict().items():
        assert p.shape == sd[name].shape, name
    block = port.lstt.block(0)
    assert (block.att_heads, block.self_attn.num_heads) == (2, 8)
    assert port.cfg.train_long_term_mem_gap == 1


HW = (64, 64)
OUT_HW = (60, 70)
FRAMES = 9


def test_engine_aot_nomemgap_matches_jax_teacher_forced():
    """tiny_aotl with no_memory_gap (2 heads of 32 in the long- and
    short-term attention) at 64 x 64, 1 + 2 slots and a long-term write
    every frame (the evaluator's gap with no_memory_gap): the bank fills on
    frame 2 and evicts on every later frame. Both engines share the weights
    and are teacher-forced with the JAX labels. Per frame: logits within
    LOGIT_TOL of scale, labels equal except at near ties, the slot mass,
    and the bank's count, order, ages, scores and contents as the JAX
    bank's (the same eviction victims)."""
    over = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=2,
                no_memory_gap=True)
    jcfg = jget_config("pre_vost", model="tiny_aotl", **over)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = jinit(jmodel, jax.random.PRNGKey(0), HW)
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    jeng = JEngine(jmodel, params, jcfg, donate=False)
    model = build_vos_model("aot", get_config("pre_vost", model="tiny_aotl",
                                              **over))
    model.load_state_dict(params_from_jax(params), strict=True)
    assert model.lstt.block(0).att_heads == HEADS
    peng = InferenceEngine(model, model.cfg, device="cpu")

    rng = np.random.RandomState(0)
    imgs = rng.rand(FRAMES + 1, 1, *HW, 3).astype(np.float32)
    mask = np.zeros((1, *HW), np.int32)
    mask[:, 8:30, 6:28] = 1
    mask[:, 36:60, 30:58] = 2
    mask[:, 0:4, 0:64] = 255          # an ignore band
    js, jlog = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask),
                                  [2], gap=1)
    ps, plog = peng.add_reference(imgs[0], mask, [2], gap=1)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    counts, evicted = [], 0
    for t in range(1, FRAMES + 1):
        js, jlog = jeng.propagate(js, jnp.asarray(imgs[t]))
        ps, plog = peng.propagate(ps, imgs[t])
        _close(plog, jlog, LOGIT_TOL)
        np.testing.assert_allclose(ps.record.numpy(), np.asarray(js.record),
                                   atol=1e-5)
        lab_j = np.asarray(jupsample_argmax(jlog, OUT_HW))
        lab_p = upsample_argmax(plog, OUT_HW).numpy()
        up = np.asarray(jresize_bilinear(jlog, OUT_HW))[0]
        top2 = np.sort(up, axis=-1)[..., -2:]
        assert np.all((lab_p == lab_j) | (top2[..., 1] - top2[..., 0]
                                          < TIE_EPS))
        lab_in = np.array(jresize_nearest(jnp.asarray(lab_j)[None, ..., None],
                                          HW))[..., 0]
        was_full = int(ps.bank.count) == 3
        js = jeng.update_memory(js, jnp.asarray(lab_in))
        ps = peng.update_memory(ps, lab_in)
        jb, pb = js.bank, ps.bank
        assert int(pb.count) == int(jb.count)
        np.testing.assert_array_equal(pb.order.numpy(), np.asarray(jb.order))
        np.testing.assert_array_equal(pb.times.numpy(), np.asarray(jb.times))
        np.testing.assert_array_equal(pb.scored.numpy(),
                                      np.asarray(jb.scored))
        np.testing.assert_allclose(pb.score.numpy(), np.asarray(jb.score),
                                   atol=1e-5)
        np.testing.assert_allclose(pb.k.numpy(), np.asarray(jb.k),
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(pb.v.numpy(), np.asarray(jb.v),
                                   atol=LOGIT_TOL)
        counts.append(int(pb.count))
        # a long-term write into a full bank evicts: the victim's slot holds
        # the new entry on both sides (the contents above)
        evicted += was_full and int(ps.last_mem_step) == t
    assert counts == [2, 3, 3, 3, 3, 3, 3, 3, 3]
    assert evicted == FRAMES - 2


TRAIN_HW = (129, 129)
B, T = 2, 4
OVER = dict(compute_dtype="float32", data_seq_len=T, latter_mem_len=1,
            no_memory_gap=True, train_clip_grad_norm=1.0)


def _capture_grads():
    """An optax stage whose state keeps the raw gradients it is given, put
    before the JAX optimizer so the step exposes its gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_params(jmodel, rng):
    """flax-initialiser-like weights drawn with numpy on jax.eval_shape's
    shapes, with a 0.05 N(0, 1) offset on every leaf."""
    img = jnp.zeros((1, *TRAIN_HW, 3))
    idoh = jnp.zeros((1, *TRAIN_HW, jmodel.cfg.id_channels))
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
    imgs = rng.rand(B, T, *TRAIN_HW, 3).astype(np.float32)
    labels = np.zeros((B, T, *TRAIN_HW), np.int32)
    for t in range(T):
        labels[:, t, 20 + 4 * t:70 + 4 * t, 15:60] = 1
        labels[0, t, 80:120, 60 + 5 * t:110 + 5 * t] = 2
        labels[:, t, :6] = 255
    return dict(imgs=imgs, labels=labels,
                obj_nums=np.array([2, 1], np.int32))


@pytest.fixture(scope="module")
def steps():
    """tiny_aotl with no_memory_gap (2 long- and short-term heads of 32, a
    long-term write every frame) at the `test` stage: the JAX step and the
    port's step from the same state, at step 0 and at step 50 of 100. One
    former + one latter slot, so the FIFO eviction runs; the gradient clip
    binds."""
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
    assert (cfg.model_att_heads, cfg.train_long_term_mem_gap) == (HEADS, 1)
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
        out[start] = (jnew, jmetrics, state, metrics,
                      max(group_lrs(start, cfg).values()))
    return out


@pytest.mark.parametrize("start", [0, 50], ids=["curriculum_off",
                                                "curriculum_on"])
def test_aot_nomemgap_train_step_matches_jax(steps, start):
    """The loss, per-frame losses and IoU, the grad norm, every gradient
    leaf (mapped by params_from_jax's rule), the parameters after the
    update and the EMA.

    The rule for the parameters. Both steps start from zero moments, so
    the update of an element is lr m/(sqrt(v) + eps) with m and sqrt(v)
    (bias-corrected) proportional to g and |g| after the clip. Where
    sqrt(v) >= 10 eps the update is within ~10 % of +-lr, whatever |g|, and
    the gradients' agreement holds it to PARAM_ATOL, as the other training
    tests do. Below, where the clipped gradient is ~1e-7 (f32 noise of
    leaves whose largest gradient is 3e-3 to 0.3), the update is about
    lr g / eps: the gradients' f32 differences pass into it amplified, and
    a gradient at the noise floor may change sign. There each element stays
    within the bound of one Adam step, 2 x the step's largest learning
    rate. (A gate at GRAD_TOL x the leaf's largest gradient left 4 elements
    of lstt.block1.linear_Q.weight, whose largest gradient is 3.4e-3, off
    by up to 6.1e-6.) The EMA moves by a share of the same update."""
    jnew, jm, state, m, lr = steps[start]
    assert state.step == start + 1 == int(jnew.step)
    np.testing.assert_array_equal(m["pred_label_last"].numpy(),
                                  np.asarray(jm["pred_label_last"]))
    for key in ("loss", "aux_loss", "pred_loss", "aux_weight",
                "loss_per_frame", "iou_per_frame", "grad_norm"):
        np.testing.assert_allclose(m[key].detach().numpy(),
                                   np.asarray(jm[key]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    assert float(jm["grad_norm"]) > 1.0      # the clip binds
    clipped = OVER["train_clip_grad_norm"] / float(jm["grad_norm"])
    root_v = math.sqrt((1 - ADAM_B2) / (1 - ADAM_B2 ** (start + 1)))
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
            GRAD_ATOL, (name, np.abs(g - r).max(), np.abs(r).max())
        tol = np.where(np.abs(r) * clipped * root_v >= 10 * ADAM_EPS,
                       PARAM_ATOL, 2 * lr)
        for got, ref, what in ((p.detach().numpy(), after[name].numpy(),
                                "param"),
                               (state.ema[name].numpy(), ema[name].numpy(),
                                "ema")):
            diff = np.abs(got - ref)
            assert np.all(diff <= tol), (name, what, diff.max(),
                                         diff[tol == PARAM_ATOL].max(
                                             initial=0.0))

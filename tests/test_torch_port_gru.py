"""RMem's ConvGRU memory and reverse_infer in the port against the JAX
package, f32 on both sides on the CPU, with the same weights
(params_from_jax) on the same inputs made from numpy seeds: the ConvGRU
cells on an odd grid, the GRU eviction rule (scored and FIFO, with ties),
the tiny_aotl engine serving with the GRU memory through evictions, the
training forward with the GRU memory and with reverse_infer (DeAOT and
AOT, and AOT with no_memory_gap's quarter reverse loss), and SGD over
three steps with a save and resume of its trace."""

import math
import os
from itertools import islice

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.engine.train_state import make_optimizer
from rmem_tpu.engine.training import train_forward as jtrain_forward
from rmem_tpu.memory import bank as jbank
from rmem_tpu.memory import eviction as jeviction
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.models import init_params as jinit
from rmem_tpu.models.conv_gru import ConvGRUCellOutput as JCell
from rmem_tpu.ops import masks as jmasks
from rmem_tpu.ops.resize import resize_nearest as jresize_nearest
from rmem_tpu.ops.resize import upsample_argmax as jupsample_argmax
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data.synthetic import blob_batches
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.engine.train_state import TrainState, apply_gradients
from rmem_tpu_torch.engine.training import train_forward
from rmem_tpu_torch.managers.trainer import Trainer
from rmem_tpu_torch.memory import bank as pbank
from rmem_tpu_torch.memory import eviction
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.models.conv_gru import ConvGRUCellOutput
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# f32 on both sides: convs and matmuls sum in another order (XLA vs ATen)
CELL_TOL = 1e-5         # max |port - jax| / max |jax|
LOGIT_TOL = 1e-4        # the engine: encoder, LSTT, FPN
HID_TOL = 1e-4          # the hidden states after 4 GRU rounds
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4         # max |port - jax| / max |jax| per gradient leaf
# the self-attention's key bias has a zero gradient (it adds a constant to
# every logit of a row, which the softmax cancels): both sides hold f32
# roundoff there, ~1e-9
GRAD_ATOL = 1e-8
# SGD: the updated parameters, |lr x trace| <= ~1e-4 here
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(out, ref, rel, what=""):
    """max |out - ref| <= rel * max |ref|."""
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _jax_params(jmodel, rng, hw):
    """flax-initialiser-like weights drawn with numpy on jax.eval_shape's
    shapes, with a 0.05 N(0, 1) offset on every leaf."""
    img = jnp.zeros((1, *hw, 3))
    idoh = jnp.zeros((1, *hw, jmodel.cfg.id_channels))
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


# ---- the cells and the eviction rule -------------------------------------

@pytest.mark.parametrize("kernel", [2, 1], ids=["k_plane_2x2", "v_plane_1x1"])
def test_conv_gru_cell_matches_jax(kernel):
    """ConvGRUCellOutput at 16 channels on a 9 x 11 grid (odd, so the 2 x
    2 cell's one-sided 'same' padding shows), batch 2: the new hidden
    state and the output."""
    rng = np.random.RandomState(kernel)
    c = 16
    x, h = _rand(rng, 2, 9, 11, c), _rand(rng, 2, 9, 11, c)
    jcell = JCell(c, c, kernel=kernel)
    params = jcell.init(jax.random.PRNGKey(kernel), jnp.asarray(x),
                        jnp.asarray(h))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    jh, jout = jcell.apply({"params": params}, jnp.asarray(x), jnp.asarray(h))
    cell = ConvGRUCellOutput(c, c, kernel=kernel)
    cell.load_state_dict(params_from_jax(params), strict=True)
    ph, pout = cell(torch.from_numpy(x), torch.from_numpy(h))
    _close(ph, jh, CELL_TOL, "hidden")
    _close(pout, jout, CELL_TOL, "out")


def _bank_pair(rng, count, capacity=6, hw=5, c=4):
    """The same bank on both sides: `count` slots (just appended), scores
    with ties, every slot scored but the newest, ages 1..3."""
    k, v = _rand(rng, 2, capacity, 1, hw, c), _rand(rng, 2, capacity, 1, hw, c)
    score = np.array([0.2, 0.1, 0.1, 0.1, 0.3, 0.0][:capacity], np.float32)
    scored = np.arange(capacity) < count - 1
    times = np.array([3, 2, 2, 1, 1, 0][:capacity], np.int32)
    j = jbank.MemoryBank(k=jnp.asarray(k), v=jnp.asarray(v),
                         count=jnp.int32(count), score=jnp.asarray(score),
                         scored=jnp.asarray(scored), times=jnp.asarray(times),
                         order=jnp.arange(capacity, dtype=jnp.int32))
    p = pbank.MemoryBank(k=torch.from_numpy(k), v=torch.from_numpy(v),
                         count=torch.tensor(count, dtype=torch.int32),
                         score=torch.from_numpy(score),
                         scored=torch.from_numpy(scored),
                         times=torch.from_numpy(times),
                         order=torch.arange(capacity, dtype=torch.int32))
    return j, p


@pytest.mark.parametrize("gru", [False, True], ids=["plain", "gru"])
def test_scored_drop_index_matches_jax(gru):
    """The victim, scores, scored flags and ages of one round on a bank of
    6 slots, 5 of them old: slot masses equal in pairs (ties resolve to
    the lowest slot on both sides) and a uniform mass, where only the UCB
    bonus decides."""
    rng = np.random.RandomState(3)
    for mass_rows in ([0.1, 0.3, 0.3, 0.15, 0.15, 0.0],
                      [0.2, 0.2, 0.2, 0.2, 0.2, 0.0]):
        jb, pb = _bank_pair(rng, count=6)
        rec = np.tile(np.array(mass_rows, np.float32), (1, 7, 1))
        fg = rng.rand(1, 7).astype(np.float32)
        ref = jeviction.scored_drop_index(jb, jnp.asarray(rec),
                                          jnp.asarray(fg), gru_memory=gru)
        got = eviction.scored_drop_index(pb, torch.from_numpy(rec),
                                         torch.from_numpy(fg),
                                         gru_memory=gru)
        assert int(got[0]) == int(ref[0]) >= (2 if gru else 1)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-7)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def _compress_pair(w):
    """The same stand-in for the GRU cells on both sides: each output a
    fixed mix of the slot and the hidden state's mean over the grid."""
    def compress(k, v, hk, hv, xp):
        mk, mv = hk.mean((2, 3)), hv.mean((2, 3))
        nhk = hk * w + k.reshape(hk.shape) * (1 - w)
        nhv = hv * w + v.reshape(hv.shape) * (1 - w)
        return k * 0.5 + mk[:, :, None], v * 0.25 - mv[:, :, None], nhk, nhv

    return (lambda *a: compress(*a, jnp),
            lambda *a: compress(*a, torch))


@pytest.mark.parametrize("form", ["serving", "training"])
def test_evict_if_full_gru_matches_jax(form):
    """One round on a bank of 1 + 4 slots just appended to (count 6 > 5):
    the victim (scored with ties, or FIFO at former + 1) feeds the
    compressor, whose output replaces slot 1 before compaction; the
    hidden states change. A bank at count 5 is left as it is."""
    rng = np.random.RandomState(5)
    jb, pb = _bank_pair(rng, count=6)
    hk, hv = _rand(rng, 2, 1, 1, 5, 4), _rand(rng, 2, 1, 1, 5, 4)
    jfn, pfn = _compress_pair(0.7)
    rec = fg = None
    if form == "serving":
        rec = np.tile(np.array([0.1, 0.3, 0.15, 0.15, 0.3, 0.0], np.float32),
                      (1, 7, 1))
        fg = rng.rand(1, 7).astype(np.float32)
    for count in (6, 5):
        jb2 = jb.replace(count=jnp.int32(count))
        pb2 = pbank.MemoryBank(**{**pb.__dict__, "count": torch.tensor(
            count, dtype=torch.int32)})
        jnew, jhk, jhv = jeviction.evict_if_full_gru(
            jb2, 1, 4, jfn, jnp.asarray(hk), jnp.asarray(hv),
            None if rec is None else jnp.asarray(rec),
            None if fg is None else jnp.asarray(fg),
            use_attn_weight=rec is not None)
        pnew, phk, phv = eviction.evict_if_full_gru(
            pb2, 1, 4, pfn, torch.from_numpy(hk), torch.from_numpy(hv),
            count, None if rec is None else torch.from_numpy(rec),
            None if fg is None else torch.from_numpy(fg))
        for name in ("k", "v", "score"):
            np.testing.assert_allclose(getattr(pnew, name).numpy(),
                                       np.asarray(getattr(jnew, name)),
                                       atol=1e-6, err_msg=name)
        for name in ("count", "scored", "times", "order"):
            np.testing.assert_array_equal(getattr(pnew, name).numpy(),
                                          np.asarray(getattr(jnew, name)),
                                          err_msg=name)
        np.testing.assert_allclose(phk.numpy(), np.asarray(jhk), atol=1e-6)
        np.testing.assert_allclose(phv.numpy(), np.asarray(jhv), atol=1e-6)
        assert (count == 6) == (not np.array_equal(phk.numpy(), hk))


# ---- serving --------------------------------------------------------------

HW = (64, 64)
OUT_HW = (60, 70)
FRAMES = 8


def test_gru_engine_matches_jax():
    """tiny_aotl with the GRU memory, 1 + 2 slots and a write every frame,
    through the reference and 8 frames (the bank full from frame 2, a GRU
    round on each later frame), teacher-forced with the JAX labels: per
    frame the logits, and after each write the bank (contents, count,
    scores, ages, order) and both hidden states, which change only on a
    round."""
    over = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=2,
                gru_memory=True)
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
    peng = InferenceEngine(model, model.cfg, device="cpu")

    rng = np.random.RandomState(0)
    imgs = rng.rand(FRAMES + 1, 1, *HW, 3).astype(np.float32)
    mask = np.zeros((1, *HW), np.int32)
    mask[:, 8:30, 6:28] = 1
    mask[:, 36:60, 30:58] = 2
    js, _ = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask), [2],
                               gap=1)
    ps, _ = peng.add_reference(imgs[0], mask, [2], gap=1)
    assert ps.gru_hid_k.shape == js.gru_hid_k.shape
    assert ps.gru_hid_k.shape[::4] == (2, 64) and not ps.gru_hid_k.any()
    counts, rounds = [], 0
    for t in range(1, FRAMES + 1):
        js, jlog = jeng.propagate(js, jnp.asarray(imgs[t]))
        ps, plog = peng.propagate(ps, imgs[t])
        _close(plog, jlog, LOGIT_TOL, f"logits {t}")
        lab = np.asarray(jupsample_argmax(jlog, OUT_HW))
        lab_in = np.array(jresize_nearest(jnp.asarray(lab)[None, ..., None],
                                          HW))[..., 0]
        hid = ps.gru_hid_k.clone()
        was_full = 1 + ps.long_writes >= 3
        js = jeng.update_memory(js, jnp.asarray(lab_in))
        ps = peng.update_memory(ps, lab_in)
        assert (ps.frame_step, ps.last_mem_step) == (
            int(js.frame_step), int(js.last_mem_step)) == (t, t)
        jb, pb = js.bank, ps.bank
        assert int(pb.count) == int(jb.count) == min(1 + ps.long_writes, 3)
        for name in ("order", "times", "scored"):
            np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=f"{name} {t}")
        np.testing.assert_allclose(pb.score.numpy(), np.asarray(jb.score),
                                   atol=1e-5)
        _close(pb.k, jb.k, LOGIT_TOL, f"bank k {t}")
        _close(pb.v, jb.v, LOGIT_TOL, f"bank v {t}")
        _close(ps.gru_hid_k, js.gru_hid_k, HID_TOL, f"hid_k {t}")
        _close(ps.gru_hid_v, js.gru_hid_v, HID_TOL, f"hid_v {t}")
        assert was_full == (not torch.equal(hid, ps.gru_hid_k))
        rounds += was_full
        counts.append(int(pb.count))
    assert counts == [2, 3, 3, 3, 3, 3, 3, 3] and rounds == 6


# ---- training -------------------------------------------------------------

def _train_inputs(rng, b, t, hw):
    imgs = rng.rand(b, t, *hw, 3).astype(np.float32)
    labels = np.zeros((b, t, *hw), np.int32)
    for i in range(t):
        labels[:, i, 8 + 2 * i:40 + 2 * i, 10:40] = 1
        labels[0, i, 40:60, 20 + 3 * i:50 + 3 * i] = 2
        labels[:, i, :4] = 255
    return imgs, labels, np.array([2, 1][:b], np.int32)


def _forward_pair(model_name, hw, t, grad=True, **over):
    """train_forward of both packages on the same weights, clip and id
    shuffle, at step 3 with the curriculum off. Returns (JAX loss,
    metrics, gradients as a state dict or None) and (port loss, metrics,
    model, with its gradients when `grad`)."""
    rng = np.random.RandomState(0)
    over = dict(compute_dtype="float32", data_seq_len=t, **over)
    jcfg = jget_config("test", model=model_name, **over)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = _jax_params(jmodel, rng, hw)
    imgs, labels, obj = _train_inputs(rng, 2, t, hw)
    shuffle = jmasks.host_id_shuffle_matrix(np.random.RandomState(7),
                                            jcfg.model_max_obj_num + 1, 2)

    def loss_fn(p):
        return jtrain_forward(jmodel, p, jnp.asarray(imgs),
                              jnp.asarray(labels), jnp.asarray(obj),
                              jnp.float32(3), jnp.asarray(shuffle), False,
                              jcfg)

    jgrads = None
    if grad:
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        jgrads = params_from_jax(jgrads)
    else:
        jloss, jm = jax.jit(loss_fn)(params)
    cfg = get_config("test", model=model_name, **over)
    model = build_vos_model(cfg.model_vos, cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    model.train()
    with torch.set_grad_enabled(grad):
        loss, m = train_forward(model, torch.from_numpy(imgs),
                                torch.from_numpy(labels),
                                torch.from_numpy(obj), 3,
                                torch.from_numpy(shuffle), False, cfg)
    if grad:
        loss.backward()
    return (jloss, jm, jgrads), (loss, m, model)


def _assert_grads(model, ref, prefix=""):
    seen = 0
    for name, p in model.named_parameters():
        if not name.startswith(prefix):
            continue
        r = ref[name].numpy()
        g = np.zeros_like(r) if p.grad is None else p.grad.numpy()
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max() + GRAD_ATOL, \
            (name, np.abs(g - r).max(), np.abs(r).max())
        seen += 1
    return seen


def test_train_forward_gru_memory_matches_jax():
    """tiny_aotl with the GRU memory at 65 x 65, clips of 6, 1 + 1 slots
    and a write every frame (GRU rounds on frames 2 to 5, each folding the
    slot after slot 1 into it): the loss and per-frame losses, and every
    gradient leaf, those of both GRU cells of each layer (nonzero) among
    them."""
    (jloss, jm, jg), (loss, m, model) = _forward_pair(
        "tiny_aotl", (65, 65), 6, gru_memory=True, latter_mem_len=1,
        train_long_term_mem_gap=1)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["loss_per_frame"].numpy(),
                               np.asarray(jm["loss_per_frame"]),
                               rtol=LOSS_RTOL)
    cells = [n for n, _ in model.named_parameters() if "memory_gru" in n]
    assert len(cells) == 2 * 2 * 6                  # 2 layers, 2 cells
    assert all(model.get_parameter(n).grad.abs().max() > 0 for n in cells)
    assert _assert_grads(model, jg) == len(list(model.parameters()))


@pytest.mark.parametrize("model_name,hw,over", [
    ("tiny_deaotl", (129, 129), {}),
    ("tiny_aotl", (65, 65), {}),
    ("tiny_aotl", (65, 65), dict(no_memory_gap=True)),
], ids=["deaot", "aot", "aot_no_memory_gap"])
def test_train_forward_reverse_infer_matches_jax(model_name, hw, over):
    """reverse_infer on clips of 5: a write every 2 frames (every frame
    with no_memory_gap, whose preset quarters reverse_loss to 0.1, and the
    bank of 1 + 2 slots evicts from frame 3), each followed by frame 0's
    decode from the bank without slot 0 and frame 1's detached short-term
    memory. The loss, the per-frame losses, whose write frames hold the
    reverse terms, and every gradient leaf: the reverse decodes' flow
    through the compacted bank into the frames that wrote it, and none
    through frame 1's detached short-term memory."""
    cfg = get_config("test", model=model_name, reverse_infer=True, **over)
    assert cfg.reverse_loss == jget_config(
        "test", model=model_name, reverse_infer=True, **over).reverse_loss \
        == (0.1 if over else 0.4)
    (jloss, jm, jg), (loss, m, model) = _forward_pair(
        model_name, hw, 5, reverse_infer=True, latter_mem_len=2, **over)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["loss_per_frame"].numpy(),
                               np.asarray(jm["loss_per_frame"]),
                               rtol=LOSS_RTOL)
    assert _assert_grads(model, jg) == len(list(model.parameters()))


# ---- SGD ------------------------------------------------------------------

def test_sgd_matches_optax_and_resumes_with_its_trace(tmp_path):
    """train_opt "sgd" (momentum 0.9) over 3 steps of seeded gradients on
    tiny_deaotl's weights, every leaf after each step against optax's
    chain (clip, trace, masked decay, group learning rates) and the trace
    against its state; then a Trainer's stream save holds the trace under
    "trace", and a Trainer resuming from it steps as the first does."""
    cfg = get_config("test", model="tiny_deaotl", compute_dtype="float32",
                     train_opt="sgd", train_clip_grad_norm=50.0,
                     train_lr=0.05, dir_root=str(tmp_path),
                     train_batch_size=1, data_randomcrop=(65, 65))
    jcfg = jget_config("test", model="tiny_deaotl", compute_dtype="float32",
                       train_opt="sgd", train_clip_grad_norm=50.0,
                       train_lr=0.05)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    rng = np.random.RandomState(4)
    params = _jax_params(jmodel, rng, (65, 65))
    tx = make_optimizer(params, jcfg)
    opt_state = tx.init(params)
    model = build_vos_model("deaot", cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState.create(model, "sgd")
    assert state.nu == {}
    jparams = params

    @jax.jit
    def jstep(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)
        jparams, opt_state = jstep(grads, opt_state, jparams)
        pg = params_from_jax(grads)
        for name, p in model.named_parameters():
            p.grad = pg[name].clone()
        apply_gradients(state, cfg)
        ref, trace = params_from_jax(jparams), params_from_jax(
            opt_state[1].trace)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=name)
            np.testing.assert_allclose(state.mu[name].numpy(),
                                       trace[name].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    first = Trainer(cfg, device="cpu", seed=3, log=lambda s: None,
                    batches=blob_batches(cfg, 5))
    first.train(max_steps=1)
    first.save()
    saved = torch.load(os.path.join(first.ckpt_dir, "save_step_1.pt"),
                       weights_only=True)["state"]
    assert {"trace", "ema", "params"} <= set(saved) and "mu" not in saved
    resumed = Trainer(cfg, device="cpu", seed=9, log=lambda s: None,
                      batches=islice(blob_batches(cfg, 5), 1, None))
    assert resumed.load(first.ckpt_dir)
    for name, t in first.state.mu.items():
        assert torch.equal(resumed.state.mu[name], t), name
    first.train(max_steps=1)
    resumed.train(max_steps=1)
    for (name, p), q in zip(first.state.model.named_parameters(),
                            resumed.state.model.parameters()):
        assert torch.equal(p, q), name
    first.close()
    resumed.close()
    adam = Trainer(cfg.replace(train_opt="adamw"), device="cpu",
                   log=lambda s: None)
    with pytest.raises(ValueError, match="no adamw state"):
        adam.load(first.ckpt_dir)
    with pytest.raises(ValueError, match="train_opt"):
        Trainer(cfg.replace(train_opt="lamb"), device="cpu")

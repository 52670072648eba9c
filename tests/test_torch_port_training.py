"""The port's training step against the JAX package's, and its parts.

One whole step of tiny_deaotl at the `test` stage (129x129, 4 frames, 2
clips), f32 on both sides, with the same parameters, batch and id shuffle:
the loss and metrics, every gradient leaf (mapped by params_from_jax's
rule), the parameters after the update and the EMA, with the use_prev_pred
curriculum off (step 0) and on (step 50 of 100). One former + one latter
slot and a long-term write every frame, so the FIFO eviction runs; the
gradient clip binds (norm 1). Then the losses, the schedule, the
out-of-place bank ops, the IoU, the id shuffle, the synthetic clips and the
trainer's save and resume, each against JAX where JAX has it."""

import math
import os
from itertools import islice

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rmem_tpu import memory as jmemory
from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine.train_state import TrainState as JTrainState
from rmem_tpu.engine.train_state import make_optimizer, make_train_step
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.ops import losses as jlosses
from rmem_tpu.ops import masks as jmasks
from rmem_tpu.ops import schedule as jschedule
from rmem_tpu.utils.metric import pytorch_iou_batched as jiou
from rmem_tpu_torch import memory
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data.synthetic import blob_batches, gen_blob_batch
from rmem_tpu_torch.engine.train_state import TrainState
from rmem_tpu_torch.managers.trainer import Trainer, train_step
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.ops import losses, masks, schedule
from rmem_tpu_torch.utils import params_from_jax
from rmem_tpu_torch.utils.metric import pytorch_iou_batched

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HW = (129, 129)
B, T = 2, 4
OVER = dict(compute_dtype="float32", data_seq_len=T, latter_mem_len=1,
            train_long_term_mem_gap=1, train_clip_grad_norm=1.0)
# f32 through ~40 layers, 4 frames and a backward whose sums run in another
# order (XLA vs ATen): the loss to ~1e-6 relative, each gradient leaf to
# ~1e-5 of its largest value. The update is at most lr (1e-5 at step 0,
# 1.1e-4 at step 50) per element, so parameters and EMA agree to far below
# their scale.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # max |port - jax| / max |jax| per leaf
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
    """The JAX step and the port's step from the same state, at step 0 and
    at step 50. Returns {start: (jax (state, new_state, metrics), port
    (model before, state after, metrics))}."""
    rng = np.random.RandomState(0)
    jcfg = jget_config("test", model="tiny_deaotl", **OVER)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = _jax_params(jmodel, rng)
    batch = _batch(rng)
    shuffle = jmasks.host_id_shuffle_matrix(np.random.RandomState(7),
                                            jcfg.model_max_obj_num + 1, B)
    tx = optax.chain(_capture_grads(), make_optimizer(params, jcfg))
    jstep = jax.jit(make_train_step(jmodel, jcfg, tx))
    cfg = get_config("test", model="tiny_deaotl", **OVER)
    out = {}
    for start in (0, 50):
        # every count of the optimizer's state at the step, as after
        # `start` steps
        opt_state = jax.tree_util.tree_map_with_path(
            lambda p, x: (jnp.int32(start) if getattr(p[-1], "name", None)
                          == "count" else x), tx.init(params))
        jstate = JTrainState(params=params, opt_state=opt_state,
                             ema_params=jax.tree_util.tree_map(jnp.array,
                                                               params),
                             step=jnp.int32(start))
        jnew, jmetrics = jstep(jstate, jax.tree_util.tree_map(
            jnp.asarray, batch), jnp.asarray(shuffle))

        model = build_vos_model("deaot", cfg)
        model.load_state_dict(params_from_jax(params), strict=True)
        state = TrainState.create(model)
        state.step = start
        metrics = train_step(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                             torch.from_numpy(shuffle), cfg)
        out[start] = ((jstate, jnew, jmetrics), (state, metrics))
    return out


@pytest.mark.parametrize("start", [0, 50], ids=["curriculum_off",
                                                "curriculum_on"])
def test_train_step_matches_jax(steps, start):
    (_, jnew, jm), (state, m) = steps[start]
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
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max() + 1e-9, \
            (name, np.abs(g - r).max(), np.abs(r).max())
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(),
                                   ema[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@jax.jit
def _jax_loss_and_grad(logits, label, obj, step):
    return jax.value_and_grad(lambda lg: jnp.sum(jlosses.segmentation_loss(
        lg, label, obj, step, 0.15, 10.0)))(logits)


@pytest.mark.parametrize("step", [0, 4, 10])
def test_losses_match_jax_with_ties(step):
    """Top-k CE (k annealed over 10 steps) + soft Jaccard and their
    gradients, on logits built from 5 distinct rows so that many pixel
    losses tie exactly: the top k take the lowest pixel indices of a tie on
    both sides."""
    rng = np.random.RandomState(1)
    n, h, w, c = 2, 12, 10, 4
    rows = rng.randn(5, c).astype(np.float32)
    logits = rows[rng.randint(0, 5, (n, h, w))]
    label = rng.randint(0, 3, (n, h, w)).astype(np.int32)
    label[:, 0] = 255
    obj = np.array([2, 3], np.int32)
    ref, gref = _jax_loss_and_grad(logits, label, obj, jnp.float32(step))
    lt = torch.tensor(logits, requires_grad=True)
    out = losses.segmentation_loss(lt, torch.from_numpy(label),
                                   torch.from_numpy(obj), step, 0.15, 10.0)
    out.sum().backward()
    np.testing.assert_allclose(out.sum().item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gref), rtol=1e-5,
                               atol=1e-7)


def test_lr_schedule_matches_jax():
    for kw in (dict(), dict(cosine=True), dict(restarts=3)):
        ours = schedule.make_lr_schedule(2e-4, 1e-5, 1000, **kw)
        ref = jschedule.make_lr_schedule(2e-4, 1e-5, 1000, **kw)
        for step in (0, 1, 25, 49, 50, 51, 300, 999, 1000, 1200):
            np.testing.assert_allclose(ours(step), float(ref(step)),
                                       rtol=1e-6, err_msg=f"{kw} {step}")
    np.testing.assert_allclose(
        schedule.encoder_lr(1.5e-4, 1e-5, 0.1),
        float(jschedule.encoder_lr(jnp.float32(1.5e-4), 1e-5, 0.1)),
        rtol=1e-6)


def test_bank_append_evict_and_compact_match_jax():
    """Four appends into 1 former + 2 latter slots (capacity 4): FIFO
    eviction at the former slot once full, then a compaction of slot 1,
    out of place on the port's side (the banks it was given stay as they
    were)."""
    rng = np.random.RandomState(2)
    L, S, b, hw, ck, cv = 2, 4, 1, 3, 2, 5
    jb = jmemory.init_bank(L, S, b, hw, ck, cv)
    pb = memory.init_bank(L, S, b, hw, ck, cv)
    for i in range(4):
        k, v = rng.randn(L, b, hw, ck), rng.randn(L, b, hw, cv)
        jb = jmemory.evict_if_full(jmemory.bank_append(jb, k, v), 1, 2,
                                   use_attn_weight=False)
        kept = pb.k.clone()
        new = memory.bank_appended(pb, torch.tensor(k, dtype=torch.float32),
                                   torch.tensor(v, dtype=torch.float32))
        assert torch.equal(pb.k, kept)
        pb = memory.evict_if_full(new, 1, 2, int(new.count))
        jb = jb.replace(score=jnp.arange(S, dtype=jnp.float32) + i,
                        scored=jnp.arange(S) % 2 == 0,
                        times=jnp.arange(S, dtype=jnp.int32) * (i + 1))
        pb.score = torch.tensor(np.asarray(jb.score))
        pb.scored = torch.tensor(np.asarray(jb.scored))
        pb.times = torch.tensor(np.asarray(jb.times))
        for f in ("k", "v", "count"):
            np.testing.assert_allclose(getattr(pb, f).numpy(),
                                       np.asarray(getattr(jb, f)),
                                       rtol=1e-6, err_msg=f"{f} after {i}")
    jc = jmemory.bank_compact(jb, jnp.int32(1))
    pc = memory.bank_compact(pb, torch.tensor(1))
    for f in ("k", "v", "count", "score", "scored", "times"):
        np.testing.assert_allclose(getattr(pc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-6,
                                   err_msg=f)


def test_iou_matches_jax():
    rng = np.random.RandomState(3)
    pred = rng.randint(0, 4, (3, 9, 11)).astype(np.int32)
    target = rng.randint(0, 4, (3, 9, 11)).astype(np.int32)
    for obj in ([2, 3, 0], [0, 0, 0]):
        obj = np.array(obj, np.int32)
        np.testing.assert_allclose(
            pytorch_iou_batched(*map(torch.from_numpy, (pred, target, obj)),
                                5).item(),
            float(jiou(pred, target, obj, 5)), rtol=1e-6)


def test_id_shuffle_and_label_remap_match_jax():
    """The host shuffle draws the JAX package's matrices from the same
    RandomState; the int label remap equals the argmax of the JAX float
    chain (one-hot, ignored background zeroed, shuffled, ignore channel
    appended); unshuffling the logits matches."""
    ours = masks.host_id_shuffle_matrix(np.random.RandomState(5), 11, 3)
    ref = jmasks.host_id_shuffle_matrix(np.random.RandomState(5), 11, 3)
    np.testing.assert_array_equal(ours, ref)
    rng = np.random.RandomState(6)
    label = rng.randint(0, 11, (3, 7, 8)).astype(np.int32)
    label[:, 0] = 255
    oh, ign = jmasks.one_hot_mask(jnp.asarray(label), 10)
    chain = jmasks.apply_ignore_token(oh, ign, jnp.asarray(ref))
    perm = torch.argmax(torch.from_numpy(ours), dim=-1)
    np.testing.assert_array_equal(
        masks.map_id_label(torch.from_numpy(label), perm, 10).numpy(),
        np.asarray(jnp.argmax(chain, axis=-1)))
    logits = rng.randn(3, 4, 5, 11).astype(np.float32)
    np.testing.assert_allclose(
        masks.unshuffle_logits(torch.from_numpy(logits),
                               torch.from_numpy(ours)).numpy(),
        np.asarray(jmasks.unshuffle_logits(logits, ref)), rtol=1e-6)


def test_synthetic_clips_are_seeded():
    make = lambda seed: gen_blob_batch(torch.Generator().manual_seed(seed),
                                       2, 3, (40, 48))
    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["imgs"], c["imgs"])
    assert a["imgs"].shape == (2, 3, 40, 48, 3)
    assert a["imgs"].dtype == torch.float32
    assert a["labels"].shape == (2, 3, 40, 48)
    assert a["labels"].dtype == a["obj_nums"].dtype == torch.int32
    assert torch.all((a["obj_nums"] >= 2) & (a["obj_nums"] <= 3))
    assert torch.all(a["labels"].amax(dim=(1, 2, 3)) <= a["obj_nums"])


def test_trainer_saves_and_resumes(tmp_path):
    """Two steps straight equal one step, save, load into a new trainer,
    one step: the same loss, parameters and EMA. Each step takes the next
    clip of one seeded blob stream (the resumed trainer the stream's
    second). Logs every step."""
    cfg = get_config("test", model="tiny_deaotl", compute_dtype="float32",
                     train_batch_size=1, data_randomcrop=(65, 65),
                     train_log_step=1, dir_root=str(tmp_path))
    lines = []
    straight = Trainer(cfg, device="cpu", seed=3, log=lines.append,
                       batches=blob_batches(cfg, 5))
    m2 = straight.train(max_steps=2)
    first = Trainer(cfg, device="cpu", seed=3, log=lambda s: None,
                    batches=blob_batches(cfg, 5))
    m1 = first.train(max_steps=1)
    first.save()
    resumed = Trainer(cfg, device="cpu", seed=9, log=lambda s: None,
                      batches=islice(blob_batches(cfg, 5), 1, None))
    assert resumed.load(first.ckpt_dir) == os.path.join(first.ckpt_dir,
                                                         "save_step_1.pt")
    assert resumed.state.step == 1
    assert resumed.train(max_steps=1)["loss"] == m2["loss"] != m1["loss"]
    for (name, p), q in zip(straight.state.model.named_parameters(),
                            resumed.state.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(straight.state.ema[name], resumed.state.ema[name])
    assert len(lines) == 2 and lines[1].startswith("step 2/100 loss ")
    summary = straight.frame_meter_summary()
    assert len(summary["loss_per_frame"]) == cfg.data_seq_len - 1
    assert all(0 <= v <= 100 for v in summary["iou_per_frame"])


def test_unported_training_branches_raise():
    """reverse_infer and the GRU memory are ported (their parity tests are
    tests/test_torch_port_gru.py): the trainer takes them, and the var
    loss; so is the static-image dataset (its parity tests are
    tests/test_torch_port_image_transforms.py). What the port does not
    take still raises instead of being skipped: another optimizer than
    adamw and sgd, another remat policy."""
    for model, over in (("tiny_deaotl", dict(reverse_infer=True)),
                        ("tiny_aotl", dict(gru_memory=True)),
                        ("tiny_deaotl", dict(var_loss_weight=0.01))):
        cfg = get_config("test", model=model, compute_dtype="float32",
                         **over)
        Trainer(cfg, device="cpu")
    for over, err in ((dict(train_opt="lamb"), ValueError),
                      (dict(train_remat="offload"), ValueError)):
        with pytest.raises(err):
            Trainer(get_config("test", model="tiny_deaotl",
                               compute_dtype="float32", **over),
                    device="cpu")


def test_deaot_trains_with_gru_memory_ignored():
    """DeAOT ignores gru_memory, as the JAX step does (it acts on
    `gru_memory_active`, which holds for AOT only): a tiny_deaotl step with
    the flag equals one without, bit for bit."""
    runs = []
    for flag in (False, True):
        cfg = get_config("test", model="tiny_deaotl", compute_dtype="float32",
                         train_batch_size=1, data_randomcrop=(65, 65),
                         gru_memory=flag)
        assert cfg.gru_memory_active is False
        trainer = Trainer(cfg, device="cpu", seed=3, log=lambda s: None,
                          batches=blob_batches(cfg, 5))
        runs.append((trainer.train(max_steps=1), trainer.state.model))
    (m0, model0), (m1, model1) = runs
    assert m0 == m1
    for (name, p), q in zip(model0.named_parameters(), model1.parameters()):
        assert torch.equal(p, q), name

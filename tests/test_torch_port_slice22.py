"""The exported serving step with RMem's ConvGRU memory and with
no_long_memory (tools/export.py over InferenceEngine.functional_step)
against the JAX package's jitted `_step_impl` (rmem_tpu/engine/inference.py,
which its tools/export.py exports for any config) and against the port's
eager step, f32 on the CPU, the same weights on both sides
(params_from_jax, or the JAX tree as a msgpack file the export CLI reads);
the device-count GRU eviction round against the host-count one; the state's
tensors as each config gives them.

Tolerances: labels equal; logits, bank keys and values and the GRU hidden
states to 1e-4 of each tensor's max against JAX (XLA and ATen sum f32 convs
and matmuls in another order); the bank's count, order, ages and flags
exact, its scores to 1e-5; the exported program against the eager engine,
the same ATen ops, to 1e-6."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_params as jinit
from rmem_tpu.utils import checkpoint as jckpt
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.memory import bank as pbank
from rmem_tpu_torch.memory import eviction
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.tools import export as port_export
from rmem_tpu_torch.utils import params_from_jax

JAX_TOL = 1e-4          # max |port - jax| / max |jax|
SCORE_ATOL = 1e-5
EAGER_ATOL = 1e-6       # the exported program against the eager engine
GRU_HW = (64, 64)
GRU_FRAMES = 5          # a write every frame into 1 + 2 slots: 3 rounds
GRU_OVER = dict(compute_dtype="float32", gru_memory=True, former_mem_len=1,
                latter_mem_len=2)
NOLONG_HW = (33, 33)
NOLONG_FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(out, ref, rel, what=""):
    """max |out - ref| <= rel * max |ref|."""
    out = out.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), (what, err)


def _jax_side(model, hw, over, seed):
    """(JAX engine, its params with a 0.05 N(0, 1) offset on every leaf,
    the jitted `_step_impl` at out_hw = hw)."""
    jcfg = jget_config("test", model=model, **over)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = jinit(jmodel, jax.random.PRNGKey(0), hw)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    jeng = JEngine(jmodel, params, jcfg, donate=False)
    return jeng, params, jax.jit(functools.partial(jeng._step_impl,
                                                   out_hw=hw))


def _inputs(hw, frames, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(frames + 1, 1, *hw, 3).astype(np.float32)
    mask = np.zeros((1, *hw), np.int32)
    mask[:, hw[0] // 8:hw[0] // 2, hw[1] // 10:hw[1] // 2] = 1
    mask[:, hw[0] // 2:hw[0] - 4, hw[1] // 2:hw[1] - 6] = 2
    return imgs, mask


def _run_three(step, jstep, jeng, jparams, engine, imgs, mask, hw, frames,
               compare):
    """The reference frame, then `frames` frames through the exported
    program, JAX's step and the port's eager step (a write every frame);
    `compare(t, fields, tensors, jax state, eager state)` after each."""
    js, _ = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask), [2],
                               gap=1)
    live, _ = engine.add_reference(imgs[0], mask, [2], gap=1)
    sched, _ = engine.add_reference(imgs[0], mask, [2], gap=1)
    fields = engine.state_fields()
    tensors = [t.clone() for t in engine.state_tensors(sched)]
    for t in range(1, frames + 1):
        flag = torch.tensor(engine.write_due(sched))
        with torch.no_grad():
            *tensors, label = step(*tensors, torch.from_numpy(imgs[t]), flag)
        js, jlabel = jstep(jparams, js, jnp.asarray(imgs[t]))
        live, live_label = engine.step(live, imgs[t], hw)
        assert tuple(label.shape) == hw and label.dtype == torch.int32
        np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel),
                                      err_msg=f"frame {t}")
        np.testing.assert_array_equal(label.numpy(), live_label.numpy())
        for name, got, ref in zip(fields, tensors,
                                  engine.state_tensors(live)):
            assert got.dtype == ref.dtype, name
            torch.testing.assert_close(got, ref, rtol=0, atol=EAGER_ATOL,
                                       msg=f"{name} against eager, {t}")
        compare(t, dict(zip(fields, tensors)), js, live)


@pytest.fixture(scope="module")
def gru_export(tmp_path_factory):
    """The export CLI on tiny_aotl with the GRU memory (`--opt`), its
    weights the JAX tree's as a msgpack file (`--ckpt`): (the loaded
    program, the JAX side, the port engine on the same weights)."""
    tmp = tmp_path_factory.mktemp("gru_export")
    jeng, jparams, jstep = _jax_side("tiny_aotl", GRU_HW, GRU_OVER, seed=1)
    ckpt = str(tmp / "tiny_aotl.msgpack")
    jckpt.save_pytree(jparams, ckpt)
    out = str(tmp / "gru.pt2")
    port_export.main(["--stage", "test", "--model", "tiny_aotl", "--hw",
                      *map(str, GRU_HW), "--ckpt", ckpt, "--out", out,
                      "--device", "cpu", "--opt", "gru_memory=true",
                      "former_mem_len=1", "latter_mem_len=2"])
    prog = torch.export.load(out)
    cfg = get_config("test", model="tiny_aotl", **GRU_OVER)
    engine = InferenceEngine(build_vos_model(cfg.model_vos, cfg), cfg,
                             device="cpu")
    engine.model.load_state_dict(params_from_jax(jparams))
    return prog, jeng, jparams, jstep, engine


def test_exported_gru_step_matches_jax_and_eager(gru_export):
    """The CLI's artifact, loaded, over the reference and 5 frames, a write
    every frame into 1 + 2 slots: the bank fills at frame 2 and frames 3-5
    each run a GRU round on the device (the flag's torch.cond, then the
    round by the bank's count). Per frame: the label equal to JAX's and to
    the eager engine's, the logits, the bank and both hidden states
    against JAX's, every state tensor against the eager engine's; the
    hidden states change on exactly the 3 rounds."""
    prog, jeng, jparams, jstep, engine = gru_export
    assert sum(str(n.target) == "cond" for n in prog.graph.nodes) == 1
    assert len(prog.graph_signature.user_outputs) == len(
        engine.state_fields()) + 1 == 15
    imgs, mask = _inputs(GRU_HW, GRU_FRAMES)
    counts, changed = [], []
    hid = [None]

    def compare(t, got, js, live):
        jb = js.bank
        _close(got["logits4x"], js.logits4x, JAX_TOL, f"logits {t}")
        _close(got["bank_k"], jb.k, JAX_TOL, f"bank k {t}")
        _close(got["bank_v"], jb.v, JAX_TOL, f"bank v {t}")
        for name in ("count", "order", "times", "scored"):
            np.testing.assert_array_equal(got[f"bank_{name}"].numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=f"{name} {t}")
        np.testing.assert_allclose(got["bank_score"].numpy(),
                                   np.asarray(jb.score), atol=SCORE_ATOL)
        _close(got["gru_hid_k"], js.gru_hid_k, JAX_TOL, f"hid_k {t}")
        _close(got["gru_hid_v"], js.gru_hid_v, JAX_TOL, f"hid_v {t}")
        if hid[0] is not None:
            changed.append(not torch.equal(hid[0], got["gru_hid_k"]))
        hid[0] = got["gru_hid_k"].clone()
        counts.append(int(got["bank_count"]))

    _run_three(prog.module(), jstep, jeng, jparams, engine, imgs, mask,
               GRU_HW, GRU_FRAMES, compare)
    assert counts == [2, 3, 3, 3, 3]
    assert changed == [False, True, True, True]


def test_exported_no_long_memory_step_matches_jax_and_eager():
    """tiny_deaotl with no_long_memory through build_exported: the state
    has no record (11 tensors), the step writes only the short-term
    memory whatever the flag says, and the bank keeps the reference's one
    slot; labels, logits and the short-term memory against JAX's over 3
    frames, every tensor against the eager engine's."""
    over = dict(compute_dtype="float32", no_long_memory=True)
    jeng, jparams, jstep = _jax_side("tiny_deaotl", NOLONG_HW, over, seed=2)
    cfg = get_config("test", model="tiny_deaotl", **over)
    params = params_from_jax(jparams)
    prog, example, _ = port_export.build_exported(cfg, params, NOLONG_HW,
                                                  device="cpu")
    engine = InferenceEngine(build_vos_model(cfg.model_vos, cfg), cfg,
                             device="cpu")
    engine.model.load_state_dict(params)
    assert "record" not in engine.state_fields() and len(example) == 11
    imgs, mask = _inputs(NOLONG_HW, NOLONG_FRAMES, seed=3)

    def compare(t, got, js, live):
        assert int(got["bank_count"]) == int(js.bank.count) == 1
        _close(got["logits4x"], js.logits4x, JAX_TOL, f"logits {t}")
        _close(got["short_k"], js.short_k, JAX_TOL, f"short_k {t}")
        _close(got["short_v"], js.short_v, JAX_TOL, f"short_v {t}")
        _close(got["bank_k"], js.bank.k, JAX_TOL, f"bank k {t}")

    _run_three(prog.module(), jstep, jeng, jparams, engine, imgs, mask,
               NOLONG_HW, NOLONG_FRAMES, compare)


def _bank(rng, count, capacity=6, hw=5, c=4):
    """A bank of `capacity` slots, `count` of them written (just appended),
    scores with ties, every slot scored but the newest, ages 1..3."""
    return pbank.MemoryBank(
        k=torch.from_numpy(rng.randn(2, capacity, 1, hw, c).astype(
            np.float32)),
        v=torch.from_numpy(rng.randn(2, capacity, 1, hw, c).astype(
            np.float32)),
        count=torch.tensor(count, dtype=torch.int32),
        score=torch.tensor([0.2, 0.1, 0.1, 0.1, 0.3, 0.0][:capacity]),
        scored=torch.arange(capacity) < count - 1,
        times=torch.tensor([3, 2, 2, 1, 1, 0][:capacity], dtype=torch.int32),
        order=torch.arange(capacity, dtype=torch.int32))


def _compress(k, v, hk, hv):
    """A stand-in for the GRU cells: each output a fixed mix of the slot
    and the hidden state's mean over the grid."""
    mk, mv = hk.mean((2, 3)), hv.mean((2, 3))
    return (k * 0.5 + mk[:, :, None], v * 0.25 - mv[:, :, None],
            hk * 0.7 + k.reshape(hk.shape) * 0.3,
            hv * 0.7 + v.reshape(hv.shape) * 0.3)


@pytest.mark.parametrize("form", ["serving", "training"])
def test_evict_if_full_gru_device_matches_host_count(form):
    """The round decided from bank.count on the device (the exported
    step's) against the one decided from the host's count, on the same
    banks of 1 + 4 slots: at count 6 a round (the victim scored with slot
    1 pinned, or FIFO at former + 1), at count 5 none. Every field, both
    hidden states, and no output that is an input."""
    rng = np.random.RandomState(5)
    hk = torch.from_numpy(rng.randn(2, 1, 1, 5, 4).astype(np.float32))
    hv = torch.from_numpy(rng.randn(2, 1, 1, 5, 4).astype(np.float32))
    rec = fg = None
    if form == "serving":
        rec = torch.tensor([0.1, 0.3, 0.15, 0.15, 0.3, 0.0]).repeat(1, 7, 1)
        fg = torch.from_numpy(rng.rand(1, 7).astype(np.float32))
    for count in (6, 5):
        bank = _bank(rng, count)
        ref, rhk, rhv = eviction.evict_if_full_gru(
            bank, 1, 4, _compress, hk, hv, count, rec, fg)
        got, ghk, ghv = eviction.evict_if_full_gru_device(
            bank, 1, 4, _compress, hk, hv, rec, fg)
        for name in ("k", "v", "count", "score", "scored", "times", "order"):
            a, b = getattr(got, name), getattr(ref, name)
            assert a.dtype == b.dtype and a is not getattr(bank, name), name
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(ghk, rhk, rtol=0, atol=0)
        torch.testing.assert_close(ghv, rhv, rtol=0, atol=0)
        assert (count == 6) == (not torch.equal(ghk, hk))
        assert ghk is not hk and ghv is not hv


@pytest.mark.parametrize("over,fields", [
    ({}, InferenceEngine.STATE_FIELDS),
    (dict(no_long_memory=True),
     tuple(n for n in InferenceEngine.STATE_FIELDS if n != "record")),
    (dict(gru_memory=True),
     InferenceEngine.STATE_FIELDS + InferenceEngine.GRU_FIELDS),
], ids=["in_place", "no_long_memory", "gru_memory"])
def test_state_fields_follow_the_config(over, fields):
    """tiny_aotl's state after add_reference: the tensors state_fields
    names, in its order (the in-place bank's 12 first, the record left out
    under no_long_memory, the hidden states [L, B, H, W, C] last with the
    GRU memory, in the bank's dtype, as JAX keeps them)."""
    cfg = get_config("test", model="tiny_aotl", compute_dtype="float32",
                     **over)
    engine = InferenceEngine(build_vos_model(cfg.model_vos, cfg), cfg,
                             device="cpu")
    assert engine.state_fields() == fields
    state, _ = engine.add_reference(np.zeros((1, 33, 33, 3), np.float32),
                                    np.zeros((1, 33, 33), np.int32), [1])
    tensors = engine.state_tensors(state)
    assert len(tensors) == len(fields)
    assert all(isinstance(t, torch.Tensor) for t in tensors)
    if "gru_hid_k" in fields:
        hid = tensors[fields.index("gru_hid_k")]
        assert hid.dtype == state.bank.k.dtype and hid.dim() == 5
        assert hid.shape[2] * hid.shape[3] == state.bank.k.shape[3]
        assert math.prod(hid.shape) and not hid.any()


def test_tp_gather_keeps_each_collective_on_the_tensor_device(monkeypatch):
    """TensorParallelSplit.gather of a parameter on another device than
    its split's index tensor (on the card: the weights on cuda, the index
    on the CPU) hands every all_gather its inputs and outputs on the
    parameter's device, as gloo demands; here the meta device stands in
    for the card and a recording all_gather for the collective."""
    from rmem_tpu_torch.parallel import tp
    split = tp.TensorParallelSplit(group=None, size=2)
    split.index["w"] = (1, torch.arange(2, 4))
    devices = []

    def all_gather(outs, x, group=None):
        devices.append({o.device for o in outs} | {x.device})
        for o in outs:
            o.copy_(x)

    monkeypatch.setattr(tp.dist, "all_gather", all_gather)
    whole = split.gather("w", torch.empty((3, 2), device="meta"))
    assert tuple(whole.shape) == (3, 4) and whole.device.type == "meta"
    assert devices == [{torch.device("meta")}] * 2

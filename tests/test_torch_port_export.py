"""tools/export.py: the port's serving step through torch.export, saved,
loaded and run, against the live port step and the JAX package's
exported step (tests/test_export.py) on the same weights: tiny_deaotl,
f32, 33x33. The kernels are in the graph as the rmem:: custom ops
(kernels/ops.py), their plain versions on the CPU. Labels are held equal
(the same ATen ops, and the JAX side's f32 logits decide every pixel of
these frames apart by more than their rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.tools.export import build_exported as jbuild_exported
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.tools import export as port_export
from rmem_tpu_torch.utils import params_from_jax

HW = (33, 33)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def exported():
    """(JAX exported, JAX state, JAX params, port program, its example
    state, the port weights)."""
    cfg = jget_config("test", model="tiny_deaotl", compute_dtype="float32")
    jexp, jstate, jparams = jbuild_exported(cfg, hw=HW)
    pcfg = get_config("test", model="tiny_deaotl", compute_dtype="float32")
    params = params_from_jax(jparams)
    prog, state, _ = port_export.build_exported(pcfg, params, HW,
                                                device="cpu")
    return jexp, jstate, jparams, prog, state, params, pcfg


def _frame(seed=0):
    return np.random.RandomState(seed).rand(1, *HW, 3).astype(np.float32)


def test_export_roundtrip_matches_live_step_and_jax(exported, tmp_path):
    """Saved and loaded, the program's label equals its own before the
    round trip, the live port engine's step and the JAX exported step's;
    the state keeps its tensors and the bank's count (one slot: the JAX
    step's schedule writes nothing at frame 1 of a gap of 5, nor does the
    flag the port engine's schedule gives)."""
    jexp, jstate, jparams, prog, state, params, cfg = exported
    path = str(tmp_path / "step.pt2")
    torch.export.save(prog, path)
    loaded = torch.export.load(path).module()
    img = _frame()
    engine = InferenceEngine(build_vos_model(cfg.model_vos, cfg), cfg,
                             device="cpu")
    engine.model.load_state_dict(params)
    live, _ = engine.add_reference(np.zeros((1, *HW, 3), np.float32),
                                   np.zeros((1, *HW), np.int32),
                                   [cfg.model_max_obj_num], gap=5)
    for got, ref in zip(engine.state_tensors(live), state):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    flag = torch.tensor(engine.write_due(live))
    assert not bool(flag)
    with torch.no_grad():
        *new_state, label = loaded(*state, torch.from_numpy(img), flag)
        *_, label0 = prog.module()(*state, torch.from_numpy(img), flag)
    live, live_label = engine.step(
        engine.add_reference(np.zeros((1, *HW, 3), np.float32),
                             np.zeros((1, *HW), np.int32),
                             [cfg.model_max_obj_num], gap=5)[0], img, HW)
    jnew, jlabel = jexp.call(jparams, jstate, jnp.asarray(img))
    assert tuple(label.shape) == HW and label.dtype == torch.int32
    np.testing.assert_array_equal(label.numpy(), label0.numpy())
    np.testing.assert_array_equal(label.numpy(), live_label.numpy())
    np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    assert len(new_state) == len(InferenceEngine.STATE_FIELDS)
    assert [tuple(t.shape) for t in new_state] == [tuple(t.shape)
                                                   for t in state]
    assert int(new_state[2]) == int(np.asarray(jnew.bank.count)) == 1
    assert int(live.bank.count) == 1


def test_exported_write_flag_and_custom_ops(exported):
    """The graph holds the kernels as rmem:: ops; with the write flag set
    the step writes the bank (count 2) as the live engine does when its
    schedule is due (gap 1), and the outputs are new tensors: the inputs
    are left as they were."""
    _, _, _, prog, state, params, cfg = exported
    ops = {str(n.target) for n in prog.graph.nodes
           if str(n.target).startswith("rmem.")}
    assert ops == {"rmem.bank_attention_infer.default",
                   "rmem.local_attention.default"}
    before = [t.clone() for t in state]
    img = torch.from_numpy(_frame(1))
    with torch.no_grad():
        *new_state, label = prog.module()(*state, img, torch.tensor(True))
    for a, b in zip(state, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    engine = InferenceEngine(build_vos_model(cfg.model_vos, cfg), cfg,
                             device="cpu")
    engine.model.load_state_dict(params)
    live, _ = engine.add_reference(np.zeros((1, *HW, 3), np.float32),
                                   np.zeros((1, *HW), np.int32),
                                   [cfg.model_max_obj_num], gap=1)
    live, live_label = engine.step(live, img, HW)
    assert int(new_state[2]) == int(live.bank.count) == 2
    np.testing.assert_array_equal(label.numpy(), live_label.numpy())
    for got, ref in zip(new_state, engine.state_tensors(live)):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_export_cli_writes_a_loadable_artifact(tmp_path, capsys):
    """`python -m rmem_tpu_torch.tools.export --device cpu` writes a .pt2
    that torch.export.load reads back (with the rmem:: ops registered by
    the kernels' import)."""
    out = str(tmp_path / "tiny.pt2")
    port_export.main(["--stage", "test", "--model", "tiny_deaotl", "--hw",
                      "33", "33", "--out", out, "--device", "cpu"])
    assert "rmem.bank_attention_infer" in capsys.readouterr().out
    prog = torch.export.load(out)
    assert len(prog.graph_signature.user_outputs) == len(
        InferenceEngine.STATE_FIELDS) + 1

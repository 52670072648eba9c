"""Processes: data-parallel training and evaluation of the port over two
gloo ranks on the CPU, each held to one process, the port's counterparts
of tests/test_multihost_train.py and tests/test_multihost_eval.py; the
process group's start from the launcher's environment; the
tensor-parallel rule against JAX's spec_for_param, and a step split
across a (1, 2) ("data", "model") mesh against one rank's.

Each case starts its ranks as processes of their own
(tests/_torch_parallel_worker.py), joined through a free localhost port,
with a time limit. Tolerance of two ranks against one: the loss to 1e-5
relative and every weight to 1e-5 absolute. The steps take SGD, whose
update is linear in the gradient: the two clips' gradients are averaged
in another order than one batch's mean (they agree to ~2e-6 of each
tensor's largest), and Adam's first steps, which are sign-like, would
pass that rounding into the weights at up to twice a step's learning
rate wherever a gradient is near 0 (1.3e-4 after 3 steps here)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
TIMEOUT = 600
RTOL, ATOL = 1e-5, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(mode: str, outdir: str, ranks: int, *extra: str):
    """The worker as `ranks` processes of one group (0: one process, no
    group), `extra` after its mode and directory; returns each one's
    result."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    group = [dict(RANK=str(r), WORLD_SIZE=str(ranks), MASTER_ADDR="localhost",
                  MASTER_PORT=str(port)) for r in range(ranks)] or [{}]
    procs = [subprocess.Popen([sys.executable, WORKER, mode, outdir, *extra],
                              env=dict(env, **g), cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for g in group]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    tags = [f"r{r}" for r in range(ranks)] or ["one"]
    res = []
    for tag in tags:
        with open(os.path.join(outdir, f"{tag}.json")) as f:
            res.append(json.load(f))
    return res


def test_two_process_train_matches_one_process(tmp_path):
    """3 Trainer steps (SGD) of tiny_deaotl f32 at global batch 2 as two gloo
    ranks (a clip each: the rows of the global batch and id shuffle, the
    gradients averaged before Adam, the metrics before logging) against
    one process on both clips."""
    two = _run("train", str(tmp_path), 2)
    (one,) = _run("train", str(tmp_path), 0)
    assert two[0]["losses"] == two[1]["losses"]
    assert all(np.isfinite(two[0]["losses"]))
    assert two[0]["losses"][-1] < two[0]["losses"][0]
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=RTOL)
    p0, p1, ref = (np.load(os.path.join(str(tmp_path), f"params_{t}.npz"))
                   for t in ("r0", "r1", "one"))
    assert set(p0.files) == set(p1.files) == set(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        np.testing.assert_allclose(p0[k], ref[k], rtol=0, atol=ATOL,
                                   err_msg=k)


def test_two_process_eval_shards_and_allreduces(tmp_path):
    """The Evaluator as two ranks: the 3 sequences split by length,
    disjoint and covering, the global stats summed over the ranks, each
    rank's masks those of one process."""
    res = _run("eval", str(tmp_path), 2)
    (one,) = _run("eval", str(tmp_path), 0)
    n0, n1 = set(res[0]["seq_names"]), set(res[1]["seq_names"])
    assert n0 and n1 and not (n0 & n1)
    assert n0 | n1 == set(one["seq_names"]) and len(n0 | n1) == 3
    for r in res:
        # 3 sequences x (4 processed frames - the reference) = 9
        assert r["stats"]["global_frames"] == 9.0
        assert r["stats"]["global_seqs"] == 3.0
        assert r["stats"]["global_all_frame_fps"] > 0
    assert res[0]["stats"]["global_all_frame_fps"] == pytest.approx(
        res[1]["stats"]["global_all_frame_fps"], rel=1e-6)
    ref_root = os.path.join(str(tmp_path), "masks_one")
    for tag, names in (("r0", n0), ("r1", n1)):
        for name in names:
            d = os.path.join(str(tmp_path), f"masks_{tag}", name)
            files = sorted(os.listdir(d))
            assert len(files) == 4
            for fn in files:
                with open(os.path.join(d, fn), "rb") as a, \
                        open(os.path.join(ref_root, name, fn), "rb") as b:
                    assert a.read() == b.read(), (name, fn)


def test_two_process_eval_dynamic_tail_claims(tmp_path):
    """The dynamic tail under two ranks: the shortest sequence is claimed
    at run time by exactly one rank through the shared claim directory,
    the other two split by length; coverage complete, globals summed."""
    res = _run("eval_claim", str(tmp_path), 2)
    n0, n1 = set(res[0]["seq_names"]), set(res[1]["seq_names"])
    assert not (n0 & n1) and len(n0 | n1) == 3 and n0 and n1
    claims = os.listdir(os.path.join(str(tmp_path), "claims"))
    assert len(claims) == 1, claims
    for r in res:
        assert r["stats"]["global_frames"] == 9.0
        assert r["stats"]["global_seqs"] == 3.0


def test_maybe_initialize_distributed_is_a_no_op_unconfigured(monkeypatch):
    """Without a launcher's environment or arguments nothing starts: the
    process is rank 0 of 1, the stats are its own, and make_mesh asks for
    a group."""
    from rmem_tpu_torch import parallel
    from rmem_tpu_torch.parallel import eval_sharding
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not parallel.maybe_initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (eval_sharding.rank(), eval_sharding.world_size()) == (0, 1)
    assert parallel.allreduce_stats({"a": 2.0}) == {"a": 2.0}
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh((2,))


def test_shard_batch_takes_equal_rows():
    """Each data index takes its equal share of the global batch; a batch
    the data axis does not divide raises (the losses are batch means)."""
    from rmem_tpu_torch.parallel import mesh as pmesh

    class FakeMesh:            # data index 1 of 2
        mesh_dim_names = ("data",)

        def get_local_rank(self, name):
            return 1

        def size(self, dim):
            return 2

    x = torch.arange(8).reshape(4, 2)
    np.testing.assert_array_equal(pmesh.shard_rows(x, FakeMesh()).numpy(),
                                  x[2:].numpy())
    out = pmesh.shard_batch({"a": x, "b": x[:, 0]}, FakeMesh())
    assert out["b"].tolist() == [4, 6]
    with pytest.raises(ValueError, match="batch means"):
        pmesh.shard_rows(torch.zeros(3), FakeMesh())
    assert pmesh.resolve_shape((-1, 2), 4) == (2, 2)
    with pytest.raises(ValueError):
        pmesh.resolve_shape((3,), 4)


@pytest.mark.parametrize("model", ["tiny_deaotl", "tiny_aotl"])
def test_tp_rule_matches_jax_spec_for_param(model):
    """For every leaf of the JAX params tree, the port's rule on the
    parameter's name gives the partition JAX's spec_for_param gives its
    flax path; the split dim in the torch layout follows."""
    import jax
    from rmem_tpu.config import get_config as jget_config
    from rmem_tpu.models import build_vos_model as jbuild
    from rmem_tpu.models import init_params as jinit
    from rmem_tpu.parallel import spec_for_param as jspec
    from rmem_tpu_torch.parallel import tp

    cfg = jget_config("test", model=model)
    params = jinit(jbuild(cfg.model_vos, cfg), jax.random.PRNGKey(0),
                   (33, 33))
    split = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [str(k.key) for k in path]
        name = ".".join(keys[:-1] + (
            ["weight"] if keys[-1] == "kernel" else keys[-1:]))
        want = tuple(jspec(path))
        assert tp.spec_for_param(name) == want, name
        if want:
            split += 1
            dim = tp.torch_dim(name)
            assert dim == (1 - want.index("model") if keys[-1] == "kernel"
                           else want.index("model"))
    assert split == (2 * (2 * 4 + 1) if model == "tiny_deaotl" else 2)
    if model == "tiny_deaotl":       # the train state's entries follow
        from rmem_tpu_torch.config import get_config
        from rmem_tpu_torch.engine.train_state import TrainState
        from rmem_tpu_torch.models import build_vos_model
        pcfg = get_config("test", model=model)
        state = TrainState.create(build_vos_model(pcfg.model_vos, pcfg))
        specs = tp.state_shardings(state)
        assert set(specs) == {"params", "mu", "nu", "ema"}
        assert all(specs["ema"][n] == specs["params"][n] ==
                   tp.spec_for_param(n) for n in specs["params"])


# each model's split parameters: 2 layers x (4 column-parallel weights and
# biases + the projection) for DeAOT's GPM, 2 projections for AOT's LSTT
@pytest.mark.parametrize("model,split", [("tiny_deaotl", 18),
                                         ("tiny_aotl", 2)])
def test_tp_step_matches_one_rank(tmp_path, model, split):
    """2 Trainer steps (SGD) of the model in f32 with the self-attention
    split across the "model" axis of a (1, 2) mesh (DeAOT: each rank its
    half of the GPM's value and gate rows, the matching taps and
    projection columns; AOT: each rank its half of the output
    projection's input columns) against one unsplit process: the losses,
    equal on both ranks, to 1e-5; every weight, gathered whole, to
    1e-5."""
    two = _run("tp", str(tmp_path), 2, model)
    (one,) = _run("tp", str(tmp_path), 0, model)
    assert [r["split"] for r in two] == [split, split] and one["split"] == 0
    assert two[0]["losses"] == two[1]["losses"]
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=RTOL)
    p0, p1, ref = (np.load(os.path.join(str(tmp_path), f"params_{t}.npz"))
                   for t in ("r0", "r1", "one"))
    assert set(p0.files) == set(ref.files)
    for k in ref.files:
        assert p0[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        np.testing.assert_allclose(p0[k], ref[k], rtol=0, atol=ATOL,
                                   err_msg=k)

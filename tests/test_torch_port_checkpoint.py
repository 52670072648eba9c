"""Checkpoints in and out against the JAX package on the CPU: the
reference's .pth through the converter and the shape-tolerant merge, the
flax msgpack reader (with flax's bfloat16 leaves and chunked arrays, every
msgpack type tag, and no `msgpack` package), the checkpoint stream, and
the Trainer's pretrain load, stream and auto-resume.

The .pth files are fabricated from each model's JAX init tree by
`tests/test_checkpoint.py:_fabricate_torch_sd` (reference names and
layouts, BN running statistics with a positive variance), then given the
reference's wrapping: `module.` prefixes under a `state_dict` key, the id
bank's 11 input channels and a dead TIME_ENCODE key. Both sides must give
the same weights bit for bit (the port through `params_from_jax` of the
same numpy expressions) and the same skipped, extra, dead and unexpected
lists."""

import json
import os
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch
from test_checkpoint import _fabricate_torch_sd

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_params as jinit
from rmem_tpu.utils import checkpoint as jckpt
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data.synthetic import blob_batches
from rmem_tpu_torch.managers import trainer as trainer_mod
from rmem_tpu_torch.managers.trainer import Trainer
from rmem_tpu_torch.models import build_vos_model, load_model_params
from rmem_tpu_torch.tools import train as train_cli
from rmem_tpu_torch.utils import checkpoint as ckpt
from rmem_tpu_torch.utils.checkpoint import params_from_jax

REPO = Path(__file__).resolve().parents[1]
HW = (33, 33)          # the init's input: the parameters do not depend on it
DEAD_KEY = "LSTT.layers.0.Q_time_encode.0.weight"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_init(model, **over):
    cfg = jget_config("pre_vost", model=model, **over)
    return cfg, jinit(jbuild(cfg.model_vos, cfg), jax.random.PRNGKey(0), HW)


@pytest.fixture(scope="module")
def deaotl():
    return _jax_init("r50_deaotl")


@pytest.fixture(scope="module")
def aotl():
    """R50-AOTL with RMem's ConvGRU memory: its tree holds the GRU cells."""
    return _jax_init("r50_aotl", gru_memory=True)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _reference_sd(cfg, jparams, drop=(), gru=False):
    """The reference's layout of jparams' names and shapes, seeded values;
    with `gru`, each layer's two GRU memory cells under the reference's
    names (memory_grus.0 the K plane's 2 x 2, memory_grus.1 the V plane's
    1 x 1)."""
    flat = {k: v for k, v in _flat(jax.device_get(jparams))
            if not any(p.startswith("memory_gru") for p in k)}
    sd = _fabricate_torch_sd(flat, cfg.model_vos)
    sd["patch_wise_id_bank.weight"] = sd["patch_wise_id_bank.weight"][:, :11]
    sd[DEAD_KEY] = np.ones((4, 4), np.float32)
    rng = np.random.RandomState(2)
    d = cfg.model_encoder_embedding_dim
    for i in range(cfg.model_lstt_num if gru else 0):
        for g, k in ((0, 2), (1, 1)):
            t = f"LSTT.layers.{i}.memory_grus.{g}"
            for name, shape in (
                    ("conv_gru_cell.conv_gates.weight", (2 * d, 2 * d, k, k)),
                    ("conv_gru_cell.conv_gates.bias", (2 * d,)),
                    ("conv_gru_cell.conv_can.weight", (d, 2 * d, k, k)),
                    ("conv_gru_cell.conv_can.bias", (d,)),
                    ("output_conv.weight", (d, d, 1, 1)),
                    ("output_conv.bias", (d,))):
                sd[f"{t}.{name}"] = rng.randn(*shape).astype(np.float32)
    for key in drop:
        del sd[key]
    return sd


def _write_pth(sd, path):
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return str(path)


def _both(cfg, jparams, path):
    """(JAX merged tree, its skipped, extra, converter report) and the
    port's (model, report) for one .pth."""
    jtree, jskipped, jextra = jckpt.load_pretrained(
        jparams, path, cfg.model_vos, cfg.id_channels)
    sd = jckpt.load_torch_state_dict(path)
    jrep = {}
    jckpt.convert_torch_checkpoint(sd, cfg.model_vos, cfg.model_lstt_num,
                                   cfg.id_channels, report=jrep)
    model = build_vos_model(cfg.model_vos, get_config(
        "pre_vost", model=("r50_aotl" if cfg.model_vos == "aot"
                           else "r50_deaotl"), gru_memory=cfg.gru_memory))
    rep, lines = {}, []
    load_model_params(model, path, report=rep, log=lines.append)
    return (jtree, jskipped, jextra, jrep), (model, rep, lines)


@pytest.mark.parametrize("which", ["deaotl", "aotl"])
def test_pth_loads_as_jax_loads_it(which, request, tmp_path):
    cfg, jparams = request.getfixturevalue(which)
    sd = _reference_sd(cfg, jparams, gru=which == "aotl")
    path = _write_pth(sd, tmp_path / "ref.pth")
    (jtree, jskipped, jextra, jrep), (model, rep, lines) = _both(
        cfg, jparams, path)
    ref = params_from_jax(jtree)
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for name, t in got.items():
        assert torch.equal(t, ref[name]), name
    assert rep["skipped"] == jskipped == []
    # the GRU cells load into the GRU model on both sides: nothing extra
    assert rep["extra"] == jextra == []
    gru = [n for n in got if "memory_gru" in n]
    assert len(gru) == (3 * 2 * 6 if which == "aotl" else 0)
    if gru:
        assert torch.equal(got["lstt.block1.memory_gru_k.cell.conv_can."
                                "weight"], torch.from_numpy(sd[
                                    "LSTT.layers.1.memory_grus.0."
                                    "conv_gru_cell.conv_can.weight"]))
    assert rep["dead_keys"] == jrep["dead_keys"] == [DEAD_KEY]
    assert rep["unexpected_keys"] == jrep["unexpected_keys"] == []
    bank = got["patch_wise_id_bank.weight"]               # OIHW, 12 in
    assert bank.shape[1] == 12 and not bank[:, 11].any()
    assert any("dropped 1 reference-dead" in ln for ln in lines)


def test_partial_pth_skips_what_jax_skips(deaotl, tmp_path):
    """A DeAOT checkpoint from before RMem (no temporal PEs) and one layer
    of another width: the same skipped paths and shapes (flax layout) on
    both sides, every other weight bit-equal. The skipped leaves keep each
    side's own init, which differ."""
    cfg, jparams = deaotl
    sd = _reference_sd(cfg, jparams, drop=("cur_pos_emb", "mem_pos_emb"))
    sd["decoder.conv_out.weight"] = sd["decoder.conv_out.weight"][:-1]
    path = _write_pth(sd, tmp_path / "partial.pth")
    (jtree, jskipped, _, _), (model, rep, lines) = _both(cfg, jparams, path)
    assert sorted(rep["skipped"]) == sorted(jskipped)
    assert {s[1] for s in jskipped} == {
        ("cur_pos_emb",), ("mem_pos_emb",), ("decoder", "conv_out", "kernel")}
    assert any("skipped 3 entries" in ln for ln in lines)
    skipped = {".".join(s[1]).replace("kernel", "weight") for s in jskipped}
    ref = params_from_jax(jtree)
    for name, t in model.state_dict().items():
        if name not in skipped:
            assert torch.equal(t, ref[name]), name


def _assert_trees_equal(got, ref, where=()):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), where
        for k in ref:
            _assert_trees_equal(got[k], ref[k], where + (k,))
    elif isinstance(ref, (np.ndarray, jax.Array)):
        ref = np.asarray(ref)
        widened = ref.dtype == jax.numpy.bfloat16
        assert got.dtype == (np.float32 if widened else ref.dtype), where
        assert got.shape == ref.shape, where
        np.testing.assert_array_equal(got, ref.astype(got.dtype),
                                      err_msg=str(where))
    else:
        assert got == ref and type(got) is type(ref), where


def test_msgpack_reads_jax_params(deaotl, aotl, tmp_path):
    """Both models' init trees as the JAX package saves them (R50-AOTL's
    with the GRU memory's cells): the port's reader gives flax's own
    restore, and load_model_params the weights of params_from_jax."""
    for name, (cfg, jparams) in (("r50_deaotl", deaotl),
                                 ("r50_aotl", aotl)):
        path = str(tmp_path / f"{name}.msgpack")
        jckpt.save_pytree(jparams, path)
        data = Path(path).read_bytes()
        _assert_trees_equal(ckpt.msgpack_restore(data),
                            flax.serialization.msgpack_restore(data))
        model = build_vos_model(cfg.model_vos, get_config(
            "pre_vost", model=name, gru_memory=cfg.gru_memory))
        load_model_params(model, path, log=lambda s: None)
        ref = params_from_jax(jax.device_get(jparams))
        for key, t in model.state_dict().items():
            assert torch.equal(t, ref[key]), key


def test_msgpack_bfloat16_and_chunked_arrays(monkeypatch):
    """A bfloat16 leaf (widened to f32, exactly), scalars, and arrays over
    flax's MAX_CHUNK_SIZE, which flax writes as chunk dicts."""
    rng = np.random.RandomState(0)
    tree = {"a": {"w": rng.randn(37, 5).astype(np.float32),
                  "bf": jax.numpy.asarray(rng.randn(3, 7),
                                          jax.numpy.bfloat16),
                  "i": np.arange(11, dtype=np.int32)},
            "step": np.int32(7), "s": np.float32(0.25),
            "big": rng.randn(300).astype(np.float64)}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = ckpt.msgpack_restore(data)
    _assert_trees_equal(got, flax.serialization.msgpack_restore(data))
    assert got["big"].shape == (300,) and got["a"]["w"].shape == (37, 5)


def _every_tag():
    """Objects whose msgpack encoding uses every type byte, one family a
    list entry."""
    rng = np.random.RandomState(5)
    s = lambda n: "".join(chr(97 + i) for i in rng.randint(0, 26, n))
    b = lambda n: rng.randint(0, 256, n).astype(np.uint8).tobytes()
    return [
        [0, 127, -1, -32],                                  # fixints
        [200, 60_000, 4_000_000_000, 2 ** 63],              # uint 8..64
        [-100, -30_000, -2_000_000_000, -2 ** 62],          # int 8..64
        [None, True, False, 1.5, -2.25e300],                # nil, bool, f64
        [s(5), s(200), s(70_000), s(300)],                  # str fix, 8..32
        [b(3), b(70_000), b(300)],                          # bin 8, 32, 16
        list(range(20)), list(range(70_000)),               # array 16, 32
        {s(3): i for i in range(20)},                       # map 16
        {f"k{i}": i for i in range(70_000)},                # map 32
        {"x": {"y": [1, {"z": None}]}},                     # fixmap, fixarray
        [msgpack.ExtType(c, b(n)) for c, n in                # fixext, ext
         ((5, 1), (6, 2), (7, 4), (8, 8), (9, 16), (10, 3), (11, 300),
          (12, 70_000), (13, 5))],
    ]


def test_msgpack_reader_matches_msgpack_on_every_tag():
    objs = _every_tag()
    tags = set()
    for obj in objs:
        data = msgpack.packb(obj, use_bin_type=True)
        assert ckpt.unpackb(data) == msgpack.unpackb(data, raw=False), obj
        tags.add(data[0])
        for item in (obj.values() if isinstance(obj, dict) else obj):
            tags.add(msgpack.packb(item, use_bin_type=True)[0])
    f32 = msgpack.packb([0.5, -3.25], use_single_float=True)
    assert ckpt.unpackb(f32) == msgpack.unpackb(f32) == [0.5, -3.25]
    tags.add(f32[1])
    fixed = {0xc0, 0xc2, 0xc3} | set(range(0xc4, 0xe0)) - {0xc1}
    assert fixed <= tags, sorted(hex(t) for t in fixed - tags)
    for first, last in ((0x80, 0x8f), (0x90, 0x9f), (0xa0, 0xbf),
                        (0x00, 0x7f), (0xe0, 0xff)):
        assert any(first <= t <= last for t in tags), hex(first)
    with pytest.raises(ValueError):
        ckpt.unpackb(msgpack.packb([1, 2, 3])[:-1])


def test_msgpack_read_without_the_msgpack_package(deaotl, tmp_path):
    """In a fresh interpreter where msgpack, flax, jax and rmem_tpu cannot
    be imported (as on the card's machine), the reader gives the tree the
    JAX package saved."""
    _, jparams = deaotl
    path = str(tmp_path / "p.msgpack")
    jckpt.save_pytree(jparams, path)
    code = ("import sys\n"
            "for m in ('msgpack', 'flax', 'jax', 'rmem_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import json\n"
            "from rmem_tpu_torch.utils.checkpoint import load_msgpack\n"
            "def walk(t, p=''):\n"
            "    for k, v in t.items():\n"
            "        if isinstance(v, dict):\n"
            "            yield from walk(v, p + k + '/')\n"
            "        else:\n"
            "            yield p + k, float(v.astype('float64').sum())\n"
            f"print(json.dumps(dict(walk(load_msgpack({path!r})))))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    sums = json.loads(r.stdout)
    ref = {"/".join(k): float(np.asarray(v, np.float64).sum())
           for k, v in _flat(jax.device_get(jparams))}
    assert sums == ref


def _tree():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}


def test_stream_keeps_what_jax_keeps(tmp_path):
    """The same step sequences and max_keep: the same steps kept, and the
    same latest, as the JAX package's stream."""
    for n, (steps, keep) in enumerate((([500, 1000, 1500], 2),
                                       ([3, 1, 2, 10, 7], 3),
                                       ([2, 4, 6, 8], 8), ([5], 1))):
        jdir, pdir = str(tmp_path / f"j{n}"), str(tmp_path / f"p{n}")
        for s in steps:
            jckpt.save_checkpoint(_tree(), jdir, s, max_keep=keep)
            ckpt.save_checkpoint({"w": torch.ones(2)}, pdir, s,
                                 max_keep=keep, log=lambda m: None)
        kept = lambda d, ext: sorted(int(f.split("_")[-1].split(".")[0])
                                     for f in os.listdir(d)
                                     if f.endswith(ext))
        assert kept(pdir, ".pt") == kept(jdir, ".msgpack")
        assert len(os.listdir(pdir)) == len(os.listdir(jdir))
        assert ckpt.latest_checkpoint(pdir)[1] == \
            jckpt.latest_checkpoint(jdir)[1]


def test_save_is_atomic_and_a_truncated_save_falls_back(tmp_path,
                                                        monkeypatch):
    """A torch.save that raises mid-write leaves nothing at the final name
    (and no temporary file); a truncated newest save is logged and the one
    before it loads."""
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint({"step": 1, "w": torch.ones(3)}, d, 1, log=print)
    save = torch.save

    def failing(obj, f):
        with open(f, "wb") as out:
            out.write(b"PK\x03\x04 partial")
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(RuntimeError, match="mid-write"):
        ckpt.save_checkpoint({"w": torch.ones(3)}, d, 2, log=print)
    monkeypatch.setattr(torch, "save", save)
    assert os.listdir(d) == ["save_step_1.pt"]
    ckpt.save_checkpoint({"step": 3, "w": torch.ones(3)}, d, 3, log=print)
    path = os.path.join(d, "save_step_3.pt")
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:len(data) // 2])
    lines = []
    obj, step, found = ckpt.load_latest_checkpoint(d, log=lines.append)
    assert (step, obj["step"], os.path.basename(found)) == (
        1, 1, "save_step_1.pt")
    assert len(lines) == 1 and "save_step_3.pt unreadable" in lines[0]


def test_unwritable_dir_falls_back_to_saved_models(tmp_path, monkeypatch):
    """An OSError from the result volume: the save lands in ./saved_models
    (under the working directory), as the reference's does."""
    monkeypatch.chdir(tmp_path)
    Path("blocker").write_text("a file, not a directory")
    lines = []
    path = ckpt.save_checkpoint({"w": torch.ones(2)}, "blocker/ckpt", 4,
                                log=lines.append)
    assert path == os.path.join("./saved_models", "save_step_4.pt")
    assert torch.load(path, weights_only=True)["w"].sum() == 2
    assert "retrying in ./saved_models" in lines[0]


def _tiny_cfg(tmp_path, **over):
    return get_config("test", model="tiny_deaotl", compute_dtype="float32",
                      train_batch_size=1, data_randomcrop=(65, 65),
                      dir_root=str(tmp_path / "results"), train_save_step=1,
                      train_max_keep_ckpt=2, **over)


def _assert_states_equal(a, b):
    sa, sb = a.state.state_dict(), b.state.state_dict()
    assert sa["step"] == sb["step"]
    for key in ("params", "mu", "nu", "ema"):
        for name in sa[key]:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)


def test_trainer_stream_and_auto_resume(tmp_path):
    """3 steps saving every step and keeping 2: steps 2 and 3 in each
    stream; a new trainer with auto-resume starts at step 3 with the saved
    state, the host RNG included (its next id shuffle is the first
    trainer's); with
    step 3's save truncated it resumes from step 2 and says so; the EMA
    stream loads through load_model_params."""
    cfg = _tiny_cfg(tmp_path)
    first = Trainer(cfg, device="cpu", seed=3, log=lambda s: None,
                    batches=blob_batches(cfg, 5))
    first.train(max_steps=3)
    ckpt_dir, ema_dir = first.ckpt_dir, first.ema_dir
    assert ckpt_dir.startswith(str(tmp_path))
    assert sorted(os.listdir(ckpt_dir)) == ["save_step_2.pt",
                                            "save_step_3.pt"]
    assert sorted(os.listdir(ema_dir)) == ["ema_step_2.pt", "ema_step_3.pt"]
    lines = []
    resumed = Trainer(cfg.replace(train_auto_resume=True), device="cpu",
                      seed=9, log=lines.append)
    _assert_states_equal(resumed, first)
    assert resumed.rng.randint(1 << 30) == first.rng.randint(1 << 30)
    assert lines[-1].startswith("auto-resumed from ") and "(step 3)" in \
        lines[-1]
    model = build_vos_model("deaot", cfg)
    ema_path = os.path.join(ema_dir, "ema_step_3.pt")
    load_model_params(model, ema_path, log=lambda s: None)
    for name, t in model.state_dict().items():
        assert torch.equal(t, first.state.ema[name]), name
    with pytest.raises(ValueError, match="holds only EMA weights"):
        load_model_params(model, ema_path, ema=False)
    old = str(tmp_path / "before_the_stream.pt")   # the RNG as numpy
    torch.save({"state": first.state.state_dict(),
                "rng": first.rng.get_state()}, old)
    with pytest.raises(ValueError, match="RNG as a numpy tuple"):
        load_model_params(model, old)
    path = os.path.join(ckpt_dir, "save_step_3.pt")
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:len(data) // 2])
    lines = []
    fallback = Trainer(cfg.replace(train_auto_resume=True), device="cpu",
                       seed=9, log=lines.append)
    assert fallback.state.step == 2
    assert any("save_step_3.pt unreadable" in ln for ln in lines)
    assert "(step 2)" in lines[-1]


def test_trainer_pretrains_from_a_jax_msgpack(tmp_path):
    """pretrain_model a JAX params tree: the trainer's first parameters
    are params_from_jax of that tree."""
    jcfg = jget_config("test", model="tiny_deaotl")
    jparams = jinit(jbuild(jcfg.model_vos, jcfg), jax.random.PRNGKey(4))
    path = str(tmp_path / "pre.msgpack")
    jckpt.save_pytree(jparams, path)
    trainer = Trainer(_tiny_cfg(tmp_path, pretrain=True, pretrain_model=path),
                      device="cpu", seed=3, log=lambda s: None)
    ref = params_from_jax(jax.device_get(jparams))
    for name, p in trainer.state.model.named_parameters():
        assert torch.equal(p.detach(), ref[name]), name
        assert torch.equal(trainer.state.ema[name], ref[name]), name


def test_train_cli_pretrained_path(monkeypatch, tmp_path):
    """--pretrained_path sets pretrain_model, as the JAX CLI's does;
    --resume loads the save or stream directory it names and stops when it
    holds none; --save saves the stream after the run."""
    built, calls = [], []

    class Recorder:
        def __init__(self, cfg, **kw):
            built.append(cfg)

        def load(self, path):
            calls.append(("load", path))
            return None if path == "empty" else path

        def train(self, max_steps=None):
            calls.append(("train", max_steps))
            return {}

        def save(self, step=None):
            calls.append(("save", step))

        def close(self):
            pass

    monkeypatch.setattr(trainer_mod, "Trainer", Recorder)
    out = ["--opt", f"dir_root={tmp_path}"]      # the run's config and logs
    train_cli.main(["--device", "cpu", "--max_steps", "1",
                    "--pretrained_path", "R50_DeAOTL.pth", *out])
    assert (built[0].pretrain_model, built[0].pretrain) == (
        "R50_DeAOTL.pth", True)
    assert calls == [("train", 1)]
    train_cli.main(["--device", "cpu", "--max_steps", "2", "--resume",
                    "results/ckpt", "--save", *out])
    assert calls[1:] == [("load", "results/ckpt"), ("train", 2),
                         ("save", None)]
    with pytest.raises(SystemExit, match="no readable save in empty"):
        train_cli.main(["--device", "cpu", "--resume", "empty", *out])

"""AOT (the LSTT family) in the port against the JAX package, f32 on the
CPU, with the same weights (moved over by params_from_jax) on the same
inputs made from numpy seeds: the LSTT block and stack, the memory writes,
the weight bridge and seeded weights on tiny_aotl and r50_aotl, the
tiny_aotl engine teacher-forced through an eviction, and the bank
attention's route rule by head shape."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as trav

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.models import init_params as jinit
from rmem_tpu.models.lstt import LSTT as JLSTT
from rmem_tpu.models.lstt import LSTTBlock as JLSTTBlock
from rmem_tpu.ops.resize import resize_bilinear as jresize_bilinear
from rmem_tpu.ops.resize import resize_nearest as jresize_nearest
from rmem_tpu.ops.resize import upsample_argmax as jupsample_argmax
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.models.encoders import fold_bn_params
from rmem_tpu_torch.models.lstt import LSTT, LSTTBlock
from rmem_tpu_torch.ops.resize import upsample_argmax
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# f32 on both sides: a block's dozen matmuls sum in another order (XLA vs
# ATen), so outputs agree to ~1e-6 of their scale
BLOCK_TOL = 1e-5
# the engine's logits pass the encoder, the stack and the FPN
LOGIT_TOL = 1e-4
# labels may differ only where the top-2 upsampled logits are this close
TIE_EPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _init(module, rng, *args, amount=0.1, **kwargs):
    """Variables of a flax module on the shapes of `jax.eval_shape` of its
    init, drawn with numpy: kernels lecun-normal, scales 1, other leaves 0,
    each offset by `amount` x N(0, 1) so unit scales and zero biases take
    part."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args, **kwargs),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            base = rng.randn(*s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif name == "scale":
            base = np.ones(s.shape)
        else:
            base = np.zeros(s.shape)
        return (base + amount * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(out, ref, rel):
    """max |out - ref| <= rel * max |ref|."""
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _model_tree(model: str, rng=None):
    """The JAX AOT model and its parameter tree as numpy (zeros, or
    `_init`'s draws from `rng`) on the shapes of one reference pass."""
    cfg = jget_config("pre_vost", model=model, compute_dtype="float32")
    jm = jbuild(cfg.model_vos, cfg)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, cfg.id_channels), jnp.float32)
    if rng is None:
        shapes = jax.eval_shape(
            lambda r: jm.init(r, img, oh, method=init_forward),
            jax.random.PRNGKey(0))["params"]
        return jm, jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)
    return jm, _init(jm, rng, img, oh, method=init_forward)["params"]


@pytest.mark.parametrize("model", ["tiny_aotl", "r50_aotl"])
def test_aot_presets_match_jax(model):
    """Every field of the port's Config reads as in the JAX preset, and the
    stack takes 8 self- and 8 bank-attention heads (32 wide at r50_aotl)."""
    port = get_config("pre_vost", model=model)
    ref = jget_config("pre_vost", model=model)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    lstt = build_vos_model("aot", port).lstt
    assert lstt.block(0).att_heads == lstt.block(0).self_attn.num_heads == 8
    assert lstt.num_layers == ref.model_lstt_num and not port.model_linear_q


def _block_inputs(rng, d, hw, s, pad):
    r = lambda *sh: jnp.asarray(rng.randn(*sh).astype(np.float32))
    return dict(tgt=r(1, hw, d), bank_k=r(s, 1, hw + pad, d),
                bank_v=r(s, 1, hw + pad, d), short_k=r(1, hw, d),
                short_v=r(1, hw, d), id_emb=r(1, hw, d),
                self_pos=r(1, hw, d), cur_pe=r(1, d), slot_pe=r(s, d))


@pytest.mark.parametrize("frame,linear_q", [("reference", False),
                                             ("memory", False),
                                             ("memory", True)])
def test_lstt_block_matches_jax(frame, linear_q):
    """One LSTT block at tiny_aotl widths (d 64, 8 heads of 8, FFN 1024) on
    a 5 x 6 grid. The reference frame attends to itself (id_emb, one slot);
    a memory frame reads 3 slots with 2 valid, keys padded 5 past true_lk,
    the slot PE and the short-term memory, with the default short-term form
    and with linear_q's concatenation. Output, mems and the slot mass
    within BLOCK_TOL of scale."""
    rng = np.random.RandomState(3 + linear_q)
    d, size, s, count = 64, (5, 6), 3, 2
    hw = size[0] * size[1]
    x = _block_inputs(rng, d, hw, s, pad=5)
    ref = frame == "reference"
    jb = JLSTTBlock(d, 8, 8, 1024, linear_q=linear_q)
    args = (x["tgt"], None if ref else x["bank_k"],
            None if ref else x["bank_v"], jnp.arange(s) < count,
            None if ref else x["short_k"], None if ref else x["short_v"],
            x["id_emb"] if ref else None, x["self_pos"], x["cur_pe"],
            x["slot_pe"][:1] if ref else x["slot_pe"])
    # init through the reference path and the memory write, so every
    # parameter exists
    init_args = (x["tgt"], x["bank_k"], x["bank_v"], jnp.arange(s) < count,
                 x["short_k"], x["short_v"], x["id_emb"], x["self_pos"],
                 x["cur_pe"], x["slot_pe"][:1], size)

    def forward_and_write(m, *a):
        out = m(*a)
        m.project_memories(out[1]["curr_v"], out[1]["short_v"], a[6])
        return out

    var = _init(jb, rng, *init_args, amount=0.02, method=forward_and_write)
    jt, jmems, jrec = jax.jit(lambda v, a: jb.apply(
        v, *a, size, need_record=True))(var, args)

    tb = LSTTBlock(d, 8, 8, 1024, linear_q=linear_q).eval()
    tb.load_state_dict(params_from_jax(var["params"]), strict=True)
    with torch.no_grad():
        tt, tmems, trec = tb(
            _t(args[0]), _t(args[1]), _t(args[2]),
            torch.tensor(1 if ref else count, dtype=torch.int32),
            _t(args[4]), _t(args[5]), _t(args[6]), _t(args[7]),
            _t(args[8]), _t(args[9]), size,
            true_lk=None if ref else hw)
    _close(tt, jt, BLOCK_TOL)
    for key in ("curr_k", "curr_v", "short_k", "short_v"):
        _close(tmems[key], jmems[key], BLOCK_TOL)
    _close(trec, jrec, BLOCK_TOL)
    assert np.all(trec.numpy()[..., 1 if ref else count:] == 0.0)


def test_lstt_stack_matches_jax():
    """Two LSTT layers with the intermediate norms: the reference frame,
    then a memory frame reading a 4-slot bank (3 valid) of the reference
    frame's written memories beside random ones. Intermediates, mems and
    layer 0's slot mass within BLOCK_TOL of scale."""
    rng = np.random.RandomState(7)
    d, size, L, s = 64, (4, 5), 2, 4
    hw = size[0] * size[1]
    r = lambda *sh: jnp.asarray(rng.randn(*sh).astype(np.float32))
    tgt, id_emb, self_pos = r(1, hw, d), r(1, hw, d), r(1, hw, d)
    cur_pe, slot_pe = r(1, d), r(s, d)
    jl = JLSTT(L, d, 8, 8)

    def forward_and_write(m, *a):
        out = m(*a)
        m.project_memories(out[1], a[4])
        return out

    var = _init(jl, rng, tgt, None, None, None, id_emb, self_pos, cur_pe,
                slot_pe[:1], size, amount=0.02, method=forward_and_write)
    tl = LSTT(L, d, 8, 8).eval()
    tl.load_state_dict(params_from_jax(var["params"]), strict=True)

    jinter, jmems, _ = jax.jit(lambda v: jl.apply(
        v, tgt, None, None, None, id_emb, self_pos, cur_pe, slot_pe[:1],
        size))(var)
    with torch.no_grad():
        tinter, tmems, _ = tl(_t(tgt), None, None, None, _t(id_emb),
                              _t(cur_pe), _t(slot_pe[:1]), size,
                              self_pos=_t(self_pos))
    for a, b in zip(tinter, jinter):
        _close(a, b, BLOCK_TOL)

    bank_k = jnp.stack([jmems["curr_k"]] + [r(L, 1, hw, d)
                                            for _ in range(s - 1)], axis=1)
    bank_v = r(L, s, 1, hw, d)
    short = (r(L, 1, hw, d), r(L, 1, hw, d))
    tgt2 = r(1, hw, d)
    jinter, jmems, jrec = jax.jit(lambda v: jl.apply(
        v, tgt2, (bank_k, bank_v), jnp.arange(s) < 3, short, None, self_pos,
        cur_pe, slot_pe, size, need_record=True))(var)
    with torch.no_grad():
        tinter, tmems, trec = tl(
            _t(tgt2), (_t(bank_k), _t(bank_v)),
            torch.tensor(3, dtype=torch.int32), (_t(short[0]), _t(short[1])),
            None, _t(cur_pe), _t(slot_pe), size, self_pos=_t(self_pos))
    for a, b in zip(tinter, jinter):
        _close(a, b, BLOCK_TOL)
    for key in jmems:
        _close(tmems[key], jmems[key], BLOCK_TOL)
    _close(trec, jrec, BLOCK_TOL)


def test_write_memories_matches_jax():
    """The AOT model's memory write on tiny_aotl weights: (curr_k,
    linear_V(curr_v + id), short_k, linear_VMem(short_v + id)) per layer."""
    rng = np.random.RandomState(11)
    jm, tree = _model_tree("tiny_aotl", rng)
    port = build_vos_model("aot", get_config("pre_vost", model="tiny_aotl",
                                             compute_dtype="float32"))
    port.load_state_dict(params_from_jax(tree), strict=True)
    L, hw, d = 2, 12, 64
    mems = {key: rng.randn(L, 1, hw, d).astype(np.float32)
            for key in ("curr_k", "curr_v", "short_k", "short_v")}
    id_emb = rng.randn(1, hw, d).astype(np.float32)
    ref = jm.apply({"params": tree}, {k: jnp.asarray(v)
                                      for k, v in mems.items()},
                   jnp.asarray(id_emb), method=type(jm).write_memories)
    with torch.no_grad():
        out = port.write_memories({k: _t(v) for k, v in mems.items()},
                                  _t(id_emb))
    for a, b in zip(out, ref):
        _close(a, b, BLOCK_TOL)
    # the keys are passed through as they are
    assert torch.equal(out[0], _t(mems["curr_k"]))
    assert torch.equal(out[2], _t(mems["short_k"]))


@pytest.mark.parametrize("model", ["tiny_aotl", "r50_aotl"])
def test_params_from_jax_and_init_params_cover_the_aot_tree(model):
    """Every JAX leaf lands on a port parameter of its shape and every port
    parameter is set (strict load); init_params sets every parameter (each
    starts as NaN here), LayerNorm scales to 1 and biases to 0; the bf16
    engine's BN fold covers the ResNet-50 encoder."""
    _, tree = _model_tree(model)
    sd = params_from_jax(tree)
    assert len(sd) == len(trav.flatten_dict(tree))
    port = build_vos_model("aot", get_config("pre_vost", model=model))
    port.load_state_dict(sd, strict=True)
    for name, p in port.state_dict().items():
        assert p.shape == sd[name].shape, name

    with torch.no_grad():
        for p in port.parameters():
            p.fill_(float("nan"))
    init_params(port, seed=0)
    norms = [n for n, m in port.named_modules()
             if type(m).__name__ == "LayerNorm"]
    # norm1 to norm4 of each block, and one decoder norm per block
    assert len(norms) == 5 * port.cfg.model_lstt_num
    for name, p in port.named_parameters():
        assert torch.isfinite(p).all(), name
        if name.rsplit(".", 1)[0] in norms:
            assert torch.all(p == (1.0 if name.endswith(".scale") else 0.0))
    if model == "r50_aotl":
        folded = fold_bn_params(port.state_dict())
        scales = [k for k in folded if k.startswith("encoder.")
                  and k.endswith(".scale")]
        assert len(scales) == 43
        assert all(torch.all(folded[k] == 1) for k in scales)


HW = (64, 64)
OUT_HW = (60, 70)
FRAMES = 9


def test_engine_matches_jax_teacher_forced():
    """tiny_aotl at 64 x 64, 1 + 2 slots and a long-term write every 2
    frames: the bank fills on frame 4 and evicts on frames 6 and 8. Both
    engines share the weights and are teacher-forced with the JAX labels.
    Per frame: logits within LOGIT_TOL of scale, labels equal except at
    near ties, the slot mass, and the bank's count, order, ages, scores and
    contents as the JAX bank's (the same eviction victims)."""
    over = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=2)
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
    mask[:, 0:4, 0:64] = 255          # an ignore band
    js, jlog = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask),
                                  [2], gap=2)
    ps, plog = peng.add_reference(imgs[0], mask, [2], gap=2)
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
    assert counts == [1, 2, 2, 3, 3, 3, 3, 3, 3]
    assert evicted == 2


def test_bank_attention_route_by_head_shape():
    """The rule the card's bank-attention wrapper dispatches on: one or two
    heads of 128 (values a multiple of 256 a head, or 128 a head at two:
    AOT's no_memory_gap) to K1's template, 8 heads of 32 to K1ʰ, any other
    head shape raises."""
    assert kb.infer_route(1, 128, 1024) == "slots"
    assert kb.infer_route(1, 128, 256) == "slots"
    assert kb.infer_route(2, 128, 512) == "slots"
    assert kb.infer_route(2, 128, 128) == "slots"
    assert kb.infer_route(8, 32, 32) == "heads"
    for shape in ((1, 128, 128), (8, 32, 64), (8, 8, 8),
                  (4, 64, 64), (1, 64, 256)):
        with pytest.raises(ValueError, match="heads of width"):
            kb.infer_route(*shape)

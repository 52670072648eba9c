"""DeAOT with `no_memory_gap` (2 attention heads, a long-term write every
frame) in the port against the JAX package, f32 on the CPU, on the same
inputs made from numpy seeds: the config, one GPM block in training mode at
2 heads, the plain versions of the bank attention (K1, K3) and the local
attention (K4) at 2 heads against the Pallas kernels in interpret mode, the
bias's head-major form that K4 reads at 2 heads, the route rule, the weight
bridge on the 2-head tree and the tiny_deaotl engine teacher-forced through
evictions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as trav
from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.kernels.bank_attention import (pallas_bank_attention_infer,
                                             pallas_bank_attention_qminor)
from rmem_tpu.kernels.local_attention import pallas_local_attention
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.models import init_params as jinit
from rmem_tpu.models.gpm import GPMBlock as JGPMBlock
from rmem_tpu.ops.resize import resize_bilinear as jresize_bilinear
from rmem_tpu.ops.resize import resize_nearest as jresize_nearest
from rmem_tpu.ops.resize import upsample_argmax as jupsample_argmax
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.kernels import local_attention as kl
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.models.gpm import GPMBlock
from rmem_tpu_torch.ops.resize import upsample_argmax
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# f32 on both sides; the Pallas kernels and XLA sum in another order, so
# the kernels' plain versions agree to a few f32 ulps of O(1) values
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
# a GPM block's dozen matmuls, forward and backward: ~1e-6 of scale
BLOCK_TOL = 2e-5
GRAD_TOL = 1e-4
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


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def _close(out, ref, rel):
    """max |out - ref| <= rel * max |ref|."""
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("model", ["tiny_deaotl", "r50_deaotl"])
def test_nomemgap_config_matches_jax(model):
    """Every field of the port's Config reads as in the JAX config with
    no_memory_gap: 2 attention heads, a long-term write every training
    frame; the GPM then runs 2 heads of d/2 with a 2 x 225 bias."""
    port = get_config("pre_vost", model=model, no_memory_gap=True)
    ref = jget_config("pre_vost", model=model, no_memory_gap=True)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.model_att_heads, port.train_long_term_mem_gap) == (2, 1)
    block = build_vos_model("deaot", port).lstt.block(0)
    d = port.model_encoder_embedding_dim
    assert (block.att_heads, block.d_att) == (2, d // 2)
    assert block.relative_emb_k.out_features == 2 * 225


def test_gpm_block_trains_at_two_heads():
    """One GPM block in training mode (the differentiable bank and local
    attention) at 2 heads of 32 (d 64), layer 1 on an 8 x 8 grid, a 4-slot
    bank with 3 valid slots and the slot PE, against rmem_tpu's GPMBlock
    (deterministic): both outputs within BLOCK_TOL of scale, and the
    gradient of a seeded weighted sum of them with respect to every
    parameter and every input within GRAD_TOL of each one's scale."""
    rng = np.random.RandomState(21)
    d, size, s, count = 64, (8, 8), 4, 3
    hw = size[0] * size[1]
    ev = 2 * d                          # the block's expand_d, values per head
    r = lambda *sh: jnp.asarray(_rand(rng, *sh))
    x = dict(tgt=r(1, hw, d), tgt_id=r(1, hw, d), bank_k=r(s, 1, hw, d),
             bank_v=r(s, 1, hw, 2 * ev), short_k=r(1, hw, d),
             short_v=r(1, hw, 2 * ev))
    cur_pe, slot_pe = r(1, d), r(s, d)
    w_t, w_id = r(1, hw, d), r(1, hw, d)
    mask = jnp.arange(s) < count

    jb = JGPMBlock(d, 1, 2, layer_idx=1)
    # init through the reference frame's path (id_emb), so every parameter
    # exists
    var = jb.init(jax.random.PRNGKey(0), x["tgt"], x["tgt_id"], x["bank_k"],
                  x["bank_v"], mask, x["short_k"], x["short_v"],
                  r(1, hw, d), cur_pe, slot_pe[:1], size)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * _rand(rng, *a.shape), var["params"])

    def jloss(p, inputs):
        t, tid, _, _ = jb.apply(
            {"params": p}, inputs["tgt"], inputs["tgt_id"], inputs["bank_k"],
            inputs["bank_v"], mask, inputs["short_k"], inputs["short_v"],
            None, cur_pe, slot_pe, size, deterministic=True)
        return jnp.sum(t * w_t) + jnp.sum(tid * w_id), (t, tid)

    (_, (jt, jtid)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, x)

    tb = GPMBlock(d, 1, 2, layer_idx=1).train()
    tb.load_state_dict(params_from_jax(params), strict=True)
    tx = {k: _t(v).requires_grad_() for k, v in x.items()}
    tt, ttid, _, _ = tb(
        tx["tgt"], tx["tgt_id"], tx["bank_k"], tx["bank_v"],
        torch.tensor(count, dtype=torch.int32), tx["short_k"],
        tx["short_v"], None, _t(cur_pe), _t(slot_pe), size)
    ((tt * _t(w_t)).sum() + (ttid * _t(w_id)).sum()).backward()
    _close(tt, jt, BLOCK_TOL)
    _close(ttid, jtid, BLOCK_TOL)
    ref_grads = params_from_jax(jgp)
    for name, p in tb.named_parameters():
        # linear_ID_V serves the reference frame only: no gradient here
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close(grad, ref_grads[name].numpy(), GRAD_TOL)
    for key, t in tx.items():
        _close(t.grad, jgx[key], GRAD_TOL)
    # the same block serving: the slot PE as the bank attention's logit
    # bias, 2 x 225 local bias, no gradient
    with torch.no_grad():
        et, etid, _, erec = tb.eval()(
            *(tx[k].detach() for k in ("tgt", "tgt_id", "bank_k", "bank_v")),
            torch.tensor(count, dtype=torch.int32),
            *(tx[k].detach() for k in ("short_k", "short_v")), None,
            _t(cur_pe), _t(slot_pe), size, true_lk=hw)
    _close(et, jt, BLOCK_TOL)
    _close(etid, jtid, BLOCK_TOL)
    assert torch.all(erec[..., count:] == 0)


@pytest.mark.parametrize("b,count,true_lk,lk", [
    pytest.param(1, 3, 40, 52, id="b1-padded"),
    pytest.param(2, 5, 48, 48, id="b2-full")])
def test_bank_attention_plain_two_heads_matches_pallas_infer(b, count,
                                                             true_lk, lk):
    """K1's plain version at 2 heads of 32 with values 64 a head (the
    no_memory_gap shape's ratio), the per-(head, query, slot) slot-PE bias
    and keys masked at true_lk, against pallas_bank_attention_infer in
    interpret mode: output, and the slot mass as the head mean."""
    rng = np.random.RandomState(31 + b)
    s, lq, heads, dh, dv = 5, 40, 2, 32, 64
    q = _rand(rng, b, lq, heads * dh)
    bk = _rand(rng, s, b, lk, heads * dh)
    bv = _rand(rng, s, b, lk, heads * dv)
    bias = _rand(rng, b, heads, lq, s)
    scale = dh ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref, rrec = pallas_bank_attention_infer(
            jnp.asarray(q), jnp.asarray(bk), jnp.asarray(bv),
            jnp.int32(count), heads, scale=scale, true_lk=true_lk,
            qbias=jnp.asarray(bias.reshape(b * heads, lq, s)))
    out, rec = kb.bank_attention_infer(
        _t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32), heads,
        scale, true_lk=true_lk, qbias=_t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rrec), **KERNEL_TOL)
    assert np.all(rec.numpy()[..., count:] == 0.0)
    assert kb.bank_attention_infer.launches == 0       # no launch on the CPU


def test_bank_attention_qminor_plain_two_heads_matches_pallas():
    """K3's plain version at 2 heads of 64 with values 128 a head against
    pallas_bank_attention_qminor in interpret mode (ragged against its
    tiles): output within 2e-4 and slot mass within 2e-5, the JAX test's
    tolerances (f32 sums in another order)."""
    rng = np.random.RandomState(41)
    s, lq, lk, heads, dh, dv, count = 4, 300, 270, 2, 64, 128, 3
    q = _rand(rng, 1, lq, heads * dh)
    bk = _rand(rng, s, 1, lk, heads * dh)
    bv = _rand(rng, s, 1, lk, heads * dv)
    with pltpu.force_tpu_interpret_mode():
        jout, jrec = pallas_bank_attention_qminor(
            jnp.asarray(q), jnp.asarray(bk), jnp.asarray(bv),
            jnp.int32(count), heads)
    out, rec = kb.bank_attention_qminor(
        _t(q), _t(bk), _t(bv), torch.tensor(count, dtype=torch.int32), heads,
        dh ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=2e-5)
    assert np.all(rec.numpy()[..., count:] == 0)


@pytest.mark.parametrize("size,b", [pytest.param((8, 11), 1, id="8x11"),
                                    pytest.param((9, 13), 2, id="b2-9x13")])
def test_local_attention_plain_two_heads_matches_pallas(size, b):
    """K4's plain version at 2 heads of 32 with values 64 a head and a
    2 x 225 bias against pallas_local_attention in interpret mode, on
    ragged grids of at least 8 a side (under 8 the JAX window clamps,
    ROADMAP Queue 3)."""
    rng = np.random.RandomState(51 + b)
    hw, heads = size[0] * size[1], 2
    q, k = _rand(rng, b, hw, heads * 32), _rand(rng, b, hw, heads * 32)
    v, rel = _rand(rng, b, hw, heads * 64), _rand(rng, b, hw, heads * 225)
    ref = pallas_local_attention(*map(jnp.asarray, (q, k, v, rel)), size,
                                 heads, max_dis=7, interpret=True)
    out = kl.local_attention(_t(q), _t(k), _t(v), _t(rel), size, heads, 7,
                             32 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    assert kl.local_attention.launches == 0            # no launch on the CPU


def test_rel_head_major_is_what_each_head_reads():
    """The bias's head-major copy that K4 reads at 2 heads: each head's
    slice of it, with that head's q, k and v columns, through the one-head
    plain version gives the 2-head plain version's columns of that head
    exactly (the same f32 sums); at one head it is the tensor itself."""
    rng = np.random.RandomState(61)
    size, b, heads, dh, dv = (9, 10), 2, 2, 32, 64
    hw = size[0] * size[1]
    q, k = _t(_rand(rng, b, hw, heads * dh)), _t(_rand(rng, b, hw, heads * dh))
    v, rel = _t(_rand(rng, b, hw, heads * dv)), _t(_rand(rng, b, hw,
                                                         heads * 225))
    both = kl.local_attention_plain(q, k, v, rel, size, heads, 7, dh ** -0.5)
    rel_hm = kl.rel_head_major(rel, heads)
    assert rel_hm.shape == (b, heads, hw, 225) and rel_hm.is_contiguous()
    for h in range(heads):
        one = kl.local_attention_plain(
            q[..., h * dh:(h + 1) * dh].contiguous(),
            k[..., h * dh:(h + 1) * dh].contiguous(),
            v[..., h * dv:(h + 1) * dv].contiguous(), rel_hm[:, h], size, 1,
            7, dh ** -0.5)
        assert torch.equal(one, both[..., h * dv:(h + 1) * dv])
    assert kl.rel_head_major(rel, 1) is rel


def test_routes_at_two_heads():
    """On the card, serving and training at 2 heads of 128 with values a
    multiple of 256 a head take K1's template (and K2 in training), as does
    AOT's no_memory_gap shape (values 128 a head, the template's 128-wide
    instantiation); any other 2-head shape raises in both."""
    assert kb.infer_route(2, 128, 512) == "slots"
    assert kb.infer_route(2, 128, 256) == "slots"
    assert kb.infer_route(1, 128, 1024) == "slots"
    assert kb.infer_route(2, 128, 128) == "slots"
    assert kb.train_route(1, 128, 1024) == "slots"
    assert kb.train_route(2, 128, 512) == "slots"
    assert kb.train_route(2, 128, 128) == "slots"
    for shape in ((2, 64, 512), (3, 128, 512), (4, 128, 256)):
        with pytest.raises(ValueError, match="heads of width"):
            kb.infer_route(*shape)
    with pytest.raises(ValueError, match="heads of width"):
        kb.train_route(2, 64, 512)


def _jax_tree(**over):
    """The JAX r50_deaotl pre_vost parameter tree (zeros) on the shapes of
    one reference pass at 65 x 65."""
    cfg = jget_config("pre_vost", model="r50_deaotl",
                      compute_dtype="float32", **over)
    jm = jbuild(cfg.model_vos, cfg)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, cfg.id_channels), jnp.float32)
    shapes = jax.eval_shape(
        lambda r: jm.init(r, img, oh, method=init_forward),
        jax.random.PRNGKey(0))["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)


def test_params_from_jax_covers_the_two_head_tree():
    """r50_deaotl with no_memory_gap. The JAX package cannot build it with
    the temporal PE (fixed at C/2 = 128 wide, against keys of 2 x 128: the
    query + PE add does not broadcast, ROADMAP Queue 3), so its tree is
    taken without the PE: every JAX leaf lands on a port parameter of its
    shape and every port parameter is set (strict load), and only the
    keys' projection (linear_QV, 128 + 512 wide at one head, 256 + 512 at
    two) and relative_emb_k (225 to 2 x 225) widen. The port's PE is as
    wide as the keys: 256 at two heads, 128 at one."""
    with pytest.raises((TypeError, ValueError), match="broadcast"):
        _jax_tree(no_memory_gap=True)
    over = dict(no_memory_gap=True, use_temporal_positional_embedding=False)
    tree = _jax_tree(**over)
    sd = params_from_jax(tree)
    assert len(sd) == len(trav.flatten_dict(tree))
    port = build_vos_model("deaot", get_config("pre_vost", model="r50_deaotl",
                                               **over)).state_dict()
    build_vos_model("deaot", get_config(
        "pre_vost", model="r50_deaotl", **over)).load_state_dict(sd,
                                                                 strict=True)
    for name, p in port.items():
        assert p.shape == sd[name].shape, name
    one_head = build_vos_model("deaot", get_config(
        "pre_vost", model="r50_deaotl",
        use_temporal_positional_embedding=False)).state_dict()
    wider = {n for n, p in port.items() if p.shape != one_head[n].shape}
    assert wider == {f"lstt.block{i}.{m}.{w}" for i in range(3)
                     for m in ("linear_QV", "relative_emb_k")
                     for w in ("weight", "bias")}
    assert port["lstt.block0.relative_emb_k.weight"].shape == (450, 256)
    assert port["lstt.block0.linear_QV.weight"].shape == (256 + 512, 256)
    for heads, width in ((2, 256), (1, 128)):
        pe = build_vos_model("deaot", get_config(
            "pre_vost", model="r50_deaotl",
            no_memory_gap=heads == 2)).state_dict()
        assert pe["cur_pos_emb"].shape == (1, width)
        assert pe["mem_pos_emb"].shape == (4, width)


HW = (64, 64)
OUT_HW = (60, 70)
FRAMES = 9


def _evaluator_gap(cfg, num_frames: int) -> int:
    """The serving gap of rmem_tpu/managers/evaluator.py:328-331."""
    gap = max(int(round(num_frames / 30)), 5)
    return int(round(gap / 4)) if cfg.no_memory_gap else gap


def test_engine_nomemgap_matches_jax_teacher_forced():
    """tiny_deaotl with no_memory_gap (2 heads of 32, values 128 a head) at
    64 x 64, 1 + 2 slots and the evaluator's gap (1 on this 10-frame
    video): the bank fills on frame 2 and evicts on every later frame,
    without the temporal PE, which the JAX package cannot take at two heads
    (the GPM block test holds the PE at two heads). Both engines share the
    weights and are teacher-forced with the JAX labels.
    Per frame: logits within LOGIT_TOL of scale, labels equal except at
    near ties, the slot mass, and the bank's count, order, ages, scores and
    contents as the JAX bank's (the same eviction victims)."""
    over = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=2,
                no_memory_gap=True, use_temporal_positional_embedding=False)
    jcfg = jget_config("pre_vost", model="tiny_deaotl", **over)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = jinit(jmodel, jax.random.PRNGKey(0), HW)
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    jeng = JEngine(jmodel, params, jcfg, donate=False)
    cfg = get_config("pre_vost", model="tiny_deaotl", **over)
    model = build_vos_model("deaot", cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    assert model.lstt.block(0).att_heads == 2
    peng = InferenceEngine(model, cfg, device="cpu")
    gap = _evaluator_gap(cfg, FRAMES + 1)
    assert gap == 1

    rng = np.random.RandomState(0)
    imgs = rng.rand(FRAMES + 1, 1, *HW, 3).astype(np.float32)
    mask = np.zeros((1, *HW), np.int32)
    mask[:, 8:30, 6:28] = 1
    mask[:, 36:60, 30:58] = 2
    mask[:, 0:4, 0:64] = 255          # an ignore band
    js, jlog = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask),
                                  [2], gap=gap)
    ps, plog = peng.add_reference(imgs[0], mask, [2], gap=gap)
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
        evicted += was_full and int(ps.last_mem_step) == t
    assert counts == [2, 3] + [3] * (FRAMES - 2)
    assert evicted == FRAMES - 2

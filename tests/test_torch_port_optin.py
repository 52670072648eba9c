"""The port's opt-in inference kernels against the JAX package, in f32 (and
bf16 for the depthwise conv) on the CPU: the plain versions of K3 (the
slot-split bank attention) and K8 (the gated depthwise conv) against the
Pallas kernels in interpret mode, one GPM block with both routes on against
the JAX block's default path, and the engine's choice of route."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rmem_tpu.kernels.bank_attention import pallas_bank_attention_qminor
from rmem_tpu.kernels.dwconv import pallas_gated_dwconv
from rmem_tpu.models.gpm import GPMBlock as JGPMBlock
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.kernels import dwconv as kd
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.models.gpm import GPMBlock
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_valid", [1, 3, 4])
def test_qminor_plain_matches_pallas(n_valid):
    """K3's plain version against pallas_bank_attention_qminor in interpret
    mode at the JAX test's shapes (4 slots, 300 queries, 270 keys, ragged
    against both tiles), f32: output within 2e-4 and slot mass within 2e-5
    (the JAX test's tolerances: f32 sums in another order)."""
    rng = np.random.RandomState(9)
    s, lq, lk, dh, dv = 4, 300, 270, 128, 256
    q = rng.randn(1, lq, dh).astype(np.float32)
    bk = rng.randn(s, 1, lk, dh).astype(np.float32)
    bv = rng.randn(s, 1, lk, dv).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jout, jrec = pallas_bank_attention_qminor(
            jnp.asarray(q), jnp.asarray(bk), jnp.asarray(bv),
            jnp.int32(n_valid), 1)
    out, rec = kb.bank_attention_qminor(
        _t(q), _t(bk), _t(bv), torch.tensor(n_valid, dtype=torch.int32), 1,
        dh ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=2e-5)
    assert np.all(rec.numpy()[..., n_valid:] == 0)
    assert kb.bank_attention_qminor.launches == 0     # no launch on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_dwconv_plain_matches_pallas(dtype):
    """K8's plain version against pallas_gated_dwconv in interpret mode on
    a 13 x 21 grid of 256 channels (two of the kernel's 8-row bands and a
    ragged one). f32: within 1e-5 of the output's scale (sums in the same
    order; XLA may contract a tap into an FMA). bf16: the port rounds the
    product and each tap to bf16 and sums in f32, as the kernel is written;
    XLA on the CPU may keep a bf16 product in f32 (its excess-precision
    rule), so a tap may differ by one bf16 rounding: within two bf16 ulps
    (2^-7) of the output's scale (1.2 ulps measured, on 40 % of values)."""
    rng = np.random.RandomState(6)
    b, h, w, c = 1, 13, 21, 256
    x = rng.randn(b, h * w, c).astype(np.float32)
    g = rng.randn(b, h * w, c).astype(np.float32)
    k = (rng.randn(5, 5, 1, c) * 0.2).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jout = pallas_gated_dwconv(
        jnp.asarray(x).astype(jdt).reshape(b, h, w, c),
        jnp.asarray(g).astype(jdt).reshape(b, h, w, c),
        jnp.asarray(k).astype(jdt), interpret=True)
    ref = np.asarray(jout.astype(jnp.float32)).reshape(b, h * w, c)
    tdt = getattr(torch, dtype)
    weight = _t(k).permute(3, 2, 0, 1).contiguous()          # [C, 1, 5, 5]
    out = kd.gated_dwconv(_t(x).to(tdt), _t(g).to(tdt), weight.to(tdt),
                          (h, w))
    assert out.dtype == tdt and out.shape == (b, h * w, c)
    got = out.float().numpy()
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        assert np.abs(got - ref).max() <= 2 ** -7 * np.abs(ref).max()
    assert kd.gated_dwconv.launches == 0


def _init(module, rng, *args, **kwargs):
    """flax variables drawn with numpy (kernels lecun-normal, scales 1,
    the rest 0, each leaf then offset by 0.02 x N(0, 1))."""
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
        return (base + 0.02 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("frame", ["reference", "memory"])
def test_gpm_block_optin_matches_jax(frame):
    """One GPM block at tiny_deaotl widths (d 64, keys 32, tails 256 wide)
    with both opt-ins on, K3 with the slot PE added to the keys and K8 in
    every tail (their plain versions here), against the JAX block on its
    default path (einsum bank attention with the factored PE bias, the
    unrolled depthwise conv): the same function, so within 2e-5 of each
    output's scale in f32. The memory frame is layer 1 over a 4-slot bank
    with 3 valid slots; the reference frame is layer 0 with id_emb."""
    rng = np.random.RandomState(3)
    # (an 8 x 9 grid: on grids under 8 wide that are not square the JAX
    # block shrinks the local window to min(h, w) - 1, see ROADMAP Queue 3)
    d, size, s, count = 64, (8, 9), 4, 3
    hw = size[0] * size[1]
    layer = 1 if frame == "memory" else 0
    r = lambda *sh: jnp.asarray(rng.randn(*sh).astype(np.float32))
    tgt, tgt_id = r(1, hw, d), r(1, hw, d)
    bank_k, bank_v = r(s, 1, hw, 32), r(s, 1, hw, 256)
    short_k, short_v = r(1, hw, 32), r(1, hw, 256)
    cur_pe, slot_pe, id_emb = r(1, 32), r(s, 32), r(1, hw, d)
    mask = jnp.arange(s) < count
    jb = JGPMBlock(d, 1, 1, layer_idx=layer)
    var = _init(jb, rng, tgt, tgt_id if layer else None, bank_k, bank_v, mask,
                short_k, short_v, id_emb, cur_pe, slot_pe[:1], size,
                need_record=True)
    if frame == "memory":
        args = (tgt, tgt_id, bank_k, bank_v, mask, short_k, short_v, None,
                cur_pe, slot_pe)
    else:
        args = (tgt, None, None, None, None, None, None, id_emb, cur_pe,
                slot_pe[:1])
    jt, jtid, jmems, jrec = jax.jit(lambda v, a: jb.apply(
        v, *a, size, need_record=True))(var, args)

    tb = GPMBlock(d, 1, 1, layer_idx=layer).eval()
    tb.load_state_dict(params_from_jax(var["params"]), strict=True)
    targs = [_t(a) for a in args]
    targs[4] = torch.tensor(count if frame == "memory" else 1,
                            dtype=torch.int32)
    with torch.no_grad():
        tt, ttid, tmems, trec = tb(*targs, size, qminor=True, fused_dw=True)
    for got, ref in [(tt, jt), (ttid, jtid), (trec, jrec)] + [
            (tmems[k], jmems[k]) for k in ("curr_k", "curr_v", "curr_id_v")]:
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 2e-5 * np.abs(ref).max(), err


def test_engine_routes_every_call_through_the_opt_ins(monkeypatch):
    """With use_pallas_dwconv and RMEM_BANK_QMINOR set, the engine (read
    once, when built) sends every gated tail (3 per layer, all 256 wide in
    tiny_deaotl) through gated_dwconv and every bank-attention call through
    bank_attention_qminor, at the reference frame and after; with both off,
    neither runs. Calls are counted at the wrappers the model reaches."""
    calls = {"dw": 0, "qminor": 0, "infer": 0}

    def counting(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(kd, "gated_dwconv",
                        counting("dw", kd.gated_dwconv))
    monkeypatch.setattr(kb, "bank_attention_qminor",
                        counting("qminor", kb.bank_attention_qminor))
    monkeypatch.setattr(kb, "bank_attention_infer",
                        counting("infer", kb.bank_attention_infer))
    rng = np.random.RandomState(0)
    img = rng.rand(2, 1, 33, 33, 3).astype(np.float32)
    lab = np.zeros((1, 33, 33), np.int32)
    lab[:, 5:20, 5:20] = 1
    seen = {}
    for on in (True, False):
        if on:
            monkeypatch.setenv("RMEM_BANK_QMINOR", "1")
        cfg = get_config("pre_vost", model="tiny_deaotl",
                         compute_dtype="float32", use_pallas_dwconv=on)
        eng = InferenceEngine(init_params(build_vos_model("deaot", cfg)),
                              cfg, device="cpu")
        monkeypatch.delenv("RMEM_BANK_QMINOR", raising=False)  # read once
        for key in calls:
            calls[key] = 0
        state, _ = eng.add_reference(img[0], lab, [1], gap=1)
        eng.step(state, img[1], (33, 33))
        seen[on] = dict(calls)
    layers = 2                                   # tiny_deaotl's GPM depth
    assert seen[True] == {"dw": 2 * 3 * layers, "qminor": 2 * layers,
                          "infer": 0}
    assert seen[False] == {"dw": 0, "qminor": 0, "infer": 2 * layers}

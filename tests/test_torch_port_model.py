"""The port's model modules against the JAX package's with the same weights
(moved over by params_from_jax) on the same inputs, in f32."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.traverse_util as trav

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.models.decoders.fpn import FPNSegmentationHead as JFPN
from rmem_tpu.models.encoders import fold_bn_params as jfold_bn_params
from rmem_tpu.models.encoders.resnet import ResNet50 as JResNet50
from rmem_tpu.models.gpm import GPMBlock as JGPMBlock
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.models.decoders.fpn import FPNSegmentationHead
from rmem_tpu_torch.models.encoders import fold_bn_params
from rmem_tpu_torch.models.encoders.resnet import ResNet50
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


def _init(module, rng, *args, amount=0.1, **kwargs):
    """Variables of a flax module as its initialisers make them (kernels
    lecun-normal, scales 1, every other leaf 0), drawn with numpy from `rng`
    on the shapes of `jax.eval_shape` (flax's own init runs the model on the
    CPU, op by op, at several times the cost), then offset by `amount` x
    N(0, 1) on every leaf, so unit scales and zero biases take part in the
    comparison."""
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
    """max |out - ref| <= rel * max |ref|: f32 through a deep network drifts
    with the summation order of each conv/matmul (XLA vs ATen)."""
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("model", ["tiny_deaotl", "r50_deaotl"])
def test_config_presets_match_jax(model):
    """Every field of the port's Config reads as in the JAX package's
    preset, derived capacities included."""
    port = get_config("pre_vost", model=model)
    ref = jget_config("pre_vost", model=model)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.max_mem_slots, port.id_channels) == \
        (ref.max_mem_slots, ref.id_channels)


@pytest.mark.parametrize("model", ["tiny_deaotl", "r50_deaotl"])
def test_params_from_jax_sets_every_parameter(model):
    """Every JAX leaf lands on a port parameter of the same size, and every
    port parameter is set (strict load)."""
    cfg = jget_config("pre_vost", model=model, compute_dtype="float32")
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
    port = build_vos_model("deaot", get_config("pre_vost", model=model))
    port.load_state_dict(sd, strict=True)      # no key missing or unused
    for name, p in port.state_dict().items():
        assert p.shape == sd[name].shape, name


def test_fold_bn_params_matches_jax():
    """The bf16 engine's BN fold gives the JAX fold's weights for every
    ResNet-50 leaf: each scale folded into its conv, then reset to 1."""
    shapes = jax.eval_shape(
        lambda r: JResNet50(dtype=jnp.float32).init(
            r, jnp.zeros((1, 65, 65, 3), jnp.float32)),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(5)
    tree = {"encoder": jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)}
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                 jfold_bn_params(tree)))
    out = fold_bn_params(params_from_jax(tree))
    assert out.keys() == ref.keys()
    # the stem's BN, three in each of the 3 + 4 + 6 bottlenecks, and the
    # three projection shortcuts' BNs
    scales = [k for k in ref if k.endswith(".scale")]
    assert len(scales) == 43 and all(torch.all(ref[k] == 1) for k in scales)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)


def test_resnet50_and_fpn_at_65():
    rng = np.random.RandomState(0)
    x = rng.rand(1, 65, 65, 3).astype(np.float32)
    jenc = JResNet50(dtype=jnp.float32)
    evar = _init(jenc, rng, jnp.asarray(x))
    jxs = jax.jit(jenc.apply)(evar, jnp.asarray(x))
    enc = ResNet50()
    enc.load_state_dict(params_from_jax(evar["params"]), strict=True)
    with torch.no_grad():
        xs = enc(torch.from_numpy(x))
    for a, b in zip(xs, jxs):
        _close(a.permute(0, 2, 3, 1), b, 1e-4)

    dims = (256, 512, 1024, 1024)
    feat = rng.randn(1, 5, 5, 512).astype(np.float32)
    jdec = JFPN(in_dim=512, out_dim=11, decode_intermediate_input=False,
                hidden_dim=256, shortcut_dims=dims)
    inputs = [jxs[-1], jnp.asarray(feat)]
    dvar = _init(jdec, rng, inputs, jxs)
    jlog = jax.jit(jdec.apply)(dvar, inputs, jxs)
    dec = FPNSegmentationHead(512, 11, False, 256, dims)
    dec.load_state_dict(params_from_jax(dvar["params"]), strict=True)
    with torch.no_grad():
        logits = dec([xs[-1], torch.from_numpy(feat).permute(0, 3, 1, 2)],
                     xs)
    assert logits.dtype == torch.float32
    _close(logits.permute(0, 2, 3, 1), jlog, 1e-4)


@pytest.mark.parametrize("layer_idx", [0, 1])
def test_gpm_block_r50_widths_on_5x5(layer_idx):
    """One GPM block at r50_deaotl widths (d 256, keys 128, values 1024).
    Layer 1 reads a 4-slot bank with 3 valid slots, the slot PE bias and
    the local window; layer 0 takes the reference-frame path (id_emb)."""
    rng = np.random.RandomState(1 + layer_idx)
    d, size, hw, s = 256, (5, 5), 25, 4
    r = lambda *sh: jnp.asarray(rng.randn(*sh).astype(np.float32))
    tgt = r(1, hw, d)
    tgt_id = r(1, hw, d) if layer_idx else None
    bank_k, bank_v = r(s, 1, hw, 128), r(s, 1, hw, 1024)
    short_k, short_v = r(1, hw, 128), r(1, hw, 1024)
    cur_pe, slot_pe = r(1, 128), r(s, 128)
    id_emb = None if layer_idx else r(1, hw, d)
    count = 3
    mask = jnp.arange(s) < count

    jb = JGPMBlock(d, 1, 1, layer_idx=layer_idx)
    args = (tgt, tgt_id, bank_k, bank_v, mask, short_k, short_v, id_emb,
            cur_pe, slot_pe if layer_idx else slot_pe[:1], size)
    # init through the id_emb path too, so every parameter exists
    init_args = args[:7] + (r(1, hw, d), cur_pe, slot_pe[:1], size)
    var = _init(jb, rng, *init_args, amount=0.02, need_record=True)
    jt, jtid, jmems, jrec = jax.jit(lambda v, a: jb.apply(
        v, *a, size, need_record=True, true_lk=hw if layer_idx else None))(
        var, args[:-1])

    tb = GPMBlock(d, 1, 1, layer_idx=layer_idx)
    tb.load_state_dict(params_from_jax(var["params"]), strict=True)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    with torch.no_grad():
        tt, ttid, tmems, trec = tb(
            t(tgt), t(tgt_id), t(bank_k), t(bank_v),
            torch.tensor(count, dtype=torch.int32), t(short_k), t(short_v),
            t(id_emb), t(cur_pe), t(slot_pe if layer_idx else slot_pe[:1]),
            size, true_lk=hw if layer_idx else None)
    _close(tt, jt, 2e-5)
    _close(ttid, jtid, 2e-5)
    for key in ("curr_k", "curr_v", "curr_id_v"):
        _close(tmems[key], jmems[key], 2e-5)
    _close(trec, jrec, 2e-5)


def test_init_params_is_seeded():
    cfg = get_config("pre_vost", model="tiny_deaotl")
    a = init_params(build_vos_model("deaot", cfg), seed=3).state_dict()
    b = init_params(build_vos_model("deaot", cfg), seed=3).state_dict()
    c = init_params(build_vos_model("deaot", cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.stem.weight"], c["encoder.stem.weight"])
    w = a["patch_wise_id_bank.weight"].reshape(a["patch_wise_id_bank.weight"]
                                               .shape[0], -1)
    # orthogonal rows scaled by k^-2
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(w.shape[0]) / 17 ** 4,
                               atol=1e-9)

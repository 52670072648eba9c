"""The port's encoders against the JAX package's, f32 on the CPU, beside
the families' pyramids and VJPs (test_torch_port_encoders.py): a small
Swin with shifted windows and an odd side, the weight bridge on the
full-size Swin-B, ResNet-101 and ResNeSt-101 trees, the inference BN fold
and the train state's parameter groups, leaf by leaf, and ResNeSt's
shortcut pool against the reference's."""

import functools

import flax.linen as fnn
import flax.traverse_util as trav
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_encoders import (FWD_TOL, GRAD_TOL, HW, _close, _draw,
                                      _shapes, _vjp_both)

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine.train_state import param_label as jparam_label
from rmem_tpu.engine.train_state import wd_applies as jwd_applies
from rmem_tpu.models.encoders import build_encoder as jbuild_encoder
from rmem_tpu.models.encoders import fold_bn_params as jfold_bn_params
from rmem_tpu.models.encoders.swin import SwinTransformer as JSwin
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine.train_state import param_label, wd_applies
from rmem_tpu_torch.models.encoders import build_encoder, fold_bn_params
from rmem_tpu_torch.models.encoders.resnest import avg_down
from rmem_tpu_torch.models.encoders.swin import SwinTransformer
from rmem_tpu_torch.utils import params_from_jax
from rmem_tpu_torch.utils.checkpoint import flax_path


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_swin_matches_flax():
    """A small Swin (embed 32, depths (2, 2, 2), window 4; the JAX encoder
    tests' variant) at 64 x 52: the 16 x 13 grid pads its windows and its
    first merge pads the odd side; stages 0 and 1 shift their windows (the
    grids exceed the window), stage 2 (4 x 4) does not."""
    hw = (64, 52)
    rng = np.random.RandomState(1)
    x = rng.rand(1, *hw, 3).astype(np.float32)
    kw = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8),
              window_size=4)
    jenc = JSwin(dtype=jnp.float32, **kw)
    params = _draw(_shapes(jenc, jnp.asarray(x)), rng)
    (jpyr, _, jdx, jgrads), (pyr, _, dx, grads) = _vjp_both(
        jenc, SwinTransformer(**kw), params, x, rng, False)
    assert [tuple(p.shape[1:3]) for p in pyr] == [(16, 13), (8, 7), (4, 4),
                                                  (4, 4)]
    for i, (a, b) in enumerate(zip(pyr, jpyr)):
        _close(a, b, FWD_TOL, f"level {i}")
    _close(dx, jdx, GRAD_TOL, "d image")
    for k, g in grads.items():
        _close(g, jgrads[k], GRAD_TOL, k)


@functools.lru_cache(maxsize=None)
def _encoder_shapes(name):
    """The JAX encoder's parameter shapes at 65 x 65, by jax.eval_shape
    (no compute)."""
    return _shapes(jbuild_encoder(name), jnp.zeros((1, *HW, 3)))


def _tree(name, rng=None):
    """An encoder's tree under `encoder`: zeros, or random leaves from `rng`
    (scales in [0.5, 1.5))."""
    def leaf(path, s):
        if rng is None:
            return np.zeros(s.shape, np.float32)
        a = rng.randn(*s.shape)
        if path[-1].key == "scale":
            a = rng.rand(*s.shape) + 0.5
        return a.astype(np.float32)

    return {"encoder": jax.tree_util.tree_map_with_path(
        leaf, _encoder_shapes(name))}


def _assert_groups_match(name):
    """Every leaf's group (frozen, encoder) and weight-decay rule as the
    JAX package's."""
    cfg, jcfg = get_config("pre_vost"), jget_config("pre_vost")
    for k, v in params_from_jax(_tree(name)).items():
        path = flax_path(k)
        leaf = np.zeros(v.shape[::-1] if v.dim() == 2 else v.shape)
        assert param_label(k, cfg) == jparam_label(path, jcfg), k
        assert wd_applies(k, v, cfg) == jwd_applies(path, leaf, jcfg), k


@pytest.mark.parametrize("name", ["swin_base", "resnet101", "resnest101"])
def test_params_from_jax_covers_the_full_encoders(name):
    """The full-size trees (from jax.eval_shape: no compute) load strictly:
    every JAX leaf lands on a port parameter of its size, none is unset;
    and each leaf takes the JAX package's parameter group."""
    tree = _tree(name)["encoder"]
    sd = params_from_jax(tree)
    assert len(sd) == len(trav.flatten_dict(tree))
    enc = build_encoder(name)
    enc.load_state_dict(sd, strict=True)
    blocks = {"swin_base": "stage2_block17", "resnet101": "layer3_22",
              "resnest101": "layer3_22"}[name]
    assert hasattr(enc, blocks)
    _assert_groups_match(name)


def test_fold_bn_params_matches_jax():
    """For every family, the bf16 engine's BN fold gives the JAX fold's
    weights leaf by leaf, with one difference: where the paired conv has a
    bias (ResNeSt's split-attention fc1) the port scales it too. The JAX
    fold leaves it as it was, which changes the encoder's output; the
    port's keeps it (ResNeSt-50 at 33 x 33, f32)."""
    rng = np.random.RandomState(5)
    for name in ("mobilenetv2", "mobilenetv3", "resnest50",
                 "resnet50_topdown", "tiny_topdown"):
        tree = _tree(name, rng)
        ref = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jfold_bn_params(tree)))
        src = params_from_jax(tree)
        out = fold_bn_params(src)
        assert out.keys() == ref.keys()
        folded = [k for k in ref if k.endswith(".scale")
                  and not torch.equal(src[k], ref[k])]
        assert folded or name == "tiny_topdown", name
        for k in folded:
            assert torch.all(ref[k] == 1) and torch.equal(out[k], ref[k]), k
        for k in ref:
            if name == "resnest50" and k.endswith(".fc1.bias"):
                scale = src[k.replace("fc1.bias", "bn1.scale")]
                assert torch.equal(out[k], src[k] * scale), k
                assert torch.equal(ref[k], src[k]), k
            else:
                assert torch.equal(out[k], ref[k]), (name, k)
    # ResNeSt-50 on _draw's weights (fc1's biases drawn too), f32
    enc = build_encoder("resnest50").eval()
    x = torch.rand(1, 33, 33, 3, generator=torch.Generator().manual_seed(0))
    tree = {"encoder": _draw(_encoder_shapes("resnest50"), rng)}
    src = params_from_jax(tree)

    def encode(sd):
        enc.load_state_dict({k.removeprefix("encoder."): v
                             for k, v in sd.items()})
        return enc(x)[-1]

    with torch.no_grad():
        want, got = encode(src), encode(fold_bn_params(src))
        jax_fold = encode(params_from_jax(jax.tree_util.tree_map(
            np.asarray, jfold_bn_params(tree))))
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
    assert (jax_fold - want).abs().max() > 1e-2 * scale


def test_param_groups_match_jax():
    """Every leaf of every family takes the JAX package's group (frozen,
    encoder) and weight-decay rule (the full-size Swin-B, ResNet-101 and
    ResNeSt-101 in the test above). The JAX rule freezes a BN only where a
    path part starts with `bn` or is `downsample_bn`, and the stages
    conv1 / bn1 / layer1: so MobileNetV3's stem_bn, pw_bn, dw_bn, out_bn and
    head_bn, and ResNeSt's stem0_bn and stem1_bn (with the deep stem's
    convs), train, where the reference's FrozenBatchNorm and freeze_at
    would hold them (ROADMAP Queue 3): pinned here as the JAX rule."""
    for name in ("mobilenetv2", "mobilenetv3", "resnest50",
                 "resnet50_topdown", "tiny_topdown"):
        _assert_groups_match(name)
    cfg = get_config("pre_vost")
    labels = {k: param_label(k, cfg) for k in (
        "encoder.stem_bn.scale", "encoder.block4.dw_bn.bias",
        "encoder.head_bn.scale", "encoder.stem0_bn.scale",
        "encoder.stem1.weight", "encoder.bn1.scale",
        "encoder.block4.dw.bn.scale", "encoder.block4.bn_out.bias")}
    assert labels == {
        "encoder.stem_bn.scale": "encoder", "encoder.block4.dw_bn.bias":
        "encoder", "encoder.head_bn.scale": "encoder",
        "encoder.stem0_bn.scale": "encoder", "encoder.stem1.weight":
        "encoder", "encoder.bn1.scale": "frozen",
        "encoder.block4.dw.bn.scale": "frozen",
        "encoder.block4.bn_out.bias": "frozen"}


def test_avg_down_is_the_reference_pool():
    """ResNeSt's shortcut pool: flax's 2 x 2 / 2 avg_pool, SAME, padded
    zeros not counted (the JAX encoder's form) is the reference's
    AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False), also at odd
    sides, where the last window holds one column (121 x 213 is the 4x
    grid of a 481 x 849 frame); and so is the port's."""
    rng = np.random.RandomState(2)
    for hw in ((17, 17), (9, 10), (121, 213)):
        x = rng.randn(1, *hw, 3).astype(np.float32)
        jax_pool = np.asarray(fnn.avg_pool(jnp.asarray(x), (2, 2), (2, 2),
                                           padding="SAME",
                                           count_include_pad=False))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        ref = F.avg_pool2d(xt, 2, 2, ceil_mode=True,
                           count_include_pad=False)
        np.testing.assert_allclose(ref.permute(0, 2, 3, 1).numpy(),
                                   jax_pool, rtol=1e-6, atol=1e-7)
        assert torch.equal(avg_down(xt, 2), ref)

"""The port's plain ops (rmem_tpu_torch.ops) against the JAX package's, on
the same inputs made from a seed with numpy, in f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmem_tpu.ops import attention as jatt
from rmem_tpu.ops import layers as jlayers
from rmem_tpu.ops import masks as jmasks
from rmem_tpu.ops import position as jpos
from rmem_tpu.ops import resize as jresize
from rmem_tpu.ops import temporal_pe as jtpe
from rmem_tpu_torch.ops import attention as tatt
from rmem_tpu_torch.ops import layers as tlayers
from rmem_tpu_torch.ops import masks as tmasks
from rmem_tpu_torch.ops import position as tpos
from rmem_tpu_torch.ops import resize as tresize
from rmem_tpu_torch.ops import temporal_pe as ttpe
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# f32 on both sides; sums run in another order (XLA vs ATen), so elementwise
# results agree to a few f32 ulps of the values' magnitude (O(1) here)
TOL = dict(rtol=1e-5, atol=1e-5)


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
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _load(module, variables):
    module.load_state_dict(params_from_jax(variables["params"]), strict=True)
    return module


# ---------------------------------------------------------------- layers ---

def test_conv_gn_and_folded_bn():
    rng = np.random.RandomState(0)
    x = _rand(rng, 2, 9, 11, 16)
    jm = jlayers.ConvGN(32, 3, gn_groups=8)
    var = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    var = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), var)
    ref = jm.apply(var, jnp.asarray(x))
    tm = _load(tlayers.ConvGN(16, 32, 3, gn_groups=8), var)
    out = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)

    jbn = jlayers.FoldedBN(16)
    bvar = {"params": {"scale": _rand(rng, 16), "bias": _rand(rng, 16)}}
    tbn = _load(tlayers.FoldedBN(16), bvar)
    np.testing.assert_allclose(
        _np(tbn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)),
        np.asarray(jbn.apply(bvar, jnp.asarray(x))), **TOL)


def test_gn_act_dwconv_and_dwconv():
    rng = np.random.RandomState(1)
    size = (6, 7)
    x = _rand(rng, 2, 42, 64)
    jm = jlayers.GNActDWConv2d(64)
    var = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), size)
    ref = jm.apply(var, jnp.asarray(x), size)
    tm = _load(tlayers.GNActDWConv2d(64), var)
    np.testing.assert_allclose(_np(tm(_t(x), size)), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)

    jd = jlayers.DWConv2d(64)
    dvar = jd.init(jax.random.PRNGKey(2), jnp.asarray(x), size)
    tdw = _load(tlayers.DWConv2d(64), dvar)
    np.testing.assert_allclose(_np(tdw(_t(x), size)),
                               np.asarray(jd.apply(dvar, jnp.asarray(x), size)),
                               rtol=1e-4, atol=1e-5)


def test_norms_and_silu_and_maxpool():
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 30, 16)
    g = jlayers.GroupNorm1D(4)
    gvar = g.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tg = _load(tlayers.GroupNorm1D(16, 4), gvar)
    np.testing.assert_allclose(_np(tg(_t(x))),
                               np.asarray(g.apply(gvar, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)

    ln = jlayers.layer_norm("ln")
    lvar = {"params": {"scale": _rand(rng, 16), "bias": _rand(rng, 16)}}
    tln = _load(tlayers.LayerNorm(16), lvar)
    np.testing.assert_allclose(_np(tln(_t(x))),
                               np.asarray(ln.apply(lvar, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)

    np.testing.assert_allclose(_np(tlayers.silu(_t(x))),
                               np.asarray(jlayers.silu(jnp.asarray(x))), **TOL)

    img = _rand(rng, 1, 13, 10, 4)
    ref = jlayers.max_pool_3x3_s2(jnp.asarray(img))
    out = tlayers.max_pool_3x3_s2(_t(img).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_np(out.permute(0, 2, 3, 1)),
                                  np.asarray(ref))


# ------------------------------------------------------ position / masks ---

@pytest.mark.parametrize("hw", [(4, 4), (31, 54)])
def test_sine_position_embedding(hw):
    ref = jpos.sine_position_embedding(*hw, 256)
    np.testing.assert_array_equal(_np(tpos.sine_position_embedding(*hw, 256)),
                                  np.asarray(ref))


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 7, 9])
def test_interpolate_temporal_pe_both_branches(t):
    """t <= 4 takes table rows directly (linear branch), t > 4 the
    flip-nearest-expand branch; both are gathers, so exact."""
    rng = np.random.RandomState(3)
    table = _rand(rng, 4, 8)
    ref = jtpe.interpolate_temporal_pe(jnp.asarray(table), jnp.int32(t), 10)
    out = ttpe.interpolate_temporal_pe(_t(table),
                                       torch.tensor(t, dtype=torch.int32), 10)
    np.testing.assert_array_equal(_np(out)[:t], np.asarray(ref)[:t])


def test_masks():
    rng = np.random.RandomState(4)
    lab = rng.randint(0, 5, (2, 6, 7)).astype(np.int32)
    lab[0, 0, :3] = 255
    oh, ig = jmasks.one_hot_mask(jnp.asarray(lab), 4)
    toh, tig = tmasks.one_hot_mask(torch.from_numpy(lab), 4)
    np.testing.assert_array_equal(_np(toh), np.asarray(oh))
    np.testing.assert_array_equal(_np(tig), np.asarray(ig))

    logits = _rand(rng, 2, 3, 4, 11)
    objs = np.array([3, 10], np.int32)
    ref = jmasks.mask_unused_ids(jnp.asarray(logits), jnp.asarray(objs))
    out = tmasks.mask_unused_ids(_t(logits), torch.from_numpy(objs))
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


# ----------------------------------------------------------------- resize ---

@pytest.mark.parametrize("src,dst,align", [
    ((16, 16), (4, 4), True),        # integral downsample (strided pick)
    ((4, 4), (16, 16), True),        # generic upsample
    ((13, 22), (49, 85), True),      # integral 4x upsample (interleave)
    ((13, 22), (30, 41), False),     # half-pixel centres
])
def test_resize_bilinear(src, dst, align):
    rng = np.random.RandomState(5)
    x = _rand(rng, 1, *src, 5)
    ref = jresize.resize_bilinear(jnp.asarray(x), dst, align)
    out = tresize.resize_bilinear(_t(x), dst, align)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    ref_c = jresize.resize_bilinear(jnp.asarray(x).transpose(0, 3, 1, 2), dst,
                                    align, channel_last=False)
    out_c = tresize.resize_bilinear(_t(x).permute(0, 3, 1, 2), dst, align,
                                    channel_last=False)
    np.testing.assert_allclose(_np(out_c), np.asarray(ref_c), **TOL)


def test_resize_nearest():
    rng = np.random.RandomState(6)
    x = rng.randint(0, 9, (1, 30, 52, 1)).astype(np.int32)
    for dst in [(121, 213), (7, 11), (30, 52)]:
        ref = jresize.resize_nearest(jnp.asarray(x), dst)
        out = tresize.resize_nearest(torch.from_numpy(x), dst)
        np.testing.assert_array_equal(_np(out), np.asarray(ref))


@pytest.mark.parametrize("src,dst", [
    ((13, 22), (49, 85)),    # phase path (4x align-corners)
    ((13, 22), (48, 86)),    # generic path (production output size)
])
def test_upsample_argmax(src, dst):
    """Labels equal except where the top-2 interpolated logits lie within
    1e-5 of each other (ties can flip with the order of f32 ops)."""
    rng = np.random.RandomState(7)
    x = _rand(rng, 1, *src, 11)
    ref = np.asarray(jresize.upsample_argmax(jnp.asarray(x), dst))
    out = _np(tresize.upsample_argmax(_t(x), dst))
    up = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst))[0]
    top2 = np.sort(up, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) < 1e-5
    assert out.dtype == np.int32 and out.shape == dst
    assert np.all((out == ref) | near_tie)


# -------------------------------------------------------------- attention ---

def test_multihead_attention_and_interleave():
    rng = np.random.RandomState(8)
    q, k = _rand(rng, 2, 20, 32), _rand(rng, 2, 24, 32)
    v = _rand(rng, 2, 24, 48)
    ref = jatt.multihead_attention(*map(jnp.asarray, (q, k, v)), 4)
    out = tatt.multihead_attention(_t(q), _t(k), _t(v), 4)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    for heads in (1, 2):
        a, b = _rand(rng, 2, 5, 8), _rand(rng, 2, 5, 8)
        np.testing.assert_array_equal(
            _np(tatt.interleave_heads(_t(a), _t(b), heads)),
            np.asarray(jatt.interleave_heads(jnp.asarray(a), jnp.asarray(b),
                                             heads)))


@pytest.mark.parametrize("heads,n_valid,true_lk", [(1, 3, 40), (2, 5, None)])
def test_bank_attention_with_bias_and_padding(heads, n_valid, true_lk):
    rng = np.random.RandomState(9)
    s, b, lq, lk, dh, dv = 6, 1, 30, 48, 16, 24
    q = _rand(rng, b, lq, heads * dh)
    bk = _rand(rng, s, b, lk, heads * dh)
    bv = _rand(rng, s, b, lk, heads * dv)
    pe = _rand(rng, s, heads * dh)
    mask = np.arange(s) < n_valid
    scale = dh ** -0.5
    jb = jatt._slot_pe_bias(jnp.asarray(q), jnp.asarray(pe), heads, scale)
    tb = tatt.slot_pe_bias(_t(q), _t(pe), heads, scale)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), **TOL)
    ref, rrec = jatt.bank_attention(
        *map(jnp.asarray, (q, bk, bv, mask)), heads, need_record=True,
        scale=scale, true_lk=true_lk, logit_bias=jb)
    out, rec = tatt.bank_attention(
        _t(q), _t(bk), _t(bv), torch.from_numpy(mask), heads,
        need_record=True, scale=scale, true_lk=true_lk, logit_bias=tb)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_np(rec), np.asarray(rrec), **TOL)
    np.testing.assert_allclose(_np(rec).sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("size", [(4, 4), (17, 19)])
def test_dense_local_attention(size):
    """The port's plain local attention against the JAX dense form, at a
    grid smaller than the 15x15 window (where the JAX forms shrink the
    window and crop the relative table) and at one larger, and against the
    tiled form (the JAX engine's CPU path, slow to compile) on the small
    grid."""
    rng = np.random.RandomState(10)
    heads, dh, dv = 1, 16, 24
    hw = size[0] * size[1]
    q, k = _rand(rng, 1, hw, dh), _rand(rng, 1, hw, dh)
    v = _rand(rng, 1, hw, dv)
    rel = _rand(rng, 1, hw, heads * 225)
    out = tatt.dense_local_attention(_t(q), _t(k), _t(v), _t(rel), size,
                                     heads, max_dis=7)
    args = tuple(map(jnp.asarray, (q, k, v, rel)))
    dense, _ = jatt.dense_local_attention(*args, size, heads, max_dis=7)
    np.testing.assert_allclose(_np(out), np.asarray(dense), **TOL)
    if min(size) - 1 < 7:
        tiled = jatt.tiled_local_attention(*args, size, heads, max_dis=7)
        np.testing.assert_allclose(_np(out), np.asarray(tiled), rtol=1e-4,
                                   atol=1e-5)

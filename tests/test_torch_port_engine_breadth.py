"""The engine's breadth against the JAX package on the CPU, in f32: more
objects than the model takes as id groups, multi-scale + flip
augmentations, and raw uint8 frames resized and normalised on the device.

The JAX engine's fused steps (`_step_impl`, `_multi_step_impl`) split the
fed-back label into `img.shape[0]` groups, which is 1 for the evaluator's
frames, so with more than one id group they fail in `update_memory` (a
concatenate of a G-batch with a 1-batch; ROADMAP Queue 3). The two-group
test therefore holds the port's fused multi-aug scan to the JAX engine's
per-call functions composed as the fused step composes them, with the
label split into the state's groups; the one-group test holds it to the
JAX engine's own `scan_steps_multi_raw` and `scan_steps_raw`."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.data.transforms import resize_label, restrict_size as jrestrict
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.engine import separate_mask as jseparate_mask
from rmem_tpu.engine import soft_logit_aggregation as jsoft_aggregation
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_params as jinit
from rmem_tpu.ops.resize import resize_cubic as jresize_cubic
from rmem_tpu.ops.resize import resize_nearest as jresize_nearest
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data.transforms import restrict_size
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.engine.inference import (separate_mask,
                                             soft_logit_aggregation)
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.ops.resize import resize_cubic, resize_nearest
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RAW_HW = (161, 193)      # not square, so a flip or a swapped axis shows
MAX_OBJ = 10
OVER = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=2)
GAP = 2                  # writes at frames 2 and 4 fill 1 + 2 slots; 6 evicts
FRAMES = 7
# augs (scale, flip): grids 11 x 13 and 8 x 10 (the JAX local attention
# shrinks its window on narrower grids that are not square)
AUGS = ((1.0, True), (0.75, False))
# f32 on both sides; logits pass ~30 layers whose sums run in another order
LOGIT_TOL = 1e-4
# labels are not teacher-forced: a pixel whose top-2 mean probabilities
# nearly tie may flip and then feed a slightly different memory; measured
# 1.0 on every frame
AGREE_FLOOR = 0.999


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_separate_mask_matches_jax():
    """Global labels (with 255 and ids beyond the groups) into 2 and 3
    groups of 10."""
    rng = np.random.RandomState(0)
    label = rng.randint(0, 26, (1, 17, 23)).astype(np.int32)
    label[0, :3] = 255
    for groups in (2, 3):
        ref = np.asarray(jseparate_mask(jnp.asarray(label), groups, MAX_OBJ))
        got = separate_mask(torch.from_numpy(label), groups, MAX_OBJ)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_soft_logit_aggregation_matches_jax():
    """One group (identity) and three groups (product of background
    probabilities, clamped logit), f32: within 1e-5 of the logit scale."""
    rng = np.random.RandomState(1)
    for groups in (1, 3):
        logits = (rng.randn(groups, 9, 11, MAX_OBJ + 1) * 3).astype(
            np.float32)
        ref = np.asarray(jsoft_aggregation(jnp.asarray(logits), MAX_OBJ))
        got = soft_logit_aggregation(torch.from_numpy(logits), MAX_OBJ)
        assert got.shape == ref.shape == (9, 11, 1 + groups * MAX_OBJ)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("sizes", [((161, 193), (113, 145)),
                                   ((100, 80), (50, 40)),
                                   ((50, 40), (100, 81))],
                         ids=["down", "down2x", "up"])
def test_resize_cubic_matches_jax_and_cv2(sizes):
    """resize_cubic of a float image in [0, 255] against the JAX package's
    and against cv2.resize(INTER_CUBIC): within 5e-4 absolute, the JAX
    test's tolerance against cv2 (f32 weights and sums in another order)."""
    (h0, w0), (h1, w1) = sizes
    img = np.random.RandomState(2).rand(h0, w0, 3).astype(np.float32) * 255
    got = resize_cubic(torch.from_numpy(img[None]), (h1, w1))[0].numpy()
    ref = np.asarray(jresize_cubic(jnp.asarray(img[None]), (h1, w1))[0])
    want = cv2.resize(img, (w1, h1), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(got, ref, atol=5e-4)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_restrict_size_matches_jax():
    for h, w in ((480, 854), (1080, 1920), (161, 193), (720, 1280)):
        for scale in (0.75, 1.0, 1.3):
            for max_size, min_size in ((800 * 1.3, None), (None, 480)):
                assert restrict_size(h, w, max_size, min_size, scale) == \
                    jrestrict(h, w, max_size, min_size, scale)


def test_cached_tables_serve_autograd_after_inference():
    """The resize and local-window tables are cached per size and device on
    first use; a first use inside the engine's inference mode must still
    give tensors that a later training step can save for its backward."""
    from rmem_tpu_torch.ops.attention import dense_local_attention
    from rmem_tpu_torch.ops.resize import resize_bilinear
    x = torch.rand(1, 7, 11, 3)
    q = torch.rand(1, 6 * 7, 8)
    with torch.inference_mode():
        resize_bilinear(x, (13, 21))
        resize_nearest(x, (9, 5))
        resize_cubic(x, (5, 9))
        dense_local_attention(q, q, q, torch.rand(1, 42, 225), (6, 7), 1)
    xg = x.clone().requires_grad_()
    qg = q.clone().requires_grad_()
    out = (resize_bilinear(xg, (13, 21)).sum()
           + resize_nearest(xg, (9, 5)).sum() + resize_cubic(xg, (5, 9)).sum()
           + dense_local_attention(qg, qg, qg, torch.rand(1, 42, 225), (6, 7),
                                   1).sum())
    out.backward()
    assert xg.grad is not None and qg.grad is not None


def _video(num_objects):
    """Seeded raw uint8 RGB frames and a first-frame mask of `num_objects`
    stripes (plus an ignore band)."""
    rng = np.random.RandomState(3)
    raw = (rng.rand(FRAMES + 1, *RAW_HW, 3) * 255).astype(np.uint8)
    mask = np.zeros(RAW_HW, np.int32)
    for i in range(num_objects):
        mask[20:150, 8 + 15 * i:20 + 15 * i] = i + 1
    mask[:4] = 255
    return raw, mask


@pytest.fixture(scope="module")
def engines():
    jcfg = jget_config("pre_vost", model="tiny_deaotl", **OVER)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = jinit(jmodel, jax.random.PRNGKey(0), (65, 65))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    jeng = JEngine(jmodel, params, jcfg, donate=False)
    cfg = get_config("pre_vost", model="tiny_deaotl", **OVER)
    model = build_vos_model("deaot", cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return jeng, InferenceEngine(model, cfg, device="cpu")


def _references(jeng, peng, raw0, mask, augs, in_hws, groups, obj_nums):
    """Both engines' states after the first frame, one per aug: the frame
    prepared on the device by each engine's own prep, the label flipped at
    full size and then nearest-resized (the evaluator's order)."""
    jstates, pstates = [], []
    for (scale, flip), in_hw in zip(augs, in_hws):
        lab = resize_label(mask[:, ::-1] if flip else mask, in_hw)
        jimg = jeng._prep_impl(jnp.asarray(raw0[None]), in_hw, flip)[0]
        js, jlog = jeng.add_reference(
            jimg, jseparate_mask(jnp.asarray(lab[None]), groups, MAX_OBJ),
            obj_nums, gap=GAP)
        ptl = torch.from_numpy(mask)
        ptl = resize_nearest((ptl.flip(1) if flip else ptl)[None, ..., None],
                             in_hw)[..., 0]
        pimg = peng.prep(raw0[None], in_hw, flip)[0]
        np.testing.assert_allclose(pimg.numpy(), np.asarray(jimg), atol=1e-5)
        ps, plog = peng.add_reference(
            pimg, separate_mask(ptl, groups, MAX_OBJ), obj_nums, gap=GAP)
        assert plog.shape[0] == groups
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        jstates.append(js)
        pstates.append(ps)
    return jstates, pstates


def _jax_multi_step(jeng, states, raw_t, in_hws, groups):
    """One frame of the JAX engine's fused multi-aug step from its
    per-call functions, with the label split into `groups`."""
    flips = [f for _, f in AUGS]
    probs = []
    for i, (in_hw, flip) in enumerate(zip(in_hws, flips)):
        img = jeng._prep_impl(jnp.asarray(raw_t[None]), in_hw, flip)[0]
        states[i], logits4 = jeng.propagate(states[i], img)
        merged = jsoft_aggregation(jeng.predict_logits_at(logits4, RAW_HW),
                                   MAX_OBJ)
        if flip:
            merged = merged[:, ::-1]
        probs.append(jax.nn.softmax(merged.astype(jnp.float32), axis=-1))
    label = jnp.argmax(jnp.mean(jnp.stack(probs), 0), -1).astype(jnp.int32)
    for i, (in_hw, flip) in enumerate(zip(in_hws, flips)):
        lab = label[:, ::-1] if flip else label
        lab_in = jresize_nearest(lab[None, ..., None], in_hw)[0, ..., 0]
        states[i] = jeng.update_memory(
            states[i], jseparate_mask(lab_in[None], groups, MAX_OBJ))
    return np.asarray(label)


def test_multi_raw_two_groups_matches_jax(engines):
    """12 objects as two id groups (10 + 2), augs (1.0, flip) + (0.75, no
    flip), 7 raw frames after the reference (the bank fills at frame 4 and
    evicts at 6) through the port's scan_steps_multi_raw in one chunk,
    against the JAX engine's per-call functions composed as its fused
    multi-aug step. Labels per frame agree on >= AGREE_FLOOR of pixels, and
    both banks end with the same count."""
    jeng, peng = engines
    raw, mask = _video(12)
    in_hws = [restrict_size(*RAW_HW, 800 * 1.3, None, s) for s, _ in AUGS]
    assert [h // 16 + 1 for h, _ in in_hws] == [11, 8]
    jstates, pstates = _references(jeng, peng, raw[0], mask, AUGS, in_hws,
                                   2, [MAX_OBJ, 2])
    pstates, labels = peng.scan_steps_multi_raw(
        pstates, raw[1:], in_hws, RAW_HW, [f for _, f in AUGS])
    assert labels.dtype == torch.uint8 and labels.shape == (FRAMES, *RAW_HW)
    for t in range(FRAMES):
        ref = _jax_multi_step(jeng, jstates, raw[1 + t], in_hws, 2)
        agree = (labels[t].numpy() == ref).mean()
        assert agree >= AGREE_FLOOR, (t, agree)
    assert int(labels.max()) > MAX_OBJ          # the second group labels
    for js, ps in zip(jstates, pstates):
        assert int(ps.bank.count) == int(js.bank.count) == 3
        assert ps.short_k.shape[1] == 2


def test_raw_one_group_matches_jax_scans(engines):
    """Two objects, one group: the port's scan_steps_multi_raw against the
    JAX engine's own scan_steps_multi_raw (augs as above), and the port's
    single-aug scan_steps_raw against the JAX engine's, each over 7 raw
    frames in one chunk; labels per frame agree on >= AGREE_FLOOR of
    pixels."""
    jeng, peng = engines
    raw, mask = _video(2)
    in_hws = [restrict_size(*RAW_HW, 800 * 1.3, None, s) for s, _ in AUGS]
    flips = [f for _, f in AUGS]
    jstates, pstates = _references(jeng, peng, raw[0], mask, AUGS, in_hws,
                                   1, [2])
    _, jlabels = jeng.scan_steps_multi_raw(jstates, jnp.asarray(raw[1:]),
                                           in_hws, RAW_HW, flips)
    _, plabels = peng.scan_steps_multi_raw(pstates, raw[1:], in_hws, RAW_HW,
                                           flips)
    jstates, pstates = _references(jeng, peng, raw[0], mask, AUGS[1:],
                                   in_hws[1:], 1, [2])
    _, jlab1 = jeng.scan_steps_raw(jstates[0], jnp.asarray(raw[1:]),
                                   in_hws[1], RAW_HW, False)
    _, plab1 = peng.scan_steps_raw(pstates[0], raw[1:], in_hws[1], RAW_HW,
                                   False)
    for got, ref in ((plabels, jlabels), (plab1, jlab1)):
        assert got.dtype == torch.uint8
        agree = (got.numpy() == np.asarray(ref)).reshape(FRAMES, -1).mean(1)
        assert agree.min() >= AGREE_FLOOR, agree

"""The port's inference engine end to end against the JAX engine:
tiny_deaotl at 64x64, 1 former + 2 latter slots, a long-term write every
frame, so the bank fills on frame 2 and evicts from frame 3 on. Both
engines share the weights and are teacher-forced with the JAX engine's
labels, so any divergence shows on the frame where it starts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine import InferenceEngine as JEngine
from rmem_tpu.memory import valid_slot_mask as jvalid_slot_mask
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_params as jinit
from rmem_tpu.ops.resize import resize_bilinear as jresize_bilinear
from rmem_tpu.ops.resize import resize_nearest as jresize_nearest
from rmem_tpu.ops.resize import upsample_argmax as jupsample_argmax
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.memory import valid_slot_mask
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.ops.resize import upsample_argmax
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HW = (64, 64)
OUT_HW = (60, 70)        # production-style output: not grid-aligned
FRAMES = 9
OVER = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=2)
# f32 on both sides; logits pass ~40 layers whose sums run in another order
# (XLA vs ATen), so they agree to ~1e-5 of their scale
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


def _video():
    rng = np.random.RandomState(0)
    imgs = rng.rand(FRAMES + 1, 1, *HW, 3).astype(np.float32)
    mask = np.zeros((1, *HW), np.int32)
    mask[:, 8:30, 6:28] = 1
    mask[:, 36:60, 30:58] = 2
    mask[:, 0:4, 0:64] = 255          # an ignore band
    return imgs, mask


@pytest.fixture(scope="module")
def engines():
    jcfg = jget_config("pre_vost", model="tiny_deaotl", **OVER)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = jinit(jmodel, jax.random.PRNGKey(0), HW)
    # offsets on every leaf so unit scales and zero biases are exercised
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    jeng = JEngine(jmodel, params, jcfg, donate=False)

    def port_engine():
        cfg = get_config("pre_vost", model="tiny_deaotl", **OVER)
        model = build_vos_model("deaot", cfg)
        model.load_state_dict(params_from_jax(params), strict=True)
        return InferenceEngine(model, cfg, device="cpu")

    return jeng, port_engine


def _top2_gap(logits4, out_hw):
    up = np.asarray(jresize_bilinear(logits4, out_hw))[0]
    top2 = np.sort(up, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_engine_matches_jax_teacher_forced(engines):
    jeng, port_engine = engines
    peng = port_engine()
    imgs, mask = _video()
    js, jlog = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask),
                                  [2], gap=1)
    ps, plog = peng.add_reference(imgs[0], mask, [2], gap=1)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)

    counts, orders = [], []
    for t in range(1, FRAMES + 1):
        js, jlog = jeng.propagate(js, jnp.asarray(imgs[t]))
        ps, plog = peng.propagate(ps, imgs[t])
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_allclose(ps.record.numpy(), np.asarray(js.record),
                                   atol=1e-5)

        lab_j = np.asarray(jupsample_argmax(jlog, OUT_HW))
        lab_p = upsample_argmax(plog, OUT_HW).numpy()
        assert np.all((lab_p == lab_j) | (_top2_gap(jlog, OUT_HW) < TIE_EPS))

        lab_in = np.array(jresize_nearest(jnp.asarray(lab_j)[None, ..., None],
                                          HW))[..., 0]
        js = jeng.update_memory(js, jnp.asarray(lab_in))
        ps = peng.update_memory(ps, lab_in)

        jb, pb = js.bank, ps.bank
        assert int(pb.count) == int(jb.count)
        np.testing.assert_array_equal(valid_slot_mask(pb).numpy(),
                                      np.asarray(jvalid_slot_mask(jb)))
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
        orders.append(pb.order.tolist())
    # filled on frame 2, then one eviction per frame; the in-place writes
    # left physical and temporal order apart
    assert counts == [2, 3] + [3] * (FRAMES - 2)
    assert orders != [list(range(4))] * len(orders)


def test_step_loop_matches_teacher_forced_labels(engines):
    """The fused step (propagate, upsample + argmax, nearest resize back,
    update) over the same frames gives the JAX labels."""
    jeng, port_engine = engines
    peng = port_engine()
    imgs, mask = _video()
    js, _ = jeng.add_reference(jnp.asarray(imgs[0]), jnp.asarray(mask), [2],
                               gap=1)
    ps, _ = peng.add_reference(imgs[0], mask, [2], gap=1)
    ps, labels = peng.scan_steps(ps, imgs[1:], OUT_HW)
    assert labels.shape == (FRAMES, *OUT_HW) and labels.dtype == torch.int32
    for t in range(FRAMES):
        js, jlab = jeng.step(js, jnp.asarray(imgs[t + 1]), OUT_HW)
        gap = _top2_gap(js.logits4x, OUT_HW)
        assert np.all((labels[t].numpy() == np.asarray(jlab)) |
                      (gap < TIE_EPS)), t
    assert int(ps.bank.count) == int(js.bank.count)
    np.testing.assert_array_equal(ps.bank.order.numpy(),
                                  np.asarray(js.bank.order))


@pytest.mark.parametrize("do_write", [True, False])
def test_eviction_tie_takes_the_lowest_slot(do_write):
    """A full bank whose candidates score exactly alike (zero attention
    mass, equal survival counts): the victim is the lowest eligible slot on
    both sides, and a frame that writes nothing leaves order and count."""
    from rmem_tpu.memory import init_bank as jinit_bank
    from rmem_tpu.memory.eviction import update_bank_inplace as jupdate
    from rmem_tpu_torch.memory import init_bank, update_bank_inplace

    L, S, B, hw, c = 1, 5, 1, 4, 2
    jb = jinit_bank(L, S, B, hw, c, c)
    jb = jb.replace(count=jnp.int32(4), times=jnp.asarray([3, 2, 2, 2, 0],
                                                          jnp.int32),
                    scored=jnp.asarray([True] * 4 + [False]),
                    order=jnp.asarray([0, 3, 1, 2, 4], jnp.int32))
    pb = init_bank(L, S, B, hw, c, c)
    pb.count = torch.tensor(4, dtype=torch.int32)
    pb.times = torch.tensor([3, 2, 2, 2, 0], dtype=torch.int32)
    pb.scored = torch.tensor([True] * 4 + [False])
    pb.order = torch.tensor([0, 3, 1, 2, 4], dtype=torch.int32)
    rng = np.random.RandomState(3)
    new_k = rng.randn(L, B, hw, c).astype(np.float32)
    mass = np.zeros((B, hw, S), np.float32)
    fg = np.ones((B, hw), np.float32)
    jb = jupdate(jb, jnp.asarray(new_k), jnp.asarray(new_k),
                 jnp.asarray(do_write), 1, 3, jnp.asarray(mass),
                 jnp.asarray(fg))
    pb = update_bank_inplace(pb, torch.from_numpy(new_k),
                             torch.from_numpy(new_k), torch.tensor(do_write),
                             1, 3, torch.from_numpy(mass),
                             torch.from_numpy(fg))
    np.testing.assert_array_equal(pb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(pb.times.numpy(), np.asarray(jb.times))
    np.testing.assert_array_equal(pb.k.numpy(), np.asarray(jb.k))
    assert int(pb.count) == int(jb.count) == 4
    if do_write:
        # slots 1-3 tie; the lowest, physical slot 1, is overwritten and
        # keeps the newest rank
        assert pb.order.tolist() == [0, 3, 1, 2, 4]
        np.testing.assert_array_equal(pb.k.numpy()[:, 1], new_k)

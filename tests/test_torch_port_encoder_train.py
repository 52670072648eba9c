"""Training with a top-down encoder in the port against the JAX package,
f32 on both sides on the CPU, on the same inputs made from numpy seeds:
one whole AOT training step on the tiny top-down encoder (the tiny pyramid
and its reconstruction loss) with var_loss_weight 0.01, against
make_train_step, leaf by leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_encoders import _draw

from rmem_tpu.config import get_config as jget_config
from rmem_tpu.engine.train_state import TrainState as JTrainState
from rmem_tpu.engine.train_state import make_optimizer, make_train_step
from rmem_tpu.models import build_vos_model as jbuild
from rmem_tpu.models import init_forward
from rmem_tpu.ops import masks as jmasks
from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine.train_state import TrainState
from rmem_tpu_torch.managers.trainer import train_step
from rmem_tpu_torch.models import build_vos_model
from rmem_tpu_torch.utils import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the whole step, as tests/test_torch_port_aot_train.py holds tiny_aotl's:
# the losses to ~1e-6 relative, each gradient leaf to ~1e-5 of its largest
# value, the update at most lr (1e-5 at step 0) per element
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # max |port - jax| / max |jax| per leaf
# the self-attention's key bias has a zero gradient (the softmax cancels
# it): both sides hold f32 roundoff there
GRAD_ATOL = 1e-8
PARAM_ATOL = 1e-6

HW = (65, 65)
B, T = 2, 3
OVER = dict(compute_dtype="float32", data_seq_len=T, latter_mem_len=1,
            train_long_term_mem_gap=1, model_encoder="tiny_topdown",
            var_loss_weight=0.01)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _capture_grads():
    """An optax stage whose state keeps the raw gradients it is given, put
    before the JAX optimizer so the step exposes its gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _batch(rng):
    """Two clips: moving rectangles (2 objects, then 1), an ignore band."""
    imgs = rng.rand(B, T, *HW, 3).astype(np.float32)
    labels = np.zeros((B, T, *HW), np.int32)
    for t in range(T):
        labels[:, t, 10 + 3 * t:35 + 3 * t, 8:30] = 1
        labels[0, t, 40:60, 30 + 3 * t:55 + 3 * t] = 2
        labels[:, t, :4] = 255
    return dict(imgs=imgs, labels=labels,
                obj_nums=np.array([2, 1], np.int32))


def test_topdown_train_step_matches_jax():
    """tiny_aotl on the tiny top-down encoder at the `test` stage, step 0:
    the loss (with 0.01 x var_loss in it), var_loss itself, the aux and
    per-frame losses, IoU, the grad norm, every gradient leaf (the
    encoder's from the reconstruction loss too), the parameters after the
    update and the EMA."""
    rng = np.random.RandomState(0)
    jcfg = jget_config("test", model="tiny_aotl", **OVER)
    jmodel = jbuild(jcfg.model_vos, jcfg)
    params = _draw(jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, *HW, 3)), jnp.zeros((1, *HW, jcfg.id_channels)),
        method=init_forward), jax.random.PRNGKey(0))["params"], rng,
        amount=0.05)
    batch = _batch(rng)
    shuffle = jmasks.host_id_shuffle_matrix(
        np.random.RandomState(7), jcfg.model_max_obj_num + 1, B)
    tx = optax.chain(_capture_grads(), make_optimizer(params, jcfg))
    jstate = JTrainState(params=params, opt_state=tx.init(params),
                         ema_params=jax.tree_util.tree_map(jnp.array,
                                                           params),
                         step=jnp.int32(0))
    jnew, jm = jax.jit(make_train_step(jmodel, jcfg, tx))(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch),
        jnp.asarray(shuffle))

    cfg = get_config("test", model="tiny_aotl", **OVER)
    model = build_vos_model("aot", cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    state = TrainState.create(model)
    m = train_step(state, {k: torch.from_numpy(v)
                           for k, v in batch.items()},
                   torch.from_numpy(shuffle), cfg)

    assert state.step == 1 == int(jnew.step)
    assert float(jm["var_loss"]) > 0
    for key in ("loss", "var_loss", "aux_loss", "pred_loss", "aux_weight",
                "loss_per_frame", "iou_per_frame", "grad_norm"):
        np.testing.assert_allclose(m[key].detach().numpy(),
                                   np.asarray(jm[key]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    base = float(m["aux_weight"] * m["aux_loss"] + m["pred_loss"])
    np.testing.assert_allclose(float(m["loss"]),
                               base + 0.01 * float(m["var_loss"]), rtol=1e-6)
    grads = params_from_jax(jnew.opt_state[0])
    after = params_from_jax(jnew.params)
    ema = params_from_jax(jnew.ema_params)
    named = dict(state.model.named_parameters())
    assert set(named) == set(grads)
    assert named["encoder.recon.weight"].grad.abs().max() > 0
    for name, p in named.items():
        g = np.zeros_like(p.detach().numpy()) if p.grad is None \
            else p.grad.numpy()
        r = grads[name].numpy()
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max() + \
            GRAD_ATOL, (name, np.abs(g - r).max(), np.abs(r).max())
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(),
                                   ema[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)

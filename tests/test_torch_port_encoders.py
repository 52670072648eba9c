"""The port's encoder families against the JAX package's, f32 on the CPU,
with the same weights (moved over by params_from_jax) on the same inputs
made from numpy seeds: each family's pyramid and VJP (the input's and every
parameter's gradient) at 65 x 65, the top-down encoders' var_loss too.
Swin, the weight bridge on the full-size trees, the BN fold and the
parameter groups are in test_torch_port_encoder_parts.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmem_tpu.models.encoders import build_encoder as jbuild_encoder
from rmem_tpu_torch.models.encoders import build_encoder
from rmem_tpu_torch.utils import params_from_jax

HW = (65, 65)
# f32 on both sides: deep conv stacks sum in another order (XLA vs ATen)
FWD_TOL = 1e-4
# gradients pass the whole stack twice; each leaf against its own scale
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _draw(shapes, rng, amount=0.1):
    """A parameter tree on `shapes` drawn with numpy: kernels lecun-normal,
    scales 0.3 (at 1 the deep residual stacks' activations grow to ~1e9 on
    random weights, and at 0.5 the top-down encoder's second pass to ~1e3,
    where f32 sums lose the gradients to ~1e-3), every other leaf 0, each offset by `amount` x N(0, 1),
    so zero biases take part; the top-down transform the identity plus
    the offset."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            base = rng.randn(*s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif name == "scale":
            base = np.full(s.shape, 0.3)
        elif name == "top_down_transform":
            base = np.eye(s.shape[0])
        else:
            base = np.zeros(s.shape)
        return (base + amount * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _shapes(module, x):
    return jax.eval_shape(lambda r: module.init(r, x),
                          jax.random.PRNGKey(0))["params"]


def _close(out, ref, rel, what=""):
    """max |out - ref| <= rel * max |ref|."""
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _vjp_both(jenc, enc, params, x, rng, topdown):
    """Forward and VJP of the flax encoder and the port's on the same
    weights, input and cotangents (N(0, 1) on every pyramid level, and 1
    on the var_loss). Returns ((pyramid, var_loss, dx, dparams) of JAX,
    the same of the port) with the port's pyramid NHWC and its gradients
    by state-dict name."""
    def jfwd(p, xx):
        out = jenc.apply({"params": p}, xx)
        return out if topdown else (out, jnp.zeros(()))

    @jax.jit
    def fwd_vjp(p, xx, ct):       # one compile for both directions
        out, vjp = jax.vjp(jfwd, p, xx)
        return out, vjp((ct, jnp.ones(())))

    shapes = jax.eval_shape(jfwd, params, jnp.asarray(x))[0]
    cts = tuple(rng.randn(*t.shape).astype(np.float32) for t in shapes)
    (jpyr, jvl), (jdp, jdx) = fwd_vjp(params, jnp.asarray(x), cts)

    enc.load_state_dict(params_from_jax(params), strict=True)
    enc.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = enc(xt)
    pyr, vl = out if topdown else (out, None)
    total = sum((p * torch.from_numpy(c).permute(0, 3, 1, 2)).sum()
                for p, c in zip(pyr, cts))
    (total + (vl if topdown else 0.0)).backward()
    grads = {n: p.grad for n, p in enc.named_parameters()}
    return ((jpyr, jvl, jdx, params_from_jax(jax.device_get(jdp))),
            (tuple(p.permute(0, 2, 3, 1) for p in pyr), vl, xt.grad, grads))


@pytest.mark.parametrize("name", ["mobilenetv2", "mobilenetv3", "resnest50",
                                  "resnet50_topdown", "tiny_topdown"])
def test_encoder_matches_flax(name):
    """Pyramid, var_loss (top-down), the image's gradient and every
    parameter's gradient, leaf by leaf, at 65 x 65 (odd: every stride
    rounds up, the avg-down shortcut pools a last single column)."""
    rng = np.random.RandomState(0)
    x = rng.rand(1, *HW, 3).astype(np.float32)
    jenc = jbuild_encoder(name, dtype=jnp.float32)
    params = _draw(_shapes(jenc, jnp.asarray(x)), rng)
    topdown = name.endswith("topdown")
    (jpyr, jvl, jdx, jgrads), (pyr, vl, dx, grads) = _vjp_both(
        jenc, build_encoder(name), params, x, rng, topdown)
    assert len(pyr) == len(jpyr) == 4
    for i, (a, b) in enumerate(zip(pyr, jpyr)):
        _close(a, b, FWD_TOL, f"level {i}")
    if topdown:
        assert float(jvl) > 0
        _close(vl, jvl, FWD_TOL, "var_loss")
    _close(dx, jdx, GRAD_TOL, "d image")
    assert grads.keys() == jgrads.keys()
    for k, g in grads.items():
        if g is None:      # reaches no output: zero on the JAX side
            assert not np.any(jgrads[k].numpy()), k
        else:
            _close(g, jgrads[k], GRAD_TOL, k)

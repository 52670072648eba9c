"""The plain version behind K5's hand-written backward, against the JAX
package and against autograd, f32 on the CPU: `local_attention_bwd_plain`
(what csrc/local_attention.cu's two backward kernels compute) against the
backward rule of pallas_local_attention_trainable and against autograd of
the port's plain forward, on a grid of whole 8 x 8 tiles in one axis and
one ragged in both; and the autograd Function that takes it on the card.
K3's rewrite moved no arithmetic to the host: its partials and merge run
on the card and are held there (chip_smoke.py), and its plain version
against the JAX K3 in test_torch_port_optin.py."""

import jax
import numpy as np
import pytest
import torch

from rmem_tpu.kernels.local_attention import _trainable_bwd
from rmem_tpu_torch.kernels import local_attention as klocal

# f32 on both sides; the JAX rule sums in another order (the tiled XLA
# form's VJP): a few f32 ulps of O(1) values, as test_torch_port_train_kernels
TOL = dict(rtol=1e-4, atol=1e-4)
# the same function in the same library, summed in another order
AUTOGRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# 8 x 9: whole 8 x 8 tiles down, ragged across; 9 x 13: ragged on both
# axes (both at least 8 a side, where the JAX form keeps the whole window)
GRIDS = [(8, 9), (9, 13)]
B, DH, DV = 2, 32, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _local_inputs(size, seed):
    rng = np.random.RandomState(seed)
    hw = size[0] * size[1]
    args = [rng.randn(B, hw, d).astype(np.float32)
            for d in (DH, DH, DV, 225)]
    g = rng.randn(B, hw, DV).astype(np.float32)
    return args, g, DH ** -0.5


@pytest.mark.parametrize("size", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_local_attention_bwd_plain_matches_jax_rule(size):
    """dq, dk, dv, drel of the plain backward against
    pallas_local_attention_trainable's backward rule (_trainable_bwd, the
    VJP of the XLA tiled form at the saved inputs)."""
    args, g, scale = _local_inputs(size, 0)
    refs = jax.jit(lambda *a: _trainable_bwd(size, 1, 7, scale, True, a[:4],
                                             a[4]))(*args, g)
    got = klocal.local_attention_bwd_plain(
        *map(torch.tensor, args), torch.tensor(g), size, 1, 7, scale)
    for name, t, r in zip(("dq", "dk", "dv", "drel"), got, refs):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("size", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_local_attention_bwd_plain_matches_autograd(size):
    """The plain backward against autograd of the port's plain forward;
    drel is 0 wherever the window leaves the image."""
    args, g, scale = _local_inputs(size, 1)
    ins = [torch.tensor(a, requires_grad=True) for a in args]
    klocal.local_attention_plain(*ins, size, 1, 7, scale).backward(
        torch.tensor(g))
    got = klocal.local_attention_bwd_plain(
        *map(torch.tensor, args), torch.tensor(g), size, 1, 7, scale)
    for name, t, leaf in zip(("dq", "dk", "dv", "drel"), got, ins):
        np.testing.assert_allclose(t.numpy(), leaf.grad.numpy(),
                                   **AUTOGRAD_TOL, err_msg=name)
    _, inside = klocal._window_keys(*size, 7)
    assert np.all(got[3].numpy()[:, ~inside] == 0)


def test_local_attention_function_drops_unasked_gradients():
    """The autograd Function the card runs (K4 forward, the backward
    kernels), here on CPU tensors, where both wrappers take their plain
    versions: gradients of the inputs that ask for one, in each input's
    dtype, none for the others, and no launch counted."""
    size = (9, 13)
    args, g, scale = _local_inputs(size, 2)
    q, k, v, rel = (torch.tensor(a, requires_grad=n) for a, n in
                    zip(args, (True, False, False, True)))
    before = klocal.local_attention_bwd.launches
    out = klocal._LocalAttention.apply(q, k, v, rel, size, 1, 7, scale)
    out.backward(torch.tensor(g))
    # the Function hands the kernels the cotangent in bf16, their type
    ref = klocal.local_attention_bwd_plain(
        q.detach(), k, v, rel.detach(), torch.tensor(g).to(torch.bfloat16),
        size, 1, 7, scale)
    assert k.grad is None and v.grad is None
    for t, r in ((q, ref[0]), (rel, ref[3])):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.numpy(), r.numpy(), rtol=0, atol=0)
    assert klocal.local_attention_bwd.launches == before


def test_local_attention_function_under_checkpoint():
    """The training loop runs each frame under torch.utils.checkpoint,
    which lets a backward read its saved tensors once: the Function's
    gradients there equal the plain backward's."""
    size = (9, 13)
    args, g, scale = _local_inputs(size, 3)
    ins = [torch.tensor(a, requires_grad=True) for a in args]
    out = torch.utils.checkpoint.checkpoint(
        lambda *a: klocal._LocalAttention.apply(*a, size, 1, 7, scale), *ins,
        use_reentrant=False)
    out.backward(torch.tensor(g))
    ref = klocal.local_attention_bwd_plain(
        *map(torch.tensor, args), torch.tensor(g).to(torch.bfloat16), size,
        1, 7, scale)
    for t, r in zip(ins, ref):
        np.testing.assert_allclose(t.grad.numpy(), r.numpy(), rtol=0, atol=0)


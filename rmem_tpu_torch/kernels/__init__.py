"""Hand-written CUDA kernels for Hopper (sources in ../csrc), one module
each, and their build. A wrapper launches its kernel for tensors on the card
and runs its plain PyTorch version for tensors on the CPU."""

from __future__ import annotations


def plain_vjp(fn, inputs, needs_grad, g):
    """The backward of a kernel that has none of its own: gradients of the
    plain version `fn` at the saved `inputs` for the cotangent `g`, by
    autograd with autocast off (the plain version sets its own types).
    Returns one gradient per input, None where `needs_grad` is False."""
    import torch
    with torch.enable_grad(), torch.autocast(g.device.type, enabled=False):
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs,
                                                            needs_grad)]
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*ins), wanted, g)
                     if wanted else ())
    return tuple(next(grads) if n else None for n in needs_grad)

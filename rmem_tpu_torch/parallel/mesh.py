"""Data-parallel training over processes, one process a card.

Counterpart of `rmem_tpu/parallel/mesh.py`. The JAX package drives every
device from one process and lets XLA insert the gradient psum; here each
process runs the step on its rows of the global batch and the gradients
are averaged over the mesh's "data" axis after the backward, before the
optimizer, so the global-norm clip and Adam see the global batch's
gradient, as the psum gives it (and as the reference's DDP did,
trainer.py:92-109). The step calls the model's methods rather than its
forward, so the gradients are all-reduced here, in flat buckets, instead
of through DistributedDataParallel's hooks; a parameter with no gradient
on a step (the temporal PE, the GRU cells) takes zeros, as
`apply_gradients` does. BN is frozen, so there is no SyncBN.

The losses are batch means, so every process takes the same number of
rows: a global batch the data axis does not divide raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2**20


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_shape(shape: Sequence[int], world: int) -> tuple:
    """The mesh's axis sizes, -1 taking the processes left."""
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape = tuple(world // known if s == -1 else s for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape} for {world} processes")
    return shape


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)):
    """A DeviceMesh over the default process group's ranks (which must be
    initialised: parallel.maybe_initialize_distributed), on the card
    under nccl and on the CPU under gloo; -1 absorbs the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.maybe_initialize_distributed)")
    shape = resolve_shape(shape, _world())
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, shape, mesh_dim_names=tuple(axes))


def data_coordinate(mesh) -> tuple:
    """(this process's index on the "data" axis, the axis's size)."""
    return (mesh.get_local_rank("data"), mesh.size(
        mesh.mesh_dim_names.index("data")))


def shard_rows(x, mesh):
    """This process's rows of a global-batch array or tensor: the i-th of
    n equal parts along the leading dim for data index i of n."""
    i, n = data_coordinate(mesh)
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} over {n} data-parallel "
                         "processes: the losses are batch means, so each "
                         "takes the same number of rows")
    return x[i * b // n:(i + 1) * b // n]


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This process's rows of every entry of a global batch."""
    return {k: shard_rows(v, mesh) for k, v in batch.items()}


def allreduce_grads(params: Sequence[torch.nn.Parameter], group=None,
                    bucket_bytes: int = BUCKET_BYTES) -> None:
    """Average the parameters' gradients over `group` in flat buckets (a
    missing gradient counts as zeros and is set)."""
    n = dist.get_world_size(group)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket: list = []
    size = 0

    def flush():
        flat = torch.cat([p.grad.reshape(-1) for p in bucket])
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        off = 0
        for p in bucket:
            k = p.grad.numel()
            p.grad.copy_(flat[off:off + k].view_as(p.grad))
            off += k

    for p in params:
        if bucket and (size + p.grad.numel() * p.grad.element_size()
                       > bucket_bytes or p.grad.dtype != bucket[0].grad.dtype):
            flush()
            bucket, size = [], 0
        bucket.append(p)
        size += p.grad.numel() * p.grad.element_size()
    if bucket:
        flush()


def allreduce_metrics(metrics: Dict[str, torch.Tensor], group=None
                      ) -> Dict[str, torch.Tensor]:
    """The mean over `group` of every floating metric of one step but the
    per-sample prediction, in one all-reduce."""
    keys = [k for k, v in metrics.items()
            if v.is_floating_point() and k != "pred_label_last"]
    if not keys:
        return metrics
    dev = next((metrics[k].device for k in keys if metrics[k].is_cuda),
               torch.device("cpu"))
    parts = [metrics[k].to(dev, torch.float32).reshape(-1) for k in keys]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    out = dict(metrics)
    off = 0
    for k, p in zip(keys, parts):
        v = metrics[k]
        out[k] = flat[off:off + p.numel()].view_as(v).to(v.device, v.dtype)
        off += p.numel()
    return out


def make_parallel_train_step(step_fn: Callable, mesh) -> Callable:
    """step_fn(state, batch, shuffle, cfg, reduce_grads=...) over this
    process's rows of the global batch and shuffle, its gradients averaged
    over the mesh's "data" axis before the optimizer and its metrics
    averaged after. With a "model" axis the model must already be split by
    parallel/tp.py (its sharded gradients are averaged over "data" only,
    like the rest)."""
    group = mesh.get_group("data")

    def reduce(model: torch.nn.Module) -> None:
        allreduce_grads(list(model.parameters()), group)

    def step(state, batch, shuffle: Optional[torch.Tensor], cfg):
        batch = shard_batch(batch, mesh)
        if shuffle is not None:
            shuffle = shard_rows(shuffle, mesh)
        metrics = step_fn(state, batch, shuffle, cfg, reduce_grads=reduce)
        return allreduce_metrics(metrics, group)

    return step

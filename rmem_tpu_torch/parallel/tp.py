"""Tensor-parallel split of the self-attention on a ("data", "model") mesh.

Counterpart of `rmem_tpu/parallel/tp.py`. `spec_for_param` is its rule,
by the parameter's name (the flax path with dots; a torch Linear's
`weight` is the flax `kernel` transposed), giving the partition in the
flax layout as JAX's PartitionSpec reads it:

  linear_V1/V2/U1/U2 kernel [in, out] and bias: column-parallel
      ((None, "model") and ("model",));
  self_attn ... projection kernel: row-parallel (("model", None)), its
      bias replicated;
  everything else: replicated (()).

GSPMD partitions every op from those annotations in JAX; here
`split_model` does it by hand, one process a shard, with local slices and
one all-reduce a block. In DeAOT's gated self-attention each rank keeps
its rows of the four column-parallel layers, so the value and gate
streams, the attention output, the gate multiply and the depthwise conv
hold only this rank's channels (the depthwise conv's weight is
replicated, and each rank takes its channels' taps); the projection takes
the matching columns of its kernel and the partial outputs are summed
over the "model" axis (in f32). The attention's query/key projection is
replicated; with more heads than ranks each rank takes its heads' columns
of it. In AOT's self-attention only the output projection is split (its
input is replicated; each rank takes its columns). Wherever a replicated
tensor enters a split computation, its gradient is summed over the axis
(Megatron's conjugate pair), so every replicated parameter's gradient is
whole on every rank, and the data-parallel average (parallel/mesh.py)
runs over "data" alone. `gather` and `shard` move a parameter-shaped
tensor (the weights, the optimizer's moments, the EMA) between its local
and its whole form, so that checkpoints hold whole tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from rmem_tpu_torch.utils.checkpoint import flax_path

COL_DENSE = ("linear_V1", "linear_V2", "linear_U1", "linear_U2")


def spec_for_param(name: str) -> Tuple[Optional[str], ...]:
    """The partition of one parameter in the flax layout: (None, "model"),
    ("model",), ("model", None) or () (replicated). Reads optimizer and
    EMA mirrors of a parameter by the same name."""
    keys = flax_path(name)
    if len(keys) >= 2 and keys[-2] in COL_DENSE:
        if keys[-1] == "kernel":
            return (None, "model")
        if keys[-1] == "bias":
            return ("model",)
    if (len(keys) >= 2 and keys[-2] == "projection"
            and keys[-1] == "kernel" and "self_attn" in keys):
        return ("model", None)
    return ()


def state_shardings(state) -> Dict[str, Dict[str, Tuple]]:
    """The rule over a TrainState: each parameter-shaped entry (the
    weights, the optimizer's moments, the EMA) by its name, as JAX's
    state_shardings annotates its train state."""
    return {key: {n: spec_for_param(n) for n in tensors}
            for key, tensors in state.state_dict().items()
            if isinstance(tensors, dict)}


def torch_dim(name: str) -> Optional[int]:
    """The torch layout's split dim of a parameter (None: replicated): a
    Linear weight is the flax kernel transposed."""
    spec = spec_for_param(name)
    if "model" not in spec:
        return None
    dim = spec.index("model")
    return 1 - dim if flax_path(name)[-1] == "kernel" else dim


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromModel(torch.autograd.Function):
    """The partial outputs summed over the axis; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ToModel.apply(x, group)


def from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Sum partial outputs over the axis in f32, back in x's dtype."""
    return _FromModel.apply(x.float(), group).to(x.dtype)


class ColumnParallelLinear(nn.Module):
    """This rank's output rows of a Linear, on a replicated input."""

    def __init__(self, lin: nn.Linear, rows: torch.Tensor, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(lin.weight.detach()[rows].clone())
        self.bias = nn.Parameter(lin.bias.detach()[rows].clone())

    def forward(self, x):
        return F.linear(to_model(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's input columns of a Linear, its partial outputs summed
    over the axis, then the (replicated) bias. With `cols` the input is
    replicated and the rank takes those columns of it."""

    def __init__(self, lin: nn.Linear, cols: torch.Tensor, group,
                 take_cols: bool):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(lin.weight.detach()[:, cols].clone())
        self.bias = nn.Parameter(lin.bias.detach().clone())
        self.register_buffer("cols", cols if take_cols else None,
                             persistent=False)

    def forward(self, x):
        if self.cols is not None:
            x = to_model(x, self.group)[..., self.cols]
        return from_model(F.linear(x, self.weight), self.group) + self.bias


class ReplicatedLinear(nn.Module):
    """A replicated Linear feeding split work: its output's gradient is
    summed over the axis; with `cols` the rank keeps those columns."""

    def __init__(self, lin: nn.Linear, cols: Optional[torch.Tensor], group):
        super().__init__()
        self.group = group
        self.weight, self.bias = lin.weight, lin.bias
        self.register_buffer("cols", cols, persistent=False)

    def forward(self, x):
        y = to_model(F.linear(x, self.weight, self.bias), self.group)
        return y if self.cols is None else y[..., self.cols]


class SlicedDepthwiseConv(nn.Module):
    """A replicated depthwise conv's taps for this rank's channels."""

    def __init__(self, conv: nn.Conv2d, channels: torch.Tensor, group):
        super().__init__()
        if conv.bias is not None:
            raise ValueError("the depthwise conv has no bias")
        self.group = group
        self.weight = conv.weight
        self.padding = conv.padding
        self.register_buffer("channels", channels, persistent=False)

    def forward(self, x):
        w = to_model(self.weight, self.group)[self.channels]
        return F.conv2d(x, w, padding=self.padding, groups=w.shape[0])


class TensorParallelSplit:
    """What `split_model` did: for each split parameter, its torch dim and
    this rank's indices along it."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = size
        self.index: Dict[str, Tuple[int, torch.Tensor]] = {}

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a parameter-shaped local one (collective:
        every rank calls it for the same names in the same order)."""
        if name not in self.index:
            return t
        dim, idx = self.index[name]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        # every tensor of a collective on one device (gloo refuses a mix)
        idx = idx.to(t.device)
        idxs = [torch.empty_like(idx) for _ in range(self.size)]
        dist.all_gather(idxs, idx, group=self.group)
        shape = list(t.shape)
        shape[dim] = sum(i.numel() for i in idxs)
        whole = t.new_empty(shape)
        whole.index_copy_(dim, torch.cat(idxs), torch.cat(parts, dim=dim))
        return whole

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole parameter-shaped tensor."""
        if name not in self.index:
            return t
        dim, idx = self.index[name]
        return t.index_select(dim, idx.to(t.device))


def _split_gpm(sa, rank: int, size: int, group, prefix: str,
               split: TensorParallelSplit) -> None:
    """DeAOT's GatedSelfAttention: column-parallel value and gate, the
    local heads (or all of one head), sliced depthwise taps, row-parallel
    projection."""
    from rmem_tpu_torch.ops.attention import interleave_heads
    h = sa.num_heads
    d_vu = sa.linear_V1.out_features
    if d_vu % size or not (h == 1 or h % size == 0):
        raise ValueError(f"{prefix}: {h} heads of {d_vu} values over "
                         f"{size} ranks")
    c = d_vu // size
    rows = torch.arange(rank * c, (rank + 1) * c)
    heads = 1 if h == 1 else h // size
    a = rows.float()[None, None]
    chans = interleave_heads(a, a + d_vu, heads)[0, 0].long()
    qk_cols = None
    if h > 1:
        d_att = sa.linear_QK.out_features // h
        qk_cols = torch.arange(rank * heads * d_att,
                               (rank + 1) * heads * d_att)
    for name in COL_DENSE:
        setattr(sa, name, ColumnParallelLinear(getattr(sa, name), rows,
                                               group))
        split.index[f"{prefix}.{name}.weight"] = (0, rows)
        split.index[f"{prefix}.{name}.bias"] = (0, rows)
    sa.linear_QK = ReplicatedLinear(sa.linear_QK, qk_cols, group)
    sa.num_heads = heads
    sa.tail.dw_conv.conv = SlicedDepthwiseConv(sa.tail.dw_conv.conv, chans,
                                               group)
    sa.tail.projection = RowParallelLinear(sa.tail.projection, chans, group,
                                           take_cols=False)
    split.index[f"{prefix}.tail.projection.weight"] = (1, chans)


def _split_aot(sa, rank: int, size: int, group, prefix: str,
               split: TensorParallelSplit) -> None:
    """AOT's self-attention: the output projection row-parallel on its
    replicated input."""
    d = sa.projection.in_features
    if d % size:
        raise ValueError(f"{prefix}: {d} channels over {size} ranks")
    cols = torch.arange(rank * d // size, (rank + 1) * d // size)
    sa.projection = RowParallelLinear(sa.projection, cols, group,
                                      take_cols=True)
    split.index[f"{prefix}.projection.weight"] = (1, cols)


def split_model(model: nn.Module, mesh) -> TensorParallelSplit:
    """Split `model` in place across the mesh's "model" axis (before the
    optimizer state is made): every self-attention block by the rule
    above; the parameters keep their names. Returns the split's record,
    also kept as model.tp_split."""
    from rmem_tpu_torch.models.gpm import GatedSelfAttention
    from rmem_tpu_torch.models.lstt import MultiheadAttentionModule
    group = mesh.get_group("model")
    rank = mesh.get_local_rank("model")
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    split = TensorParallelSplit(group, size)
    for name, mod in list(model.named_modules()):
        if not name.endswith("self_attn"):
            continue
        if isinstance(mod, GatedSelfAttention):
            _split_gpm(mod, rank, size, group, name, split)
        elif isinstance(mod, MultiheadAttentionModule):
            _split_aot(mod, rank, size, group, name, split)
    for pname in split.index:
        if torch_dim(pname) != split.index[pname][0]:
            raise AssertionError(f"{pname}: split off the rule's dim")
    model.tp_split = split
    return split

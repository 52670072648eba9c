"""Processes: data-parallel training (mesh), the tensor-parallel split of
the GPM self-attention (tp), and evaluation spread over processes
(eval_sharding). Counterpart of `rmem_tpu/parallel/__init__.py`."""

from rmem_tpu_torch.parallel.eval_sharding import (  # noqa: F401
    allreduce_stats,
    host_sequence_indices,
    maybe_initialize_distributed,
)
from rmem_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_parallel_train_step,
    shard_batch,
)
from rmem_tpu_torch.parallel.tp import (  # noqa: F401
    spec_for_param,
    split_model,
    state_shardings,
)

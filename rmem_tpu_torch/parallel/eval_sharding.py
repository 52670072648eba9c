"""Evaluation over several processes: starting their process group, which
sequences each takes, and the sum of their scalar stats.

Counterpart of `rmem_tpu/parallel/eval_sharding.py`.
`maybe_initialize_distributed` starts `torch.distributed`'s default
group from explicit arguments or the launcher's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them) and does
nothing when neither names one. The partition helpers are plain Python
and give every process the same answer; `allreduce_stats` sums over the
default group when one is initialised, and is the identity otherwise.
Without a group the process is rank 0 of 1.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device: Optional[str] = None,
                                 timeout_s: float = 600.0) -> bool:
    """Start the default process group and return True, or return False
    when nothing names one (no init_method and no MASTER_ADDR in the
    environment). init_method is a URL (tcp://host:port); world_size and
    rank default to WORLD_SIZE and RANK. The backend is nccl when the
    process runs on the card (`device` cuda, or None with a card present)
    and each of the host's ranks (LOCAL_WORLD_SIZE, else the world) has a
    card of its own, else gloo (nccl refuses two ranks on one card). On
    the card the process takes the card LOCAL_RANK (else its rank) modulo
    the cards present. An initialised group is left as it is."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = (f"tcp://{env['MASTER_ADDR']}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None or world_size is None:
        return False
    rank = 0 if rank is None else rank
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    if on_card:
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        local = int(env.get("LOCAL_WORLD_SIZE", world_size))
        backend = ("nccl" if on_card and local <= torch.cuda.device_count()
                   else "gloo")
    import datetime
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_sequence_indices(num_sequences: int,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None,
                          lengths: Optional[Sequence[int]] = None
                          ) -> List[int]:
    """This process's sequence indices: with `lengths` (frames a
    sequence), greedy longest-processing-time assignment (longest first,
    each to the least-loaded process, ties to the lower index); without,
    a stride."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if lengths is None:
        return list(range(pi, num_sequences, pc))
    if len(lengths) != num_sequences:
        raise ValueError(f"{len(lengths)} lengths for {num_sequences} "
                         "sequences")
    loads = [0] * pc
    assign: List[List[int]] = [[] for _ in range(pc)]
    order = sorted(range(num_sequences), key=lambda i: (-lengths[i], i))
    for i in order:
        h = min(range(pc), key=lambda j: (loads[j], j))
        loads[h] += lengths[i]
        assign[h].append(i)
    return sorted(assign[pi])


def split_bulk_tail(num_sequences: int, lengths: Sequence[int],
                    process_count: int, tail_frac: float = 0.1
                    ) -> Tuple[List[List[int]], List[int]]:
    """(bulk per process, tail): the shortest sequences, up to tail_frac of
    all frames, are held back to be claimed at run time by whichever
    process finishes first (`claim_next`); the rest are assigned longest
    first to the least-loaded process."""
    if len(lengths) != num_sequences:
        raise ValueError(f"{len(lengths)} lengths for {num_sequences} "
                         "sequences")
    budget = sum(lengths) * tail_frac
    by_len = sorted(range(num_sequences), key=lambda i: (lengths[i], i))
    tail: List[int] = []
    acc = 0
    for i in by_len:
        if acc + lengths[i] > budget or process_count <= 1:
            break
        tail.append(i)
        acc += lengths[i]
    tail_set = set(tail)
    bulk = [i for i in range(num_sequences) if i not in tail_set]
    loads = [0] * process_count
    assign: List[List[int]] = [[] for _ in range(process_count)]
    for i in sorted(bulk, key=lambda i: (-lengths[i], i)):
        h = min(range(process_count), key=lambda j: (loads[j], j))
        loads[h] += lengths[i]
        assign[h].append(i)
    return [sorted(a) for a in assign], sorted(tail)


def claim_next(claim_dir: str, candidates: Sequence[int],
               owner: str = "") -> Optional[int]:
    """Claim the first unclaimed index by creating its lock file with
    O_CREAT | O_EXCL in a directory every process shares; None when all
    are taken."""
    os.makedirs(claim_dir, exist_ok=True)
    for i in candidates:
        path = os.path.join(claim_dir, f"seq_{i:06d}.claim")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        with os.fdopen(fd, "w") as f:
            f.write(owner)
        return i
    return None


def allreduce_stats(stats: Dict[str, float]) -> Dict[str, float]:
    """Sum scalar stats over the processes of the default group (f64, on
    the group backend's device); the identity in a single process."""
    if world_size() == 1:
        return dict(stats)
    keys = sorted(stats)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    vec = torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64,
                       device=dev)
    dist.all_reduce(vec)
    return {k: float(v) for k, v in zip(keys, vec.tolist())}

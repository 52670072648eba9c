"""Training CLI: compose the config and train on the stage's datasets.

    python -m rmem_tpu_torch.tools.train --stage test --model tiny_deaotl
    python -m rmem_tpu_torch.tools.train --model r50_aotl --batch_size 4 \
        --data_root ./datasets
    python -m rmem_tpu_torch.tools.train ... --device cpu
    python -m rmem_tpu_torch.tools.train ... --pretrained_path R50_DeAOTL.pth
    python -m rmem_tpu_torch.tools.train ... --opt gru_memory=true \
        reverse_infer=true train_opt=sgd
    python -m rmem_tpu_torch.tools.train --stage pre --data_root ./datasets
    python -m rmem_tpu_torch.tools.train ... --mesh 4

The stage's `datasets` are read under --data_root (default the config's
dir_data, ./datasets) in their layouts (data/train_datasets.py:
build_train_dataset: VOST/, DAVIS/, YTB/2019/train/, VISOR/); the stage
`test` trains on constant synthetic clips. The config is saved as
<dir_result>/config.json, stdout is mirrored into
<dir_result>/logs/train_<time>.txt and the package's source copied to
<dir_result>/codes.

Runs on the card unless --device cpu is given; on the CPU the activations
default to f32 (--opt compute_dtype=bfloat16 overrides). --pretrained_path
starts from a reference .pth, a JAX msgpack params tree or a file of this
package's where the stage's `pretrain` is on. The trainer saves its checkpoint stream every train_save_step
steps under the run's result directory and resumes from it when
train_auto_resume is set (the stages pre_vost* and test turn it off).
--save also saves the stream after the last step; --resume starts from a
file of the stream or from the newest readable one in a stream directory.
Results go under <dir_root>/<exp_name>_<model name>/<stage>, where
tools/eval.py looks for them (both default --exp_name to rmem).

--mesh N spawns N ranks (torch.multiprocessing), one card each, joined by
nccl, or by gloo on the CPU (--device cpu) or where the ranks outnumber
the cards; the config's mesh_shape becomes the given sizes (`--mesh 1 2
--opt "mesh_axes=('data','model')"` adds the tensor-parallel axis). Each
rank steps on its rows of the global batch of --batch_size clips; rank 0
writes the config, the logs and the checkpoints.
"""

from __future__ import annotations

import argparse
import ast


def _parse_opts(pairs):
    """KEY=VALUE config overrides, values read as Python literals where
    they parse (ints, floats, bools, tuples), true and false in any case
    as bools, and as strings otherwise."""
    over = {}
    for kv in pairs:
        if "=" not in kv:
            raise SystemExit(f"--opt expects KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            over[k] = v.lower() == "true"
            continue
        try:
            over[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            over[k] = v
    return over


def main(argv=None):
    p = argparse.ArgumentParser(description="rmem_tpu_torch training")
    p.add_argument("--exp_name", default="rmem")
    p.add_argument("--stage", default="pre_vost_2")
    p.add_argument("--model", default="r50_deaotl")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--total_steps", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop after this many steps")
    p.add_argument("--pretrained_path", default=None)
    p.add_argument("--data_root", default=None,
                   help="the datasets' root (default: the config's "
                        "dir_data)")
    p.add_argument("--seed", type=int, default=0,
                   help="the initial weights' seed (init_params), where "
                        "no pretrained weights are loaded")
    p.add_argument("--save", action="store_true",
                   help="save the checkpoint stream after the last step")
    p.add_argument("--resume", default=None,
                   help="start from this save, or from the newest in this "
                        "stream directory")
    p.add_argument("--mesh", type=int, nargs="*", default=None,
                   help="the process mesh's sizes, one rank a card, e.g. "
                        "--mesh 4")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms in every rank, "
                        "so that a run repeats bit for bit")
    p.add_argument("--fix_random", action="store_true",
                   help="seed numpy's global random state with 1, as "
                        "rmem_tpu's CLI does")
    p.add_argument("--opt", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, e.g. --opt train_log_step=1")
    args = p.parse_args(argv)
    if args.mesh:
        import math
        n = math.prod(args.mesh)
        if n < 1:
            raise SystemExit(f"--mesh {args.mesh}: give every axis's size")
        import socket

        import torch.multiprocessing as mp
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        mp.spawn(_rank_main, args=(n, port, args), nprocs=n, join=True)
        return
    _run(args)


def _rank_main(rank: int, world: int, port: int, args) -> None:
    """One rank of --mesh: its process group, then the run."""
    import torch

    from rmem_tpu_torch.parallel import maybe_initialize_distributed
    maybe_initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                 device=("cpu" if args.device == "cpu"
                                         else "cuda"))
    try:
        _run(args)
    finally:
        torch.distributed.destroy_process_group()


def _run(args) -> None:
    import os

    import torch

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.managers.trainer import Trainer
    from rmem_tpu_torch.utils.logging import Tee, copy_codes
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    over = {}
    if args.device == "cpu":
        over["compute_dtype"] = "float32"
    if args.batch_size:
        over["train_batch_size"] = args.batch_size
    if args.total_steps:
        over["train_total_steps"] = args.total_steps
    if args.pretrained_path:
        over["pretrain_model"] = args.pretrained_path
    if args.mesh:
        over["mesh_shape"] = tuple(args.mesh)
    over.update(_parse_opts(args.opt))
    cfg = get_config(args.stage, args.exp_name, args.model, **over)
    rank0 = (not torch.distributed.is_initialized()
             or torch.distributed.get_rank() == 0)
    device = args.device
    if device is None and torch.distributed.is_initialized():
        device = f"cuda:{torch.cuda.current_device()}"
    if rank0:
        cfg.save()
    tee = (Tee(os.path.join(cfg.dir_result, "logs"), "train").install()
           if rank0 else None)
    try:
        if rank0:
            copy_codes(cfg.dir_result)
        if args.fix_random:
            import numpy as np
            np.random.seed(1)
        trainer = Trainer(cfg, data_root=args.data_root, device=device,
                          seed=args.seed)
        try:
            if args.resume and not trainer.load(args.resume):
                raise SystemExit(f"no readable save in {args.resume}")
            metrics = trainer.train(max_steps=args.max_steps)
            if args.save:
                trainer.save()
            if rank0:
                print("final metrics:", metrics)
        finally:
            trainer.close()
    finally:
        if tee is not None:
            tee.close()


if __name__ == "__main__":
    main()

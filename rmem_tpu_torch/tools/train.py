"""Training CLI: compose the config and train on the stage's datasets.

    python -m rmem_tpu_torch.tools.train --stage test --model tiny_deaotl
    python -m rmem_tpu_torch.tools.train --model r50_aotl --batch_size 4 \
        --data_root ./datasets
    python -m rmem_tpu_torch.tools.train ... --device cpu
    python -m rmem_tpu_torch.tools.train ... --pretrained_path R50_DeAOTL.pth
    python -m rmem_tpu_torch.tools.train ... --opt gru_memory=true \
        reverse_infer=true train_opt=sgd

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
    p.add_argument("--opt", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, e.g. --opt train_log_step=1")
    args = p.parse_args(argv)

    import os

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.managers.trainer import Trainer
    from rmem_tpu_torch.utils.logging import Tee, copy_codes
    over = {}
    if args.device == "cpu":
        over["compute_dtype"] = "float32"
    if args.batch_size:
        over["train_batch_size"] = args.batch_size
    if args.total_steps:
        over["train_total_steps"] = args.total_steps
    if args.pretrained_path:
        over["pretrain_model"] = args.pretrained_path
    over.update(_parse_opts(args.opt))
    cfg = get_config(args.stage, model=args.model, **over)
    cfg.save()
    tee = Tee(os.path.join(cfg.dir_result, "logs"), "train").install()
    try:
        copy_codes(cfg.dir_result)
        trainer = Trainer(cfg, data_root=args.data_root, device=args.device,
                          seed=args.seed)
        try:
            if args.resume and not trainer.load(args.resume):
                raise SystemExit(f"no readable save in {args.resume}")
            metrics = trainer.train(max_steps=args.max_steps)
            if args.save:
                trainer.save()
            print("final metrics:", metrics)
        finally:
            trainer.close()
    finally:
        tee.close()


if __name__ == "__main__":
    main()

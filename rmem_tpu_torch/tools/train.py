"""Training CLI: compose the config and take steps on seeded synthetic
clips.

    python -m rmem_tpu_torch.tools.train --stage test --model tiny_deaotl
    python -m rmem_tpu_torch.tools.train --model r50_aotl --batch_size 4
    python -m rmem_tpu_torch.tools.train ... --device cpu

Runs on the card unless --device cpu is given; on the CPU the activations
default to f32 (--opt compute_dtype=bfloat16 overrides). --save writes the
state after the run and --resume starts from such a file.
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", default=None, help="write the state here")
    p.add_argument("--resume", default=None, help="start from this state")
    p.add_argument("--opt", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, e.g. --opt train_log_step=1")
    args = p.parse_args(argv)

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.managers.trainer import Trainer
    over = {}
    if args.device == "cpu":
        over["compute_dtype"] = "float32"
    if args.batch_size:
        over["train_batch_size"] = args.batch_size
    if args.total_steps:
        over["train_total_steps"] = args.total_steps
    over.update(_parse_opts(args.opt))
    cfg = get_config(args.stage, model=args.model, **over)
    trainer = Trainer(cfg, device=args.device, seed=args.seed)
    if args.resume:
        trainer.load(args.resume)
    metrics = trainer.train(max_steps=args.max_steps)
    if args.save:
        trainer.save(args.save)
    print("final metrics:", metrics)


if __name__ == "__main__":
    main()

"""Evaluation CLI: run inference over an eval dataset, write palette PNG
masks and frames/s, and optionally score J, J_tr and F.

    python -m rmem_tpu_torch.tools.eval --stage pre_vost_2 \\
        --model r50_deaotl --dataset vost --data_root <root> --score
    python -m rmem_tpu_torch.tools.eval --dataset test --device cpu \\
        --max_frames 3

The flags and defaults are those of `rmem_tpu/tools/eval.py`; a
config.json saved in the run's result directory is reloaded, the test-time
flags applied on top. It runs on the card unless --device cpu is given; on
the CPU the activations default to f32 (--opt compute_dtype=bfloat16
overrides). --profile DIR writes a torch.profiler trace of the run
(`trace.json`, CPU and CUDA activity) into DIR.

Launched as N ranks (torchrun, or any launcher that sets RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT), each rank joins the process
group (parallel.maybe_initialize_distributed: nccl where each rank has
a card of its own, else gloo), evaluates its share of the sequences (longest first to the
least-loaded rank; with --claim_dir, a directory every rank sees, the
shortest tenth of the frames is claimed at run time by whichever rank is
free) into the common output root, and prints the stats summed over the
ranks (`global_*`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rmem_tpu_torch evaluation")
    p.add_argument("--exp_name", default="rmem")
    p.add_argument("--stage", default="pre_vost_2")
    p.add_argument("--model", default="r50_deaotl")
    p.add_argument("--dataset", default="vost")
    p.add_argument("--split", default="val")
    p.add_argument("--ckpt_path", default="test",
                   help="'test' runs random weights (synthetic smoke)")
    p.add_argument("--data_root", default=None)
    p.add_argument("--output_root", default=None)
    p.add_argument("--former_mem_len", type=int, default=1)
    p.add_argument("--latter_mem_len", type=int, default=8)
    p.add_argument("--flip", action="store_true")
    p.add_argument("--ms", type=float, nargs="*", default=[1.0])
    p.add_argument("--max_seqs", type=int, default=None)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--score", action="store_true",
                   help="run offline J/J_tr scoring afterwards")
    p.add_argument("--metrics", nargs="*", default=["J", "J_last"],
                   help="offline metrics: J, J_last, F (F gives the Long "
                        "Videos J&F)")
    p.add_argument("--probe", action="store_true",
                   help="print per-frame logit probes (determinism harness)")
    p.add_argument("--zip", action="store_true",
                   help="zip the result tree afterwards (benchmark "
                        "submission format)")
    p.add_argument("--opt", nargs="*", default=[], metavar="KEY=VALUE",
                   help="generic config overrides")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the eval loop "
                        "into DIR")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--claim_dir", default=None,
                   help="with several ranks: a shared directory through "
                        "which the shortest sequences are claimed at run "
                        "time")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rmem_tpu_torch.parallel import maybe_initialize_distributed
    distributed = maybe_initialize_distributed(device=args.device)
    try:
        _evaluate(args)
    finally:
        if distributed:
            import torch.distributed as dist
            dist.destroy_process_group()


def _evaluate(args) -> None:
    from rmem_tpu_torch.config import Config, get_config
    from rmem_tpu_torch.tools.train import _parse_opts
    test_over = dict(
        test_dataset=args.dataset, test_dataset_split=args.split,
        test_ckpt_path=args.ckpt_path,
        former_mem_len=args.former_mem_len,
        latter_mem_len=args.latter_mem_len,
        test_flip=args.flip, test_multiscale=tuple(args.ms))
    if args.device == "cpu":
        test_over["compute_dtype"] = "float32"
    test_over.update(_parse_opts(args.opt))
    cfg = get_config(args.stage, args.exp_name, args.model, **test_over)
    # the config saved at training time, the test-time flags on top
    saved = os.path.join(cfg.dir_result, "config.json")
    if os.path.isfile(saved):
        print(f"reloading saved training config: {saved}")
        cfg = Config.load(saved).replace(**test_over)

    from rmem_tpu_torch.managers.evaluator import Evaluator
    ev = Evaluator(cfg, data_root=args.data_root,
                   output_root=args.output_root, probe=args.probe,
                   device=args.device)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if ev.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        trace_cm = profile(activities=acts)
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm as prof:
        stats = ev.evaluate(max_seqs=args.max_seqs,
                            max_frames=args.max_frames,
                            claim_dir=args.claim_dir)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"wrote {trace}")
    if args.probe:
        for i, pr in enumerate(ev.probes):
            print(f"probe[{i}]: {pr.tolist()}")
    print(json.dumps({k: v for k, v in stats.items()
                      if k != "per_seq_fps"}, indent=2))

    if args.zip:
        from rmem_tpu_torch.utils.eval import zip_folder
        zpath = ev.output_root.rstrip("/") + ".zip"
        print(f"zipped results: {zip_folder(ev.output_root, zpath)}")

    if args.score and args.dataset not in ("test",):
        from rmem_tpu_torch.evaluation import Evaluation
        from rmem_tpu_torch.evaluation.evaluation import summarize
        from rmem_tpu_torch.evaluation.evaluation_method import write_csvs
        root = args.data_root or cfg.dir_data
        sub = {"vost": "VOST", "davis2017": "DAVIS",
               "long_videos": "long_videos"}[args.dataset]
        e = Evaluation(os.path.join(root, sub), args.split)
        # Long Videos reports J&F (RMem's Table 2): F is always scored there
        metric = tuple(args.metrics)
        if args.dataset == "long_videos" and "F" not in metric:
            metric = metric + ("F",)
        metrics = e.evaluate(ev.output_root, metric=metric)
        print(json.dumps(summarize(metrics), indent=2))
        csv_g, csv_seq = write_csvs(ev.output_root, metrics, metric,
                                    args.split)
        print(f"wrote {csv_g}\nwrote {csv_seq}")


if __name__ == "__main__":
    main()

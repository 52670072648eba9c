"""Offline evaluation CLI: scores saved PNG masks against the ground
truth and writes the global and per-sequence CSVs beside the results.

A copy of `rmem_tpu/evaluation/evaluation_method.py`: the reference's file
names (`global_results-{set}.csv`, `per-sequence_results-{set}.csv`),
header rows and %.6f fractions. The default metrics are J and J_last;
`--metrics J J_last F` adds the boundary F of the Long Videos J&F table.

    python -m rmem_tpu_torch.evaluation.evaluation_method \
        --results_path <masks> --dataset_path <root with Annotations/>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rmem_tpu_torch.evaluation.evaluation import Evaluation, summarize

# the reference's header rows
G_MEASURES = ["J-Mean", "J-Recall", "J-Decay",
              "J_last-Mean", "J_last-Recall", "J_last-Decay"]
G_MEASURES_F = ["J-Mean", "J-Recall", "J-Decay",
                "J_last-Mean", "J_last-Recall", "J_last-Decay",
                "F-Mean", "F-Recall", "F-Decay"]


def write_csvs(results_path: str, metrics, metric, gt_set: str):
    """Write the two reference-format CSVs; returns their paths."""
    csv_g = os.path.join(results_path, f"global_results-{gt_set}.csv")
    csv_seq = os.path.join(results_path,
                           f"per-sequence_results-{gt_set}.csv")

    def mrd(key):
        m = metrics[key]
        return [float(np.mean(m["M"])), float(np.mean(m["R"])),
                float(np.mean(m["D"]))]

    heads = list(G_MEASURES_F if "F" in metric else G_MEASURES)
    row = mrd("J") + (mrd("J_last") if "J_last" in metric
                      else [float("nan")] * 3)
    if "F" in metric:
        row += mrd("F")
    with open(csv_g, "w") as f:
        f.write(",".join(heads) + "\n")
        f.write(",".join(f"{v:.6f}" for v in row) + "\n")

    seq_keys = [k for k in ("J", "J_last", "F") if k in metric]
    seq_heads = ["Sequence"] + [f"{k}-Mean" for k in seq_keys]
    with open(csv_seq, "w") as f:
        f.write(",".join(seq_heads) + "\n")
        for name in metrics[seq_keys[0]]["M_per_object"]:
            vals = [metrics[k]["M_per_object"][name] for k in seq_keys]
            f.write(name + "," + ",".join(f"{v:.6f}" for v in vals) + "\n")
    return csv_g, csv_seq


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--results_path", required=True,
                   help="dir with per-sequence PNG masks")
    p.add_argument("--dataset_path", required=True,
                   help="dataset root (Annotations/, ImageSets/)")
    p.add_argument("--set", default="val")
    p.add_argument("--re", action="store_true", help="recompute CSVs")
    p.add_argument("--metrics", nargs="*", default=["J", "J_last"],
                   help="J, J_last, F (add F for Long Videos J&F)")
    args = p.parse_args()

    csv_g = os.path.join(args.results_path, f"global_results-{args.set}.csv")
    if os.path.exists(csv_g) and not args.re:
        print(f"already computed: {csv_g}")
        with open(csv_g) as f:
            print(f.read())
        return

    ev = Evaluation(args.dataset_path, args.set)
    metric = tuple(args.metrics)
    metrics = ev.evaluate(args.results_path, metric=metric)
    g = summarize(metrics)
    csv_g, csv_seq = write_csvs(args.results_path, metrics, metric,
                                args.set)
    print("  ".join(f"{k}: {v:.1f}" for k, v in g.items()))
    print(f"wrote {csv_g}\nwrote {csv_seq}")


if __name__ == "__main__":
    main()

"""Offline J / J_last (VOST J_tr) / F evaluation of saved PNG masks
against the ground truth.

A copy of `rmem_tpu/evaluation/evaluation.py` (the reference's
evaluation/source/evaluation.py:17-116, dataset.py:8-109), reading PNGs
with this package's reader (no PIL). Its semantics:
- only frames with annotations are scored; the first and last annotated
  frames are dropped (evaluation.py:84),
- GT void pixels (255) are zeroed into background and *not* passed as a void
  mask to the IoU (evaluation.py:40 passes None),
- object count comes from the first annotated frame (dataset.py:100),
- J_last scores the last 25% of evaluated frames — the VOST
  tracking-after-transformation metric J_tr (evaluation.py:86,97-102).

Sequences are scored on a thread pool.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from math import floor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rmem_tpu_torch.evaluation.metrics import (db_eval_boundary,
                                               db_eval_iou, db_statistics)
from rmem_tpu_torch.utils.image import read_png


class Evaluation:
    def __init__(self, dataset_root: str, gt_set: str = "val",
                 sequences="all"):
        self.root = dataset_root
        self.subset = gt_set
        self.mask_path = os.path.join(dataset_root, "Annotations")
        self.imagesets_path = os.path.join(dataset_root, "ImageSets")
        if sequences == "all":
            with open(os.path.join(self.imagesets_path,
                                   f"{gt_set}.txt")) as f:
                sequences = [s.strip() for s in f if s.strip()]
        self.sequences = list(sequences)

    # -- GT loading (dataset.py:78-106) --
    def _get_all_masks(self, seq: str):
        files = sorted(os.listdir(os.path.join(self.mask_path, seq)))
        files = [f for f in files if f.endswith(".png")]
        masks = np.stack([
            read_png(os.path.join(self.mask_path, seq, f)) for f in files])
        masks_id = [os.path.splitext(f)[0] for f in files]
        void = masks == 255
        masks = np.where(void, 0, masks)
        num_objects = int(masks[0].max())
        sep = np.stack([(masks == i) for i in range(1, num_objects + 1)])
        return sep, void, masks_id

    def _read_results(self, res_path: str, seq: str,
                      masks_id: List[str], num_objects: int):
        frames = []
        for mid in masks_id:
            p = os.path.join(res_path, seq, f"{mid}.png")
            if os.path.exists(p):
                frames.append(read_png(p))
            else:
                frames.append(None)
        hw = next(f.shape for f in frames if f is not None)
        stack = np.stack([f if f is not None else np.zeros(hw, np.uint8)
                          for f in frames])
        return np.stack([(stack == i) for i in range(1, num_objects + 1)])

    def _evaluate_sequence(self, seq: str, res_path: str,
                           metric: Sequence[str]):
        gt, void, masks_id = self._get_all_masks(seq)
        # drop first & last annotated frames (evaluation.py:84)
        gt, masks_id = gt[:, 1:-1], masks_id[1:-1]
        num_eval = len(masks_id)
        last_quarter = int(floor(num_eval * 0.75))
        res = self._read_results(res_path, seq, masks_id, gt.shape[0])
        out = {}
        for ii in range(gt.shape[0]):
            vals = {}
            if "J" in metric or "J_last" in metric:
                j = db_eval_iou(gt[ii], res[ii], None)
                if "J" in metric:
                    vals["J"] = j
                if "J_last" in metric:
                    vals["J_last"] = j[last_quarter:]
            if "F" in metric:
                # boundary F for the Long Videos J&F tables
                # (source/metrics.py:40-119)
                vals["F"] = db_eval_boundary(gt[ii], res[ii], None)
            out[f"{seq}_{ii + 1}"] = vals
        return out

    def evaluate(self, res_path: str, workers: int = 4,
                 metric: Sequence[str] = ("J", "J_last")) -> Dict:
        metrics = {key: {"M": [], "R": [], "D": [], "M_per_object": {}}
                   for key in metric}
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = pool.map(
                lambda s: self._evaluate_sequence(s, res_path, metric),
                self.sequences)
        for per_obj in results:
            for name, vals_by_key in per_obj.items():
                for key, vals in vals_by_key.items():
                    m, r, d = db_statistics(vals)
                    metrics[key]["M"].append(m)
                    metrics[key]["R"].append(r)
                    metrics[key]["D"].append(d)
                    metrics[key]["M_per_object"][name] = m
        return metrics


def summarize(metrics: Dict) -> Dict[str, float]:
    """Global means as reported in the README table (J, J_tr) and the
    Long Videos J&F table (J, F, J&F)."""
    out = {}
    if "J" in metrics:
        out["J"] = float(np.mean(metrics["J"]["M"])) * 100.0
        out["J_recall"] = float(np.mean(metrics["J"]["R"])) * 100.0
        out["J_decay"] = float(np.mean(metrics["J"]["D"])) * 100.0
    if "J_last" in metrics:
        out["J_tr"] = float(np.mean(metrics["J_last"]["M"])) * 100.0
    if "F" in metrics:
        out["F"] = float(np.mean(metrics["F"]["M"])) * 100.0
        out["F_recall"] = float(np.mean(metrics["F"]["R"])) * 100.0
        if "J" in metrics:
            out["J&F"] = (out["J"] + out["F"]) / 2.0
    return out

"""Trainer: build the model, then take training steps on seeded synthetic
clips, log, save and resume.

Counterpart of the parts of `rmem_tpu/managers/trainer.py` that a run of a
few steps needs: the id shuffle drawn on the host from
np.random.RandomState(train_start_step + 7), one step per batch, the log
line every train_log_step steps, and the state saved with torch.save. It
runs on one card (or on the CPU when asked); the batches are the synthetic
clips of data/synthetic.py.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.data.synthetic import gen_blob_batch
from rmem_tpu_torch.engine.inference import resolve_device
from rmem_tpu_torch.engine.train_state import TrainState, apply_gradients
from rmem_tpu_torch.engine.training import check_supported, train_forward
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.ops.masks import host_id_shuffle_matrix
from rmem_tpu_torch.utils.metric import AverageMeter


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               shuffle: Optional[torch.Tensor],
               cfg: Config) -> Dict[str, torch.Tensor]:
    """One step: the clip loss and its gradients (bf16 autocast on the
    parameters' f32 when cfg.compute_dtype is bfloat16), then the
    optimizer and the EMA. Returns the metrics, on the device."""
    model = state.model.train()
    for p in model.parameters():
        p.grad = None
    dev = next(model.parameters()).device
    use_prev = state.step >= (cfg.train_seq_training_start_ratio
                              * cfg.train_total_steps)
    with torch.autocast(dev.type, dtype=torch.bfloat16,
                        enabled=cfg.compute_dtype == "bfloat16"):
        loss, metrics = train_forward(
            model, batch["imgs"], batch["labels"], batch["obj_nums"],
            state.step, shuffle, use_prev, cfg)
    loss.backward()
    metrics["grad_norm"] = apply_gradients(state, cfg)
    return metrics


class Trainer:
    """One model on one device. `params`: a state dict to start from (for
    example utils.params_from_jax of a JAX tree); else init_params(seed)."""

    def __init__(self, cfg: Config,
                 device: Union[None, str, torch.device] = None,
                 seed: int = 0, params: Optional[dict] = None, log=print):
        check_supported(cfg)
        if cfg.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        model = build_vos_model(cfg.model_vos, cfg)
        if params is None:
            init_params(model, seed)
        else:
            model.load_state_dict(params, strict=True)
        self.state = TrainState.create(model.to(self.device))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.rng = np.random.RandomState(cfg.train_start_step + 7)
        self.loss_meters: list = []
        self.iou_meters: list = []

    def next_batch(self):
        """A synthetic clip batch and its id shuffle, on the device."""
        cfg = self.cfg
        batch = gen_blob_batch(self.gen, cfg.train_batch_size,
                               cfg.data_seq_len, tuple(cfg.data_randomcrop))
        shuffle = torch.from_numpy(host_id_shuffle_matrix(
            self.rng, cfg.model_max_obj_num + 1, cfg.train_batch_size))
        if self.device.type == "cuda":   # no wait for the queued work
            shuffle = shuffle.pin_memory()
        return batch, shuffle.to(self.device, non_blocking=True)

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Steps until train_total_steps, or max_steps more. Returns the
        last step's scalar metrics."""
        cfg = self.cfg
        stop = cfg.train_total_steps
        if max_steps is not None:
            stop = min(stop, self.state.step + max_steps)
        metrics: Dict[str, torch.Tensor] = {}
        t_last, logged = time.perf_counter(), self.state.step
        while self.state.step < stop:
            batch, shuffle = self.next_batch()
            metrics = train_step(self.state, batch, shuffle, cfg)
            step = self.state.step
            if step % cfg.train_log_step == 0 or step == stop:
                self._update_meters(metrics)
                dt = (time.perf_counter() - t_last) / (step - logged)
                t_last, logged = time.perf_counter(), step
                eta_h = dt * (cfg.train_total_steps - step) / 3600
                self.log(f"step {step}/{cfg.train_total_steps} loss "
                         f"{float(metrics['loss']):.4f} (aux "
                         f"{float(metrics['aux_loss']):.4f} w="
                         f"{float(metrics['aux_weight']):.2f}) iou "
                         f"{float(metrics['iou']) * 100:.1f} gnorm "
                         f"{float(metrics['grad_norm']):.2f} {dt:.2f}s/it "
                         f"ETA {eta_h:.1f}h")
        return {k: float(v) for k, v in metrics.items() if v.dim() == 0}

    def frame_meter_summary(self) -> Dict[str, list]:
        """Running means per frame position of the loss and the IoU (in
        %), over the logged steps."""
        return {"loss_per_frame": [mt.avg for mt in self.loss_meters],
                "iou_per_frame": [mt.avg for mt in self.iou_meters]}

    def _update_meters(self, m: Dict[str, torch.Tensor]) -> None:
        lpf = m["loss_per_frame"].tolist()
        ipf = m["iou_per_frame"].tolist()
        if not self.loss_meters:
            self.loss_meters = [AverageMeter() for _ in lpf]
            self.iou_meters = [AverageMeter() for _ in ipf]
        for meter, v in zip(self.loss_meters, lpf):
            meter.update(v)
        for meter, v in zip(self.iou_meters, ipf):
            meter.update(v * 100.0)

    def save(self, path: str) -> None:
        torch.save({"state": self.state.state_dict(),
                    "rng": self.rng.get_state(),
                    "gen": self.gen.get_state()}, path)

    def load(self, path: str) -> None:
        """Resume from `save`'s file (written by this program)."""
        d = torch.load(path, map_location=self.device, weights_only=False)
        self.state.load_state_dict(d["state"])
        self.rng.set_state(d["rng"])
        self.gen.set_state(d["gen"].cpu())

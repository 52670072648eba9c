"""Trainer: build the model, then take training steps on the clips of
cfg.datasets, log, save and resume.

Counterpart of `rmem_tpu/managers/trainer.py` on one card (or on the CPU
when asked): the clips of cfg.datasets under data_root (else cfg.dir_data)
by data/train_datasets.py's loader (num_workers min(data_workers, 4):
prepared a batch ahead on a thread), or the device batches of a given
iterator, the weights of cfg.pretrain_model (a reference .pth, a JAX
msgpack params tree or this package's own file) when cfg.pretrain is set,
the id shuffle drawn on the host from np.random.RandomState(
train_start_step + 7), one step per batch, the log line every
train_log_step steps, and the checkpoint stream: every train_save_step
steps the state (with the host RNG) goes to
dir_result/ckpt/save_step_<N>.pt and the EMA weights to
dir_result/ema_ckpt/ema_step_<N>.pt, each stream pruned to its newest
train_max_keep_ckpt files; with cfg.train_auto_resume a new Trainer starts
from the newest readable save. Every train_tblog_step steps (0: never) the
batch's first clip's last frame, its labels and the prediction go to
dir_result/img_logs as PNGs.

With an initialised process group (parallel.maybe_initialize_distributed;
tools/train.py --mesh N starts one), the Trainer is one rank of
cfg.mesh_shape over cfg.mesh_axes: every rank draws the same global
batch of train_batch_size clips and id shuffle from the same seeds and
steps on its rows of them, the gradients averaged over the "data" axis
before the optimizer (parallel/mesh.py) and the metrics before logging;
with a "model" axis the GPM self-attention is split across it
(parallel/tp.py). Rank 0 alone logs and writes checkpoints and image
logs; every rank reads the auto-resume save.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.data.train_datasets import (build_train_dataset,
                                                make_batch_loader)
from rmem_tpu_torch.engine.inference import resolve_device
from rmem_tpu_torch.engine.train_state import TrainState, apply_gradients
from rmem_tpu_torch.engine.training import check_supported, train_forward
from rmem_tpu_torch.models import (build_vos_model, init_params,
                                   load_model_params)
from rmem_tpu_torch.ops.masks import host_id_shuffle_matrix
from rmem_tpu_torch.parallel.eval_sharding import rank
from rmem_tpu_torch.utils.checkpoint import (load_file,
                                             load_latest_checkpoint,
                                             save_checkpoint)
from rmem_tpu_torch.utils.image import _save_mask, encode_png_rgb
from rmem_tpu_torch.utils.metric import AverageMeter


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               shuffle: Optional[torch.Tensor], cfg: Config,
               reduce_grads=None) -> Dict[str, torch.Tensor]:
    """One step: the clip loss and its gradients (bf16 autocast on the
    parameters' f32 when cfg.compute_dtype is bfloat16), `reduce_grads`
    (model) where given (the data-parallel average), then the optimizer
    and the EMA. Returns the metrics, on the device."""
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
    if reduce_grads is not None:
        reduce_grads(model)
    metrics["grad_norm"] = apply_gradients(state, cfg)
    return metrics


def _module_train_step(*args, **kwargs):
    """This module's train_step as it is at call time (a stand-in set on
    the module after the Trainer is built takes effect)."""
    return train_step(*args, **kwargs)


class Trainer:
    """One model on one device. `params`: a state dict to start from (for
    example utils.params_from_jax of a JAX tree); else init_params(seed)
    (`seed` sets the initial weights and nothing else), then cfg.pretrain_model's weights when cfg.pretrain is set. `batches`:
    an iterator of device batches (dicts of imgs, labels, obj_nums) to
    train on instead of cfg.datasets' clips under data_root, whose loader
    is built at the first batch."""

    def __init__(self, cfg: Config, data_root: Optional[str] = None,
                 device: Union[None, str, torch.device] = None,
                 seed: int = 0, params: Optional[dict] = None, log=print,
                 batches: Optional[Iterator[Dict[str, torch.Tensor]]] = None):
        check_supported(cfg)
        if cfg.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.rank0 = rank() == 0
        self.log = log if self.rank0 else (lambda *a, **k: None)
        log = self.log
        self.device = resolve_device(device)
        model = build_vos_model(cfg.model_vos, cfg)
        if params is None:
            init_params(model, seed)
            if cfg.pretrain and cfg.pretrain_model:
                load_model_params(model, cfg.pretrain_model, log=log)
        else:
            model.load_state_dict(params, strict=True)
        self.mesh = None
        self.step_fn = _module_train_step
        if torch.distributed.is_initialized():
            from rmem_tpu_torch.parallel.mesh import (
                make_mesh, make_parallel_train_step)
            self.mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes)
            if "model" in cfg.mesh_axes:
                from rmem_tpu_torch.parallel.tp import split_model
                split_model(model, self.mesh)
            self.step_fn = make_parallel_train_step(_module_train_step,
                                                    self.mesh)
        elif int(np.prod(cfg.mesh_shape)) != 1:
            raise ValueError(f"mesh_shape {cfg.mesh_shape} needs one process "
                             "a rank (tools/train.py --mesh N)")
        self.state = TrainState.create(model.to(self.device), cfg.train_opt)
        self.data_root = data_root
        self.batches = batches
        self.rng = np.random.RandomState(cfg.train_start_step + 7)
        self.loss_meters: list = []
        self.iou_meters: list = []
        self.ckpt_dir = os.path.join(cfg.dir_result, "ckpt")
        self.ema_dir = os.path.join(cfg.dir_result, "ema_ckpt")
        if cfg.train_auto_resume and os.path.isdir(self.ckpt_dir):
            path = self.load(self.ckpt_dir)
            if path:
                log(f"auto-resumed from {path} (step {self.state.step})")

    def next_batch(self):
        """The next clip batch and its id shuffle, on the device."""
        cfg = self.cfg
        if self.batches is None:
            self.batches = make_batch_loader(
                build_train_dataset(cfg, self.data_root),
                cfg.train_batch_size, max_obj=cfg.model_max_obj_num,
                num_workers=min(cfg.data_workers, 4), device=self.device)
        batch = next(self.batches)
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
            metrics = self.step_fn(self.state, batch, shuffle, cfg)
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
            if (cfg.train_tblog_step and step % cfg.train_tblog_step == 0
                    and self.rank0):
                self._dump_images(batch, metrics["pred_label_last"], step)
            if step % cfg.train_save_step == 0:
                self.save(step)
        return {k: float(v) for k, v in metrics.items() if v.dim() == 0}

    def close(self) -> None:
        """Stop the loader's prefetch thread, if it has one."""
        close = getattr(self.batches, "close", None)
        if close is not None:
            close()

    def _dump_images(self, batch, pred_label_last, step: int) -> None:
        """The batch's first clip's last frame (min-max scaled to 0..255),
        its labels (255 as 0) and the prediction, as
        dir_result/img_logs/<step>_{img,gt,pred}.png."""
        out = os.path.join(self.cfg.dir_result, "img_logs")
        os.makedirs(out, exist_ok=True)
        img = batch["imgs"][0, -1].float().cpu().numpy()
        gt = batch["labels"][0, -1].cpu().numpy().astype(np.uint8)
        pred = pred_label_last[0].cpu().numpy().astype(np.uint8)
        lo, hi = float(img.min()), float(img.max())
        u8 = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
        with open(os.path.join(out, f"{step:08d}_img.png"), "wb") as f:
            f.write(encode_png_rgb(u8))
        _save_mask(np.where(gt == 255, 0, gt),
                   os.path.join(out, f"{step:08d}_gt.png"))
        _save_mask(pred, os.path.join(out, f"{step:08d}_pred.png"))

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

    def _whole(self, tensors: Dict[str, torch.Tensor],
                part: bool = False) -> Dict[str, torch.Tensor]:
        """Parameter-shaped tensors whole (or, with `part`, this rank's
        parts of whole ones) where the model is split across a "model"
        axis (parallel/tp.py; gathering is collective); else as given."""
        split = getattr(self.state.model, "tp_split", None)
        if split is None:
            return tensors
        fn = split.shard if part else split.gather
        return {n: fn(n, t) for n, t in tensors.items()}

    def _state_file(self) -> dict:
        """The state and the host RNG, as tensors and numbers only (so that
        torch.load reads it with weights_only); split tensors whole."""
        kind, keys, pos, has_gauss, gauss = self.rng.get_state()
        state = {k: self._whole(v) if isinstance(v, dict) else v
                 for k, v in self.state.state_dict().items()}
        return {"state": state,
                "rng": {"kind": kind,
                        "keys": torch.from_numpy(keys.astype(np.int64)),
                        "pos": pos, "has_gauss": has_gauss, "gauss": gauss}}

    def _restore(self, d: dict) -> None:
        self.state.load_state_dict(
            {k: self._whole(v, part=True) if isinstance(v, dict) else v
             for k, v in d["state"].items()})
        r = d["rng"]
        self.rng.set_state((r["kind"],
                            r["keys"].cpu().numpy().astype(np.uint32),
                            r["pos"], r["has_gauss"], r["gauss"]))

    def save(self, step: Optional[int] = None) -> None:
        """The checkpoint stream at `step` (the state's own by default):
        the state under dir_result/ckpt and the EMA weights under
        dir_result/ema_ckpt, each pruned to train_max_keep_ckpt files; on
        rank 0 only."""
        step = self.state.step if step is None else step
        keep = self.cfg.train_max_keep_ckpt
        state, ema = self._state_file(), self._whole(self.state.ema)
        if not self.rank0:
            return
        save_checkpoint(state, self.ckpt_dir, step, keep, log=self.log)
        save_checkpoint({"state": {"ema": ema, "step": step}},
                        self.ema_dir, step, keep, prefix="ema_step_",
                        log=self.log)
        self.log(f"saved checkpoint at step {step}")

    def load(self, path: str) -> Optional[str]:
        """Resume from a file of the save stream, or from the newest
        readable one in a stream directory (dir_result/ckpt). Returns the
        file's path, or None for a directory without a readable save."""
        if os.path.isdir(path):
            found = load_latest_checkpoint(path, log=self.log,
                                           map_location=self.device)
            if not found:
                return None
            d, _, path = found
        else:
            d = load_file(path, self.device)
        self._restore(d)
        return path

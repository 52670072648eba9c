"""Evaluator: per-video inference over an eval dataset, multi-scale and
flip, palette PNG masks, frames/s.

Counterpart of `rmem_tpu/managers/evaluator.py`, at the same behaviour.
Per video:
- the long-term write gap is max(round(num_frames / 30), 5), a quarter of
  it (rounded) with no_memory_gap;
- frame 0 is the reference, with its annotation nearest-resized to each
  aug's input size (flipped first for a flipped aug);
- later frames run in chunks of eval_scan_chunk frames through the
  engine's raw-frame scan (every aug prepared on the engine's device from
  the one decoded frame), the last chunk of a video padded with repeats of
  its final frame; a frame with an annotation (YouTube-VOS's new objects)
  ends a chunk early, runs the unpadded frames before it one at a time,
  and then propagates, merges its annotation into the prediction (the
  annotation wins where it is not background) and re-references every aug
  from the merged label;
- more than model_max_obj_num objects run as id groups, each group told
  it has model_max_obj_num objects, as the reference's sub-engines are;
- the first annotation is copied into the results byte for byte; the
  other masks stay on the device until the video ends and are then
  written as palette PNGs on background threads, outside the timed
  window.

Frames are decoded on a thread of their own, one or two frames ahead: on
the card by nvJPEG on a CUDA stream of the thread's, each frame handed to
the consumer's stream through an event (and `record_stream`, so that the
caching allocator does not reuse its memory while that stream may still
read it). `force_slow` (or the probe harness with several augs or
annotations) takes the per-frame path, which propagates, aggregates and
writes the memory frame by frame as the reference's evaluator does.

A video's time is wall-clock from frame 0's arrival to its last label on
the host; `eval_fps_window` > 0 adds frames/s over every window of that
many frames. `peak_hbm_gb` is the card's peak allocation over `evaluate`.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.data.eval_datasets import (build_eval_dataset,
                                               sequence_lengths)
from rmem_tpu_torch.data.transforms import resize_label, restrict_size
from rmem_tpu_torch.engine.inference import (InferenceEngine,
                                             resolve_device, separate_mask,
                                             soft_logit_aggregation)
from rmem_tpu_torch.models import build_vos_model, load_model_params
from rmem_tpu_torch.ops.resize import resize_nearest
from rmem_tpu_torch.parallel.eval_sharding import (allreduce_stats,
                                                   claim_next,
                                                   host_sequence_indices,
                                                   rank, split_bulk_tail,
                                                   world_size)
from rmem_tpu_torch.utils.image import AsyncMaskWriter


@dataclass
class _AugSpec:
    scale: float
    flip: bool


@dataclass
class SequenceResult:
    name: str
    num_frames: int
    seconds: float
    # (frames, seconds) of each eval_fps_window-frame window, or None
    windows: Optional[List[Tuple[int, float]]] = None

    @property
    def fps(self) -> float:
        return (self.num_frames - 1) / max(self.seconds, 1e-9)

    @property
    def window_fps(self) -> Optional[List[float]]:
        if not self.windows:
            return None
        return [n / max(s, 1e-9) for n, s in self.windows]


class Evaluator:
    """Runs cfg.test_dataset through the inference engine on `device`
    (default: the card) and writes a mask PNG for every frame under
    output_root (default: dir_result/eval/<test_dataset>). `params`: a
    state dict (for example utils.params_from_jax of a JAX tree); else
    the weights of cfg.test_ckpt_path (see load_model_params)."""

    def __init__(self, cfg: Config, params: Optional[dict] = None,
                 data_root: Optional[str] = None,
                 output_root: Optional[str] = None, log=print,
                 probe: bool = False,
                 device: Union[None, str, torch.device] = None):
        if cfg.eval_yuv420_upload:
            raise NotImplementedError(
                "eval_yuv420_upload: the YUV 4:2:0 upload is not ported "
                "(ROADMAP, Not to port): frames are uploaded as JPEG bytes "
                "and decoded on the card")
        if not cfg.eval_device_prep:
            raise NotImplementedError(
                "eval_device_prep=False: the JAX package's cv2 host prep is "
                "not ported; frames are prepared on the engine's device")
        self.cfg = cfg
        self.log = log
        # the logits at one pixel of every frame, the reference's
        # determinism harness (its tools/eval.py --debug_fix_random)
        self.probe = probe
        self.probes: List[np.ndarray] = []
        self.device = resolve_device(device)
        model = build_vos_model(cfg.model_vos, cfg)
        if params is None:
            load_model_params(model, cfg.test_ckpt_path, cfg.test_ema, log)
        else:
            model.load_state_dict(params, strict=True)
        self.engine = InferenceEngine(model, cfg, device=self.device)
        self.dataset = build_eval_dataset(cfg, data_root, self.device)
        self.output_root = output_root or os.path.join(
            cfg.dir_result, "eval", cfg.test_dataset)
        self.augs = [_AugSpec(s, f) for s in cfg.test_multiscale
                     for f in ((False, True) if cfg.test_flip
                               else (False,))]
        self.writer = AsyncMaskWriter()
        self.force_slow = False

    # ------------------------------------------------------------------
    def _in_hws(self, ori_h: int, ori_w: int) -> List[Tuple[int, int]]:
        cfg = self.cfg
        return [restrict_size(ori_h, ori_w, cfg.test_max_size,
                              cfg.test_min_size, aug.scale,
                              cfg.model_align_corners) for aug in self.augs]

    def _prep_frame(self, image: torch.Tensor, in_hw, flip: bool
                    ) -> torch.Tensor:
        """[H, W, 3] frame -> [1, h, w, 3] f32 model input."""
        return self.engine.prep(image[None], in_hw, flip)[0]

    def _prep_label(self, label, hw, flip: bool) -> torch.Tensor:
        """Flip at the original size, then nearest-resize: the two do not
        commute (the index map floor(i * s) is not symmetric), and the
        reference flips the label before its engine resizes it."""
        label = torch.as_tensor(label).to(self.device)
        if flip:
            label = label.flip(1)
        return resize_nearest(label[None, ..., None], hw)[0, ..., 0]

    def _ref_labels(self, label, hw, flip: bool, groups: int):
        return separate_mask(self._prep_label(label, hw, flip)[None], groups,
                             self.cfg.model_max_obj_num)

    def _group_obj_nums(self, obj_num: int, groups: int) -> List[int]:
        """As the reference at inference, every id group is told it has
        model_max_obj_num objects, so the unused id channels are not
        masked: they take part in the argmax and are fed back into
        memory, which the released checkpoints' scores rely on."""
        del obj_num
        return [self.cfg.model_max_obj_num] * groups

    def _groups(self, obj_num: int) -> int:
        return max(int(np.ceil(obj_num / self.cfg.model_max_obj_num)), 1)

    # ------------------------------------------------------------------
    def evaluate(self, max_seqs: Optional[int] = None,
                 max_frames: Optional[int] = None,
                 shard_across_hosts: bool = True,
                 claim_dir: Optional[str] = None,
                 tail_frac: float = 0.1) -> Dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        procs = world_size()
        tail: List[int] = []
        if shard_across_hosts:
            lengths = sequence_lengths(self.dataset) if procs > 1 else None
            if lengths is not None and claim_dir is not None:
                # the shortest sequences are claimed at run time by the
                # first process to finish its share
                bulk, tail = split_bulk_tail(len(self.dataset), lengths,
                                             procs, tail_frac=tail_frac)
                indices = bulk[rank()]
            else:
                indices = host_sequence_indices(len(self.dataset),
                                                lengths=lengths)
        else:
            indices = list(range(len(self.dataset)))
        results: List[SequenceResult] = []

        def run_one(idx: int) -> None:
            res = self._eval_sequence(self.dataset.sequence(idx), max_frames)
            results.append(res)
            total_frames = sum(r.num_frames - 1 for r in results)
            total_time = sum(r.seconds for r in results)
            self.log(f"Seq {res.name} - FPS: {res.fps:.2f}. All-Frame FPS: "
                     f"{total_frames / max(total_time, 1e-9):.2f}")

        for n_done, idx in enumerate(indices):
            if max_seqs is not None and n_done >= max_seqs:
                break
            run_one(idx)
        while tail and (max_seqs is None or len(results) < max_seqs):
            idx = claim_next(claim_dir, tail, owner=f"host{rank()}")
            if idx is None:
                break
            run_one(idx)
        self.writer.join()
        total_frames = sum(r.num_frames - 1 for r in results)
        total_time = sum(r.seconds for r in results)
        stats = {
            "per_seq_fps": {r.name: r.fps for r in results},
            "all_frame_fps": total_frames / max(total_time, 1e-9),
            "all_seq_fps": float(np.mean([r.fps for r in results]))
            if results else 0.0,
        }
        if any(r.windows for r in results):
            stats["per_seq_window_fps"] = {
                r.name: [round(f, 2) for f in r.window_fps]
                for r in results if r.windows}
        if cuda:
            # peak device memory over the run: the memory axis of RMem's
            # boundedness claim
            stats["peak_hbm_gb"] = round(
                torch.cuda.max_memory_allocated(self.device) / 2**30, 3)
        if procs > 1:
            # the frames of every process over the slowest one's time
            g = allreduce_stats({"frames": float(total_frames),
                                 "seconds_sum": float(total_time),
                                 "seqs": float(len(results))})
            stats["global_frames"] = g["frames"]
            stats["global_seqs"] = g["seqs"]
            stats["global_all_frame_fps"] = (
                g["frames"] / max(g["seconds_sum"] / procs, 1e-9))
        return stats

    # ------------------------------------------------------------------
    def _frames(self, seq, max_frames: Optional[int]):
        """(index, Frame) of the video's first max_frames frames, decoded
        on a thread one or two frames ahead of the caller. On the card the
        thread decodes on a CUDA stream of its own; each frame reaches the
        caller's stream through an event."""
        dev = self.device
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def worker():
            try:
                with (torch.cuda.device(dev) if side is not None
                      else contextlib.nullcontext()), \
                        (torch.cuda.stream(side) if side is not None
                         else contextlib.nullcontext()):
                    for i, frame in enumerate(seq):
                        if stop.is_set() or (max_frames is not None
                                             and i >= max_frames):
                            break
                        ready = None
                        if side is not None:
                            ready = torch.cuda.Event()
                            ready.record(side)
                        q.put((i, frame, ready))
                q.put(None)
            except Exception as e:     # raised in the caller's thread
                q.put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                i, frame, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(ready)
                    frame.image.record_stream(stream)
                yield i, frame
        finally:
            stop.set()
            while thread.is_alive():     # unblock a put on the full queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()

    def _eval_sequence(self, seq, max_frames: Optional[int] = None
                       ) -> SequenceResult:
        gap = max(int(round(len(seq) / 30)), 5)
        if self.cfg.no_memory_gap:
            gap = int(round(gap / 4))
        # the probe records aug 0's logits before aggregation, which only
        # the per-frame path has once there are several augs or
        # annotations
        if (not (self.probe and (len(self.augs) > 1 or len(seq.labels) > 1))
                and not self.force_slow):
            return self._eval_sequence_fused(seq, gap, max_frames)
        return self._eval_sequence_slow(seq, gap, max_frames)

    def _add_references(self, frame, imgs, label, obj_num: int,
                        frame_idx: int, gap: int):
        groups = self._groups(obj_num)
        states = []
        for img, aug in zip(imgs, self.augs):
            st, _ = self.engine.add_reference(
                img, self._ref_labels(label, img.shape[1:3], aug.flip,
                                      groups),
                self._group_obj_nums(obj_num, groups),
                frame_step=frame_idx, gap=gap)
            states.append(st)
        return states, groups

    def _aug_mean_label(self, states, imgs, out_hw, first_probe=False):
        """Propagate every aug; the argmax of the mean over augs of the
        softmax of each aug's group-merged, unflipped logits at out_hw."""
        probs = []
        for ai, (img, aug) in enumerate(zip(imgs, self.augs)):
            states[ai], logits4 = self.engine.propagate(states[ai], img)
            logits = self.engine.predict_logits_at(logits4, out_hw)
            if first_probe and ai == 0:
                self._record_probe(logits)
            merged = soft_logit_aggregation(logits,
                                            self.cfg.model_max_obj_num)
            if aug.flip:
                merged = merged.flip(1)
            probs.append(torch.softmax(merged.float(), dim=-1))
        return torch.argmax(torch.stack(probs).mean(dim=0),
                            dim=-1).to(torch.uint8)

    def _record_probe(self, logits: torch.Tensor) -> None:
        h, w = logits.shape[1:3]
        py, px = min(100, h - 1), min(100, w - 1)
        self.probes.append(logits[0, py, px, :7].float().cpu().numpy())

    def _eval_sequence_slow(self, seq, gap: int,
                            max_frames: Optional[int]) -> SequenceResult:
        states, groups = None, 1
        obj_idx = None
        seconds = 0.0
        n_processed = 0
        for frame_idx, frame in self._frames(seq, max_frames):
            n_processed += 1
            ori_h, ori_w = frame.image.shape[:2]
            obj_idx = frame.obj_idx
            imgs = [self._prep_frame(frame.image, hw, aug.flip)
                    for hw, aug in zip(self._in_hws(ori_h, ori_w),
                                       self.augs)]
            if frame_idx == 0:
                states, groups = self._add_references(
                    frame, imgs, frame.label, frame.obj_num, 0, gap)
                self._save_first(seq, frame, ori_h, ori_w)
                continue
            t0 = time.perf_counter()
            pred = self._aug_mean_label(states, imgs, (ori_h, ori_w),
                                        first_probe=self.probe)
            if frame.label is not None:
                # any annotated frame after 0 merges its annotation and
                # re-references every aug
                gt = torch.from_numpy(frame.label).to(self.device)
                pred = torch.where(gt == 0, pred, gt)
                states, groups = self._add_references(
                    frame, imgs, pred, int(pred.max()), frame_idx, gap)
            else:
                for ai, (img, aug) in enumerate(zip(imgs, self.augs)):
                    states[ai] = self.engine.write_label(
                        states[ai], pred, tuple(img.shape[1:3]), aug.flip)
            label = pred.cpu().numpy()   # waits for the frame's work
            seconds += time.perf_counter() - t0
            self._save(label, seq.name, frame.name, ori_h, ori_w, obj_idx)
        return SequenceResult(seq.name, n_processed, seconds)

    def _eval_sequence_fused(self, seq, gap: int,
                             max_frames: Optional[int] = None
                             ) -> SequenceResult:
        """Chunks of eval_scan_chunk frames through the engine's raw-frame
        scan, every aug inside one call; the labels stay on the device
        until the video ends. The time is wall-clock from frame 0's
        arrival to the last label on the host: it includes the reference
        frame and waits for decoding, not the PNG writes."""
        cfg = self.cfg
        states, groups = None, 1
        pending = []  # (frame names, output size, labels [K, H, W])
        buf = []      # (frame name, frame) awaiting one engine call
        seconds = 0.0
        n_processed = 0
        obj_idx = None
        flips = tuple(a.flip for a in self.augs)
        in_hws, out_hw = None, None
        fw = int(cfg.eval_fps_window or 0)
        windows: List[Tuple[int, float]] = []
        disp_frames = win_mark = 0
        win_t = t_wall0 = None

        def dispatch(items, pad_to):
            nonlocal states
            k = len(items)
            raws = [f.image for _, f in items]
            raws += [raws[-1]] * (pad_to - k)
            raw = torch.stack(raws)
            if len(self.augs) == 1:
                st, labels = self.engine.scan_steps_raw(
                    states[0], raw, in_hws[0], out_hw, flips[0])
                states = [st]
            else:
                states, labels = self.engine.scan_steps_multi_raw(
                    states, raw, in_hws, out_hw, flips)
                states = list(states)
            pending.append(([name for name, _ in items], out_hw,
                            labels[:k]))

        for frame_idx, frame in self._frames(seq, max_frames):
            n_processed += 1
            out_hw = tuple(frame.image.shape[:2])
            obj_idx = frame.obj_idx
            if frame_idx == 0:
                t_wall0 = time.perf_counter()
                in_hws = self._in_hws(*out_hw)
                imgs = [self._prep_frame(frame.image, hw, aug.flip)
                        for hw, aug in zip(in_hws, self.augs)]
                states, groups = self._add_references(
                    frame, imgs, frame.label, frame.obj_num, 0, gap)
                self._save_first(seq, frame, *out_hw)
                continue
            if self.probe:
                t0 = time.perf_counter()
                img = self._prep_frame(frame.image, in_hws[0], False)
                states[0], logits4 = self.engine.propagate(states[0], img)
                logits = self.engine.predict_logits_at(logits4, out_hw)
                self._record_probe(logits)
                merged = soft_logit_aggregation(logits, cfg.model_max_obj_num)
                label = torch.argmax(merged, -1).to(torch.uint8)
                states[0] = self.engine.write_label(states[0], label,
                                                    in_hws[0])
                pending.append(([frame.name], out_hw, label[None]))
                seconds += time.perf_counter() - t0
                continue
            if frame.label is not None:
                # an annotated frame: the frames before it run unpadded
                # (a padded frame's memory write would reach the state
                # this frame propagates from), then the merge and the
                # re-reference
                for item in buf:
                    dispatch([item], 1)
                buf = []
                imgs = [self._prep_frame(frame.image, hw, aug.flip)
                        for hw, aug in zip(in_hws, self.augs)]
                pred = self._aug_mean_label(states, imgs, out_hw)
                gt = torch.from_numpy(frame.label).to(self.device)
                merged = torch.where(gt == 0, pred, gt)
                states, groups = self._add_references(
                    frame, imgs, merged, int(merged.max()), frame_idx, gap)
                pending.append(([frame.name], out_hw, merged[None]))
                continue
            buf.append((frame.name, frame))
            if len(buf) < max(cfg.eval_scan_chunk, 1):
                continue
            dispatch(buf, len(buf))
            disp_frames += len(buf)
            buf = []
            if fw and disp_frames - win_mark >= fw:
                int(states[0].bank.count)     # waits for every call so far
                now = time.perf_counter()
                windows.append((disp_frames - win_mark,
                                now - (win_t or t_wall0)))
                win_mark, win_t = disp_frames, now
        if buf and not self.probe:
            # padded to a whole chunk, as the JAX package pads to reuse its
            # compiled chunk; the padding's memory writes die with the
            # video's state
            dispatch(buf, max(cfg.eval_scan_chunk, 1))
            disp_frames += len(buf)
        if pending:
            names, hw_, labels = pending[-1]
            pending[-1] = (names, hw_, labels.cpu())  # bounds every call
        if not self.probe and n_processed > 1:
            seconds = time.perf_counter() - t_wall0
        if fw and disp_frames > win_mark:
            windows.append((disp_frames - win_mark,
                            time.perf_counter() - (win_t or t_wall0)))
        for names, (oh, ow), labels in pending:
            labels_np = labels.cpu().numpy().astype(np.uint8)
            for i, name in enumerate(names):
                self._save(labels_np[i], seq.name, name, oh, ow, obj_idx)
        return SequenceResult(seq.name, n_processed, seconds,
                              windows=windows or None)

    def _save_first(self, seq, frame, ori_h: int, ori_w: int) -> None:
        """The first annotation is copied byte for byte into the results,
        not re-encoded."""
        src = getattr(seq, "first_label_file", lambda: None)()
        if src is not None:
            dst = os.path.join(self.output_root, seq.name,
                               os.path.splitext(frame.name)[0] + ".png")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(src, dst)
            return
        self._save(np.asarray(frame.label, np.uint8), seq.name, frame.name,
                   ori_h, ori_w, frame.obj_idx)

    def _save(self, label: np.ndarray, seq_name: str, frame_name: str,
              h: int, w: int, obj_idx) -> None:
        if label.shape != (h, w):
            label = resize_label(label, (h, w))
        path = os.path.join(self.output_root, seq_name,
                            os.path.splitext(frame_name)[0] + ".png")
        self.writer.save(label, path, squeeze_idx=obj_idx)

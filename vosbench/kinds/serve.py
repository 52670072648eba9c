"""A serving cell: multi-scale + flip inference of a seeded video through
the package's `InferenceEngine.scan_steps_multi_raw`, as its evaluator
serves a video with `test_multiscale` and `test_flip`.

Set-up builds the engine from seeded weights, makes the video (on the
device, then kept on the host in pinned memory, as a decoder hands frames
over), gives every aug its reference frame (the first mask split into id
groups) and serves the first `fill_frames` frames in chunks, so that the
bank is full and every long-term write in the window evicts by score. The
window then serves chunks of `chunk` frames for the run's seconds,
finishing the chunk under way; each chunk's frames are copied to the card
and its labels back to the host, as the evaluator's writer needs them, and
`serve_fps` is the frames whose labels reached the host over the window's
time.

The check (after the window, the program freed): the plain reference
replays the video as served, from its first frame, teacher-forced with the
labels the program served and the victims its bank evicted (read from the
bank's slot order and a probe of each slot's content after every chunk).
It compares every served frame's label against the reference's merged
probabilities (the widest gap below the best), every eviction's victim
against the reference's scores, and after every chunk the bank's content
against the reference's.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from vosbench.harness import host
from vosbench.reference.model import build as build_reference
from vosbench.reference.numerics import tf32_off
from vosbench.reference.serve import Stream, label_gap, victim_gap

BANK = ("k", "v", "count", "score", "scored", "times", "order")


class ServeRun:
    """One run of a serving cell; `faults` (tests only) breaks the timed
    path: "frozen" chunks that leave every aug's memory as it was, "half"
    chunks that serve half of the augs, "label" chunks whose labels are
    altered where they are produced."""

    def __init__(self, wl: Dict, cfg, seed: int, device, faults=()):
        self.wl, self.cfg, self.seed, self.dev = wl, cfg, seed, device
        self.faults = set(faults)
        self.cfgd = dataclasses.asdict(cfg)
        self.augs = [(tuple(a[:2]), bool(a[2])) for a in wl["augs"]]
        self.out_hw = tuple(wl["video"]["raw_hw"])

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from rmem_tpu_torch.engine import InferenceEngine
        from rmem_tpu_torch.engine.inference import separate_mask
        from rmem_tpu_torch.models import build_vos_model
        from rmem_tpu_torch.ops.resize import resize_nearest
        from vosbench.weights import seeded_state_dict
        cfg, dev, wl = self.cfg, self.dev, self.wl
        with torch.device("meta"):
            model = build_vos_model(cfg.model_vos, cfg)
        sd = seeded_state_dict([(n, p.shape) for n, p in
                                model.named_parameters()], self.seed, dev)
        self.params = {k: host(v) for k, v in sd.items()}
        model.load_state_dict(sd, strict=True, assign=True)
        self.engine = InferenceEngine(model, cfg, device=dev)
        m = cfg.model_max_obj_num
        objects = wl["video"]["objects"]
        groups = -(-objects // m)
        obj_nums = [min(m, objects - g * m) for g in range(groups)]
        traffic = importlib.import_module(f"vosbench.traffic.{wl['generator']}")
        frames, self.mask = traffic.make_video(wl["video"], self.seed, dev)
        self.frames = host(frames)
        if dev.type == "cuda":
            self.frames = self.frames.pin_memory()
        self.states = []
        for (in_hw, flip) in self.augs:
            lab = resize_nearest(
                (self.mask.flip(1) if flip else self.mask)[None, ..., None],
                in_hw)[..., 0]
            st, _ = self.engine.add_reference(
                self.engine.prep(frames[0:1], in_hw, flip)[0],
                separate_mask(lab, groups, m), obj_nums, gap=wl["gap"])
            self.states.append(st)
        del frames
        self.pos, self.chunks = 0, []
        for _ in range(0, wl["fill_frames"], wl["chunk"]):
            self.chunk()

    # -- one chunk ------------------------------------------------------------
    def _snapshot(self, states) -> List:
        """Each aug's slot order and a probe of each slot's content: its
        last layer's values summed over the id groups and tokens, [S, Cv]
        in f32 (what the whole propagation wrote)."""
        return [(st.bank.order.clone(), st.bank.v[-1].float().sum((1, 2)))
                for st in states]

    def chunk(self) -> None:
        """Serve the video's next `chunk` frames (cycling over frames
        1..T-1): copy them to the card, serve them, and copy their labels
        to the host."""
        k = self.wl["chunk"]
        t = self.frames.shape[0]
        idx = [(self.pos + i) % (t - 1) + 1 for i in range(k)]
        self.pos += k
        raw = self.frames[idx[0]:idx[0] + k] if idx[-1] - idx[0] == k - 1 \
            else self.frames[torch.tensor(idx)]
        raw = raw.to(self.dev, non_blocking=True)
        before = self._snapshot(self.states)
        in_hws = [a[0] for a in self.augs]
        flips = [a[1] for a in self.augs]
        if self.faults:
            states, labels = self._faulty(raw, in_hws, flips)
        else:
            states, labels = self.engine.scan_steps_multi_raw(
                self.states, raw, in_hws, self.out_hw, flips)
        self.states = states
        after = self._snapshot(states)
        labels = labels.cpu()
        self.chunks.append(dict(idx=idx, labels=labels, before=before,
                                after=after))

    def _faulty(self, raw, in_hws, flips):
        eng = self.engine
        if "half" in self.faults:
            n = len(in_hws) // 2
            states, labels = eng.scan_steps_multi_raw(
                self.states[:n], raw, in_hws[:n], self.out_hw, flips[:n])
            return states + self.states[n:], labels
        if "frozen" in self.faults:
            keep = [(s.short_k, s.short_v) for s in self.states]
            saved = [tuple(getattr(s.bank, n).clone() for n in BANK)
                     for s in self.states]
            states, labels = eng.scan_steps_multi_raw(
                self.states, raw, in_hws, self.out_hw, flips)
            for s, (sk, sv), fields in zip(states, keep, saved):
                for name, x in zip(BANK, fields):
                    setattr(s.bank, name, x)
                s.short_k, s.short_v = sk, sv
            return states, labels
        states, labels = eng.scan_steps_multi_raw(
            self.states, raw, in_hws, self.out_hw, flips)
        objects = self.wl["video"]["objects"]
        labels[0] = (labels[0] + 1) % (objects + 1)   # the chunk's first
        return states, labels

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        """Chunks for `seconds`, the last one finished; each chunk ends with
        its labels on the host."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        frames = 0
        while True:
            self.chunk()
            frames += self.wl["chunk"]
            if time.perf_counter() - t0 >= seconds:
                break
        return {"frames": frames, "seconds": time.perf_counter() - t0}

    def traced(self, chunks: int) -> None:
        """The traced window: `chunks` more chunks, outside the timed one."""
        for _ in range(chunks):
            self.chunk()

    def attempted(self, win: Dict) -> int:
        return win["frames"]

    def end_to_end(self, win: Dict, peak: int, setup_s: float,
                   names) -> Dict:
        have = {"serve_fps": (win["frames"] / win["seconds"], "frames/s"),
                "peak_mem_gib": (peak / 2 ** 30, "GiB"),
                "setup_s": (setup_s, "s")}
        return {n: {"value": have[n][0], "unit": have[n][1]} for n in names}

    def finish(self) -> None:
        """Free the program before the check."""
        self.states = None
        del self.engine
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def _victims(self, ch: Dict, writes: int):
        """Each aug's written slots of a chunk: the slots whose probe
        changed (the spare slot aside). As many as the chunk's writes: a
        list in write order (by their rank after the chunk). Fewer (a slot
        written twice): the set of them, which write took which unknown."""
        out = []
        cap = ch["before"][0][0].shape[0]
        for (ob, pb), (oa, pa) in zip(ch["before"], ch["after"]):
            changed = (pb[:cap - 1] != pa[:cap - 1]).any(-1).nonzero()
            slots = [int(i) for i in changed.flatten()]
            out.append(sorted(slots, key=lambda i: int(oa[i]))
                       if len(slots) == writes else set(slots))
        return out

    def check(self, control: bool = False) -> Dict:
        """The reference replay of the video as served; with `control`, the
        fp8 control in lockstep, judged by the reference the same way, and
        its numbers compared in the program's place. Returns the numbers
        compared and what they were read from."""
        tf32_off()
        # PyTorch's own convs: cuDNN's choice for some of these f32 convs
        # is an FFT of many small launches, ~0.9 s a frame
        cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            return self._replay(control)
        finally:
            torch.backends.cudnn.enabled = cudnn

    def _replay(self, control: bool) -> Dict:
        dev = self.dev
        ref = Stream(build_reference(self.cfgd, self.params, dev),
                     self.cfgd, [a[0] for a in self.augs],
                     [a[1] for a in self.augs], self.out_hw, self.wl["gap"])
        ctl = None
        if control:
            ctl = Stream(build_reference(self.cfgd, self.params, dev, "fp8"),
                         self.cfgd, ref.in_hws, ref.flips, self.out_hw,
                         self.wl["gap"])
        objects = self.wl["video"]["objects"]
        frames = self.frames
        for r in (ref, ctl):
            if r is not None:
                r.reference(frames[0].to(dev), self.mask, objects)
        lab_gaps, ev_gaps, bank_gaps, unknown, mismatch = [], [], [], 0, 0
        ctl_lab, ctl_ev, ctl_bank = [], [], []
        for ch in self.chunks:
            last, writes = ref.last_write, 0
            for j in range(len(ch["idx"])):
                if ref.frame + 1 + j - last >= ref.gap:
                    writes, last = writes + 1, ref.frame + 1 + j
            victims = self._victims(ch, writes)
            w = 0
            for j, fi in enumerate(ch["idx"]):
                label = ch["labels"][j].to(dev).long()
                raw = frames[fi].to(dev)
                probs = ref.probs(raw)
                lab_gaps.append(label_gap(probs, label))
                if ctl is not None:
                    cp = ctl.probs(raw)
                    ctl_lab.append(label_gap(probs, cp.argmax(-1)))
                if not ref.write_due():
                    ref.write(label)
                    if ctl is not None:
                        ctl.write(label)
                    continue
                rounds = ref.totals()
                forced = []
                for a, r in enumerate(rounds):
                    known = victims[a]
                    count = ref.states[a]["count"]
                    if isinstance(known, list):
                        v = known[w]
                    else:
                        # one of the slots the chunk wrote: the reference's
                        # least total among them
                        unknown += 1
                        cand = [i for i in known if r is not None
                                and math.isfinite(float(r["total"][i]))]
                        v = (count if r is None else min(
                            cand, key=lambda i: float(r["total"][i]),
                            default=None))
                    if r is None or v is None:
                        mismatch += int(v != count or r is not None)
                    else:
                        ev_gaps.append(victim_gap(r["total"], v))
                    forced.append(v)
                if ctl is not None:
                    crounds = ctl.totals()
                    for r, cr in zip(rounds, crounds):
                        if r is not None:
                            ctl_ev.append(victim_gap(
                                r["total"], int(torch.argmin(cr["total"]))))
                    ctl.write(label, forced, crounds)
                ref.write(label, forced, rounds)
                w += 1
            for a, (_, probe) in enumerate(ch["after"]):
                bank_gaps.append(bank_gap(probe, ref.states[a]))
                if ctl is not None:
                    ctl_bank.append(bank_gap(state_probe(ctl.states[a]),
                                             ref.states[a]))
        out = {"label_gap": max(lab_gaps),
               "evict_gap": max(ev_gaps, default=0.0),
               "bank_gap": max(bank_gaps), "slot_mismatch": float(mismatch),
               "frames_checked": len(lab_gaps),
               "evictions_checked": len(ev_gaps), "victims_unknown": unknown}
        if ctl is not None:
            # the control in the program's place; its fill slots and
            # victims are the program's (teacher-forced)
            out.update(label_gap=max(ctl_lab),
                       evict_gap=max(ctl_ev, default=0.0),
                       bank_gap=max(ctl_bank), control=True)
        return out


def state_probe(state: Dict) -> torch.Tensor:
    """The probe of a reference aug state's bank, as `_snapshot` takes the
    program's."""
    return state["v"][-1].float().sum((1, 2))


def bank_gap(probe: torch.Tensor, ref_state: Dict) -> float:
    """The widest gap between a probe of the bank's valid slots and the
    reference's, relative to the reference's largest."""
    n = ref_state["count"]
    ref = state_probe(ref_state)[:n]
    return float((probe[:n].to(ref.device) - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


RUN = ServeRun

"""A training cell: RMem's VOST job through the package's `Trainer`.

Set-up builds one Trainer from seeded weights, on a pool of seeded clips
fed as its `batches`, starts its step counter at the workload's
`start_step` and takes the first `check_steps` steps through its own
`next_batch` and `step_fn` on distinct clips (these steps also warm up
every shape). The window then keeps stepping the same Trainer for the
run's seconds, finishing the step under way at the deadline, and
`train_clips_per_s` is its clips over the window's time. After the window
the same Trainer, warm, takes `warm_steps` more steps through the same
calls, from a copy of its state kept on the host.

The check (after those, the program freed): the plain reference follows
the first `check_steps` steps from the same weights, clips and id
shuffles, and the `warm_steps` from the program's copied state
(parameters, Adam's moments and step count): each step's loss, the first
gradient as the optimizer took it (read from Adam's first moment) and each
parameter's change over the steps are compared, each by its worst leaf,
the larger of the two stretches' gaps.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, List

import numpy as np
import torch

from vosbench.harness import host
from vosbench.reference.model import build as build_reference
from vosbench.reference.numerics import tf32_off
from vosbench.reference.train import RefTrainer, leaf_norms, worst_leaf_gap

ADAM_B1 = 0.9


class TrainRun:
    """One run of a training cell; `faults` (tests only) break the timed
    path from the window on (set-up's steps are sound): "frozen" steps
    that return the state unchanged, "half" steps that leave out half of
    each batch, "loss" a clip loss altered where it is produced (5 %
    high)."""

    def __init__(self, wl: Dict, cfg, seed: int, device, faults=()):
        self.wl, self.cfg, self.seed, self.dev = wl, cfg, seed, device
        self.faults = set(faults)
        self.cfgd = dataclasses.asdict(cfg)
        self.draws = 0       # batches drawn from the pool
        self.undo: List = []

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from rmem_tpu_torch.managers.trainer import Trainer
        from rmem_tpu_torch.models import build_vos_model
        from vosbench.weights import seeded_state_dict
        cfg, dev = self.cfg, self.dev
        b = cfg.train_batch_size
        hw = tuple(cfg.data_randomcrop)
        self.traffic = importlib.import_module(
            f"vosbench.traffic.{self.wl['generator']}")
        self.pool = self.traffic.make_pool(self.wl["clips"], cfg.data_seq_len,
                                          hw, self.seed, dev)
        with torch.device("meta"):
            shapes = [(n, p.shape) for n, p in
                      build_vos_model(cfg.model_vos, cfg).named_parameters()]
        sd = seeded_state_dict(shapes, self.seed, dev)
        self.params0 = {k: host(v) for k, v in sd.items()}
        self.trainer = Trainer(cfg, device=dev, params=sd, log=lambda *a: None,
                               batches=self.traffic.batches(self.pool, b))
        del sd
        # the id shuffles are drawn from the seed too
        self.trainer.rng = np.random.RandomState(self.seed % 2 ** 32)
        self.trainer.state.step = self.wl["start_step"]
        self.start = self._steps(self.wl["check_steps"])
        self._plant()

    def _steps(self, n: int) -> Dict:
        """n steps through the window's own calls from the state as it is,
        which is copied to the host first; returns the copy, the steps'
        batches and shuffles, and the program's readings: each step's loss,
        every leaf's norm of the first gradient as the optimizer took it
        (Adam's first moment after the step less b1 times before, over
        1 - b1) and of the change over the steps."""
        st = self.trainer.state
        model = st.model
        out = {"params": {k: host(p) for k, p in model.named_parameters()},
               "mu": {k: host(t) for k, t in st.mu.items()},
               "nu": {k: host(t) for k, t in st.nu.items()},
               "step": st.step, "draw": self.draws, "shuffles": [],
               "losses": []}
        mu0 = {k: t.clone() for k, t in st.mu.items()}
        for i in range(n):
            m, shuffle = self.step_once()
            out["shuffles"].append(host(shuffle))
            out["losses"].append(float(m["loss"]))
            if i == 0:
                out["grad1"] = leaf_norms({
                    k: (t - ADAM_B1 * mu0[k]) / (1.0 - ADAM_B1)
                    for k, t in st.mu.items()})
        del mu0
        out["delta"] = leaf_norms({k: host(p) - out["params"][k]
                                   for k, p in model.named_parameters()})
        return out

    def _plant(self) -> None:
        """Break the timed path as `faults` say, from here on."""
        if "frozen" in self.faults or "half" in self.faults:
            self.trainer.step_fn = self._faulty(self.trainer.step_fn)
        if "loss" in self.faults:
            import rmem_tpu_torch.managers.trainer as tr
            forward = tr.train_forward

            def altered(*args, **kwargs):
                loss, metrics = forward(*args, **kwargs)
                return loss * 1.05, dict(metrics, loss=metrics["loss"] * 1.05)

            tr.train_forward = altered
            self.undo.append(lambda: setattr(tr, "train_forward", forward))

    def _faulty(self, step_fn):
        def step(state, batch, shuffle, cfg):
            if "half" in self.faults:
                h = batch["imgs"].shape[0] // 2
                batch = {k: v[:h] for k, v in batch.items()}
                shuffle = shuffle[:h]
                cfg = cfg.replace(train_batch_size=h)
            if "frozen" in self.faults:
                saved = {n: p.detach().clone() for n, p in
                         state.model.named_parameters()}
                m = step_fn(state, batch, shuffle, cfg)
                with torch.no_grad():
                    for n, p in state.model.named_parameters():
                        p.copy_(saved[n])
                return m
            return step_fn(state, batch, shuffle, cfg)
        return step

    # -- the window ---------------------------------------------------------
    def step_once(self):
        """One step on the next batch: (its metrics, its id shuffle)."""
        t = self.trainer
        batch, shuffle = t.next_batch()
        self.draws += 1
        return t.step_fn(t.state, batch, shuffle, self.cfg), shuffle

    def window(self, seconds: float) -> Dict:
        """Steps for `seconds` of host time, the last one finished; returns
        steps, clips and the window's seconds."""
        sync = (lambda: torch.cuda.synchronize(self.dev)) \
            if self.dev.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        steps = 0
        while True:
            self.step_once()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        dt = time.perf_counter() - t0
        return {"steps": steps, "clips": steps * self.cfg.train_batch_size,
                "seconds": dt}

    def traced(self, steps: int) -> None:
        """The traced window: `steps` more steps, outside the timed one."""
        for _ in range(steps):
            self.step_once()

    def attempted(self, win: Dict) -> int:
        return win["steps"]

    def end_to_end(self, win: Dict, peak: int, setup_s: float,
                   names) -> Dict:
        have = {"train_clips_per_s": (win["clips"] / win["seconds"],
                                      "clips/s"),
                "peak_mem_gib": (peak / 2 ** 30, "GiB"),
                "setup_s": (setup_s, "s")}
        return {n: {"value": have[n][0], "unit": have[n][1]} for n in names}

    def finish(self) -> None:
        """The warm steps, then free the program before the check."""
        self.warm = self._steps(self.wl["warm_steps"])
        for u in reversed(self.undo):
            u()
        self.trainer.close()
        del self.trainer
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def readings(self, prog: Dict, precision: str = "float32") -> Dict:
        """The reference's (or, with precision "fp8", the control's) steps
        from the state the program took `prog`'s steps from, on the same
        clips and shuffles: the readings `_steps` takes of the program."""
        tf32_off()
        cfgd, dev = self.cfgd, self.dev
        b = self.cfg.train_batch_size
        model = build_reference(cfgd, prog["params"], dev, precision)
        ref = RefTrainer(model, cfgd, prog["step"], prog["mu"], prog["nu"])
        losses, g1 = [], None
        for i, shuffle in enumerate(prog["shuffles"]):
            first = (prog["draw"] + i) * b
            idx = torch.arange(first, first + b, device=dev) % \
                self.pool["imgs"].shape[0]
            batch = {k: v.index_select(0, idx) for k, v in self.pool.items()}
            losses.append(ref.train_step(batch["imgs"], batch["labels"],
                                         batch["obj_nums"], shuffle.to(dev)))
            if i == 0:
                g1 = leaf_norms(ref.last_grads)
        delta = leaf_norms({n: host(p) - prog["params"][n]
                            for n, p in model.named_parameters()})
        del model, ref
        return {"losses": losses, "grad1": g1, "delta": delta}

    def check(self, control: bool = False) -> Dict:
        """The program's readings (with `control`, the control's: the
        reference in fp8 from the same states) against the reference's,
        over set-up's first steps and the warm steps; each number the
        larger of the two."""
        out = {}
        for part, prog in (("start", self.start), ("warm", self.warm)):
            ref = self.readings(prog)
            got = compare(self.readings(prog, "fp8") if control else prog,
                          ref)
            for k in NUMBERS:
                out[k] = max(out.get(k, 0.0), got[k])
            out[part] = got
        return out


NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def compare(prog: Dict, ref: Dict) -> Dict:
    """The numbers compared: the widest relative gap of a step's loss, and
    by the worst leaf the gap of the first gradient's norm and of the
    change's norm, each against the larger of the leaf's and the median
    leaf's reference norm."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))
    names = list(ref["grad1"])
    grad_gap, grad_at = worst_leaf_gap(prog["grad1"], ref["grad1"], names)
    # leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out of the change by that rule
    med = float(np.median([ref["grad1"][n] for n in names]))
    moved = [n for n in names if ref["grad1"][n] >= 1e-3 * med]
    change_gap, change_at = worst_leaf_gap(
        prog["delta"], ref["delta"],
        [n for n in moved if ref["delta"][n] > 0] or moved)
    if any(ref["delta"][n] == 0 and prog["delta"][n] > 0 for n in moved):
        change_gap = max(change_gap, 1.0)     # moved where the reference not
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_at,
            "change_leaf": change_at, "losses": prog["losses"],
            "ref_losses": ref["losses"], "left_out": len(names) - len(moved)}


RUN = TrainRun

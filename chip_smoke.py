#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rmem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--frames N] [--profile]

Run from the root of a checkout. Phases, any failure ending the run with a
non-zero exit code:

1. print the card (name and power limit, as nvidia-smi gives them) and
   build the CUDA kernels from csrc/ into build/, one nvcc per source, all
   at once;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes, in bf16, and time both (CUDA events), plus one PyTorch library
   call for the same function where one exists;
3. drive the main path: R50-DeAOTL + RMem inference at 481x849, 10
   objects, random weights from a seed, the reference frame with a
   long-term write every 5 frames, then N frames (default 130) at the
   480x854 output, so the bank fills its 9 slots by frame 40 and evicts.
   Launch counts are zeroed just before and read just after; every kernel
   must have run, and evictions are counted on the device. Frames/s is timed over consecutive 30-frame windows with
   the bank full (three by default), each printed with the median, beside
   the card and the host's CPU and load (the frame is host-bound);
4. run the first frames again through the kernel engine, holding every
   kernel call against its plain version on the same inputs, and through
   an engine with every kernel replaced by its plain version, the latter
   teacher-forced with the former's labels so both banks take the same
   writes up to the full bank; hold the logits and labels of every frame
   of the two engines against each other.

Prints the `kernels` JSON line, then the card line, then the result line
`{"ok": true, "device": {...}}` last. Exits non-zero without a result when
no CUDA device is available or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
IN_HW = (481, 849)
OUT_HW = (480, 854)
NUM_OBJECTS = 10
WINDOW = 30        # frames per timed window
BANK_FULL = 40     # frames until the 1 + 8 slots are full (a write every 5)
# phase 4 stops at the full bank (9 slots at frame 40), before the first
# eviction, whose victim may follow a near tie in the slot mass
AGREE_FRAMES = 44
# the kernel and plain engines differ by bf16 rounding inside the kernels
# (the plain versions compute in f32): the logits of every frame by a few
# bf16 steps (2^-8) of their scale, 1.1e-2 to 1.7e-2 measured on an H100;
# the labels only where the top-2 logits nearly tie, which random weights
# make common (0.986 to 0.990 of pixels agree, measured on an H100)
LOGIT_TOL = 3e-2        # max |kernel - plain| / max |plain| per frame
AGREE_FLOOR = 0.98
# each kernel call against its plain version (which computes in f32), in
# phase 2 and on the path in phase 4: K1 and K4 round probabilities and
# output to bf16, ~3 roundings of the output's scale; K1's slot mass sums
# f32 probabilities of the same f32 logits on both sides (4.3e-7 measured
# on an H100); K6 within one bf16 ulp (see held)
OUT_TOL = 2e-2          # K1, K4: max |kernel - plain| / max |plain|
MASS_TOL = 1e-4         # K1: max |slot mass - plain|
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3


def check(ok: bool, what: str) -> None:
    """Fail the run; unlike an assert statement it holds under python -O."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def host_line() -> str:
    """The host's CPU model and architecture, visible CPUs and load."""
    cpuinfo = Path("/proc/cpuinfo")
    lines = cpuinfo.read_text().splitlines() if cpuinfo.exists() else []
    model = next((ln.split(":", 1)[1].strip() for ln in lines
                  if ln.startswith("model name")), "CPU model not shown")
    return (f"{model} ({platform.machine()}), {os.cpu_count()} CPUs "
            f"visible, 1-minute load {os.getloadavg()[0]:.2f}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def held(name: str, got, ref):
    """Hold one kernel call's result against its plain version's on the
    same inputs. Returns (max |out - plain|, max |plain|, and for K1 max
    |slot mass - plain|, else None)."""
    import torch
    mass_err = None
    if name == "bank_attention":
        (got, mass), (ref, mass_ref) = got, ref
        mass_err = (mass - mass_ref).abs().max().item()
        check(mass_err <= MASS_TOL, f"{name} slot mass {mass_err}")
    diff = (got.float() - ref.float()).abs()
    err, top = diff.max().item(), ref.float().abs().max().item()
    if name == "stem":
        # the conv sums in another order, so the bf16-rounded conv may move
        # by one ulp: of the value itself, or, where the bias cancels the
        # conv near zero, of the conv's scale (bounded by the output's top)
        ok = bool(torch.all(diff <= 2 ** -7 * ref.float().abs()
                            + 2 ** -8 * top))
    else:
        ok = err <= OUT_TOL * top
    check(ok, f"{name} max|out-plain| {err} of max|plain| {top}")
    return err, top, mass_err


def check_kernels(dev):
    """Phase 2: each kernel against its plain version at main-path shapes.
    Returns {name: entry} without launch counts."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.ops.attention import NEG_INF, _local_offset_map_on

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    entries = {}
    h, w = (IN_HW[0] - 1) // 16 + 1, (IN_HW[1] - 1) // 16 + 1     # 31 x 54
    hw, dh, dv, S, count = h * w, 128, 1024, 10, 9
    scale = dh ** -0.5

    # ---- K1 bank attention: 9 of 10 slots valid, slot-PE bias ----
    q = randn(1, hw, dh, scale=2.0)
    bk, bvv = randn(S, 1, hw, dh), randn(S, 1, hw, dv)
    qbias = randn(1, 1, hw, S, dtype=torch.float32, scale=0.5)
    cnt = torch.tensor(count, dtype=torch.int32, device=dev)
    args = (q, bk, bvv, cnt, 1, scale, hw, qbias)
    out, rec = kb.bank_attention_infer(*args)
    err, top, rerr = held("bank_attention", (out, rec),
                          kb.bank_attention_plain(*args))
    print(f"K1 bank_attention: max|out-plain| {err:.3e} (max|plain| "
          f"{top:.3e}), max|rec-plain| {rerr:.3e}")
    check(bool(torch.all(rec[..., count:] == 0)), "K1 mass of empty slots")
    # the reference frame's call: one slot, no bias
    one = torch.ones((), dtype=torch.int32, device=dev)
    o1, r1 = kb.bank_attention_infer(q, bk[:1], bvv[:1], one, 1, scale)
    err1, _, _ = held("bank_attention", (o1, r1), kb.bank_attention_plain(
        q, bk[:1], bvv[:1], one, 1, scale))
    check(torch.allclose(r1, torch.ones_like(r1), atol=1e-4), "K1 S=1 mass")
    kv = count * hw
    k_lib = bk[:count].reshape(1, 1, kv, dh)
    v_lib = bvv[:count].reshape(1, 1, kv, dv)
    mask = qbias[0, 0, :, :count].to(bf).repeat_interleave(hw, dim=1)[None, None]
    flops = 2.0 * hw * kv * (dh + dv)
    nbytes = (q.numel() + kv * (dh + dv) + hw * dv) * 2 + 2 * hw * S * 4
    b_ms, b_by = bound(flops, nbytes)
    entries["bank_attention"] = dict(
        name="bank_attention", route="cuda",
        source="rmem_tpu_torch/csrc/bank_attention.cu",
        replaces="rmem_tpu/kernels/bank_attention.py:505",
        max_abs_err=max(err, err1), max_abs_err_rec=rerr,
        ms=cuda_ms(lambda: kb.bank_attention_infer(*args), 20),
        plain_ms=cuda_ms(lambda: kb.bank_attention_plain(*args), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k_lib, v_lib, attn_mask=mask, scale=scale), 20))

    # ---- K4 local attention on the 31 x 54 grid ----
    k = randn(1, hw, dh)
    v = randn(1, hw, dv)
    rel = randn(1, hw, 225)
    largs = (q, k, v, rel, (h, w), 1, 7, scale)
    err, top, _ = held("local_attention", kl.local_attention(*largs),
                       kl.local_attention_plain(*largs))
    print(f"K4 local_attention: max|out-plain| {err:.3e} (max|plain| "
          f"{top:.3e})")
    omap = _local_offset_map_on(h, w, 7, dev)
    keys = (omap < 225).sum().item()             # in-image window keys
    relp = torch.cat([rel[0], torch.full((hw, 1), NEG_INF, dtype=bf,
                                         device=dev)], dim=1)
    dense_bias = torch.gather(relp, 1, omap)[None, None]
    # q and k, v and rel read once, the output written once
    b_ms, b_by = bound(2.0 * keys * (dh + dv),
                       (2 * hw * dh + 2 * hw * dv + hw * 225) * 2)
    entries["local_attention"] = dict(
        name="local_attention", route="cuda",
        source="rmem_tpu_torch/csrc/local_attention.cu",
        replaces="rmem_tpu/kernels/local_attention.py:133",
        max_abs_err=err,
        ms=cuda_ms(lambda: kl.local_attention(*largs), 50),
        plain_ms=cuda_ms(lambda: kl.local_attention_plain(*largs), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=dense_bias, scale=scale),
            20))

    # ---- K6 stem on the 481 x 849 image ----
    x = torch.rand((1, *IN_HW, 3), generator=g, device=dev)
    wt = randn(64, 3, 7, 7, scale=0.2)
    sc = torch.ones(64, dtype=bf, device=dev)     # BN scale folded into wt
    bi = randn(64, scale=0.1)
    sargs = (x, wt, sc, bi)
    out = ks.stem(*sargs)
    ref = ks.stem_plain(*sargs)
    ho, wo = (IN_HW[0] - 1) // 2 + 1, (IN_HW[1] - 1) // 2 + 1
    check(out.shape == ref.shape == (1, (ho - 1) // 2 + 1,
                                     (wo - 1) // 2 + 1, 64),
          f"K6 shape {tuple(out.shape)}")
    err, top, _ = held("stem", out, ref)
    print(f"K6 stem: max|out-plain| {err:.3e} (max|plain| {top:.3e}), "
          f"{int((out != ref).sum())} of {out.numel()} values differ")
    b_ms, b_by = bound(2.0 * 147 * 64 * ho * wo,
                       x.numel() * 4 + wt.numel() * 2 + out.numel() * 2)
    entries["stem"] = dict(
        name="stem", route="cuda", source="rmem_tpu_torch/csrc/stem.cu",
        replaces="rmem_tpu/kernels/stem.py:137", max_abs_err=err,
        ms=cuda_ms(lambda: ks.stem(*sargs), 50),
        plain_ms=cuda_ms(lambda: ks.stem_plain(*sargs), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries


def reference_inputs(dev):
    import numpy as np
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    mask = np.zeros((1, *IN_HW), np.int32)
    for i in range(NUM_OBJECTS):          # 10 object stripes
        mask[:, :, i * 80:i * 80 + 60] = i + 1
    img0 = torch.rand((1, *IN_HW, 3), generator=g, device=dev)
    return img0, mask, g


def build_engine(dev):
    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.engine import InferenceEngine
    from rmem_tpu_torch.models import build_vos_model, init_params
    cfg = get_config("pre_vost", model="r50_deaotl")
    model = init_params(build_vos_model(cfg.model_vos, cfg), seed=0)
    return InferenceEngine(model, cfg, device=dev), cfg


def main_path(dev, frames: int, card: str, profile: bool):
    """Phase 3: returns (launch counts, per-window frames/s)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, cfg = build_engine(dev)
    img0, mask, g = reference_inputs(dev)
    imgs = torch.rand((frames, 1, *IN_HW, 3), generator=g, device=dev)
    torch.cuda.synchronize()
    print(f"main path: model built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in engine.model.parameters())} weights")

    wrappers = (kb.bank_attention_infer, kl.local_attention, ks.stem)
    for fn in wrappers:
        fn.launches = 0
    gap = cfg.test_long_term_mem_gap
    state, logits = engine.add_reference(img0, mask, [NUM_OBJECTS], gap=gap)
    labels = []
    windows = max(1, (frames - BANK_FULL) // WINDOW)
    first = frames - windows * WINDOW
    host = host_line()
    marks = []
    slots = cfg.former_mem_len + cfg.latter_mem_len
    evictions = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(frames):
        if t >= first and (t - first) % WINDOW == 0:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        was_full = state.bank.count >= slots
        state, label = engine.step(state, imgs[t], OUT_HW)
        # a long-term write into a full bank evicts
        evictions += was_full & (state.last_mem_step == state.frame_step)
        labels.append(label)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    counts = {fn.__name__: fn.launches for fn in wrappers}
    window_fps = [WINDOW / (b - a) for a, b in zip(marks, marks[1:])]
    fps = statistics.median(window_fps)

    labels = torch.stack(labels)
    evictions = int(evictions)
    # the reference fills slot 1; a write every `gap` frames fills the rest
    scheduled = frames // gap - (slots - 1)
    print(f"main path: {frames} frames, launches {counts}, bank count "
          f"{int(state.bank.count)}, order {state.bank.order.tolist()}, "
          f"times {state.bank.times.tolist()}")
    check(all(n > 0 for n in counts.values()), f"a kernel never ran: {counts}")
    check(int(state.bank.count) == slots, "bank not full")
    check(evictions >= 1 and evictions == scheduled,
          f"{evictions} evictions, {scheduled} scheduled")
    check(labels.shape == (frames, *OUT_HW), f"labels {tuple(labels.shape)}")
    check(int(labels.min()) >= 0 and int(labels.max()) <= NUM_OBJECTS,
          "labels out of [0, 10]")
    check(bool(torch.isfinite(state.logits4x).all()), "non-finite logits")
    print(f"main path: {evictions} evictions counted on the device "
          f"({scheduled} scheduled); labels in "
          f"[{int(labels.min())}, {int(labels.max())}]; per-frame label "
          f"histogram of the last frame "
          f"{torch.bincount(labels[-1].flatten().long(), minlength=11).tolist()}")
    print(f"main path: {fps:.3f} frames/s, median of {windows} windows of "
          f"{WINDOW} frames ("
          + ", ".join(f"{x:.3f}" for x in window_fps)
          + f"; the last is the last {WINDOW} frames) at 481x849 in, "
          f"480x854 out, 10 objects, on {card}; host {host}; main-path "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            for t in range(5):
                state, _ = engine.step(state, imgs[t], OUT_HW)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType
        events = p.key_averages()
        print(events.table(sort_by="cuda_time_total", row_limit=25,
                           max_name_column_width=60))
        # kernels only: an operator's row repeats its kernels' device time
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA) / 5e3
        print(f"profile: device busy {busy_ms:.3f} ms per frame; against "
              f"the unprofiled {1e3 / fps:.3f} ms per frame the device idles "
              f"{100 * (1 - busy_ms * fps / 1e3):.1f} %")
    return counts, window_fps


def plain_agreement(dev):
    """Phase 4: the same weights and frames through the kernel engine,
    each of whose kernel calls is held against its plain version on the
    same inputs, and through an engine whose kernels are their plain
    versions. The plain engine is teacher-forced with the kernel engine's
    labels, so both banks take the same writes and the logits of every
    frame compare, with 1 to 9 valid slots. Returns (per-kernel worst call,
    per-frame relative logit error with the reference frame first,
    per-frame label agreement)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.ops.resize import resize_nearest, upsample_argmax

    kernels = (("bank_attention", kb, "bank_attention_infer",
                kb.bank_attention_plain),
               ("local_attention", kl, "local_attention",
                kl.local_attention_plain),
               ("stem", ks, "stem", ks.stem_plain))
    calls = {name: [] for name, *_ in kernels}

    def on_path(name, kernel, plain_fn):
        def call(*args, **kwargs):
            got = kernel(*args, **kwargs)
            calls[name].append(held(name, got, plain_fn(*args, **kwargs)))
            return got
        # the wrapper counts its launches on the name it has in its module,
        # which is now this function's
        call.launches = 0
        return call

    img0, mask, g = reference_inputs(dev)
    imgs = torch.rand((AGREE_FRAMES, 1, *IN_HW, 3), generator=g, device=dev)
    runs = []
    for plain in (False, True):
        with ExitStack() as stack:
            for name, mod, attr, plain_fn in kernels:
                fn = (plain_fn if plain
                      else on_path(name, getattr(mod, attr), plain_fn))
                stack.enter_context(mock.patch.object(mod, attr, fn))
            engine, cfg = build_engine(dev)
            state, logits = engine.add_reference(
                img0, mask, [NUM_OBJECTS], gap=cfg.test_long_term_mem_gap)
            frame_logits, labels = [logits.float()], []
            for t in range(AGREE_FRAMES):
                if not plain:
                    state, label = engine.step(state, imgs[t], OUT_HW)
                else:
                    state, logits4 = engine.propagate(state, imgs[t])
                    label = upsample_argmax(logits4, OUT_HW,
                                            cfg.model_align_corners)
                    forced = runs[0][1][t]
                    engine.update_memory(state, resize_nearest(
                        forced[None, ..., None], IN_HW)[..., 0])
                frame_logits.append(state.logits4x.float())
                labels.append(label)
            runs.append((frame_logits, labels, int(state.bank.count)))
    worst = {}
    for name, errs in calls.items():
        worst[name] = dict(calls=len(errs),
                           rel_err=max(e / top for e, top, _ in errs))
        if name == "bank_attention":
            worst[name]["slot_mass_err"] = max(m for *_, m in errs)
    print(f"phase 4, every kernel call on the path against its plain "
          f"version: {worst}")
    (lk, yk, count), (lp, yp, count_p) = runs
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(lk, lp)]
    agree = [(a == b).float().mean().item() for a, b in zip(yk, yp)]
    print("kernel vs plain engine, max|logits diff| / max|plain logits| per "
          "frame (reference first): " + ", ".join(f"{e:.3e}" for e in errs))
    print("kernel vs plain engine, label agreement per frame: "
          + ", ".join(f"{a:.5f}" for a in agree))
    slots = cfg.former_mem_len + cfg.latter_mem_len
    check(count == count_p == slots, f"bank counts {count}, {count_p}")
    check(all(w["calls"] > 0 for w in worst.values()), f"calls {worst}")
    check(max(errs) <= LOGIT_TOL, f"logits {max(errs)}")
    check(min(agree) >= AGREE_FLOOR, f"label agreement {min(agree)}")
    return worst, errs, agree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=BANK_FULL + 3 * WINDOW)
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of 5 steady frames")
    args = ap.parse_args()
    if args.frames < 60:
        ap.error("--frames must be at least 60 (the bank fills at 40)")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "rmem_tpu_torch").is_dir():
        print(f"chip_smoke: rmem_tpu_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    from rmem_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build()
    print(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    entries = check_kernels(dev)
    counts, window_fps = main_path(dev, args.frames, card, args.profile)
    for key, fn_name in (("bank_attention", "bank_attention_infer"),
                         ("local_attention", "local_attention"),
                         ("stem", "stem")):
        entries[key]["launches"] = counts[fn_name]
    on_path, logit_errs, agree = plain_agreement(dev)

    print(json.dumps({"fps_windows": window_fps,
                      "fps_median": statistics.median(window_fps),
                      "on_path": on_path, "logit_rel_err": logit_errs,
                      "label_agreement": agree, "card": card,
                      "host": host_line()}))
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rmem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--frames N] [--profile]
    python3 chip_smoke.py --mutants

Run from the root of a checkout. Phases, any failure ending the run with a
non-zero exit code:

1. print the card (name and power limit, as nvidia-smi gives them) and
   build the CUDA kernels from csrc/ into build/, one nvcc per source, all
   at once;
2. hold each kernel against its plain PyTorch version at its path's
   shapes, in bf16, and time both (CUDA events), plus one PyTorch library
   call for the same function where one exists: the serving kernels (K1,
   K4, K6) and the opt-in inference kernels (K3, beside K1 on the same
   inputs; K8, timed through a CUDA graph over input sets larger than the
   L2) at 481x849, and the training kernels (K1 with its lse output,
   K2's three backward kernels with a nonzero drec, K5 and K7 forward and
   backward) at the training shapes;
3. drive the serving path: R50-DeAOTL + RMem inference at 481x849, 10
   objects, random weights from a seed, the reference frame with a
   long-term write every 5 frames, then N frames (default 130) at the
   480x854 output, so the bank fills its 9 slots by frame 40 and evicts.
   Launch counts are zeroed just before and read just after; every kernel
   must have run, and evictions are counted on the device. Frames/s is
   timed over consecutive 30-frame windows with the bank full (three by
   default), each printed with the median, beside the card and the host's
   CPU and load (the frame is host-bound);
4. run the first frames again through the kernel engine, holding every
   kernel call against its plain version on the same inputs, and through
   an engine with every kernel replaced by its plain version, the latter
   teacher-forced with the former's labels so both banks take the same
   writes up to the full bank; hold the logits and labels of every frame
   of the two engines against each other;
5. drive the training path: 6 steps of R50-DeAOTL pre_vost at
   465x465, 15 frames, 4 clips of seeded synthetic blobs, with the
   use_prev_pred curriculum starting inside the run. Launch counts are
   zeroed just before and read just after (per step too); every training
   kernel must launch in every step; losses finite, parameters changed;
   seconds per step (median and each) and peak memory beside the card and
   the host;
6. one step of the kernel model, every K2 call of which is held against
   its plain version on the same inputs, and one step of a model whose
   kernels are all plain, on the same batch, weights and shuffle: hold the
   loss and the global gradient norm against each other;
7. drive the opt-in inference path, with RMEM_BANK_QMINOR set for this
   phase only: R50-DeAOTL with use_pallas_dwconv (K8 in every gated tail,
   K3 for every bank-attention call), 12 objects as two id groups, four
   augs (scales 1.0 and 1.3, each plain and flipped) from seeded raw uint8
   480x854 frames resized and normalised on the card, 70 frames in chunks
   of 5 through scan_steps_multi_raw, so the bank fills at frame 40 and
   evicts. Launch counts are zeroed just before and read just after (K3
   and K8 once per call, K1 never); labels in [0, 12], finite logits,
   evictions counted on the device; frames/s over three 10-frame windows
   after the bank fills (`--profile`: one more chunk under torch.profiler).
   Then the first 12 frames again, every K3 and K8 call held against its
   plain version, and through an all-plain engine teacher-forced with the
   kernel engine's labels: logits and labels agree per frame;
8. the two serving routes on the same traffic: phase 7's engine built
   twice from one seed, with both opt-ins on (K3, K8) and with both off
   (K1, the gate multiply and PyTorch's depthwise conv); each fills its
   bank on phase 7's video, then three 10-frame windows of each, the
   routes alternating, and one chunk of each under torch.profiler:
   frames/s and the device's busy time per frame of each route.

Prints the `kernels` JSON line, then the card line, then the result line
`{"ok": true, "device": {...}}` last. Exits non-zero without a result when
no CUDA device is available or the package is not beside this script.

`--mutants` runs only a mutation check of the per-call K2 check (held_k2):
for each mutant, the package is copied into a temporary directory, one
line of csrc/bank_attention_bwd.cu is changed there (no_drec: ds drops the
slot-mass term; dq_scale: dq is not multiplied by the logit scale), the
copy's kernels are built, and held_k2 runs on phase 2's inputs (a nonzero
drec). Each mutant must fail the check and the unmutated copy pass it;
the checkout itself is never changed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
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
# K1's lse sums f32 exponentials of the same f32 logits as its plain
# version (1.9e-6 to 3.8e-6 measured on an H100)
LSE_TOL = 1e-3          # K1 with lse: max |lse - plain|
# K2's kernels round p and their outputs to bf16 and sum in f32: a few bf16
# roundings of the output's scale (each kernel 1.4e-3 to 3.8e-3, the whole
# backward against autograd up to 1.1e-2 over a training step's 45 calls,
# measured on an H100); K5 and K7 differ from their plain versions only in
# the forward (4.1e-3 and 1.1e-3 measured)
GRAD_TOL = 2e-2         # max |kernel - plain| / max |plain|
# one training step of the kernel model against one of the plain model:
# the two differ by the kernels' bf16 roundings, carried through the clip
# (1.1e-5 and 9.4e-5 measured on an H100)
STEP_LOSS_TOL = 1e-2    # |loss - plain| / |plain|
STEP_GNORM_TOL = 5e-2   # |grad norm - plain| / plain
# the training configuration: pre_vost's 465 x 465 crops (a 30 x 30 grid at
# stride 16), clips of 15 frames, 4 clips per step (the reference's batch of
# 16 over 4 GPUs)
TRAIN_HW = (465, 465)
TRAIN_GRID = (30, 30)
TRAIN_T = 15
TRAIN_B = 4
TRAIN_STEPS = 6
# phase 7, the opt-in inference path: raw 480 x 854 frames, 12 objects (two
# id groups of up to 10), scales 1.0 and 1.3 each plain and flipped, 5
# frames per chunk (one long-term write each); the bank fills at frame 40,
# then three timed windows of 10 frames
RAW_HW = (480, 854)
OPTIN_OBJECTS = 12
OPTIN_SCALES = (1.0, 1.3)
OPTIN_CHUNK = 5
OPTIN_WINDOW = 10
OPTIN_FRAMES = BANK_FULL + 3 * OPTIN_WINDOW
OPTIN_AGREE_FRAMES = 12     # held per call and against the plain engine
# phase 8: timed windows of each serving route, alternated
ROUTE_TURNS = 3
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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of fn: CUDA events around the replay of a
    CUDA graph of `reps` calls. For a kernel shorter than the host's cost
    of an eager call, where cuda_ms measures the host's issue rate."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(x):
    """The spacing of bf16 values at each |x| (8 significant bits), 0 at
    0."""
    import torch
    a = x.float().abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                       torch.zeros_like(a))


def held(name: str, got, ref):
    """Hold one kernel call's result against its plain version's on the
    same inputs. Returns (max |out - plain|, max |plain|, and for K1 and
    K3 max |slot mass - plain|, else None)."""
    import torch
    mass_err = None
    if name in ("bank_attention", "bank_attention_qminor"):
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
    elif name == "gated_dwconv":
        # the same roundings in the same order: within one bf16 ulp of each
        # value (0 where the value is 0)
        ok = bool(torch.all(diff <= bf16_ulp(ref)))
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


def check_optin_kernels(dev):
    """Phase 2, the opt-in inference kernels at the main path's shapes in
    bf16: K3 (the slot-split bank attention; Lq = Lk = 1674, 9 valid slots
    of 10, dh 128, dv 1024) against its plain version, timed beside K1 on
    the same inputs with no bias, and K8 (the gated depthwise conv,
    [1, 1674, 1024] on the 31 x 54 grid).
    Returns {name: entry} without launch counts."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import dwconv as kd
    from rmem_tpu_torch.ops.layers import seq_to_map

    g = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    entries = {}
    h, w = (IN_HW[0] - 1) // 16 + 1, (IN_HW[1] - 1) // 16 + 1     # 31 x 54
    hw, dh, dv, S, count = h * w, 128, 1024, 10, 9
    scale = dh ** -0.5

    # ---- K3: 9 of 10 slots valid, the slot PE already in the keys ----
    q = randn(1, hw, dh, scale=2.0)
    bk, bvv = randn(S, 1, hw, dh), randn(S, 1, hw, dv)
    cnt = torch.tensor(count, dtype=torch.int32, device=dev)
    args = (q, bk, bvv, cnt, 1, scale)
    ref = kb.bank_attention_qminor_plain(*args)
    out, rec = kb.bank_attention_qminor(*args)
    errs = [held("bank_attention_qminor", (out, rec), ref)]
    check(bool(torch.all(rec[..., count:] == 0)), "K3 mass of empty slots")
    k3_ms = cuda_ms(lambda: kb.bank_attention_qminor(*args), 20)
    # the reference frame's call: one slot
    one = torch.ones((), dtype=torch.int32, device=dev)
    o1, r1 = kb.bank_attention_qminor(q, bk[:1], bvv[:1], one, 1, scale)
    errs.append(held("bank_attention_qminor", (o1, r1),
                     kb.bank_attention_qminor_plain(q, bk[:1], bvv[:1], one,
                                                    1, scale)))
    check(torch.allclose(r1, torch.ones_like(r1), atol=1e-4), "K3 S=1 mass")
    err = max(e for e, _, _ in errs)
    rerr = max(m for _, _, m in errs)
    k1_ms = cuda_ms(lambda: kb.bank_attention_infer(*args), 20)
    print(f"K3 bank_attention_qminor: max|out-plain| {err:.3e} (max|plain| "
          f"{errs[0][1]:.3e}), max|rec-plain| {rerr:.3e}; {k3_ms:.3f} ms "
          f"at {kb.SLOTS_PER_BLOCK} slots per block; K1 on the same inputs, "
          f"no bias, {k1_ms:.3f} ms; partial scratch "
          f"{-(-S // kb.SLOTS_PER_BLOCK) * hw * dv * 4 / 1e6:.1f} MB")
    kv = count * hw
    k_lib = bk[:count].reshape(1, 1, kv, dh)
    v_lib = bvv[:count].reshape(1, 1, kv, dv)
    b_ms, b_by = bound(2.0 * hw * kv * (dh + dv),
                       (q.numel() + kv * (dh + dv) + hw * dv) * 2
                       + hw * S * 4)
    entries["bank_attention_qminor"] = dict(
        name="bank_attention_qminor", route="cuda",
        source="rmem_tpu_torch/csrc/bank_attention_qminor.cu",
        replaces="rmem_tpu/kernels/bank_attention.py:540",
        max_abs_err=err, max_abs_err_rec=rerr,
        ms=k3_ms,
        plain_ms=cuda_ms(lambda: kb.bank_attention_qminor_plain(*args), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k_lib, v_lib, scale=scale), 20),
        k1_same_inputs_ms=k1_ms)

    # ---- K8: the gated tail's product and 5 x 5 depthwise conv ----
    c = 1024
    x, gate = randn(1, hw, c), randn(1, hw, c)
    wt = randn(c, 1, 5, 5, scale=0.2)
    dargs = (x, gate, wt, (h, w))
    out = kd.gated_dwconv(*dargs)
    ref = kd.gated_dwconv_plain(*dargs)
    err, top, _ = held("gated_dwconv", out, ref)
    print(f"K8 gated_dwconv: max|out-plain| {err:.3e} (max|plain| "
          f"{top:.3e}), {int((out != ref).sum())} of {out.numel()} values "
          "differ")
    # the default tail's conv on the pre-gated map (the multiply not
    # counted), channels last as the tail holds it
    xg_map = seq_to_map(x * gate, (h, w))
    # K8 takes less device time than an eager call takes the host, so its
    # times are those of a CUDA graph of 48 calls (the eager ones beside).
    # The graph cycles through 12 input sets, 83 MB of x and gate, more
    # than the 50 MB L2, so each call reads its inputs from HBM as the
    # bound counts them
    sets = [(randn(1, hw, c), randn(1, hw, c)) for _ in range(12)]
    maps = [seq_to_map(a * b, (h, w)) for a, b in sets]
    turn = itertools.count()

    def k8_call():
        a, b = sets[next(turn) % len(sets)]
        return kd.gated_dwconv(a, b, wt, (h, w))

    def conv_call():
        return F.conv2d(maps[next(turn) % len(maps)], wt, padding=2,
                        groups=c)

    b_ms, b_by = bound(2.0 * 25 * hw * c, 3 * hw * c * 2 + wt.numel() * 2)
    entries["gated_dwconv"] = dict(
        name="gated_dwconv", route="cuda",
        source="rmem_tpu_torch/csrc/gated_dwconv.cu",
        replaces="rmem_tpu/kernels/dwconv.py:51", max_abs_err=err,
        ms=graph_ms(k8_call, 48),
        plain_ms=graph_ms(lambda: kd.gated_dwconv_plain(*dargs), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(conv_call, 48),
        l2_resident_ms=graph_ms(lambda: kd.gated_dwconv(*dargs), 48),
        eager_ms=cuda_ms(lambda: kd.gated_dwconv(*dargs), 50),
        library_eager_ms=cuda_ms(lambda: F.conv2d(xg_map, wt, padding=2,
                                                  groups=c), 50))
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in f32."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def held_k2(q, bank_k, bank_v, count, dout, drec, scale):
    """K2 on one call's inputs: the forward (K1 with lse) and each of the
    three backward kernels against its plain version on the same inputs,
    and the whole backward against autograd of the plain forward. Returns
    {check: max |kernel - plain| / max |plain|}, failing the run past
    GRAD_TOL (K1's outputs past OUT_TOL, lse past LSE_TOL absolute)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    n = int(count)
    lk = bank_k.shape[2]
    out, rec, lse = kb.bank_attention_lse(q, bank_k, bank_v, count, scale)
    ref_out, ref_rec = kb.bank_attention_plain(q.float(), bank_k, bank_v,
                                               count, 1, scale)
    logits = torch.einsum("bqd,sbkd->bqsk", q.float(), bank_k[:n].float())
    ref_lse = (logits * scale).reshape(q.shape[0], q.shape[1], -1)
    ref_lse = ref_lse.logsumexp(-1)
    errs = {"out": rel_err(out, ref_out),
            "rec": (rec - ref_rec).abs().max().item(),
            "lse": (lse - ref_lse).abs().max().item()}
    delta = kb.bwd_delta(dout, out, drec, rec)
    p, ds = kb.bank_attention_bwd_ds(q, bank_k, bank_v, count, dout, lse,
                                     delta, drec, scale)
    rp, rds = kb.bank_attention_bwd_ds_plain(q, bank_k, bank_v, count, dout,
                                             lse, delta, drec, scale)
    ds32 = ds.float().sum(0)          # the hi + lo pair
    errs["p"] = rel_err(p[:, :n, :, :lk], rp[:, :n])
    errs["ds"] = rel_err(ds32[:, :n, :, :lk], rds[:, :n])
    dq = kb.bank_attention_bwd_dq(bank_k, ds, count, scale)
    errs["dq"] = rel_err(dq, kb.bank_attention_bwd_dq_plain(
        ds32[:, :n, :, :lk], bank_k[:n], scale))
    dk, dv = kb.bank_attention_bwd_dkv(q, dout, p, ds, count, scale, lk)
    rdk, rdv = kb.bank_attention_bwd_dkv_plain(p[:, :n, :, :lk],
                                               ds32[:, :n, :, :lk], q, dout,
                                               scale)
    errs["dk"] = rel_err(dk[:n], rdk)
    errs["dv"] = rel_err(dv[:n], rdv)
    check(bool((dk[n:] == 0).all() and (dv[n:] == 0).all()),
          "K2 gradients of invalid slots are not 0")
    gq, gk, gv = kb.bank_attention_bwd_plain(q, bank_k, bank_v, count, dout,
                                             drec, scale)
    errs["whole_dq"] = rel_err(dq, gq)
    errs["whole_dk"] = rel_err(dk, gk)
    errs["whole_dv"] = rel_err(dv, gv)
    for key, err in errs.items():
        tol = {"out": OUT_TOL, "rec": MASS_TOL, "lse": LSE_TOL}.get(key,
                                                                    GRAD_TOL)
        check(err <= tol, f"K1 lse / K2 {key}: {err} (tolerance {tol})")
    return errs


def k2_inputs(dev):
    """K2's phase-2 inputs at the training shapes (B 4, a 30 x 30 grid, 4
    valid slots of 10, dh 128, dv 1024, bf16) with a nonzero drec. Returns
    (the generator, (q, bank_k, bank_v, count, dout, drec, scale))."""
    import torch
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    b, hw, dh, dv, S = TRAIN_B, TRAIN_GRID[0] * TRAIN_GRID[1], 128, 1024, 10
    q = randn(b, hw, dh, scale=2.0)
    bk, bvv = randn(S, b, hw, dh), randn(S, b, hw, dv)
    cnt = torch.tensor(4, dtype=torch.int32, device=dev)
    dout = randn(b, hw, dv, scale=0.1)
    drec = randn(b, hw, S, dtype=torch.float32)
    return g, (q, bk, bvv, cnt, dout, drec, dh ** -0.5)


def check_train_kernels(dev):
    """Phase 2, training rows: K1 with lse and the three K2 kernels at the
    training shapes (B 4, a 30 x 30 grid, 4 valid slots of 10), K5 and K7
    (kernel forward, plain backward) against plain forward and backward.
    Returns ({name: entry} without launch counts, whole-K2 timings)."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.ops.attention import NEG_INF, _local_offset_map_on

    bf = torch.bfloat16
    g, (q, bk, bvv, cnt, dout, drec, scale) = k2_inputs(dev)

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    b, (h, w) = TRAIN_B, TRAIN_GRID
    (S, _, hw, dh), dv, count = bk.shape, bvv.shape[-1], int(cnt)
    errs = held_k2(q, bk, bvv, cnt, dout, drec, scale)
    print("K1 lse + K2 at the training shapes, max|kernel - plain| / "
          "max|plain| (rec, lse absolute): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    entries = {}
    kv = count * hw
    lkp = (hw + 63) // 64 * 64
    out, rec, lse = kb.bank_attention_lse(q, bk, bvv, cnt, scale)
    delta = kb.bwd_delta(dout, out, drec, rec)
    p, ds = kb.bank_attention_bwd_ds(q, bk, bvv, cnt, dout, lse, delta, drec,
                                     scale)
    ds32 = ds.float().sum(0)
    # bytes: inputs read once (valid slots only), outputs written once
    qb, kb_, vb = b * hw * dh * 2, kv * b * dh * 2, kv * b * dv * 2
    ob, sb = b * hw * dv * 2, b * hw * 4
    pb = b * count * hw * lkp * 2
    # the library's attention, no slot mass: over the valid slots only (the
    # kernels' work), and over all S slots with the invalid ones masked by
    # an additive mask (2.5x the keys at 4 of 10)
    def lib_kv(slots):
        return [t[:slots].permute(1, 0, 2, 3).reshape(b, 1, slots * hw, -1)
                .contiguous() for t in (bk, bvv)]

    lib_valid = lib_kv(count)
    lib_all = lib_kv(S)
    mask = torch.zeros((b, 1, hw, S * hw), dtype=bf, device=dev)
    mask[..., kv:] = float("-inf")
    rows = {
        "bank_attention_lse": dict(
            replaces="rmem_tpu/kernels/bank_attention.py:687",
            source="rmem_tpu_torch/csrc/bank_attention.cu",
            fn=lambda: kb.bank_attention_lse(q, bk, bvv, cnt, scale),
            plain=lambda: kb.bank_attention_plain(q, bk, bvv, cnt, 1, scale),
            flops=2.0 * b * hw * kv * (dh + dv),
            nbytes=qb + kb_ + vb + 2 * ob + b * hw * S * 4 + sb,   # f32 out
            err=max(errs["out"], errs["lse"]),
            library=lambda: F.scaled_dot_product_attention(
                q[:, None], *lib_valid, scale=scale)),
        "bank_attention_bwd_ds": dict(
            replaces="rmem_tpu/kernels/bank_attention.py:581",
            source="rmem_tpu_torch/csrc/bank_attention_bwd.cu",
            fn=lambda: kb.bank_attention_bwd_ds(q, bk, bvv, cnt, dout, lse,
                                                delta, drec, scale),
            plain=lambda: kb.bank_attention_bwd_ds_plain(
                q, bk, bvv, cnt, dout, lse, delta, drec, scale),
            flops=2.0 * b * hw * kv * (dh + dv),
            nbytes=qb + kb_ + vb + ob + 2 * sb + b * hw * S * 4 + 3 * pb,
            err=max(errs["p"], errs["ds"]), library=None),
        "bank_attention_bwd_dq": dict(
            replaces="rmem_tpu/kernels/bank_attention.py:113",
            source="rmem_tpu_torch/csrc/bank_attention_bwd.cu",
            fn=lambda: kb.bank_attention_bwd_dq(bk, ds, cnt, scale),
            plain=lambda: kb.bank_attention_bwd_dq_plain(
                ds32[:, :count, :, :hw], bk[:count], scale),
            flops=2 * 2.0 * b * hw * kv * dh, nbytes=2 * pb + kb_ + qb,
            err=errs["dq"],
            library=lambda: torch.einsum("xbsqk,sbkd->bqd",
                                         ds[:, :, :count, :, :hw],
                                         bk[:count])),
        "bank_attention_bwd_dkv": dict(
            replaces="rmem_tpu/kernels/bank_attention.py:155",
            source="rmem_tpu_torch/csrc/bank_attention_bwd.cu",
            fn=lambda: kb.bank_attention_bwd_dkv(q, dout, p, ds, cnt, scale,
                                                 hw),
            plain=lambda: kb.bank_attention_bwd_dkv_plain(
                p[:, :count, :, :hw], ds32[:, :count, :, :hw], q, dout,
                scale),
            flops=2.0 * b * hw * kv * (2 * dh + dv),
            nbytes=3 * pb + qb + ob + S * b * hw * (dh + dv) * 2,
            err=max(errs["dk"], errs["dv"]), library=None),
    }
    for name, r in rows.items():
        b_ms, b_by = bound(r["flops"], r["nbytes"])
        entries[name] = dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], max_abs_err=r["err"],
            ms=cuda_ms(r["fn"], 20), plain_ms=cuda_ms(r["plain"], 3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=(None if r["library"] is None
                        else cuda_ms(r["library"], 10)))

    entries["bank_attention_lse"]["library_masked_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q[:, None], *lib_all,
                                               attn_mask=mask, scale=scale),
        10)

    # the whole K2 backward against autograd of the plain forward and the
    # library's attention backward (no slot mass), its forward + backward
    # less its forward
    k2 = lambda: kb.bank_attention_bwd(q, bk, bvv, cnt, out, rec, lse, dout,
                                       drec, scale)

    def sdpa_bwd_ms(kv_lib, attn_mask):
        ins = [t.detach().requires_grad_() for t in (q[:, None], *kv_lib)]

        def run(backward: bool):
            o = F.scaled_dot_product_attention(*ins, attn_mask=attn_mask,
                                               scale=scale)
            if backward:
                torch.autograd.grad(o, ins, dout[:, None])

        return cuda_ms(lambda: run(True), 10) - cuda_ms(lambda: run(False),
                                                        10)

    whole = dict(
        ms=cuda_ms(k2, 10),
        plain_ms=cuda_ms(lambda: kb.bank_attention_bwd_plain(
            q, bk, bvv, cnt, dout, drec, scale), 3),
        library_bwd_ms=sdpa_bwd_ms(lib_valid, None),
        library_bwd_masked_ms=sdpa_bwd_ms(lib_all, mask),
        # S.T recomputed (dh) and g = dout.v^T (dv) once each, then dq and
        # dk (dh each) and dv (dv): 3 dh + 2 dv per query, valid key and
        # batch element; reads q, k, v, dout, out (f32), lse, drec, rec;
        # writes dq, dk, dv
        bound_ms=bound(2.0 * b * hw * kv * (3 * dh + 2 * dv),
                       2 * qb + kb_ + vb + 3 * ob + sb + 2 * b * hw * S * 4
                       + S * b * hw * (dh + dv) * 2)[0],
        held=errs)
    print(f"K2 whole backward: {whole['ms']:.3f} ms (plain autograd "
          f"{whole['plain_ms']:.3f} ms, library attention backward over the "
          f"{count} valid slots {whole['library_bwd_ms']:.3f} ms, over all "
          f"{S} with a mask {whole['library_bwd_masked_ms']:.3f} ms, bound "
          f"{whole['bound_ms']:.3f} ms)")

    # ---- K5: local attention forward kernel + plain backward ----
    lq_ = randn(b, hw, dh, scale=2.0)
    lk_ = randn(b, hw, dh)
    lv = randn(b, hw, dv)
    rel = randn(b, hw, 225)
    gl = randn(b, hw, dv, scale=0.1)
    largs = ((h, w), 1, 7, scale)

    def fwd_bwd(fn):
        ins = [t.detach().requires_grad_() for t in (lq_, lk_, lv, rel)]
        o = fn(*ins, *largs)
        return (o, *torch.autograd.grad(o, ins, gl))

    got, ref = fwd_bwd(kl.local_attention_trainable), fwd_bwd(
        kl.local_attention_plain)
    lerr = max(rel_err(a, r) for a, r in zip(got, ref))
    check(lerr <= GRAD_TOL, f"K5 output and gradients {lerr}")
    print(f"K5 local_attention_trainable (fwd + bwd): max rel err {lerr:.3e}")
    omap = _local_offset_map_on(h, w, 7, dev)
    keys = (omap < 225).sum().item()
    relp = torch.cat([rel, torch.full((b, hw, 1), NEG_INF, dtype=bf,
                                      device=dev)], dim=2)
    dense_bias = torch.gather(relp, 2, omap.expand(b, hw, hw))[:, None]
    lib_ins = [t.detach().requires_grad_() for t in (lq_, lk_, lv)]

    def lib_local():
        o = F.scaled_dot_product_attention(
            lib_ins[0][:, None], lib_ins[1][:, None], lib_ins[2][:, None],
            attn_mask=dense_bias, scale=scale)
        torch.autograd.grad(o, lib_ins, gl[:, None])

    # forward: q, k, v, rel read, out written; backward: the same plus the
    # cotangent read and four gradients written
    l_bytes = 2 * (2 * b * hw * dh + 2 * b * hw * dv + b * hw * 225) * 2
    b_ms, b_by = bound(3 * 2.0 * b * keys * (dh + dv), l_bytes)
    entries["local_attention_trainable"] = dict(
        name="local_attention_trainable", route="cuda",
        source="rmem_tpu_torch/csrc/local_attention.cu",
        replaces="rmem_tpu/kernels/local_attention.py:237", max_abs_err=lerr,
        ms=cuda_ms(lambda: fwd_bwd(kl.local_attention_trainable), 5),
        plain_ms=cuda_ms(lambda: fwd_bwd(kl.local_attention_plain), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_local, 5))

    # ---- K7: stem forward kernel + plain backward over B*T frames ----
    x = torch.rand((TRAIN_B * TRAIN_T, *TRAIN_HW, 3), generator=g,
                   device=dev)
    wt = randn(64, 3, 7, 7, dtype=torch.float32, scale=0.2)
    sc = 1.0 + randn(64, dtype=torch.float32, scale=0.1)
    bi = randn(64, dtype=torch.float32, scale=0.1)
    sout = ks.stem_trainable(x, wt, sc, bi)
    gs = torch.randn(sout.shape, generator=g, device=dev).to(bf)

    def stem_fwd_bwd(fn):
        ins = [t.detach().requires_grad_() for t in (wt, sc, bi)]
        o = fn(x, *ins) if fn is ks.stem_trainable else fn(
            x, *(t.to(bf) for t in ins))
        return (o, *torch.autograd.grad(o, ins, gs))

    got, ref = stem_fwd_bwd(ks.stem_trainable), stem_fwd_bwd(ks.stem_plain)
    held("stem", got[0], ref[0])
    serr = max(rel_err(a, r) for a, r in zip(got[1:], ref[1:]))
    check(serr <= GRAD_TOL, f"K7 gradients {serr}")
    print(f"K7 stem_trainable (fwd + bwd) over {x.shape[0]} frames: max rel "
          f"err of the gradients {serr:.3e}")
    ho, wo = (TRAIN_HW[0] - 1) // 2 + 1, (TRAIN_HW[1] - 1) // 2 + 1
    # the forward conv and dW; the image takes no gradient, so no dx
    s_flops = 2 * 2.0 * 147 * 64 * ho * wo * x.shape[0]
    s_bytes = x.numel() * 4 + 2 * sout.numel() * 2 + wt.numel() * 2 * 2
    b_ms, b_by = bound(s_flops, s_bytes)
    entries["stem_trainable"] = dict(
        name="stem_trainable", route="cuda",
        source="rmem_tpu_torch/csrc/stem.cu",
        replaces="rmem_tpu/kernels/stem.py:210", max_abs_err=serr,
        ms=cuda_ms(lambda: stem_fwd_bwd(ks.stem_trainable), 3),
        plain_ms=cuda_ms(lambda: stem_fwd_bwd(ks.stem_plain), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries, whole


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


def device_busy_ms(fn, n: int, table: bool = False) -> float:
    """Run fn (n units of work) under torch.profiler; return the device's
    busy time per unit in ms, the sum of its kernels' times. With `table`,
    print the kernel table."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    events = p.key_averages()
    if table:
        print(events.table(sort_by="cuda_time_total", row_limit=25,
                           max_name_column_width=60))
    # kernels only: an operator's row repeats its kernels' device time
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / (1e3 * n)


def device_busy_table(fn, n: int, wall_ms: float, per: str) -> None:
    """Print fn's kernel table under torch.profiler and the device's busy
    time per unit against the unprofiled wall time per unit, whose
    difference is the device's idle share."""
    busy_ms = device_busy_ms(fn, n, table=True)
    print(f"profile: device busy {busy_ms:.3f} ms {per}; against the "
          f"unprofiled {wall_ms:.3f} ms {per} the device idles "
          f"{100 * (1 - busy_ms / wall_ms):.1f} %")


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
        def five_frames():
            for t in range(5):
                engine.step(state, imgs[t], OUT_HW)
        device_busy_table(five_frames, 5, 1e3 / fps, "per frame")
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


def optin_config(fused_dw: bool = True):
    """R50-DeAOTL pre_vost with the gated tails through K8 (unless
    `fused_dw` is off) and phase 7's augs; K3 is chosen by
    RMEM_BANK_QMINOR, set around phases 7 and 8 only."""
    from rmem_tpu_torch.config import get_config
    return get_config("pre_vost", model="r50_deaotl",
                      use_pallas_dwconv=fused_dw,
                      test_multiscale=OPTIN_SCALES, test_flip=True)


def optin_inputs():
    """Seeded raw uint8 RGB frames at RAW_HW on the host (the reference
    frame first) and a first-frame mask of OPTIN_OBJECTS vertical stripes."""
    import numpy as np
    rng = np.random.RandomState(7)
    raw = rng.randint(0, 256, (OPTIN_FRAMES + 1, *RAW_HW, 3), dtype=np.uint8)
    mask = np.zeros(RAW_HW, np.int32)
    for i in range(OPTIN_OBJECTS):
        mask[40:440, 10 + 70 * i:60 + 70 * i] = i + 1
    return raw, mask


def optin_engine(dev, cfg):
    """The engine of phase 7 and its augs, as the evaluator builds them
    from the config: (scale, flip) for each scale and, with test_flip,
    both flips; each aug's input size by restrict_size."""
    from rmem_tpu_torch.data.transforms import restrict_size
    from rmem_tpu_torch.engine import InferenceEngine
    from rmem_tpu_torch.models import build_vos_model, init_params
    model = init_params(build_vos_model(cfg.model_vos, cfg), seed=0)
    engine = InferenceEngine(model, cfg, device=dev)
    augs = [(sc, flip) for sc in cfg.test_multiscale
            for flip in ((False, True) if cfg.test_flip else (False,))]
    in_hws = [restrict_size(*RAW_HW, cfg.test_max_size, cfg.test_min_size,
                            sc, cfg.model_align_corners) for sc, _ in augs]
    return engine, augs, in_hws


def optin_reference(engine, cfg, raw0, mask, augs, in_hws):
    """Each aug's state after the first frame: the frame prepared on the
    device, the mask flipped at full size, nearest-resized and split into
    the id groups, each group told its true object count."""
    import torch

    from rmem_tpu_torch.engine.inference import separate_mask
    from rmem_tpu_torch.ops.resize import resize_nearest
    m = cfg.model_max_obj_num
    groups = -(-OPTIN_OBJECTS // m)
    obj_nums = [min(m, OPTIN_OBJECTS - g * m) for g in range(groups)]
    full = torch.from_numpy(mask).to(engine.device)
    states = []
    for (_, flip), in_hw in zip(augs, in_hws):
        lab = resize_nearest((full.flip(1) if flip else full)[None, ..., None],
                             in_hw)[..., 0]
        st, _ = engine.add_reference(
            engine.prep(raw0[None], in_hw, flip)[0],
            separate_mask(lab, groups, m), obj_nums,
            gap=cfg.test_long_term_mem_gap)
        states.append(st)
    return states


def optin_path(dev, card: str, profile: bool):
    """Phase 7: the opt-in inference path at full width. R50-DeAOTL with
    K8 in every gated tail and K3 for every bank-attention call, 12 objects
    as two id groups, four augs (scales 1.0 and 1.3, each plain and
    flipped) from raw uint8 480x854 frames resized and normalised on the
    card, OPTIN_CHUNK frames per scan_steps_multi_raw call (one long-term
    write each), so the bank fills at frame 40 and then evicts. Launch
    counts are zeroed just before the reference frame and read just after
    the last chunk. With `profile`, one more chunk runs under
    torch.profiler. Returns (launch counts, per-window frames/s)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import dwconv as kd
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks

    torch.cuda.reset_peak_memory_stats()
    cfg = optin_config()
    raw, mask = optin_inputs()
    engine, augs, in_hws = optin_engine(dev, cfg)
    check(engine.route == dict(qminor=True, fused_dw=True),
          f"phase 7 routes {engine.route}")
    flips = [f for _, f in augs]
    wrappers = (kb.bank_attention_qminor, kd.gated_dwconv, kl.local_attention,
                ks.stem, kb.bank_attention_infer)
    for fn in wrappers:
        fn.launches = 0
    states = optin_reference(engine, cfg, raw[0], mask, augs, in_hws)
    slots = cfg.former_mem_len + cfg.latter_mem_len
    evictions = torch.zeros((), dtype=torch.int32, device=dev)
    host = host_line()
    chunks = OPTIN_FRAMES // OPTIN_CHUNK
    first = BANK_FULL // OPTIN_CHUNK            # the first chunk after
    per_window = OPTIN_WINDOW // OPTIN_CHUNK
    marks, labels = [], []
    for c in range(chunks):
        if c >= first and (c - first) % per_window == 0:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        was_full = states[0].bank.count >= slots
        last = states[0].last_mem_step.clone()
        t0 = 1 + c * OPTIN_CHUNK
        states, lab = engine.scan_steps_multi_raw(
            states, raw[t0:t0 + OPTIN_CHUNK], in_hws, RAW_HW, flips)
        # a long-term write into a full bank evicts
        evictions += was_full & (states[0].last_mem_step != last)
        labels.append(lab)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    counts = {fn.__name__: fn.launches for fn in wrappers}
    window_fps = [OPTIN_WINDOW / (b - a) for a, b in zip(marks, marks[1:])]
    labels = torch.cat(labels)
    evictions = int(evictions)
    steps = len(augs) * (1 + OPTIN_FRAMES)          # reference included
    layers = cfg.model_lstt_num
    scheduled = OPTIN_FRAMES // cfg.test_long_term_mem_gap - (slots - 1)
    hist = torch.bincount(labels[-1].flatten().long(),
                          minlength=OPTIN_OBJECTS + 1).tolist()
    print(f"phase 7: {OPTIN_FRAMES} frames x {len(augs)} augs {augs} at "
          f"inputs {in_hws}, {OPTIN_OBJECTS} objects in "
          f"{states[0].short_k.shape[1]} id groups; launches {counts}; bank "
          f"count {int(states[0].bank.count)}, {evictions} evictions counted "
          f"on the device ({scheduled} scheduled); labels in "
          f"[{int(labels.min())}, {int(labels.max())}]; label histogram of "
          f"the last frame {hist}")
    check(counts["bank_attention_qminor"] == layers * steps,
          f"K3 launches {counts['bank_attention_qminor']}, "
          f"{layers * steps} bank-attention calls")
    check(counts["gated_dwconv"] == 3 * layers * steps,
          f"K8 launches {counts['gated_dwconv']}, {3 * layers * steps} "
          "gated tails")
    check(counts["local_attention"] > 0 and counts["stem"] > 0,
          f"K4 or K6 never ran: {counts}")
    check(counts["bank_attention_infer"] == 0, "K1 ran on the K3 path")
    check(all(int(st.bank.count) == slots for st in states), "bank not full")
    check(evictions >= 1 and evictions == scheduled,
          f"{evictions} evictions, {scheduled} scheduled")
    check(labels.shape == (OPTIN_FRAMES, *RAW_HW),
          f"labels {tuple(labels.shape)}")
    check(int(labels.max()) <= OPTIN_OBJECTS, "labels out of [0, 12]")
    check(all(bool(torch.isfinite(st.logits4x).all()) for st in states),
          "non-finite logits")
    print(f"phase 7: {statistics.median(window_fps):.3f} frames/s of the "
          f"{len(augs)}-aug step, median of {len(window_fps)} windows of "
          f"{OPTIN_WINDOW} frames after the bank fills ("
          + ", ".join(f"{x:.3f}" for x in window_fps)
          + f"), raw uint8 {RAW_HW[0]}x{RAW_HW[1]} in and out, on {card}; "
          f"host {host}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        def one_chunk():
            engine.scan_steps_multi_raw(states, raw[1:1 + OPTIN_CHUNK],
                                        in_hws, RAW_HW, flips)
        device_busy_table(one_chunk, OPTIN_CHUNK,
                          1e3 / statistics.median(window_fps), "per frame")
    return counts, window_fps


def optin_agreement(dev):
    """Phase 7, held: the first OPTIN_AGREE_FRAMES frames of phase 7's
    video through the kernel engine, each of whose K3 and K8 calls is held
    against its plain version on the same inputs, and through an engine
    whose kernels are all their plain versions, teacher-forced with the
    kernel engine's labels: hold each frame's logits (every aug, over the
    id channels the object counts leave unmasked) and labels of the two
    engines against each other. Returns (per-kernel worst call, per-frame
    relative logit error, per-frame label agreement)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import dwconv as kd
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks

    held_kernels = (
        ("bank_attention_qminor", kb, kb.bank_attention_qminor_plain),
        ("gated_dwconv", kd, kd.gated_dwconv_plain))
    plain_only = ((kl, "local_attention", kl.local_attention_plain),
                  (ks, "stem", ks.stem_plain))
    calls = {name: [] for name, *_ in held_kernels}

    def on_path(name, kernel, plain_fn):
        def call(*args, **kwargs):
            got = kernel(*args, **kwargs)
            calls[name].append(held(name, got, plain_fn(*args, **kwargs)))
            return got
        call.launches = 0
        return call

    cfg = optin_config()
    raw, mask = optin_inputs()
    runs = []
    for plain in (False, True):
        with ExitStack() as stack:
            for name, mod, plain_fn in held_kernels:
                fn = (plain_fn if plain
                      else on_path(name, getattr(mod, name), plain_fn))
                stack.enter_context(mock.patch.object(mod, name, fn))
            if plain:
                for mod, attr, plain_fn in plain_only:
                    stack.enter_context(mock.patch.object(mod, attr,
                                                          plain_fn))
            engine, augs, in_hws = optin_engine(dev, cfg)
            flips = [f for _, f in augs]
            states = optin_reference(engine, cfg, raw[0], mask, augs, in_hws)
            labels, logits = [], []
            for t in range(1, 1 + OPTIN_AGREE_FRAMES):
                if not plain:
                    states, lab = engine.scan_steps_multi_raw(
                        states, raw[t:t + 1], in_hws, RAW_HW, flips)
                    labels.append(lab[0].to(torch.int32))
                    logits.append([st.logits4x.float() for st in states])
                    continue
                with torch.inference_mode():
                    logits4s = [engine.propagate(st, engine.prep(
                        raw[t:t + 1], in_hw, flip)[0])[1]
                        for st, in_hw, flip in zip(states, in_hws, flips)]
                    labels.append(engine.aug_label(logits4s, RAW_HW, flips))
                    logits.append([x.float() for x in logits4s])
                    forced = runs[0][0][t - 1]
                    states = [engine.write_label(st, forced, in_hw, flip)
                              for st, in_hw, flip in zip(states, in_hws,
                                                         flips)]
            runs.append((labels, logits))
            del engine, states
            torch.cuda.empty_cache()
    worst = {}
    for name, errs in calls.items():
        worst[name] = dict(calls=len(errs),
                           rel_err=max(e / top for e, top, _ in errs))
        if name == "bank_attention_qminor":
            worst[name]["slot_mass_err"] = max(m for *_, m in errs)
    agree = [(a == b).float().mean().item()
             for a, b in zip(runs[0][0], runs[1][0])]
    logit_errs = []
    for got_augs, ref_augs in zip(runs[0][1], runs[1][1]):
        err = top = 0.0
        for got, ref in zip(got_augs, ref_augs):
            # the masked id channels hold the same -1e10 on both sides
            live = ref > -1e9
            err = max(err, (got - ref).abs()[live].max().item())
            top = max(top, ref.abs()[live].max().item())
        logit_errs.append(err / top)
    print(f"phase 7, every K3 and K8 call of the first "
          f"{OPTIN_AGREE_FRAMES} frames against its plain version: {worst}")
    print("phase 7, kernel vs plain engine, max|logits diff| / max|plain "
          "logits| per frame (unmasked channels, all augs): "
          + ", ".join(f"{e:.3e}" for e in logit_errs))
    print("phase 7, kernel vs plain engine, label agreement per frame: "
          + ", ".join(f"{a:.5f}" for a in agree))
    layers = cfg.model_lstt_num
    steps = len(augs) * (1 + OPTIN_AGREE_FRAMES)
    check(worst["bank_attention_qminor"]["calls"] == layers * steps
          and worst["gated_dwconv"]["calls"] == 3 * layers * steps,
          f"calls {worst}")
    check(max(logit_errs) <= LOGIT_TOL, f"phase 7 logits {max(logit_errs)}")
    check(min(agree) >= AGREE_FLOOR, f"phase 7 label agreement {min(agree)}")
    return worst, logit_errs, agree


TRAIN_KERNELS = (("bank_attention", "bank_attention_lse"),
                 ("bank_attention", "bank_attention_bwd_ds"),
                 ("bank_attention", "bank_attention_bwd_dq"),
                 ("bank_attention", "bank_attention_bwd_dkv"),
                 ("local_attention", "local_attention"),
                 ("stem", "stem"))


def route_turns(dev, card: str):
    """Phase 8: the two serving routes on the same traffic. Phase 7's
    engine is built twice from the same seed, once with both opt-ins on
    (K3 for bank attention, K8 in the gated tails) and once with both off
    (K1 with the factored slot-PE bias, the gate multiply and PyTorch's
    depthwise conv), and each takes phase 7's video: the reference frame,
    then BANK_FULL frames to fill its bank. Then ROUTE_TURNS windows of
    OPTIN_WINDOW frames each alternate between the routes (on, off, off,
    on, ...), each route taking the same frames, and one more chunk of
    each runs under torch.profiler for the device's busy time. Returns
    {route: {"fps": per-window frames/s, "busy_ms": per frame}}."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import dwconv as kd

    raw, mask = optin_inputs()
    wrappers = (kb.bank_attention_qminor, kd.gated_dwconv,
                kb.bank_attention_infer)
    # route: (environment, fused_dw, kernels that must run, must not run)
    spec = {"on": ({"RMEM_BANK_QMINOR": "1"}, True,
                   ("bank_attention_qminor", "gated_dwconv"),
                   ("bank_attention_infer",)),
            "off": ({}, False, ("bank_attention_infer",),
                    ("bank_attention_qminor", "gated_dwconv"))}
    routes = {}
    for name, (env, fused_dw, _, _) in spec.items():
        cfg = optin_config(fused_dw)
        with mock.patch.dict(os.environ, env):
            if not env:
                os.environ.pop("RMEM_BANK_QMINOR", None)
            engine, augs, in_hws = optin_engine(dev, cfg)
        check(engine.route == dict(qminor=fused_dw, fused_dw=fused_dw),
              f"phase 8 {name} routes {engine.route}")
        states = optin_reference(engine, cfg, raw[0], mask, augs, in_hws)
        flips = [f for _, f in augs]
        for t0 in range(1, 1 + BANK_FULL, OPTIN_CHUNK):
            states, _ = engine.scan_steps_multi_raw(
                states, raw[t0:t0 + OPTIN_CHUNK], in_hws, RAW_HW, flips)
        routes[name] = dict(engine=engine, states=states, in_hws=in_hws,
                            flips=flips, fps=[], labels=[])
    for i in range(ROUTE_TURNS):
        t_first = 1 + BANK_FULL + i * OPTIN_WINDOW
        for name in (("on", "off") if i % 2 == 0 else ("off", "on")):
            r = routes[name]
            before = {fn.__name__: fn.launches for fn in wrappers}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(t_first, t_first + OPTIN_WINDOW, OPTIN_CHUNK):
                r["states"], lab = r["engine"].scan_steps_multi_raw(
                    r["states"], raw[t:t + OPTIN_CHUNK], r["in_hws"], RAW_HW,
                    r["flips"])
                r["labels"].append(lab)
            torch.cuda.synchronize()
            r["fps"].append(OPTIN_WINDOW / (time.perf_counter() - t0))
            ran = {fn.__name__: fn.launches - before[fn.__name__]
                   for fn in wrappers}
            _, _, must, must_not = spec[name]
            check(all(ran[k] > 0 for k in must)
                  and all(ran[k] == 0 for k in must_not),
                  f"phase 8 {name} window launches {ran}")
    for r in routes.values():
        r["busy_ms"] = device_busy_ms(
            lambda: r["engine"].scan_steps_multi_raw(
                r["states"], raw[1:1 + OPTIN_CHUNK], r["in_hws"], RAW_HW,
                r["flips"]), OPTIN_CHUNK)
    for name, r in routes.items():
        fps = statistics.median(r["fps"])
        print(f"phase 8: route {name}: {fps:.3f} frames/s median ("
              + ", ".join(f"{x:.3f}" for x in r["fps"])
              + f"), device busy {r['busy_ms']:.3f} ms per frame, so "
              f"{100 * (1 - r['busy_ms'] * fps / 1e3):.1f} % idle; on {card}")
    on, off = routes["on"], routes["off"]
    agree = (torch.cat(on["labels"])
             == torch.cat(off["labels"])).float().mean().item()
    print(f"phase 8: on/off frames/s "
          f"{statistics.median(on['fps']) / statistics.median(off['fps']):.3f}"
          f", device busy {on['busy_ms'] / off['busy_ms']:.3f}; labels of "
          f"the timed frames agree on {agree:.5f} of pixels (each route "
          "feeds its own labels back)")
    return {name: dict(fps=r["fps"], busy_ms=r["busy_ms"])
            for name, r in routes.items()}


def train_config():
    """pre_vost R50-DeAOTL at the card's batch, with train_total_steps set
    so that the use_prev_pred curriculum (from half the total) starts inside
    a run of TRAIN_STEPS steps."""
    from rmem_tpu_torch.config import get_config
    return get_config("pre_vost", model="r50_deaotl",
                      train_batch_size=TRAIN_B,
                      train_total_steps=TRAIN_STEPS + 2)


def train_phase(dev, card: str, profile: bool):
    """Phase 5: TRAIN_STEPS training steps of R50-DeAOTL on synthetic clips
    (465 x 465, 15 frames, 4 clips), random weights from a seed. Launch
    counts are zeroed just before and read just after. With `profile`, one
    more step runs under torch.profiler. Returns (launch counts by
    wrapper, per-step seconds, peak GiB)."""
    import importlib

    import torch

    from rmem_tpu_torch.managers.trainer import Trainer, train_step

    steps = TRAIN_STEPS
    cfg = train_config()
    check(cfg.data_seq_len == TRAIN_T
          and tuple(cfg.data_randomcrop) == TRAIN_HW, "pre_vost's shapes")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device=dev, seed=0)
    before = {n: p.detach().clone()
              for n, p in trainer.state.model.named_parameters()}
    batches = [trainer.next_batch() for _ in range(steps)]
    wrappers = [getattr(importlib.import_module(
        f"rmem_tpu_torch.kernels.{mod}"), fn) for mod, fn in TRAIN_KERNELS]
    for fn in wrappers:
        fn.launches = 0
    seq_start = cfg.train_seq_training_start_ratio * cfg.train_total_steps
    host = host_line()
    times, losses, per_step = [], [], []
    for i, (batch, shuffle) in enumerate(batches):
        counts0 = [fn.launches for fn in wrappers]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(trainer.state, batch, shuffle, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        per_step.append([fn.launches - c for fn, c in zip(wrappers, counts0)])
        print(f"train step {i} (curriculum {'on' if i >= seq_start else 'off'}"
              f"): loss {losses[-1]:.4f}, grad norm "
              f"{float(metrics['grad_norm']):.3f}, iou "
              f"{float(metrics['iou']):.4f}, {times[-1]:.3f} s, launches "
              + str(dict(zip((fn for _, fn in TRAIN_KERNELS), per_step[-1]))))
    counts = {fn: w.launches for (_, fn), w in zip(TRAIN_KERNELS, wrappers)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in trainer.state.model.named_parameters())
    check(all(n > 0 for n in counts.values()), f"a kernel never ran: {counts}")
    check(all(all(n > 0 for n in s) for s in per_step),
          f"a kernel missed a step: {per_step}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(moved > 0, "the parameters did not change")
    check(seq_start < steps, "the curriculum did not start")
    timed = times[1:]     # the first step includes cuDNN's autotuning
    print(f"train: {steps} steps of R50-DeAOTL pre_vost at 465x465, T "
          f"{TRAIN_T}, B {TRAIN_B} (the reference's 16 over 4 GPUs), the "
          f"curriculum from step {seq_start:g}; {statistics.median(timed):.3f}"
          f" s/step median of steps 1..{steps - 1} (each: "
          + ", ".join(f"{t:.3f}" for t in times)
          + f"); peak memory {peak:.2f} GiB; largest parameter change "
          f"{moved:.3e}; on {card}; host {host}")
    if profile:
        device_busy_table(
            lambda: train_step(trainer.state, *batches[-1], cfg),
            1, statistics.median(timed) * 1e3, "per training step")
    del trainer, batches
    torch.cuda.empty_cache()
    return counts, times, peak


def held_train_step(dev):
    """Phase 6: one step of the kernel model, every K2 call of which is
    held against its plain version on the same inputs, and one step of a
    model whose kernels are all their plain versions (computed in f32 from
    the same bf16 inputs), on the same batch, weights and shuffle. Holds
    the loss and the global gradient norm of the two. Returns a summary."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.managers.trainer import Trainer, train_step

    cfg = train_config()
    bf = torch.bfloat16
    calls = []
    kernel_bwd = kb.bank_attention_bwd

    def held_bwd(q, bank_k, bank_v, count, out, rec, lse, dout, drec, scale):
        calls.append(held_k2(q, bank_k, bank_v, count, dout, drec, scale))
        return kernel_bwd(q, bank_k, bank_v, count, out, rec, lse, dout,
                          drec, scale)

    # the plain versions take the inputs in bf16, as the kernels do
    plain = {
        (kb, "bank_attention_train"): lambda q, k, v, c, scale:
            kb.bank_attention_plain(q.to(bf), k.to(bf), v.to(bf), c, 1,
                                    scale),
        (kl, "local_attention_trainable"): lambda q, k, v, r, *a:
            kl.local_attention_plain(q.to(bf), k.to(bf), v.to(bf), r.to(bf),
                                     *a),
        (ks, "stem_trainable"): lambda x, w, s, b: ks.stem_plain(
            x, w.to(bf), s.to(bf), b.to(bf)),
    }
    runs = []
    for use_plain in (False, True):
        with ExitStack() as stack:
            patches = (plain.items() if use_plain
                       else [((kb, "bank_attention_bwd"), held_bwd)])
            for (mod, attr), fn in patches:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            trainer = Trainer(cfg, device=dev, seed=1)
            trainer.rng.seed(11)
            trainer.gen.manual_seed(11)
            batch, shuffle = trainer.next_batch()
            m = train_step(trainer.state, batch, shuffle, cfg)
            runs.append((float(m["loss"]), float(m["grad_norm"])))
            del trainer
    (loss_k, gn_k), (loss_p, gn_p) = runs
    worst = {key: max(c[key] for c in calls) for key in calls[0]}
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    gn_err = abs(gn_k - gn_p) / gn_p
    print(f"phase 6: kernel step loss {loss_k:.6f}, grad norm {gn_k:.6f}; "
          f"plain step loss {loss_p:.6f}, grad norm {gn_p:.6f}; relative "
          f"differences {loss_err:.3e} and {gn_err:.3e}; {len(calls)} K2 "
          f"calls held, worst of each check: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    check(len(calls) == cfg.model_lstt_num * TRAIN_T,
          f"{len(calls)} K2 calls on the path")
    check(loss_err <= STEP_LOSS_TOL, f"step loss {loss_err}")
    check(gn_err <= STEP_GNORM_TOL, f"step grad norm {gn_err}")
    return dict(loss=[loss_k, loss_p], grad_norm=[gn_k, gn_p],
                k2_calls=len(calls), k2_worst=worst)


MUTANTS = {
    "original": [],
    "no_drec": [("d[e] = p[e] * (gg[nt][e] + ra - da);",
                 "d[e] = p[e] * (gg[nt][e] - da);"),
                ("d[e + 2] = p[e + 2] * (gg[nt][e + 2] + rc - dc);",
                 "d[e + 2] = p[e + 2] * (gg[nt][e + 2] - dc);")],
    "dq_scale": [("pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);",
                  "pack_bf16(acc[nt][0], acc[nt][1]);"),
                 ("pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);",
                  "pack_bf16(acc[nt][2], acc[nt][3]);")],
}
# runs in a copy: the copy's chip_smoke and package come first on the path
MUTANT_RUN = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
_, args = chip_smoke.k2_inputs(torch.device("cuda", 0))
try:
    print(json.dumps({"caught": None, "errs": chip_smoke.held_k2(*args)}))
except RuntimeError as e:
    print(json.dumps({"caught": str(e)}))
"""


def mutation_check() -> int:
    """`--mutants`: 0 when every mutant fails held_k2 and the original
    passes it."""
    import shutil
    import tempfile
    source = "rmem_tpu_torch/csrc/bank_attention_bwd.cu"
    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in MUTANTS.items():
            copy = Path(tmp, name)
            shutil.copytree(ROOT / "rmem_tpu_torch", copy / "rmem_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            text = (copy / source).read_text()
            for old, new in edits:
                check(text.count(old) == 1, f"{name}: {old!r} not one line")
                text = text.replace(old, new)
            (copy / source).write_text(text)
            r = subprocess.run([sys.executable, "-c", MUTANT_RUN, str(copy)],
                               capture_output=True, text=True, timeout=600)
            check(r.returncode == 0, f"{name}: the check did not run\n"
                  f"{r.stdout}\n{r.stderr}")
            result = json.loads(r.stdout.strip().splitlines()[-1])
            print(f"mutant {name}: {json.dumps(result)}")
            if (result["caught"] is None) == (name != "original"):
                wrong.append(name)
    if wrong:
        print(f"mutants: wrong outcome for {wrong}")
        return 1
    print("mutants: every mutant failed the per-call K2 check, the "
          "original passed")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=BANK_FULL + 3 * WINDOW)
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of 5 steady frames "
                         "of phases 3 and 7 and of one training step")
    ap.add_argument("--mutants", action="store_true",
                    help="only the mutation check of the per-call K2 "
                         "check; prints no result line")
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
    if args.mutants:
        return mutation_check()
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
    entries.update(check_optin_kernels(dev))
    train_entries, k2_whole = check_train_kernels(dev)
    counts, window_fps = main_path(dev, args.frames, card, args.profile)
    for key, fn_name in (("bank_attention", "bank_attention_infer"),
                         ("local_attention", "local_attention"),
                         ("stem", "stem")):
        entries[key]["launches"] = counts[fn_name]
    on_path, logit_errs, agree = plain_agreement(dev)
    train_counts, step_times, peak = train_phase(dev, card, args.profile)
    # the trainable wrappers launch K4 and K6 forwards
    for key in train_entries:
        fn_name = {"local_attention_trainable": "local_attention",
                   "stem_trainable": "stem"}.get(key, key)
        train_entries[key]["launches"] = train_counts[fn_name]
    held_step = held_train_step(dev)
    entries.update(train_entries)
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"RMEM_BANK_QMINOR": "1"}):
        optin_counts, optin_fps = optin_path(dev, card, args.profile)
        optin_worst, optin_logit_errs, optin_agree = optin_agreement(dev)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    turns = route_turns(dev, card)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    for key in ("bank_attention_qminor", "gated_dwconv"):
        entries[key]["launches"] = optin_counts[key]

    print(json.dumps({"fps_windows": window_fps,
                      "fps_median": statistics.median(window_fps),
                      "on_path": on_path, "logit_rel_err": logit_errs,
                      "label_agreement": agree,
                      "train_step_s": step_times,
                      "train_step_s_median": statistics.median(
                          step_times[1:]),
                      "train_peak_gib": peak, "train_launches": train_counts,
                      "k2_whole": k2_whole, "held_step": held_step,
                      "optin_fps_windows": optin_fps,
                      "optin_fps_median": statistics.median(optin_fps),
                      "optin_launches": optin_counts,
                      "optin_on_path": optin_worst,
                      "optin_logit_rel_err": optin_logit_errs,
                      "optin_label_agreement": optin_agree,
                      "route_turns": turns,
                      "card": card, "host": host_line()}))
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   call for the same function where one exists: the serving kernels (K1 at
   the main path's call beside K3 on the same inputs, and at one slot, all
   ten, the reference frame's call, two id groups and keys padded past
   true_lk; K1h, the bank attention at AOT's 8 heads of 32, at the same
   six calls, beside SDPA over the valid slots with and without the bias;
   K4 at the main path's call and phase 7's two batch-2 grids,
   each beside SDPA with the dense bias, and on a ragged grid; K6 at the
   serving image and phase 7's 625x1105, each beside cuDNN's bf16 chain)
   and the opt-in inference kernels (K3 at the main path's call and at
   phase 7's two batch-2 grids, from HBM and L2-resident; K8 at the same
   three shapes, from HBM and L2-resident, beside PyTorch's depthwise
   conv2d on the pre-gated map) at 481x849,
   and the training kernels (K1' with its lse output, beside SDPA, at 4
   valid slots and at 2, where its output must not lie on the bf16 grid;
   K2's split backward (csrc/bank_attention_bwd.cu: its dq kernel with the
   sum of the slot groups' partials, its dk and its dv kernel, held each
   against its plain form, timed each and by kernel) with a nonzero drec,
   K5's forward and
   backward kernels, each backward output against its plain version and
   autograd of the plain forward, on the training grid and a ragged one,
   the backward's time split by kernel beside each kernel's bound and its
   design's products at the peak rate, K7 forward and backward beside cuDNN's
   chain through autograd) at the training shapes, and AOT's training
   kernels at 8 heads of 32 (K1'h, the forward with lse, at 4 valid slots
   of 10, at 2 and at the reference frame's one, beside SDPA over the
   valid slots; K2h, its backward (csrc/bank_attention_mh_bwd.cu: the rows
   kernel computing each head's row term from the forward's output and
   slot mass, the dkv kernel, the dq kernel and the sum of its slot
   groups' partials, in one wrapper call), after each, with a nonzero
   drec, against its plain stages and autograd of the plain forward, its
   invalid slots' dk and dv exactly 0, also on keys that nearly cancel in
   ds K, fed the plain forward's output and lse; its whole time with the
   row term, split by kernel), and the serving kernels at no_memory_gap's 2 heads
   of 128 (K1 at K1's six calls beside SDPA over the valid slots with the
   bias as a mask; K3 at the main path's call and phase 7's two batch-2
   grids; K4 at the main path's call and phase 7's grids beside SDPA with
   the dense bias, and on a ragged grid), and the training kernels at
   no_memory_gap's 2 heads of 128 (K1'x2 at 9 valid slots of 10, at 4 and
   at the reference frame's one: output, each head's lse and slot mass,
   the bf16-grid share; K2x2 after each with a nonzero drec, its three
   kernels against their plain stages and the whole against autograd of
   the plain forward, dk and dv exactly 0 past count; K5's backward at 2
   heads on the training grid and a ragged one; each beside SDPA over the
   valid slots or with the dense bias, forward or backward), and R50-AOTL
   no_memory_gap's kernels at 2 heads of 128 with values 128 a head (K1x2v128,
   its own kernel, csrc/bank_attention_infer_v128.cu, at K1's six calls,
   each with its cluster size and the clusters the card holds at once, one
   kernel a call by the profiler; K1'x2v128 as K1'x2, its own kernel,
   csrc/bank_attention_lse_v128.cu, split by kernel, and K2x2v128, the fused pair of
   csrc/bank_attention_bwd_fused.cu: its dkv kernel and its dq kernel with
   the sum of the slot groups' partials, each against the plain version,
   the whole against autograd, also on keys that nearly cancel in ds K,
   there fed the plain forward's output and lse, its device time split by
   kernel), and K3h, K3 at AOT's 8 heads of 32 (K1h's calls with no bias
   and every key valid, beside SDPA over the valid slots). K1h, K3h and
   K1'h (one slot-group kernel and its merge) print the device time of
   each by the profiler, and at each call the host's time to issue it
   and the device time of a CUDA graph of it. K4 and K8 take less device
   time than an eager call takes the host, so their times are those of
   CUDA graphs;
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
   zeroed just before and read just after, and each step's are exact
   (TRAIN_LAUNCHES: K1' and K4 87, K2's split backward (one wrapper
   call: the dq kernel and its sum, the dk and the dv kernel) and K5's
   backward
   45, K7 1, K1'h and K2h 0); losses finite, parameters changed;
   seconds per step (median and each) and peak memory beside the card and
   the host;
6. one step of the kernel model, every K2 call, K5 forward call and K5
   backward call of which is held against its plain version on the same
   inputs (the backward also against autograd of the plain forward), and
   one step of a model whose
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
   Then the first 12 frames again, every K3, K8 and K4 call held against
   its plain version, and through an all-plain engine teacher-forced with the
   kernel engine's labels: logits and labels agree per frame;
8. the two serving routes on the same traffic: phase 7's engine built
   twice from one seed, with both opt-ins on (K3, K8) and with both off
   (K1, the gate multiply and PyTorch's depthwise conv); each fills its
   bank on phase 7's video, then three 10-frame windows of each, the
   routes alternating, and one chunk of each under torch.profiler:
   frames/s and the device's busy time per frame of each route;
9. serve R50-AOTL + RMem (3 LSTT layers, 8 heads of 32) on phase 3's
   traffic: the reference frame and N frames, a long-term write every 5,
   so the bank fills at frame 40 and evicts. Launch counts are zeroed just
   before and read just after: K1h 3 a frame and K6 1 a frame (the
   reference frame included), the one-head K1, K3 and K4 never (phase 3
   holds the same exact counts for its model: K1 and K4 3 a frame, K6 1,
   K1h and K3 never); evictions counted on the device, labels in [0, 10],
   finite logits; frames/s over three 30-frame windows (`--profile`: the
   device's busy time a frame and the top ops);
10. phase 4 for R50-AOTL: the reference frame and 44 frames through the
   kernel engine, every K1h and K6 call held against its plain version,
   and through an all-plain engine teacher-forced with its labels: logits
   and labels agree per frame;
11. phase 5 for R50-AOTL: 6 training steps of r50_aotl pre_vost, exact
   launches in each (K1'h 87: 3 layers x (15 frames + 14 recomputed under
   the checkpoint), K2h 45, K7 1, K1', K2, K4 and K5 0);
12. phase 6 for R50-AOTL: one step of the kernel model, every K2h call
   held against its plain stages, and one of the all-plain model on the
   same batch, weights and shuffle: loss and global gradient norm;
13. serve R50-DeAOTL + RMem with no_memory_gap (2 heads of 128 in the
   bank and local attentions, values 512 a head) on phase 3's traffic,
   with the evaluator's write gap (evaluator_gap: 1), so the bank fills
   at frame 8 and evicts on every later frame. Launch counts are zeroed
   just before and read just after: K1 and K4 3 a frame and K6 1 (the
   reference frame included), K1h and K3 never; evictions counted on the
   device equal the scheduled count; labels in [0, 10], finite logits;
   frames/s over three 30-frame windows (`--profile`: the device's busy
   time a frame and the top ops);
14. phase 4 for phase 13's engine: every K1, K4 and K6 call over the
   reference frame and 44 frames held against its plain version, and an
   all-plain engine teacher-forced with the kernel engine's labels, logits
   and labels held frame by frame through frame 8 (before the first
   eviction: a near tie in the slot mass may pick another victim after
   it); then, with RMEM_BANK_QMINOR set for this part only, the reference
   frame and 12 frames again with every K3 call held against its plain
   version: K3 3 launches a frame, K1 none;
15. phase 5 for R50-DeAOTL with no_memory_gap (2 heads of 128, a
   long-term write every frame, so the 1 + 8 slots fill at frame 8 and
   frames 9 to 14 evict FIFO): 6 steps, exact launches in each (as phase
   5's, through the same wrappers at 2 heads), 6 FIFO evictions a clip
   counted on the host, finite losses, parameters changed, the curriculum
   started; s/step, peak memory (`--profile`: busy ms a step, top ops);
16. phase 6 for phase 15's model: one step of the kernel model, every
   K1'x2, K2x2 (its dq, dk and dv against their plain form on the
   call's own forward), K4x2 and K5x2-backward call held against its plain
   version, and one of the all-plain model on the same batch, weights and
   shuffle: loss and global gradient norm;
17. serve R50-AOTL + RMem with no_memory_gap (2 heads of 128 in the LSTT's
   long- and short-term attention, values 128 a head) on phase 3's
   traffic with the evaluator's gap of 1, as phase 13: K1x2v128 3 a frame
   (one launch a call) and K6 1 (every call of K1's launcher at that head
   shape), K1h, K3 and K4 never; evictions counted on the device equal the schedule;
   labels in [0, 10], finite logits; frames/s over three 30-frame windows
   (`--profile`: busy time a frame, top ops);
18. phase 4 for phase 17's engine: every K1x2v128 and K6 call held against
   its plain version, and the all-plain engine teacher-forced with the
   kernel engine's labels through frame 8, as phase 14;
19. phase 5 for R50-AOTL with no_memory_gap: 6 steps, exact launches in
   each (K1'x2v128 87, K2x2v128's fused pair 45: one wrapper call each, the
   dkv kernel, the dq kernel and its sum; K2's split kernels, the 8-head
   and DeAOT kernels 0, K7 1), 6 FIFO evictions a clip, finite losses,
   parameters changed, the curriculum started; s/step, peak memory
   (`--profile`: busy ms a step, top ops);
20. phase 6 for phase 19's model: one step of the kernel model, every
   K1'x2v128 and K2x2v128 call held against its plain version, and one of
   the all-plain model: loss and global gradient norm.

Prints the `kernels` JSON line, then the card line, then the result line
`{"ok": true, "device": {...}}` last. Exits non-zero without a result when
no CUDA device is available or the package is not beside this script.

`--mutants` runs only a mutation check of phase 2's per-call checks of K2
(held_k2; K1'x2 + K2x2 by held_k2h at 2 heads, values 512 a head, at 9
valid slots and on keys that cancel), K4
and K5's backward (held_k4, held_k5; each at one head and at two), K1, K3
and K1' (held_k1, held_k3, held_k2, held_k1ph; each at one head and at
two), K1x2v128 (held_k1 at K1's six calls, and at clusters of 3), K8 (held
at phase 2's three shapes and a ragged grid, and bit for bit), K1h, K3h and K1'h
(held_k1h, held_k3h, held_k1ph), K2x2v128's fused pair (held_k2h at 2
heads, values 128 a head, at 4 valid slots and on keys that cancel), K2h
(held_k2h at 4 valid slots, at the reference frame's one, and on keys
that cancel), K1'x2v128 (held_k1ph at 9, 4 and 1 valid slots) and K6 and
K7 (held, held_k7): for each
mutant (MUTANTS), the package is copied into a temporary directory, one
line of the kernel's source (or its wrapper) is changed there (K2 and
K2x2's split kernels: the dk kernel's ds drops the row term, the
wrapper's row term the slot mass's share, dq the logit scale, dq and dk
the lo plane of ds, head 1 reads head 0's resident values or rows, every
value group of the dv kernel the first group's dO, the sum of dq's
partials drops a last group of one slot, or the invalid slots' dk or dv
is computed, not zeroed; K4: the accumulator is not rescaled when a
row's maximum grows, or the bias is read at the transposed offset; K5: dq
drops the scale, the key side reads the bias and ds unmirrored, ds drops
delta, the lse drops the row maximum, or the dk role re-indexes its drel
sub-rows reversed; K4 at 2 heads: head 1 reads head 0's bias; K5 at 2
heads: head 1's drel is written into head 0's columns, or the key side
reads head 0's drel columns for head 1; K1: the bias is
dropped, or the keys are masked at Lk instead of true_lk; the K1/K3/K1'
template: the keys past Lk go unmasked, or a quarter of the accumulator
unrescaled; at 2 heads, head 1 reads head 0's keys, or the wrapper takes
head 0's slot mass for the heads' mean; K1': the partial outputs pass
through bf16, or the lse drops the log of the sum; K1'x2: only head 0's
lse is written; K1x2v128: head 1 reads head 0's values, the P.V
product's V descriptor steps 8 keys a 16-key slice, a rank's range starts
a chunk late, the merge drops rank 1's per-slot sums or weighs every
rank's output by rank 0's weight, the bias is skipped on ranks past 0, or
the key mask sits on a slot's first chunk; K8: a band's last output row
is left unwritten, the rows below the image are not skipped, the taps are
summed in reverse dx order, each channel takes its neighbour's weights,
or the gate is never multiplied in; K3h: the wrapper masks the keys a chunk short; K1h: the bias is
dropped, a slot's sum is not rescaled as the row's maximum grows, the
zero keys past true_lk go unmasked, ldmatrix reads the tiles unswizzled,
the merge weighs every group by the first group's maximum, or takes a
slot's mass against the next group's; K1'h: the f32 partials and output
stored through bf16, or the lse without the log of the sum; K2x2v128's
fused pair: dq drops ds's lo plane, the invalid slots' dk and dv are
computed instead of zeroed, the sum of dq's partials drops a last group
of one slot, head 1's dk and dv read head 0's queries, or the wrapper's
row term drops the slot mass's share; K2h: the rows kernel's rterm
drops the slot-mass term or its delta the slot mass's share, dq drops the
logit scale or ds's lo plane, the sum of dq's partials drops a last group
of one slot, the dkv kernel reads the other head's queries or the dq
kernel the other head's keys, the invalid slots' dk and dv are computed,
or their dk is left unwritten; K1'x2v128: the zero keys past Lk go
unmasked, a quarter of the accumulator unrescaled, a slot's mass is
booked to its neighbour, the merge drops the second consumer's output,
the lse drops the log of the sum, or head 1 reads head 0's values;
K6/K7: conv positions
outside the conv grid enter the pool, or the pad taps carry weights), the
copy's kernels are built, and the source's checks run on phase 2's
inputs. Each mutant must fail a check and each unmutated copy pass them
all; the checkout itself is never changed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import platform
import re
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
# K1' keeps its output f32 for K2's row term: the share of its values
# within 2^-20 of the bf16 grid is ~2^-11 for f32 values, and ~1 where
# one slot group's output went through bf16 on the way
ON_GRID_TOL = 0.05
# K2's kernels round p and their outputs to bf16 and sum in f32: a few bf16
# roundings of the output's scale (each kernel 1.4e-3 to 3.8e-3, the whole
# backward against autograd up to 1.1e-2 over a training step's 45 calls,
# measured on an H100); K5's backward rounds its bf16 outputs and p, and
# carries ds as a bf16 hi/lo pair; K7's backward runs the chain's VJP in
# bf16 from the forward's saved state, its sums in another order (3.8e-3
# measured)
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
# K3 in phase 2: the main path's call (batch 1, 31 x 54) and phase 7's
# (batch 2 on the grids of scales 1.0 and 1.3), timed over input sets of at
# least K3_COLD_BYTES together, twice the L2
K3_SHAPES = {"b1_31x54": (1, 31, 54), "b2_31x54": (2, 31, 54),
             "b2_40x70": (2, 40, 70)}
K3_COLD_BYTES = 100_000_000
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


def ptxas_lines(log: str):
    """nvcc -Xptxas -v's registers and spills of each kernel in a build
    log, one line a kernel led by its name (the mangled entry's nested
    names, e.g. rmem_bwd::ds_kernel)."""
    entry = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", line)
        if m:
            parts, s = [], m.group(1)
            while (n := re.match(r"\d+", s)):
                k = n.end() + int(n.group())
                parts.append(s[n.end():k])
                s = s[k:]
            args = re.findall(r"L[bij](\d+)E", s)
            entry = ("::".join(parts) or m.group(1)) + (
                f"<{','.join(args)}>" if args else "")
        elif "registers" in line or "spill" in line:
            yield f"{entry}: {line.split(':', 1)[-1].strip()}"


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


def kernel_split_ms(fn, reps: int = 10) -> dict:
    """Device time per call of each kernel that fn launches, by kernel
    name, from torch.profiler over `reps` calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / (1e3 * reps)
            for e in p.key_averages() if e.device_type == DeviceType.CUDA}


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


def issue_ms(fn, reps: int = 50) -> dict:
    """An eager call's two costs, for a kernel near the host's issue rate:
    `host_ms`, the host's time to issue one call of fn (reps calls back to
    back, the clock read before the device is waited on; their launches
    stay within the launch queue), and `graph_ms`, its device time in a
    CUDA graph (graph_ms). cuda_ms of an eager call is about the larger."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dict(host_ms=host, graph_ms=graph_ms(fn, 20))


def issue_text(case: dict) -> str:
    """issue_ms's two costs, printed after a case's event time."""
    if "host_ms" not in case:
        return ""
    return (f"; the host issues a call in {case['host_ms']:.4f} ms, a CUDA "
            f"graph of it runs {case['graph_ms']:.4f} ms")


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
    if name in ("bank_attention", "bank_attention_qminor",
                "bank_attention_mh"):
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

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    entries = {}
    h, w = (IN_HW[0] - 1) // 16 + 1, (IN_HW[1] - 1) // 16 + 1     # 31 x 54
    hw, dh, dv, S, count = h * w, 128, 1024, 10, 9
    scale = dh ** -0.5

    # ---- K1 bank attention: 9 of 10 slots valid, slot-PE bias, beside
    # K3 on the same q, keys and values; then the other calls it takes ----
    cases = {}
    for key, kw in K1_CASES.items():
        args = k1_inputs(dev, **kw)
        cases[key] = dict(err=held_k1(*args),
                          ms=cuda_ms(lambda: kb.bank_attention_infer(*args),
                                     20))
    args = k1_inputs(dev)
    q, bk, bvv, cnt, _, scale, _, qbias = args
    k3_ms = cuda_ms(lambda: kb.bank_attention_qminor(q, bk, bvv, cnt, 1,
                                                     scale), 20)
    main = cases["main"]
    err = max(c["err"][0] for c in cases.values())
    rerr = max(c["err"][2] for c in cases.values())
    for key, c in cases.items():
        print(f"K1 bank_attention {key} {K1_CASES[key]}: {c['ms']:.4f} ms, "
              f"max|out-plain| {c['err'][0]:.3e} (max|plain| "
              f"{c['err'][1]:.3e}), max|rec-plain| {c['err'][2]:.3e}")
    print(f"K1 at the main path {main['ms']:.4f} ms, K3 on the same q, keys "
          f"and values (no bias) {k3_ms:.4f} ms: K1/K3 "
          f"{main['ms'] / k3_ms:.3f}")
    kv = count * hw
    k_lib = bk[:count].reshape(1, 1, kv, dh)
    v_lib = bvv[:count].reshape(1, 1, kv, dv)
    mask = qbias[0, 0, :, :count].to(bf).repeat_interleave(hw, dim=1)[None, None]
    flops = 2.0 * hw * kv * (dh + dv)
    nbytes = (q.numel() + kv * (dh + dv) + hw * dv) * 2 + 2 * hw * S * 4
    b_ms, b_by = bound(flops, nbytes)
    entries["bank_attention"] = dict(
        name="bank_attention", route="cuda",
        source="rmem_tpu_torch/csrc/bank_attention_infer.cu",
        replaces="rmem_tpu/kernels/bank_attention.py:505",
        max_abs_err=err, max_abs_err_rec=rerr, ms=main["ms"],
        plain_ms=cuda_ms(lambda: kb.bank_attention_plain(*args), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k_lib, v_lib, attn_mask=mask, scale=scale), 20),
        k3_same_inputs_ms=k3_ms,
        cases={key: dict(ms=c["ms"], rel_err=c["err"][0] / c["err"][1],
                         mass_err=c["err"][2]) for key, c in cases.items()})

    # ---- K1h: the bank attention at 8 heads of 32 (AOT) ----
    entries["bank_attention_mh"] = heads_entry(dev, "bank_attention_mh")

    # ---- K4 local attention: the main path's call (31 x 54), phase 7's
    # (batch 2 on 31 x 54 and 40 x 70) and a ragged grid held ----
    shapes = {key: k4_shape(dev, *shape) for key, shape in K4_SHAPES.items()}
    for key, r in shapes.items():
        print(f"K4 local_attention {key}: {r['ms']:.4f} ms, SDPA with the "
              f"dense bias {r['library_ms']:.4f} ms ({r['library_ratio']:.3f}"
              f"x), bound {r['bound_ms']:.5f} ms, max|out-plain| / max|plain| "
              f"{r['rel_err']:.3e}")
    held_k4(*k4_inputs(dev, 2, 13, 21))
    main = shapes["b1_31x54"]
    largs = k4_inputs(dev, 1, h, w)
    entries["local_attention"] = dict(
        name="local_attention", route="cuda",
        source="rmem_tpu_torch/csrc/local_attention.cu",
        replaces="rmem_tpu/kernels/local_attention.py:133",
        max_abs_err=max(r["err"] for r in shapes.values()),
        ms=main["ms"],
        plain_ms=cuda_ms(lambda: kl.local_attention_plain(*largs), 5),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shapes=shapes)

    # ---- K6 stem at the serving image and phase 7's two scales ----
    shapes = {key: k6_shape(dev, g, hw) for key, hw in K6_SHAPES.items()}
    for key, r in shapes.items():
        print(f"K6 stem {key}: {r['ms']:.4f} ms, plain chain "
              f"{r['plain_ms']:.4f} ms, library chain (cuDNN bf16 conv2d with "
              f"the folded bias, relu, max_pool2d: three calls) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms; "
              f"max|out-plain| {r['err']:.3e} (max|plain| {r['top']:.3e}), "
              f"{r['differ']} of {r['n']} values differ")
    main = shapes["b1_481x849"]
    entries["stem"] = dict(
        name="stem", route="cuda", source="rmem_tpu_torch/csrc/stem.cu",
        replaces="rmem_tpu/kernels/stem.py:137",
        max_abs_err=max(r["err"] for r in shapes.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        library="cuDNN bf16 conv2d (channels-last, folded bias), relu, "
                "max_pool2d: a chain of three calls",
        shapes=shapes)
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries


# K6 in phase 2: the serving image (phase 3, and phase 7's scale 1.0) and
# phase 7's scale 1.3, at the batch the engine's encoder passes (one frame
# of one aug at a time)
K6_SHAPES = {"b1_481x849": (1, 481, 849), "b1_625x1105": (1, 625, 1105)}


def stem_inputs(dev, g, batch: int, h: int, w: int, train: bool = False):
    """The stem's inputs: an image in [0, 1) (f32 NHWC), weights, scale and
    bias (bf16; f32 for training, as the trainer's parameters are)."""
    import torch
    dt = torch.float32 if train else torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    x = torch.rand((batch, h, w, 3), generator=g, device=dev)
    return x, randn(64, 3, 7, 7, scale=0.2), 1.0 + randn(64, scale=0.1), \
        randn(64, scale=0.1)


def stem_library(x, wt, sc, bi):
    """The library's chain for the stem's function, from the image in bf16
    channels-last: (a function of (weight, bias) running cuDNN's conv2d with
    the BN scale folded into the weight and the bias into the conv, relu and
    max_pool2d; the folded weight; the bias)."""
    import torch
    import torch.nn.functional as F
    bf = torch.bfloat16
    xl = x.permute(0, 3, 1, 2).to(bf)               # channels-last strides
    wl = (wt.float() * sc.float()[:, None, None, None]).to(bf).contiguous(
        memory_format=torch.channels_last)
    bl = bi.to(bf)

    def chain(w_, b_):
        return F.max_pool2d(torch.relu(F.conv2d(xl, w_, b_, 2, 3)), 3, 2, 1)

    return chain, wl, bl


def stem_bound(x, out, train: bool = False):
    """The stem's bound: the conv's operations (and dW's, training) against
    the f32 image read and the bf16 output written (and its cotangent read,
    training), the weights once each way."""
    b, h, w, _ = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    flops = 2.0 * 147 * 64 * ho * wo * b * (2 if train else 1)
    nbytes = (x.numel() * 4 + out.numel() * 2 * (2 if train else 1)
              + 9408 * 2 * (2 if train else 1))
    return bound(flops, nbytes)


def k6_shape(dev, g, hw) -> dict:
    """K6 at one shape, held against its plain version, timed beside the
    plain chain and the library's chain, with its bound."""
    from rmem_tpu_torch.kernels import stem as ks
    sargs = stem_inputs(dev, g, *hw)
    out = ks.stem(*sargs)
    ref = ks.stem_plain(*sargs)
    b, h, w = hw
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    check(out.shape == ref.shape == (b, (ho - 1) // 2 + 1, (wo - 1) // 2 + 1,
                                     64), f"K6 shape {tuple(out.shape)}")
    err, top, _ = held("stem", out, ref)
    chain, wl, bl = stem_library(*sargs)
    b_ms, b_by = stem_bound(sargs[0], out)
    return dict(ms=cuda_ms(lambda: ks.stem(*sargs), 50),
                plain_ms=cuda_ms(lambda: ks.stem_plain(*sargs), 20),
                library_ms=cuda_ms(lambda: chain(wl, bl), 50),
                bound_ms=b_ms, bound_by=b_by, err=err, top=top,
                differ=int((out != ref).sum()), n=out.numel())


# K1 in phase 2: the main path's call (batch 1 on 31 x 54, 9 valid slots of
# 10, the slot-PE bias) and the other calls K1 takes: one slot or all ten,
# the reference frame's (one slot, no bias), two id groups, and keys padded
# 70 past true_lk (true_lk not a multiple of 64, so a mask at Lk shows)
K1_CASES = {"main": {}, "count_1": dict(count=1), "count_10": dict(count=10),
            "reference": dict(slots=1, count=1, bias=False),
            "batch_2": dict(batch=2), "padded": dict(pad=70)}


def k1_inputs(dev, batch: int = 1, slots: int = 10, count: int = 9,
              bias: bool = True, pad: int = 0, heads: int = 1,
              values: int = 1024):
    """K1's inputs at a serving call on the 31 x 54 grid (bf16, `heads`
    heads of 128, `values` value columns over the heads, Lq = true_lk =
    1674 and Lk = true_lk + pad): (q, bank_k, bank_v, count, heads, scale,
    true_lk, qbias [B, heads, Lq, S] or None). Two heads are
    no_memory_gap's: R50-DeAOTL's with values 1024 (phase 13), R50-AOTL's
    with 256 (phase 17)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    hw = ((IN_HW[0] - 1) // 16 + 1) * ((IN_HW[1] - 1) // 16 + 1)
    q = randn(batch, hw, 128 * heads, scale=2.0)
    bk = randn(slots, batch, hw + pad, 128 * heads)
    bv = randn(slots, batch, hw + pad, values)
    qbias = (randn(batch, heads, hw, slots, dtype=torch.float32, scale=0.5)
             if bias else None)
    return (q, bk, bv, torch.tensor(count, dtype=torch.int32, device=dev),
            heads, 128 ** -0.5, hw, qbias)


def held_k1(*args):
    """One K1 call against its plain version (output and slot mass, see
    held); the empty slots' mass must be 0, and with one slot every row's
    mass 1. Returns held's tuple."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    out, rec = kb.bank_attention_infer(*args)
    errs = held("bank_attention", (out, rec), kb.bank_attention_plain(*args))
    count = int(args[3])
    check(bool(torch.all(rec[..., count:] == 0)), "K1 mass of empty slots")
    if count == 1:
        check(torch.allclose(rec[..., 0], torch.ones_like(rec[..., 0]),
                             atol=1e-4), "K1 one-slot mass")
    return errs


def k1h_inputs(dev, batch: int = 1, slots: int = 10, count: int = 9,
               bias: bool = True, pad: int = 0):
    """K1h's inputs at a call of the AOT serving path on the 31 x 54 grid
    (bf16, 8 heads of 32, Lq = true_lk = 1674 and Lk = true_lk + pad): (q,
    bank_k, bank_v, count, heads, scale, true_lk, qbias [B, 8, Lq, S] or
    None). Phase 2 holds K1h at K1's cases (K1_CASES)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    hw = ((IN_HW[0] - 1) // 16 + 1) * ((IN_HW[1] - 1) // 16 + 1)
    q = randn(batch, hw, 256, scale=2.0)
    bk, bv = (randn(slots, batch, hw + pad, 256),
              randn(slots, batch, hw + pad, 256))
    qbias = (randn(batch, 8, hw, slots, dtype=torch.float32, scale=0.5)
             if bias else None)
    return (q, bk, bv, torch.tensor(count, dtype=torch.int32, device=dev), 8,
            32 ** -0.5, hw, qbias)


def held_k1h(*args):
    """One K1h call against its plain version (output and head-mean slot
    mass, see held); the empty slots' mass must be 0, and with one slot
    every row's mass 1. With keys past true_lk, the kernel must give the
    same bits as on the bank cut at true_lk: the padding is never read.
    Returns held's tuple."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    out, rec = kb.bank_attention_infer_mh(*args)
    errs = held("bank_attention_mh", (out, rec),
                kb.bank_attention_plain(*args))
    q, bk, bv, cnt, heads, scale, true_lk, qbias = args
    if true_lk < bk.shape[2] and q.is_cuda:
        cut = [x[:, :, :true_lk].contiguous() for x in (bk, bv)]
        out_cut, rec_cut = kb.bank_attention_infer_mh(q, *cut, cnt, heads,
                                                      scale, true_lk, qbias)
        check(torch.equal(out, out_cut) and torch.equal(rec, rec_cut),
              "K1h keys past true_lk changed the result")
    count = int(cnt)
    check(bool(torch.all(rec[..., count:] == 0)), "K1h mass of empty slots")
    if count == 1:
        check(torch.allclose(rec[..., 0], torch.ones_like(rec[..., 0]),
                             atol=1e-4), "K1h one-slot mass")
    return errs


def k1x2_inputs(dev, **kw):
    """K1's inputs at R50-DeAOTL no_memory_gap's 2 heads of 128 (values 512
    a head)."""
    return k1_inputs(dev, heads=2, **kw)


def k1x2v128_inputs(dev, **kw):
    """K1's inputs at R50-AOTL no_memory_gap's 2 heads of 128 (values 128 a
    head: K1x2v128, csrc/bank_attention_infer_v128.cu)."""
    return k1_inputs(dev, heads=2, values=256, **kw)


# the multi-head rows of K1 in phase 2 (heads_entry): K1h, AOT's 8 heads
# of 32 (csrc/bank_attention_mh.cu), and K1x2 and K1x2v128, no_memory_gap's
# 2 heads of 128 with values 512 a head (DeAOT: K1's template,
# csrc/bank_attention_infer.cu) and 128 a head (AOT: its own kernel,
# csrc/bank_attention_infer_v128.cu); `call` names the wrapper in
# kernels/bank_attention.py
HEAD_ROWS = {
    "bank_attention_mh": dict(
        label="K1h", inputs=k1h_inputs, held=held_k1h,
        call="bank_attention_infer_mh",
        source="rmem_tpu_torch/csrc/bank_attention_mh.cu"),
    "bank_attention_h2": dict(
        label="K1x2", inputs=k1x2_inputs, held=held_k1,
        call="bank_attention_infer",
        source="rmem_tpu_torch/csrc/bank_attention_infer.cu"),
    "bank_attention_h2v128": dict(
        label="K1x2v128", inputs=k1x2v128_inputs, held=held_k1,
        call="bank_attention_infer",
        source="rmem_tpu_torch/csrc/bank_attention_infer_v128.cu"),
}


def heads_entry(dev, name: str = "bank_attention_mh") -> dict:
    """Phase 2's rows of a multi-head bank attention (HEAD_ROWS): every case
    of K1_CASES held and timed (CUDA events), the main call beside its plain
    version, its bound and SDPA over the valid slots' keys flattened (the
    bias as an additive mask; and without it). K1x2v128 also prints each
    case's cluster size and the clusters of that size the card holds at
    once, and its device time by kernel (one kernel a call, no merge).
    Returns the kernels-line entry without its launch count."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    row = HEAD_ROWS[name]
    inputs, held_fn = row["inputs"], row["held"]
    call = getattr(kb, row["call"])
    cases = {}
    for key, kw in K1_CASES.items():
        args = inputs(dev, **kw)
        cases[key] = dict(err=held_fn(*args),
                          ms=cuda_ms(lambda: call(*args), 20))
        if name == "bank_attention_mh":
            cases[key].update(issue_ms(lambda: call(*args)))
        cluster = ""
        if name == "bank_attention_h2v128":
            cl, resident = kb.v128_launch_cluster(args[0])
            cases[key].update(cluster=cl, resident_clusters=resident,
                              graph_ms=graph_ms(lambda: call(*args), 20))
            cluster = (f"; clusters of {cl} blocks, {resident} resident at "
                       f"once; a CUDA graph of it {cases[key]['graph_ms']:.4f}"
                       " ms")
        print(f"{row['label']} {name} {key} {kw}: {cases[key]['ms']:.4f} ms, "
              f"max|out-plain| {cases[key]['err'][0]:.3e} (max|plain| "
              f"{cases[key]['err'][1]:.3e}), max|rec-plain| "
              f"{cases[key]['err'][2]:.3e}" + issue_text(cases[key])
              + cluster)
    args = inputs(dev)
    q, bk, bvv, cnt, heads, scale, lk, qbias = args
    count, b, lq = int(cnt), q.shape[0], q.shape[1]
    kv = count * lk
    kw_, vw = bk.shape[-1], bvv.shape[-1]       # widths over the heads

    def heads_first(x, n):          # [B, n, h*d] -> [B, h, n, d]
        return x.reshape(b, n, heads, -1).transpose(1, 2).contiguous()

    q_lib = heads_first(q, lq)
    k_lib = heads_first(bk[:count].transpose(0, 1).reshape(b, kv, kw_), kv)
    v_lib = heads_first(bvv[:count].transpose(0, 1).reshape(b, kv, vw), kv)
    mask = qbias[..., :count].to(torch.bfloat16).repeat_interleave(lk, dim=3)
    # every head's (q.k, p.v) over the valid keys; q, the valid keys and
    # values, the bias read once, the output and the head-mean mass written
    flops = 2.0 * b * lq * kv * (kw_ + vw)
    nbytes = ((q.numel() + b * kv * (kw_ + vw) + b * lq * vw) * 2
              + (qbias.numel() + b * lq * bk.shape[0]) * 4)
    b_ms, b_by = bound(flops, nbytes)
    main = cases["main"]
    entry = dict(
        name=name, route="cuda", source=row["source"],
        replaces="rmem_tpu/kernels/bank_attention.py:505", heads=heads,
        max_abs_err=max(c["err"][0] for c in cases.values()),
        max_abs_err_rec=max(c["err"][2] for c in cases.values()),
        ms=main["ms"],
        plain_ms=cuda_ms(lambda: kb.bank_attention_plain(*args), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, attn_mask=mask, scale=scale), 20),
        library_nobias_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, scale=scale), 20),
        cases={key: dict(ms=c["ms"], rel_err=c["err"][0] / c["err"][1],
                         mass_err=c["err"][2],
                         **{k: c[k] for k in ("host_ms", "graph_ms",
                                              "cluster", "resident_clusters")
                            if k in c}) for key, c in cases.items()})
    print(f"{row['label']} at the main path {main['ms']:.4f} ms, plain "
          f"{entry['plain_ms']:.4f} ms, SDPA over the 9 valid slots with the "
          f"bias as a mask {entry['library_ms']:.4f} ms (without it "
          f"{entry['library_nobias_ms']:.4f} ms), bound {b_ms:.5f} ms "
          f"({b_by})")
    if name == "bank_attention_mh":
        split_row(entry, lambda: call(*args), row["label"])
    if name == "bank_attention_h2v128":
        split_row(entry, lambda: call(*args), row["label"])
        ours = [k for k in entry["split_ms"] if "rmem_" in k]
        check(len(ours) == 1 and "infer_kernel" in ours[0],
              f"K1x2v128 launched {ours}, expected one kernel a call")
    return entry


def split_row(entry: dict, fn, label: str) -> None:
    """Add the device time a call of fn spends in each kernel (profiler, ms
    a call: a partial kernel and its merge) to a kernels-line entry, and
    print it."""
    entry["split_ms"] = kernel_split_ms(fn)
    print(f"{label} by kernel (profiler, ms a call): " + ", ".join(
        f"{k[:48]} {x:.4f}" for k, x in entry["split_ms"].items()))


# K3h in phase 2: K1h's calls with no bias and every key valid (K3's
# contract): 9 valid slots of 10, one, all ten, the reference frame's
# shape and two id groups
K3H_CASES = {key: dict(kw, bias=False) for key, kw in K1_CASES.items()
             if key != "padded"}


def held_k3h(q, bank_k, bank_v, count, heads, scale, *_):
    """One K3h call (bank_attention_qminor at 8 heads of 32) against its
    plain version, held as K1h (see held); the empty slots' mass must be 0,
    and with one slot every row's mass 1. Returns held's tuple."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    out, rec = kb.bank_attention_qminor(q, bank_k, bank_v, count, heads,
                                        scale)
    errs = held("bank_attention_qminor", (out, rec),
                kb.bank_attention_qminor_plain(q, bank_k, bank_v, count,
                                               heads, scale))
    n = int(count)
    check(bool(torch.all(rec[..., n:] == 0)), "K3h mass of empty slots")
    if n == 1:
        check(torch.allclose(rec[..., 0], torch.ones_like(rec[..., 0]),
                             atol=1e-4), "K3h one-slot mass")
    return errs


def check_aot_nmg_serving_kernels(dev):
    """Phase 2, the serving rows of R50-AOTL's no_memory_gap and AOT's
    q-minor route: K1x2v128 (2 heads of 128, values 128 a head) at K1_CASES
    beside SDPA over the valid slots (heads_entry), and K3h (K3 at 8 heads
    of 32, K1h's kernel with no bias and every key valid) at K3H_CASES,
    held as K1h, timed beside its plain version, its bound and SDPA over
    the valid slots without a bias. Returns {name: entry} without launch
    counts."""
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    entries = {"bank_attention_h2v128": heads_entry(dev,
                                                    "bank_attention_h2v128")}
    cases = {}
    for key, kw in K3H_CASES.items():
        args = k1h_inputs(dev, **kw)
        q, bk, bv, cnt, heads, scale = args[:6]
        k3h = lambda: kb.bank_attention_qminor(q, bk, bv, cnt, heads, scale)
        cases[key] = dict(err=held_k3h(*args), ms=cuda_ms(k3h, 20),
                          **issue_ms(k3h))
        print(f"K3h bank_attention_qminor {key} {kw}: "
              f"{cases[key]['ms']:.4f} ms, max|out-plain| "
              f"{cases[key]['err'][0]:.3e} (max|plain| "
              f"{cases[key]['err'][1]:.3e}), max|rec-plain| "
              f"{cases[key]['err'][2]:.3e}" + issue_text(cases[key]))
    q, bk, bv, cnt, heads, scale = k1h_inputs(dev, bias=False)[:6]
    count, b, lq, lk = int(cnt), q.shape[0], q.shape[1], bk.shape[2]
    kv = count * lk

    def heads_first(x, n):          # [B, n, 8*32] -> [B, 8, n, 32]
        return x.reshape(b, n, heads, -1).transpose(1, 2).contiguous()

    libs = [heads_first(q, lq)] + [
        heads_first(t[:count].transpose(0, 1).reshape(b, kv, t.shape[-1]),
                    kv) for t in (bk, bv)]
    # every head's (q.k, p.v) over the valid keys; q and the valid keys and
    # values read once, the output and the head-mean mass written
    b_ms, b_by = bound(2.0 * b * lq * kv * (2 * q.shape[-1]),
                       (q.numel() * 2 + b * kv * 2 * q.shape[-1]) * 2
                       + b * lq * bk.shape[0] * 4)
    entries["bank_attention_qminor_mh"] = dict(
        name="bank_attention_qminor_mh", route="cuda", heads=heads,
        source="rmem_tpu_torch/csrc/bank_attention_mh.cu",
        replaces="rmem_tpu/kernels/bank_attention.py:540",
        max_abs_err=max(c["err"][0] for c in cases.values()),
        max_abs_err_rec=max(c["err"][2] for c in cases.values()),
        ms=cases["main"]["ms"],
        plain_ms=cuda_ms(lambda: kb.bank_attention_qminor_plain(
            q, bk, bv, cnt, heads, scale), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            *libs, scale=scale), 20),
        cases={key: dict(ms=c["ms"], rel_err=c["err"][0] / c["err"][1],
                         mass_err=c["err"][2], host_ms=c["host_ms"],
                         graph_ms=c["graph_ms"])
               for key, c in cases.items()})
    e = entries["bank_attention_qminor_mh"]
    print(f"K3h at the main path's call {e['ms']:.4f} ms, plain "
          f"{e['plain_ms']:.4f} ms, SDPA over the 9 valid slots "
          f"{e['library_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    split_row(e, lambda: kb.bank_attention_qminor(q, bk, bv, cnt, heads,
                                                  scale), "K3h")
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries


# K4 in phase 2: the main path's call and phase 7's two (batch 2, the grids
# of scales 1.0 and 1.3); K5's forward at the training shape is a training
# row
K4_SHAPES = {"b1_31x54": (1, 31, 54), "b2_31x54": (2, 31, 54),
             "b2_40x70": (2, 40, 70)}


def k4_inputs(dev, batch: int, gh: int, gw: int, heads: int = 1):
    """K4's inputs at a call of the serving path (bf16, `heads` heads of
    128, values 1024 over the heads, the bias 225 a head): (q, k, v, rel,
    size_2d, heads, max_dis, scale)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    hw = gh * gw
    return (randn(batch, hw, 128 * heads, scale=2.0),
            randn(batch, hw, 128 * heads), randn(batch, hw, 1024),
            randn(batch, hw, 225 * heads), (gh, gw), heads, 7, 128 ** -0.5)


def held_k4(*args):
    """One K4 call against its plain version (see held). Returns held's
    tuple."""
    from rmem_tpu_torch.kernels import local_attention as kl
    return held("local_attention", kl.local_attention(*args),
                kl.local_attention_plain(*args))


def sdpa_local(q, k, v, rel, size_2d, scale, g=None):
    """The library's call for K4's function: SDPA with the window, image
    mask and relative bias as a dense additive [B, h, HW, HW] mask. Returns
    (a function computing it, or with the output's cotangent `g` its
    forward and backward through autograd; the in-image (query, key) pairs
    of every head)."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.ops.attention import NEG_INF, _local_offset_map_on
    b, hw = q.shape[:2]
    heads = rel.shape[-1] // 225

    def heads_first(x):             # [B, HW, h*d] -> [B, h, HW, d]
        return x.reshape(b, hw, heads, -1).transpose(1, 2).contiguous()

    omap = _local_offset_map_on(*size_2d, 7, q.device)
    relp = torch.cat([heads_first(rel),
                      torch.full((b, heads, hw, 1), NEG_INF, dtype=rel.dtype,
                                 device=q.device)], dim=3)
    dense = torch.gather(relp, 3, omap.expand(b, heads, hw, hw))
    pairs = b * heads * (omap < 225).sum().item()
    ql, kl_, vl = heads_first(q), heads_first(k), heads_first(v)
    if g is None:
        return (lambda: F.scaled_dot_product_attention(
            ql, kl_, vl, attn_mask=dense, scale=scale), pairs)
    ins = [t.requires_grad_() for t in (ql, kl_, vl)]
    gl = heads_first(g)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(*ins, attn_mask=dense, scale=scale)
        torch.autograd.grad(o, ins, gl)
    return fwd_bwd, pairs


def k4_shape(dev, batch: int, gh: int, gw: int, heads: int = 1) -> dict:
    """K4 at one call shape: held against its plain version and timed
    beside SDPA with the dense bias on the same inputs."""
    from rmem_tpu_torch.kernels import local_attention as kl
    args = k4_inputs(dev, batch, gh, gw, heads)
    q, k, v, rel, size_2d, _, _, scale = args
    err, top, _ = held_k4(*args)
    lib, pairs = sdpa_local(q, k, v, rel, size_2d, scale)
    # widths over the heads; pairs counts every head's
    dh, dv, hw = q.shape[-1], v.shape[-1], gh * gw
    # q, k, v and rel read once, the output written once
    b_ms, b_by = bound(2.0 * pairs * (dh + dv) / heads,
                       batch * hw * (2 * dh + 2 * dv + rel.shape[-1]) * 2)
    # the kernel takes less device time than an eager call takes the host,
    # so its time is that of a CUDA graph of 20 calls (the eager one beside)
    r = dict(batch=batch, grid=[gh, gw], err=err, rel_err=err / top,
             ms=graph_ms(lambda: kl.local_attention(*args), 20),
             eager_ms=cuda_ms(lambda: kl.local_attention(*args), 50),
             library_ms=cuda_ms(lib, 20), bound_ms=b_ms, bound_by=b_by)
    r["library_ratio"] = r["ms"] / r["library_ms"]
    return r


# K8 in phase 2: the main path's grid at batch 1 (the shape the kernels-line
# row reports) and phase 7's two calls, batch 2 on the grids of scales 1.0
# and 1.3 (the only calls the opt-in route makes)
K8_SHAPES = {"b1_31x54": (1, 31, 54), "b2_31x54": (2, 31, 54),
             "b2_40x70": (2, 40, 70)}


def k8_shape(randn, wt, batch: int, gh: int, gw: int) -> dict:
    """K8 at one shape ([batch, gh * gw, C] bf16, C from the weight): held
    within one bf16 ulp of its plain version, timed from HBM (a CUDA graph
    cycling through input sets of at least K3_COLD_BYTES, twice the L2) and
    on one L2-resident set, beside its plain version, its bound and
    PyTorch's depthwise conv2d on the pre-gated map (the multiply not
    counted, channels last as the tail holds it), the same graph. K8 takes
    less device time than an eager call takes the host, hence the graphs."""
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import dwconv as kd
    from rmem_tpu_torch.ops.layers import seq_to_map
    c, hw = wt.shape[0], gh * gw
    set_bytes = 2 * batch * hw * c * 2
    nsets = K3_COLD_BYTES // set_bytes + 1
    sets = [(randn(batch, hw, c), randn(batch, hw, c)) for _ in range(nsets)]
    maps = [seq_to_map(a * b, (gh, gw)) for a, b in sets]
    dargs = (*sets[0], wt, (gh, gw))
    out, ref = kd.gated_dwconv(*dargs), kd.gated_dwconv_plain(*dargs)
    err, top, _ = held("gated_dwconv", out, ref)
    turn = itertools.count()

    def k8_call():
        a, b = sets[next(turn) % nsets]
        return kd.gated_dwconv(a, b, wt, (gh, gw))

    def conv_call():
        return F.conv2d(maps[next(turn) % nsets], wt, padding=2, groups=c)

    # x and gate read once, out written once; 25 multiply-adds an output
    b_ms, b_by = bound(2.0 * 25 * batch * hw * c,
                       3 * batch * hw * c * 2 + wt.numel() * 2)
    r = dict(ms=graph_ms(k8_call, 4 * nsets), sets=nsets,
             set_mb=set_bytes / 1e6,
             l2_resident_ms=graph_ms(lambda: kd.gated_dwconv(*dargs), 48),
             plain_ms=graph_ms(lambda: kd.gated_dwconv_plain(*dargs), 10),
             library_ms=graph_ms(conv_call, 4 * nsets), bound_ms=b_ms,
             bound_by=b_by, err=err, differ=int((out != ref).sum()))
    print(f"K8 gated_dwconv {batch}x{gh}x{gw}x{c}: {r['ms']:.4f} ms from HBM "
          f"({nsets} input sets, {r['set_mb']:.1f} MB each), "
          f"{r['l2_resident_ms']:.4f} ms on one set, plain {r['plain_ms']:.4f}"
          f" ms, depthwise conv2d {r['library_ms']:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); max|out-plain| {err:.3e} (max|plain| "
          f"{top:.3e}), {r['differ']} of {out.numel()} values differ")
    return r


def check_optin_kernels(dev):
    """Phase 2, the opt-in inference kernels in bf16: K3 (the slot-split
    bank attention; 9 valid slots of 10, dh 128, dv 1024) against its plain
    version at the main path's call (batch 1, Lq = Lk = 1674) and at phase
    7's (batch 2 on 31 x 54 and 40 x 70), each timed from HBM and
    L2-resident; and K8 (the gated depthwise conv, 1024 channels) at the
    same three shapes (K8_SHAPES, k8_shape). Returns {name: entry} without
    launch counts."""
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

    # ---- K3: 9 of 10 slots valid, the slot PE already in the keys, at
    # the main path's grid (batch 1) and at phase 7's calls (batch 2, the
    # two scales' grids) ----
    q, bk, bvv, cnt, scale = k3_inputs(dev)
    count = int(cnt)
    errs = [held_k3(q, bk, bvv, cnt, scale)]
    # the reference frame's call: one slot
    one = torch.ones((), dtype=torch.int32, device=dev)
    o1, r1 = kb.bank_attention_qminor(q, bk[:1], bvv[:1], one, 1, scale)
    errs.append(held("bank_attention_qminor", (o1, r1),
                     kb.bank_attention_qminor_plain(q, bk[:1], bvv[:1], one,
                                                    1, scale)))
    check(torch.allclose(r1, torch.ones_like(r1), atol=1e-4), "K3 S=1 mass")
    shapes = {}
    for key, (nb, gh, gw) in K3_SHAPES.items():
        shapes[key] = k3_shape(dev, nb, gh, gw, errs)
    main = shapes["b1_31x54"]
    main["split_ms"] = kernel_split_ms(
        lambda: kb.bank_attention_qminor(q, bk, bvv, cnt, 1, scale))
    print("K3 by kernel at b1_31x54 (profiler, ms a call): " + ", ".join(
        f"{k[:40]} {v:.4f}" for k, v in main["split_ms"].items()))
    err = max(e for e, _, _ in errs)
    rerr = max(m for _, _, m in errs)
    for key, r in shapes.items():
        print(f"K3 bank_attention_qminor {key}: {r['ms']:.4f} ms from HBM "
              f"({r['sets']} input sets, {r['set_mb']:.1f} MB each), "
              f"{r['l2_resident_ms']:.4f} ms on one set; bound "
              f"{r['bound_ms']:.4f} ms")
    print(f"K3: max|out-plain| {err:.3e} (max|plain| {errs[0][1]:.3e}), "
          f"max|rec-plain| {rerr:.3e} over {len(errs)} calls; "
          f"{kb.SLOTS_PER_BLOCK} slots a block; partial scratch "
          f"{-(-S // kb.SLOTS_PER_BLOCK) * hw * dv * 2 / 1e6:.1f} MB (bf16)")
    kv = count * hw
    k_lib = bk[:count].reshape(1, 1, kv, dh)
    v_lib = bvv[:count].reshape(1, 1, kv, dv)
    entries["bank_attention_qminor"] = dict(
        name="bank_attention_qminor", route="cuda",
        source="rmem_tpu_torch/csrc/bank_attention_infer.cu",
        replaces="rmem_tpu/kernels/bank_attention.py:540",
        max_abs_err=err, max_abs_err_rec=rerr,
        ms=main["ms"],
        plain_ms=cuda_ms(lambda: kb.bank_attention_qminor_plain(
            q, bk, bvv, cnt, 1, scale), 5),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k_lib, v_lib, scale=scale), 20),
        l2_resident_ms=main["l2_resident_ms"], shapes=shapes)

    # ---- K8: the gated tail's product and 5 x 5 depthwise conv, at the
    # main path's grid (batch 1) and at phase 7's calls (batch 2, the two
    # scales' grids) ----
    c = 1024
    wt = randn(c, 1, 5, 5, scale=0.2)
    k8_shapes = {key: k8_shape(randn, wt, *shape)
                 for key, shape in K8_SHAPES.items()}
    main = k8_shapes["b1_31x54"]
    x, gate = randn(1, hw, c), randn(1, hw, c)
    dargs = (x, gate, wt, (h, w))
    xg_map = seq_to_map(x * gate, (h, w))
    entries["gated_dwconv"] = dict(
        name="gated_dwconv", route="cuda",
        source="rmem_tpu_torch/csrc/gated_dwconv.cu",
        replaces="rmem_tpu/kernels/dwconv.py:51",
        max_abs_err=max(r["err"] for r in k8_shapes.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        l2_resident_ms=main["l2_resident_ms"],
        eager_ms=cuda_ms(lambda: kd.gated_dwconv(*dargs), 50),
        library_eager_ms=cuda_ms(lambda: F.conv2d(xg_map, wt, padding=2,
                                                  groups=c), 50),
        shapes=k8_shapes)
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries


def check_two_head_kernels(dev):
    """Phase 2, the serving kernels at no_memory_gap's 2 heads of 128
    (values 512 a head, the bias 2 x 225): K1 at K1_CASES beside SDPA over
    the valid slots (heads_entry), K3 at the main path's call and phase 7's
    two batch-2 grids (from HBM and L2-resident, as K3's row) beside SDPA
    over the valid slots, and K4 at the main path's call and phase 7's two
    grids beside SDPA with the dense bias, and on a ragged grid. Returns
    {name: entry} without launch counts."""
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl

    entries = {"bank_attention_h2": heads_entry(dev, "bank_attention_h2")}

    errs, shapes = [], {}
    for key, (nb, gh, gw) in K3_SHAPES.items():
        shapes[key] = k3_shape(dev, nb, gh, gw, errs, heads=2)
        print(f"K3x2 bank_attention_qminor {key}: {shapes[key]['ms']:.4f} ms "
              f"from HBM ({shapes[key]['sets']} input sets), "
              f"{shapes[key]['l2_resident_ms']:.4f} ms on one set; bound "
              f"{shapes[key]['bound_ms']:.4f} ms")
    q, bk, bvv, cnt, scale = k3_inputs(dev, heads=2)
    count, hw = int(cnt), q.shape[1]
    kv = count * hw

    def heads_first(x, n):          # [1, n, 2*d] -> [1, 2, n, d]
        return x.reshape(1, n, 2, -1).transpose(1, 2).contiguous()

    libs = [heads_first(q, hw)] + [
        heads_first(t[:count].reshape(1, kv, t.shape[-1]), kv)
        for t in (bk, bvv)]
    main = shapes["b1_31x54"]
    entries["bank_attention_qminor_h2"] = dict(
        name="bank_attention_qminor_h2", route="cuda", heads=2,
        source="rmem_tpu_torch/csrc/bank_attention_infer.cu",
        replaces="rmem_tpu/kernels/bank_attention.py:540",
        max_abs_err=max(e for e, _, _ in errs),
        max_abs_err_rec=max(m for _, _, m in errs), ms=main["ms"],
        plain_ms=cuda_ms(lambda: kb.bank_attention_qminor_plain(
            q, bk, bvv, cnt, 2, scale), 5),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            *libs, scale=scale), 20),
        l2_resident_ms=main["l2_resident_ms"], shapes=shapes)
    e = entries["bank_attention_qminor_h2"]
    print(f"K3x2: max|out-plain| {e['max_abs_err']:.3e}, max|rec-plain| "
          f"{e['max_abs_err_rec']:.3e} over {len(errs)} calls; plain "
          f"{e['plain_ms']:.4f} ms, SDPA over the 9 valid slots "
          f"{e['library_ms']:.4f} ms")

    shapes = {key: k4_shape(dev, *shape, heads=2)
              for key, shape in K4_SHAPES.items()}
    for key, r in shapes.items():
        print(f"K4x2 local_attention {key}: {r['ms']:.4f} ms (eager "
              f"{r['eager_ms']:.4f}), SDPA with the dense bias "
              f"{r['library_ms']:.4f} ms ({r['library_ratio']:.3f}x), bound "
              f"{r['bound_ms']:.5f} ms, max|out-plain| / max|plain| "
              f"{r['rel_err']:.3e}")
    ragged = held_k4(*k4_inputs(dev, 2, 13, 21, heads=2))
    main = shapes["b1_31x54"]
    largs = k4_inputs(dev, *K4_SHAPES["b1_31x54"], heads=2)
    entries["local_attention_h2"] = dict(
        name="local_attention_h2", route="cuda", heads=2,
        source="rmem_tpu_torch/csrc/local_attention.cu",
        replaces="rmem_tpu/kernels/local_attention.py:133",
        max_abs_err=max([r["err"] for r in shapes.values()] + [ragged[0]]),
        ms=main["ms"],
        plain_ms=cuda_ms(lambda: kl.local_attention_plain(*largs), 5),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shapes=shapes)
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries


def k3_inputs(dev, batch: int = 1, grid=None, seed: int = 3,
              heads: int = 1):
    """K3's inputs at a bank-attention call of the serving path (bf16, 10
    slots, 9 valid, `heads` heads of 128, values 1024 over the heads, Lq =
    Lk = the grid's cells; by default batch 1 on the 31 x 54 grid of 481 x
    849): (q, bank_k, bank_v, count, scale); the head count is q's width
    over 128."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    gh, gw = grid or ((IN_HW[0] - 1) // 16 + 1, (IN_HW[1] - 1) // 16 + 1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    hw, S = gh * gw, 10
    return (randn(batch, hw, 128 * heads, scale=2.0),
            randn(S, batch, hw, 128 * heads), randn(S, batch, hw, 1024),
            torch.tensor(9, dtype=torch.int32, device=dev), 128 ** -0.5)


def held_k3(q, bank_k, bank_v, count, scale):
    """One K3 call against its plain version (output and slot mass, see
    held); the empty slots' mass must be 0. Returns held's tuple."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    heads = q.shape[-1] // 128
    out, rec = kb.bank_attention_qminor(q, bank_k, bank_v, count, heads,
                                        scale)
    errs = held("bank_attention_qminor", (out, rec),
                kb.bank_attention_qminor_plain(q, bank_k, bank_v, count,
                                               heads, scale))
    check(bool(torch.all(rec[..., int(count):] == 0)),
          "K3 mass of empty slots")
    return errs


def k3_shape(dev, batch: int, gh: int, gw: int, errs: list,
             heads: int = 1) -> dict:
    """K3 at one call shape: held against its plain version on each input
    set (appended to errs), timed over input sets that together exceed the
    50 MB L2 (so the bank comes from HBM, as the bound counts it) and on
    one L2-resident set. Returns the shape's timings. (K1 is the same
    kernel with the bias; phase 2 times it beside K3 on its own inputs.)"""
    from rmem_tpu_torch.kernels import bank_attention as kb
    one = k3_inputs(dev, batch, (gh, gw), heads=heads)
    q, bk, bvv, cnt, _ = one
    set_bytes = sum(t.numel() * t.element_size() for t in (q, bk, bvv))
    n_sets = max(1, -(-K3_COLD_BYTES // set_bytes))
    sets = [one] + [k3_inputs(dev, batch, (gh, gw), seed=100 + i,
                              heads=heads) for i in range(1, n_sets)]
    for a in sets:
        errs.append(held_k3(*a))
    turn = itertools.count()

    def cycling(fn):
        def call():
            a = sets[next(turn) % len(sets)]
            return fn(*a)
        return call

    k3 = lambda q_, k_, v_, c_, s_: kb.bank_attention_qminor(q_, k_, v_, c_,
                                                             heads, s_)
    # the bound in widths over the heads: heads x (dh + dv) a head
    hw, count = gh * gw, int(cnt)
    kv = count * hw
    dh, dv = bk.shape[-1], bvv.shape[-1]
    b_ms, b_by = bound(2.0 * batch * hw * kv * (dh + dv),
                       batch * (hw * dh + kv * (dh + dv) + hw * dv) * 2
                       + batch * hw * bk.shape[0] * 4)
    r = dict(batch=batch, grid=[gh, gw], sets=n_sets,
             set_mb=set_bytes / 1e6, ms=cuda_ms(cycling(k3), 20),
             l2_resident_ms=cuda_ms(lambda: k3(*one), 20),
             bound_ms=b_ms, bound_by=b_by)
    return r


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in f32."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def held_k2(q, bank_k, bank_v, count, dout, drec, scale):
    """K2 on one call's inputs: the forward (K1 with lse), the split
    backward's dq, dk and dv kernels against their plain form on the same
    inputs (held_split_call), and the whole backward against autograd of
    the plain forward. Returns {check: max |kernel - plain| / max |plain|},
    failing the run past GRAD_TOL (K1's outputs past OUT_TOL, lse past
    LSE_TOL absolute)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    n = int(count)
    out, rec, lse = kb.bank_attention_lse(q, bank_k, bank_v, count, scale)
    ref_out, ref_rec = kb.bank_attention_plain(q.float(), bank_k, bank_v,
                                               count, 1, scale)
    logits = torch.einsum("bqd,sbkd->bqsk", q.float(), bank_k[:n].float())
    ref_lse = (logits * scale).reshape(q.shape[0], q.shape[1], -1)
    ref_lse = ref_lse.logsumexp(-1)
    on_grid = (out - out.to(torch.bfloat16).float()).abs() <= (
        2 ** -20 * out.abs())
    errs = {"out": rel_err(out, ref_out),
            "rec": (rec - ref_rec).abs().max().item(),
            "lse": (lse - ref_lse).abs().max().item(),
            "out_on_bf16_grid": on_grid[out != 0].float().mean().item()}
    delta_h = kb.bwd_delta_mh(dout, out, drec, rec[:, None])
    (dq, dk, dv), call_errs = held_split_call(
        q, bank_k, bank_v, count, dout, lse[:, None], delta_h, drec, scale,
        "K2")
    errs.update(call_errs)
    gq, gk, gv = kb.bank_attention_bwd_plain(q, bank_k, bank_v, count, dout,
                                             drec, scale)
    errs["whole_dq"] = rel_err(dq, gq)
    errs["whole_dk"] = rel_err(dk, gk)
    errs["whole_dv"] = rel_err(dv, gv)
    for key, err in errs.items():
        tol = {"out": OUT_TOL, "rec": MASS_TOL, "lse": LSE_TOL,
               "out_on_bf16_grid": ON_GRID_TOL}.get(key, GRAD_TOL)
        check(err <= tol, f"K1 lse / K2 {key}: {err} (tolerance {tol})")
    return errs


def k2_inputs(dev, count: int = 4):
    """K2's phase-2 inputs at the training shapes (B 4, a 30 x 30 grid,
    `count` valid slots of 10: 4, or 2 for one slot group; dh 128, dv 1024,
    bf16) with a nonzero drec. Returns (the generator, (q, bank_k, bank_v,
    count, dout, drec, scale))."""
    import torch
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    b, hw, dh, dv, S = TRAIN_B, TRAIN_GRID[0] * TRAIN_GRID[1], 128, 1024, 10
    q = randn(b, hw, dh, scale=2.0)
    bk, bvv = randn(S, b, hw, dh), randn(S, b, hw, dv)
    cnt = torch.tensor(count, dtype=torch.int32, device=dev)
    dout = randn(b, hw, dv, scale=0.1)
    drec = randn(b, hw, S, dtype=torch.float32)
    return g, (q, bk, bvv, cnt, dout, drec, dh ** -0.5)


def k5_inputs(dev, heads: int = 1, batch: int = TRAIN_B, grid=TRAIN_GRID):
    """K5's phase-2 inputs, by default at the training shapes (B 4, a 30 x
    30 grid; `heads` heads of 128, values 1024 over the heads, the bias 225
    a head; bf16): (q, k, v, rel, g, size_2d, heads, max_dis, scale), g the
    output's cotangent. Two heads are no_memory_gap's."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    b, hw, dh, dv = batch, grid[0] * grid[1], 128 * heads, 1024
    return (randn(b, hw, dh, scale=2.0), randn(b, hw, dh), randn(b, hw, dv),
            randn(b, hw, 225 * heads), randn(b, hw, dv, scale=0.1),
            tuple(grid), heads, 7, 128 ** -0.5)


def held_k5(q, k, v, rel, g, size_2d, num_heads, max_dis, scale,
            kernel=None):
    """K5's backward kernels on one call's inputs (through `kernel`, by
    default `local_attention_bwd`) against their plain version
    (`local_attention_bwd_plain`) and against autograd of the plain
    forward, on each of dq, dk, dv and drel. Returns {check: max |kernel -
    reference| / max |reference|}, failing the run past GRAD_TOL; with a
    `kernel`, (its outputs, that dict)."""
    import torch

    from rmem_tpu_torch.kernels import local_attention as kl
    args = (size_2d, num_heads, max_dis, scale)
    got = (kernel or kl.local_attention_bwd)(q, k, v, rel, g, *args)
    plain = kl.local_attention_bwd_plain(q, k, v, rel, g, *args)
    ins = [t.detach().float().requires_grad_() for t in (q, k, v, rel)]
    # a held call inside a training step's backward runs with grad mode off
    # and may sit under its bf16 autocast: the plain forward needs neither
    with torch.enable_grad(), torch.autocast(q.device.type, enabled=False):
        auto = torch.autograd.grad(kl.local_attention_plain(*ins, *args),
                                   ins, g.float())
    errs = {}
    for name, a, p, r in zip(("dq", "dk", "dv", "drel"), got, plain, auto):
        errs[f"{name}_plain"] = rel_err(a, p)
        errs[f"{name}_autograd"] = rel_err(a, r)
    for key, err in errs.items():
        check(err <= GRAD_TOL, f"K5 backward {key}: {err} (tolerance "
              f"{GRAD_TOL})")
    return errs if kernel is None else (got, errs)


# K5's backward: the key side's value columns a dv block
# (csrc/local_attention.cu's BWD_NVK)
K5_DV_BLOCK = 512


def k5_kernel_rows(q, k, v, rel, g, size_2d, heads, max_dis, scale,
                   split_ms: dict) -> dict:
    """K5's backward by kernel: each kernel's device time a call (from
    `split_ms`, the profiler's) beside its bound (each tensor it reads
    read once, each it writes written once, and the window pairs' products
    at the peak rate) and `design_ms`, its own products at the peak rate:
    each 8 x 8 tile's halo cells inside the image, in 64-cell chunks, as
    the kernels count them (S, dp and dq's hi/lo pair on the query side;
    S^T and P^T G for each dv block of K5_DV_BLOCK columns and dk's pair on
    the key side)."""
    b, hw = q.shape[:2]
    dh, dv = q.shape[-1] // heads, v.shape[-1] // heads
    gh, gw = size_2d
    chunks = 0
    for y0 in range(0, gh, 8):
        for x0 in range(0, gw, 8):
            ny = min(21, gh - 1 - y0 + 7) - max(0, 7 - y0) + 1
            nx = min(21, gw - 1 - x0 + 7) - max(0, 7 - x0) + 1
            chunks += -(-ny * nx // 64)
    spans = 2.0 * 64 * 64 * chunks * b * heads
    nbq, nbk, nbv, nbr = (t.numel() * 2 for t in (q, k, v, rel))
    lse = b * heads * hw * 4
    design = {"query": spans * (dh + dv + 2 * dh),
              "key": spans * ((dv // K5_DV_BLOCK) * (dh + K5_DV_BLOCK)
                              + 2 * dh)}
    # q, k, v, g, rel in; dq, drel (f32), lse out | q, k, g, rel, lse,
    # drel in; dk, dv out. The window pairs' products: S, dp, dq | dv, dk
    pairs = 2.0 * b * heads * sum(
        (min(gh - 1, y + max_dis) - max(0, y - max_dis) + 1)
        * (min(gw - 1, x + max_dis) - max(0, x - max_dis) + 1)
        for y in range(gh) for x in range(gw))
    work = {"query": (pairs * (2 * dh + dv), 2 * nbq + nbk + 2 * nbv + nbr
                      + 2 * nbr + lse),
            "key": (pairs * (dv + dh), nbq + 2 * nbk + 2 * nbv + nbr + lse
                    + 2 * nbr)}
    rows = {}
    for side, (flops, nbytes) in work.items():
        name = next((n for n in split_ms if f"bwd_{side}_kernel" in n), None)
        b_ms, b_by = bound(flops, nbytes)
        rows[side] = dict(kernel=name, ms=split_ms.get(name), bound_ms=b_ms,
                          bound_by=b_by,
                          design_ms=design[side] / PEAK_BF16_FLOPS * 1e3)
    return rows


def k5_rows_text(rows: dict) -> str:
    return "; ".join(
        f"{side} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f}, {r['bound_by']};"
        f" design {r['design_ms']:.4f} at the peak rate)"
        for side, r in rows.items() if r["ms"] is not None)


# K1'h and K2h in phase 2: AOT's training calls (B 4, a 30 x 30 grid, 8
# heads of 32) with 4 and 2 valid slots of 10, and the reference frame's
# single slot
K1PH_CASES = {"four_slots": dict(count=4), "two_slots": dict(count=2),
              "reference": dict(slots=1, count=1)}
# H100 SXM special-function units: 16 exponentials a clock on each of 132
# SMs at the 1.98 GHz boost clock (NVIDIA's Hopper white paper)
PEAK_SFU_OPS = 16 * 132 * 1.98e9


def k1ph_inputs(dev, slots: int = 10, count: int = 4, cancel: bool = False):
    """K1'h's and K2h's phase-2 inputs at AOT's training call (B 4, a 30 x
    30 grid, 8 heads of 32, bf16) with a nonzero drec: (q, bank_k, bank_v,
    count, dout, drec, scale). With `cancel`, every key is one shared row
    plus 0.03 of noise, as k2x2_inputs gives them: ds K nearly cancels, so
    dq shows ds's lo plane."""
    import torch
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    b, hw = TRAIN_B, TRAIN_GRID[0] * TRAIN_GRID[1]
    q = randn(b, hw, 256, scale=2.0)
    if cancel:
        bk = (randn(1, 1, 1, 256, dtype=torch.float32)
              + randn(slots, b, hw, 256, dtype=torch.float32, scale=0.03)
              ).to(torch.bfloat16)
        bv = randn(slots, b, hw, 256)
    else:
        bk, bv = randn(slots, b, hw, 256), randn(slots, b, hw, 256)
    return (q, bk, bv, torch.tensor(count, dtype=torch.int32, device=dev),
            randn(b, hw, 256, scale=0.1),
            randn(b, hw, slots, dtype=torch.float32), 32 ** -0.5)


def held_k1ph(q, bank_k, bank_v, count, scale, heads: int = 8,
              kernel=None):
    """K1'h (8 heads of 32) or, with heads=2, K1'x2 (K1' at no_memory_gap's
    2 heads of 128) on one call's inputs (`kernel`, by default the wrapper)
    against its plain version on the valid slots: the output (OUT_TOL of
    its max), each head's slot mass (MASS_TOL) and lse (LSE_TOL), the share
    of the output on the bf16 grid (ON_GRID_TOL), and each head's mass
    exactly 0 past count. Returns ((out, rec_h, lse_h), {check: error})."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    n = int(count)
    label = "K1'h" if heads == 8 else "K1'x2"
    if heads == 8:
        out, rec_h, lse_h = (kernel or kb.bank_attention_lse_mh)(
            q, bank_k, bank_v, count, scale)
    else:
        out, rec_h, lse_h = (kernel or kb.bank_attention_lse)(
            q, bank_k, bank_v, count, scale, heads)
    ref_out, ref_rec, ref_lse = kb.bank_attention_lse_mh_plain(
        q, bank_k[:n], bank_v[:n], count, scale, heads)
    on_grid = (out - out.to(torch.bfloat16).float()).abs() <= (
        2 ** -20 * out.abs())
    errs = {"out": rel_err(out, ref_out),
            "rec": (rec_h[..., :n] - ref_rec).abs().max().item(),
            "lse": (lse_h - ref_lse).abs().max().item(),
            "out_on_bf16_grid": on_grid[out != 0].float().mean().item()}
    for key, err in errs.items():
        tol = {"out": OUT_TOL, "rec": MASS_TOL, "lse": LSE_TOL,
               "out_on_bf16_grid": ON_GRID_TOL}[key]
        check(err <= tol, f"{label} {key}: {err} (tolerance {tol})")
    check(bool((rec_h[..., n:] == 0).all()), f"{label} mass of empty slots")
    return (out, rec_h, lse_h), errs


def held_k2h_call(q, bank_k, bank_v, count, out, rec_h, lse_h, dout, drec,
                  scale, kernel=None):
    """One K2h call (`kernel`, by default the wrapper) against its two plain
    stages on the valid slots (GRAD_TOL of each output's max), and its dk
    and dv exactly 0 in slots >= count. The kernel computes the row term
    from the forward's f32 `out` and `rec_h`; the plain stages take the same
    lse_h and bwd_delta_mh's. The blocks the call allocates dk and dv from
    are filled with NaN first, so a slot the kernel leaves unwritten shows.
    Returns ((dq, dk, dv), {check: error})."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    n = int(count)
    poison = [torch.full_like(bank_k, float("nan")) for _ in range(2)]
    del poison
    dq, dk, dv = (kernel or kb.bank_attention_bwd_mh)(
        q, bank_k, bank_v, count, out, rec_h, lse_h, dout, drec, scale)
    args = (q, bank_k[:n], bank_v[:n], count, dout, lse_h,
            kb.bwd_delta_mh(dout, out, drec, rec_h),
            drec[..., :n].contiguous(), scale)
    rdk, rdv = kb.bank_attention_bwd_mh_dkv_plain(*args)
    errs = {"dq": rel_err(dq, kb.bank_attention_bwd_mh_dq_plain(*args)),
            "dk": rel_err(dk[:n], rdk), "dv": rel_err(dv[:n], rdv)}
    for key, err in errs.items():
        check(err <= GRAD_TOL, f"K2h {key}: {err} (tolerance {GRAD_TOL})")
    check(bool((dk[n:] == 0).all() and (dv[n:] == 0).all()),
          "K2h gradients of invalid slots are not 0")
    return (dq, dk, dv), errs


def held_k2x2v128_call(q, bank_k, bank_v, count, dout, lse_h, delta_h,
                       drec, scale):
    """One K2x2v128 call (the fused pair at 2 heads of 128 with values 128
    a head, the wrapper `bank_attention_bwd_fused`: the dkv kernel, the dq
    kernel and the sum of its slot groups' partials) against its plain
    version on the valid slots, fed the same lse_h and delta_h: dq, dk and
    dv against `bank_attention_bwd_fused_plain` (GRAD_TOL of each one's
    max), and dk and dv exactly 0 in slots >= count. The blocks the call
    allocates dk and dv from are filled with NaN first, so a slot the
    kernel leaves unwritten shows. Returns ((dq, dk, dv), {check:
    error})."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    n = int(count)
    poison = [torch.full_like(t, float("nan")) for t in (bank_k, bank_v)]
    del poison
    dq, dk, dv = kb.bank_attention_bwd_fused(q, bank_k, bank_v, count, dout,
                                             lse_h, delta_h, drec, scale)
    rdq, rdk, rdv = kb.bank_attention_bwd_fused_plain(
        q, bank_k[:n], bank_v[:n], count, dout, lse_h, delta_h,
        drec[..., :n].contiguous(), scale)
    errs = {"dq": rel_err(dq, rdq), "dk": rel_err(dk[:n], rdk),
            "dv": rel_err(dv[:n], rdv)}
    for key, err in errs.items():
        check(err <= GRAD_TOL,
              f"K2x2v128 {key}: {err} (tolerance {GRAD_TOL})")
    check(bool((dk[n:] == 0).all() and (dv[n:] == 0).all()),
          "K2x2v128 gradients of invalid slots are not 0")
    return (dq, dk, dv), errs


def held_split_call(q, bank_k, bank_v, count, dout, lse_h, delta_h, drec,
                    scale, label: str):
    """One call of K2's split backward (the wrapper
    `bank_attention_bwd_split`: the dq kernel with the sum of its slot
    groups' partials, the dk kernel and the dv kernel) against its plain
    form on the valid slots, fed the same lse_h and delta_h [B, h, Lq]: dq,
    dk and dv against `bank_attention_bwd_split_plain` (GRAD_TOL of each
    one's max), and dk and dv exactly 0 in slots >= count. The blocks the
    call allocates dk and dv from are filled with NaN first, so a slot or a
    value group the kernels leave unwritten shows. Returns ((dq, dk, dv),
    {check: error})."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    n = int(count)
    poison = [torch.full_like(t, float("nan")) for t in (bank_k, bank_v)]
    del poison
    dq, dk, dv = kb.bank_attention_bwd_split(q, bank_k, bank_v, count, dout,
                                             lse_h, delta_h, drec, scale)
    rdq, rdk, rdv = kb.bank_attention_bwd_split_plain(
        q, bank_k[:n], bank_v[:n], count, dout, lse_h, delta_h,
        drec[..., :n].contiguous(), scale)
    errs = {"dq": rel_err(dq, rdq), "dk": rel_err(dk[:n], rdk),
            "dv": rel_err(dv[:n], rdv)}
    for key, err in errs.items():
        check(err <= GRAD_TOL, f"{label} {key}: {err} (tolerance {GRAD_TOL})")
    check(bool((dk[n:] == 0).all() and (dv[n:] == 0).all()),
          f"{label} gradients of invalid slots are not 0")
    return (dq, dk, dv), errs


def held_k2x2_call(q, bank_k, bank_v, count, dout, lse_h, delta_h, drec,
                   scale):
    """One K2x2 call at no_memory_gap's 2 heads of 128 against its plain
    form (held_split_call: K2's split kernels at values 512 a head), or at
    values 128 a head the fused route's call (held_k2x2v128_call). Returns
    ((dq, dk, dv), {check: error})."""
    from rmem_tpu_torch.kernels import bank_attention as kb
    if kb.bwd_route(2, 128, bank_v.shape[-1] // 2) == "fused":
        return held_k2x2v128_call(q, bank_k, bank_v, count, dout, lse_h,
                                  delta_h, drec, scale)
    return held_split_call(q, bank_k, bank_v, count, dout, lse_h, delta_h,
                           drec, scale, "K2x2")


def held_k2h(q, bank_k, bank_v, count, dout, drec, scale, heads: int = 8,
             plain_forward: bool = False):
    """K1'h then K2h on one call's inputs (held_k1ph, held_k2h_call), or
    with heads=2 K1'x2 then K2x2 (held_k2x2_call), and the backward's
    outputs against autograd of the plain forward on the valid slots
    (GRAD_TOL). With `plain_forward` (keys that nearly cancel), the
    backward is held a second time, fed the plain forward's f32 output,
    slot mass and lse (bank_attention_lse_plain), and that call's outputs
    are the ones held against autograd; the first call's dq against
    autograd (`kfwd_whole_dq`) and the move of the row term between the
    two forwards (`kfwd_delta`) are readings, not held: there the kernel
    forward's bf16 P.V moves delta, and dq with it, past GRAD_TOL (the
    CPU test test_cancelling_keys_dq_follows_the_forwards_rounding
    reproduces it). Returns {check: error}."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    n = int(count)
    label = "K2h" if heads == 8 else "K2x2"
    (out, rec_h, lse_h), errs = held_k1ph(q, bank_k, bank_v, count, scale,
                                          heads)
    delta_h = kb.bwd_delta_mh(dout, out, drec, rec_h)

    def call(out, rec_h, lse_h, delta_h):
        # at 8 heads training's call: the kernel computes the row term from
        # the forward's output and slot mass
        if heads == 8:
            return held_k2h_call(q, bank_k, bank_v, count, out, rec_h, lse_h,
                                 dout, drec, scale)
        return held_k2x2_call(q, bank_k, bank_v, count, dout, lse_h, delta_h,
                              drec, scale)
    (dq, dk, dv), call_errs = call(out, rec_h, lse_h, delta_h)
    errs.update(call_errs)
    ins = [t.detach().float().requires_grad_()
           for t in (q, bank_k[:n], bank_v[:n])]
    o, r = kb.bank_attention_plain(*ins, count, heads, scale)
    auto = torch.autograd.grad((o, r), ins,
                               (dout.float(), drec[..., :n].float()))
    if plain_forward:
        errs["kfwd_whole_dq"] = rel_err(dq, auto[0])
        out, rec_h, lse_h = kb.bank_attention_lse_plain(q, bank_k, bank_v,
                                                        count, scale, heads)
        plain_delta = kb.bwd_delta_mh(dout, out, drec, rec_h)
        errs["kfwd_delta"] = rel_err(delta_h, plain_delta)
        (dq, dk, dv), call_errs = call(out, rec_h, lse_h, plain_delta)
        errs.update({key + "_pfwd": e for key, e in call_errs.items()})
    for key, got, ref in (("whole_dq", dq, auto[0]),
                          ("whole_dk", dk[:n], auto[1]),
                          ("whole_dv", dv[:n], auto[2])):
        errs[key] = rel_err(got, ref)
        check(errs[key] <= GRAD_TOL,
              f"{label} {key}: {errs[key]} (tolerance {GRAD_TOL})")
    return errs


def check_aot_train_kernels(dev):
    """Phase 2, AOT's training rows: K1'h at K1PH_CASES and K2h after each,
    held (held_k2h; K2h also on keys that nearly cancel, fed the plain
    forward), and timed at 4 valid slots beside their plain versions,
    bounds and SDPA over the valid slots' keys flattened to [B, 8, Lq,
    count * Lk] (the backward's: forward + backward less forward). K2h's
    time is the whole backward as training calls it, the row term
    included, with its device time by kernel (profiler), and its time
    handed the row term beside it. Returns {name: entry} without launch
    counts."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    cases = {}
    for key, kw in K1PH_CASES.items():
        args = k1ph_inputs(dev, **kw)
        q, bk, bv, cnt, dout, drec, scale = args
        k1ph = lambda: kb.bank_attention_lse_mh(q, bk, bv, cnt, scale)
        cases[key] = dict(errs=held_k2h(*args), ms=cuda_ms(k1ph, 20),
                          **issue_ms(k1ph))
        print(f"K1'h + K2h {key} {kw}: K1'h {cases[key]['ms']:.4f} ms"
              + issue_text(cases[key]) + "; max|kernel - plain| / "
              "max|plain| (rec, lse absolute; the share of out on the bf16 "
              "grid): " + ", ".join(
                  f"{k} {v:.3e}" for k, v in cases[key]["errs"].items()))
    # keys that nearly cancel in ds K, where ds's lo plane must show
    cancelling = held_k2h(*k1ph_inputs(dev, cancel=True), plain_forward=True)
    print("K1'h + K2h on keys that cancel (k1ph_inputs cancel=True), 4 "
          "valid slots: " + ", ".join(f"{k} {v:.3e}"
                                      for k, v in cancelling.items()))
    q, bk, bv, cnt, dout, drec, scale = k1ph_inputs(dev)
    count, (S, b, lk, _), lq = int(cnt), bk.shape, q.shape[1]
    kv = count * lk
    out, rec_h, lse_h = kb.bank_attention_lse_mh(q, bk, bv, cnt, scale)
    delta_h = kb.bwd_delta_mh(dout, out, drec, rec_h)
    bargs = (q, bk, bv, cnt, dout, lse_h, delta_h, drec, scale)
    # the whole backward as _BankAttentionMH calls it: the rows kernel
    # computes the row term from the forward's output and slot mass
    whole_k2h = lambda: kb.bank_attention_bwd_mh(
        q, bk, bv, cnt, out, rec_h, lse_h, dout, drec, scale)

    def heads_first(x, n):          # [B, n, 256] -> [B, 8, n, 32]
        return x.reshape(b, n, 8, 32).transpose(1, 2).contiguous()

    lib = [heads_first(q, lq)] + [
        heads_first(t[:count].transpose(0, 1).reshape(b, kv, 256), kv)
        for t in (bk, bv)]
    lib_grad = [t.detach().requires_grad_() for t in lib]
    dout_lib = heads_first(dout, lq)

    def sdpa(backward: bool):
        o = F.scaled_dot_product_attention(*lib_grad, scale=scale)
        if backward:
            torch.autograd.grad(o, lib_grad, dout_lib)

    sdpa_fwd_ms = cuda_ms(lambda: sdpa(False), 20)
    # bytes: q, dout and the valid slots' keys and values read once; the
    # f32 output, lse and per-head mass (K1'h), and dq and every slot's dk,
    # dv (K2h, zeros included) written once, with the f32 row terms
    qb, kvb = b * lq * 256 * 2, 2 * b * kv * 256 * 2
    rows = {
        "bank_attention_lse_mh": dict(
            replaces="rmem_tpu/kernels/bank_attention.py:687",
            source="rmem_tpu_torch/csrc/bank_attention_mh.cu",
            ms=cases["four_slots"]["ms"],
            plain=lambda: kb.bank_attention_lse_mh_plain(q, bk, bv, cnt,
                                                         scale),
            flops=2.0 * b * lq * kv * (32 + 32) * 8,
            nbytes=qb + kvb + b * lq * 256 * 4 + b * 8 * lq * (S + 1) * 4,
            err=max(max(c["errs"]["out"], c["errs"]["lse"])
                    for c in cases.values()),
            library_ms=sdpa_fwd_ms),
        "bank_attention_bwd_mh": dict(
            replaces="rmem_tpu/kernels/bank_attention.py:581",
            source="rmem_tpu_torch/csrc/bank_attention_mh_bwd.cu",
            ms=cuda_ms(whole_k2h, 20),
            plain=lambda: (kb.bank_attention_bwd_mh_dq_plain(*bargs),
                           kb.bank_attention_bwd_mh_dkv_plain(*bargs)),
            flops=2.0 * b * lq * kv * 32 * 5 * 8,
            # q, dout, the valid keys and values, the f32 output, lse,
            # slot mass and drec read once; dq and every slot's dk, dv
            # written once
            nbytes=(2 * qb + kvb + b * lq * 256 * 4 + b * 8 * lq * 4
                    + b * 8 * lq * S * 4 + b * lq * S * 4
                    + qb + 2 * S * b * lk * 256 * 2),
            err=max(v for c in [*cases.values(), dict(errs=cancelling)]
                    for k, v in c["errs"].items()
                    if k.startswith(("d", "whole"))
                    and not k.startswith("kfwd")),
            library_ms=cuda_ms(lambda: sdpa(True), 20) - sdpa_fwd_ms),
    }
    entries = {}
    for name, r in rows.items():
        b_ms, b_by = bound(r["flops"], r["nbytes"])
        entries[name] = dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=cuda_ms(r["plain"], 3), bound_ms=b_ms, bound_by=b_by,
            library_ms=r["library_ms"])
    # p's exponentials: once in K1'h, once in each of K2h's two kernels
    exps = b * 8 * lq * kv
    entries["bank_attention_lse_mh"].update(
        exponentials=exps, sfu_ms=exps / PEAK_SFU_OPS * 1e3,
        cases={key: dict(ms=c["ms"], host_ms=c["host_ms"],
                         graph_ms=c["graph_ms"])
               for key, c in cases.items()})
    split_row(entries["bank_attention_lse_mh"],
              lambda: kb.bank_attention_lse_mh(q, bk, bv, cnt, scale),
              "K1'h at 4 valid slots")
    entries["bank_attention_bwd_mh"].update(
        exponentials=2 * exps, sfu_ms=2 * exps / PEAK_SFU_OPS * 1e3)
    split_row(entries["bank_attention_bwd_mh"], whole_k2h,
              "K2h's whole backward at 4 valid slots")
    for name, e in entries.items():
        print(f"{name}: {e['ms']:.4f} ms at 4 valid slots, plain "
              f"{e['plain_ms']:.4f} ms, SDPA over the valid slots "
              f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.5f} ms "
              f"({e['bound_by']}); {e['exponentials']:.3g} exponentials, "
              f"{e['sfu_ms']:.4f} ms on the special-function units")
    return entries


# K1'x2 and K2x2 in phase 2: no_memory_gap's training calls (B 4, a 30 x
# 30 grid, 2 heads of 128, values 512 a head) at 9 valid slots of 10 (the
# full bank, frames 9 to 14 of a clip), at 4 and at the reference frame's
# one; the rows' numbers are the 9-slot call's
K1PX2_CASES = {"nine_slots": dict(count=9), "four_slots": dict(count=4),
               "reference": dict(slots=1, count=1)}


def k2x2_inputs(dev, slots: int = 10, count: int = 9, values: int = 1024,
                cancel: bool = False):
    """K1'x2's and K2x2's phase-2 inputs at no_memory_gap's training call
    (B 4, a 30 x 30 grid, 2 heads of 128, `values` value columns over the
    heads: 1024 for R50-DeAOTL, 256 for R50-AOTL; bf16) with a nonzero
    drec: (q, bank_k, bank_v, count, dout, drec, scale). With `cancel`,
    every key is one shared row plus 0.03 of noise (as the slot PE adds one
    row to a slot's keys): ds's rows nearly cancel against it, so dq = ds K
    is a small difference of large terms, and ds in bf16 without its lo
    plane misses dq by ~0.1 of its max (the hi + lo pair by ~2e-4; CPU
    emulation at batch 1)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    b, hw = TRAIN_B, TRAIN_GRID[0] * TRAIN_GRID[1]
    q = randn(b, hw, 256, scale=2.0)
    if cancel:
        bk = (randn(1, 1, 1, 256, dtype=torch.float32)
              + randn(slots, b, hw, 256, dtype=torch.float32, scale=0.03)
              ).to(torch.bfloat16)
        bv = randn(slots, b, hw, values)
    else:
        bk, bv = randn(slots, b, hw, 256), randn(slots, b, hw, values)
    return (q, bk, bv, torch.tensor(count, dtype=torch.int32, device=dev),
            randn(b, hw, values, scale=0.1),
            randn(b, hw, slots, dtype=torch.float32), 128 ** -0.5)


def split_stages(fargs, pargs, suffix, b, lq, lk, S, count, dh, dv, rows_b,
                 sdpa_bwd_ms) -> dict:
    """K2's split kernels as k2x2_case's stages (and check_train_kernels'
    rows at one head): "bank_attention_bwd_split_dq" (the dq kernel and the
    sum of its slot groups' partials), "_dk" and "_dv", each + `suffix`,
    timed through `_split_call` on `fargs` (q, bank_k, bank_v, count, dout,
    lse2, rterm, scale) beside its output of the plain form on `pargs` (the
    valid slots); dh and dv the widths over the heads. The bound counts the
    function's products of each role (dq: S, G, dQ; dk: S, G, dK; dv: S,
    dV); `design_flops` the design's own (ds's lo plane in dQ and dK, S
    recomputed by each value group), the bytes each role must move."""
    from rmem_tpu_torch.kernels import bank_attention as kb
    kv = count * lk
    qb, kb_, vb = b * lq * dh * 2, kv * b * dh * 2, kv * b * dv * 2
    ob = b * lq * dv * 2
    groups = dv // (kb.SPLIT_DV_COLUMNS * (dh // 128))
    plain = lambda i: (lambda: kb.bank_attention_bwd_split_plain(*pargs)[i])
    pairs = 2.0 * b * lq * kv
    return {
        "bank_attention_bwd_split_dq" + suffix: dict(
            fn=lambda: kb._split_call("dq", *fargs), plain=plain(0),
            flops=pairs * (2 * dh + dv), design_flops=pairs * (3 * dh + dv),
            nbytes=qb + ob + kb_ + vb + rows_b + qb, library=None,
            sdpa_bwd_ms=sdpa_bwd_ms),
        "bank_attention_bwd_split_dk" + suffix: dict(
            fn=lambda: kb._split_call("dk", *fargs), plain=plain(1),
            flops=pairs * (2 * dh + dv), design_flops=pairs * (3 * dh + dv),
            nbytes=qb + ob + kb_ + vb + rows_b + S * b * lk * dh * 2,
            library=None, sdpa_bwd_ms=sdpa_bwd_ms),
        "bank_attention_bwd_split_dv" + suffix: dict(
            fn=lambda: kb._split_call("dv", *fargs), plain=plain(2),
            flops=pairs * (dh + dv), design_flops=pairs * (groups * dh + dv),
            nbytes=qb + ob + kb_ + rows_b + S * b * lk * dv * 2,
            library=None, sdpa_bwd_ms=sdpa_bwd_ms)}


def k2x2_case(args, suffix: str = "_h2") -> dict:
    """One K1'x2 + K2x2 call shape: each stage timed (CUDA events) beside
    its plain version, its bound and, where one exists, the library's call
    (SDPA over the valid slots' keys flattened to [B, 2, Lq, count * Lk];
    its backward as forward + backward less forward). Returns {stage:
    {ms, plain_ms, bound_ms, bound_by, library_ms}}, the stages K2x2's rows'
    names (ending in `suffix`) and "whole" (the row term and the kernels):
    at values 512 a head K2's split kernels (dq with the sum of its slot
    groups' partials, dk, dv), at values 128 a head the fused pair (dkv; dq
    with the sum), each backward stage also beside SDPA's whole backward
    (`sdpa_bwd_ms`) and the design's own products at the peak rate
    (`design_ms`), the whole with its device time by kernel (profiler)."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    q, bk, bv, cnt, dout, drec, scale = args
    (S, b, lk, _), lq, count = bk.shape, q.shape[1], int(cnt)
    kv = count * lk
    dh, dv = 256, bv.shape[-1]              # widths over the two heads
    fused = kb.bwd_route(2, 128, dv // 2) == "fused"
    out, rec_h, lse_h = kb.bank_attention_lse(q, bk, bv, cnt, scale, 2)
    delta_h = kb.bwd_delta_mh(dout, out, drec, rec_h)
    sargs = (q, bk[:count], bv[:count], cnt, dout, lse_h, delta_h,
             drec[..., :count].contiguous(), scale)

    def heads_first(x, n):          # [B, n, 2*d] -> [B, 2, n, d]
        return x.reshape(b, n, 2, -1).transpose(1, 2).contiguous()

    lib = [heads_first(q, lq)] + [
        heads_first(t[:count].transpose(0, 1).reshape(b, kv, t.shape[-1]),
                    kv) for t in (bk, bv)]
    lib_grad = [t.detach().requires_grad_() for t in lib]
    dout_lib = heads_first(dout, lq)

    def sdpa(backward: bool):
        o = F.scaled_dot_product_attention(*lib_grad, scale=scale)
        if backward:
            torch.autograd.grad(o, lib_grad, dout_lib)

    sdpa_fwd_ms = cuda_ms(lambda: sdpa(False), 10)
    sdpa_bwd_ms = cuda_ms(lambda: sdpa(True), 10) - sdpa_fwd_ms
    # bytes: inputs read once (valid slots only), outputs written once
    qb, kb_, vb = b * lq * dh * 2, kv * b * dh * 2, kv * b * dv * 2
    ob, sb = b * lq * dv * 2, b * 2 * lq * 4
    stages = {
        "bank_attention_lse" + suffix: dict(
            fn=lambda: kb.bank_attention_lse(q, bk, bv, cnt, scale, 2),
            plain=lambda: kb.bank_attention_lse_plain(q, bk, bv, cnt, scale,
                                                      2),
            flops=2.0 * b * lq * kv * (dh + dv),
            nbytes=qb + kb_ + vb + 2 * ob + b * 2 * lq * S * 4 + sb,
            library=sdpa_fwd_ms)}
    lse2, rterm = kb.fused_rows(lse_h, delta_h, drec)
    fargs = (q, bk, bv, cnt, dout, lse2, rterm, scale)
    # the row arrays: lse2 and each valid slot's rterm, f32
    rows_b = (b * 2 * lse2.shape[-1] * (1 + count)) * 4
    if fused:
        stages.update({
            # the bound counts the function's products (dkv: S^T, G^T, dV,
            # dK; dq: S, G, dQ); `design_flops` adds the design's own, ds's
            # lo plane in dK or dQ
            "bank_attention_bwd_fused_dkv" + suffix: dict(
                fn=lambda: kb._fused_call("dkv", *fargs),
                plain=lambda: kb.bank_attention_bwd_mh_dkv_plain(*sargs),
                flops=2.0 * b * lq * kv * (2 * dh + 2 * dv),
                design_flops=2.0 * b * lq * kv * (3 * dh + 2 * dv),
                nbytes=qb + ob + kb_ + vb + rows_b
                + S * b * lk * (dh + dv) * 2,
                library=None, sdpa_bwd_ms=sdpa_bwd_ms),
            "bank_attention_bwd_fused_dq" + suffix: dict(
                fn=lambda: kb._fused_call("dq", *fargs),
                plain=lambda: kb.bank_attention_bwd_fused_plain(*sargs)[0],
                flops=2.0 * b * lq * kv * (2 * dh + dv),
                design_flops=2.0 * b * lq * kv * (3 * dh + dv),
                nbytes=qb + ob + kb_ + vb + rows_b + qb,
                library=None, sdpa_bwd_ms=sdpa_bwd_ms)})
    else:
        stages.update(split_stages(fargs, sargs, suffix, b, lq, lk, S,
                                   count, dh, dv, rows_b, sdpa_bwd_ms))
    whole_fn = lambda: kb.bank_attention_bwd(
        q, bk, bv, cnt, out, rec_h, lse_h, dout, drec, scale, 2)
    stages["whole"] = dict(
        fn=whole_fn,
        plain=lambda: kb.bank_attention_bwd_plain(q, bk, bv, cnt, dout, drec,
                                                  scale, 2),
        # S.T recomputed and g = dout.v^T once each, then dq, dk and dv;
        # reads q, k, v, dout, out (f32), lse, drec, rec; writes dq and every
        # slot's dk, dv
        flops=2.0 * b * lq * kv * (3 * dh + 2 * dv),
        nbytes=(2 * qb + kb_ + vb + 3 * ob + sb + b * lq * S * 4
                + b * 2 * lq * S * 4 + S * b * lk * (dh + dv) * 2),
        library=sdpa_bwd_ms)
    rows = {}
    for name, r in stages.items():
        b_ms, b_by = bound(r["flops"], r["nbytes"])
        rows[name] = dict(ms=cuda_ms(r["fn"], 20 if name != "whole" else 10),
                          plain_ms=cuda_ms(r["plain"], 3), bound_ms=b_ms,
                          bound_by=b_by, library_ms=r["library"])
        if "sdpa_bwd_ms" in r:
            rows[name]["sdpa_bwd_ms"] = r["sdpa_bwd_ms"]
        if "design_flops" in r:
            rows[name]["design_ms"] = r["design_flops"] / PEAK_BF16_FLOPS * 1e3
    rows["whole"]["split_ms"] = kernel_split_ms(whole_fn)
    if fused:
        lse_row = rows["bank_attention_lse" + suffix]
        lse_row["split_ms"] = kernel_split_ms(
            stages["bank_attention_lse" + suffix]["fn"])
    return rows


def nmg_bank_train_rows(dev, values: int = 1024, suffix: str = "_h2"):
    """Phase 2, the bank attention's training rows at no_memory_gap's 2
    heads of 128 with `values` value columns over the heads (1024, R50-
    DeAOTL's; 256, R50-AOTL's): K1'x2 at K1PX2_CASES and K2x2 after each,
    held (held_k2h with heads=2: K1'x2's output, each head's slot mass and
    lse, K2x2's kernels against their plain stages, the whole backward
    against autograd of the plain forward, with a nonzero drec) and timed
    (k2x2_case) at 9 and 4 valid slots. Returns ({name: entry} without
    launch counts, names ending in `suffix`; whole-K2x2 timings)."""
    from rmem_tpu_torch.kernels import bank_attention as kb
    label = {"_h2": "K1'x2 + K2x2", "_h2v128": "K1'x2v128 + K2x2v128"}[suffix]
    held_errs, timed = {}, {}
    for key, kw in K1PX2_CASES.items():
        args = k2x2_inputs(dev, values=values, **kw)
        held_errs[key] = held_k2h(*args, heads=2)
        print(f"{label} {key} {kw}: max|kernel - plain| / max|plain| "
              "(rec, lse absolute; the share of out on the bf16 grid): "
              + ", ".join(f"{k} {v:.3e}"
                          for k, v in held_errs[key].items()))
        if key != "reference":
            timed[key] = k2x2_case(args, suffix)
        else:
            q, bk, bv, cnt, _, _, scale = args
            timed[key] = {"bank_attention_lse" + suffix: dict(ms=cuda_ms(
                lambda: kb.bank_attention_lse(q, bk, bv, cnt, scale, 2),
                20))}
    # keys that nearly cancel in ds K, where ds's lo plane must show: the
    # backward's kernels against their plain stages fed the same lse and
    # row term, and the whole against autograd when fed the plain
    # forward's (held_k2h with plain_forward: through K1'x2's own output
    # dq misses by ~0.13 there, a reading)
    held_errs["cancelling"] = held_k2h(*k2x2_inputs(dev, values=values,
                                                    cancel=True), heads=2,
                                       plain_forward=True)
    print(f"{label} on keys that cancel (k2x2_inputs cancel=True), 9 valid "
          "slots: " + ", ".join(f"{k} {v:.3e}"
                                for k, v in held_errs["cancelling"].items()))
    for key, rows in timed.items():
        print(f"{label} {key}: " + "; ".join(
            f"{name} {r['ms']:.4f} ms" + (
                f" (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} "
                f"{r['bound_by']}, library "
                + ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
                + (f", SDPA backward {r['sdpa_bwd_ms']:.4f}"
                   if "sdpa_bwd_ms" in r else "")
                + (f", the design's own products "
                   f"{r['design_ms']:.4f} at the peak rate"
                   if "design_ms" in r else "") + ")"
                if "bound_ms" in r else "")
            for name, r in rows.items()))
        for name, what in (("whole", "the whole backward"),
                           ("bank_attention_lse" + suffix, "the forward")):
            if "split_ms" in rows.get(name, {}):
                print(f"{label} {key}: {what} by kernel (profiler, ms a "
                      "call): " + ", ".join(
                          f"{k[:48]} {x:.4f}"
                          for k, x in rows[name]["split_ms"].items()))

    def worst(*keys):
        return max(e[k] for e in held_errs.values() for k in keys)

    bwd = "rmem_tpu_torch/csrc/bank_attention_bwd.cu"
    fused = "rmem_tpu_torch/csrc/bank_attention_bwd_fused.cu"
    narrow = kb.bwd_route(2, 128, values // 2) == "fused"
    stages = {"bank_attention_lse": (
        worst("out", "lse"),
        "rmem_tpu_torch/csrc/bank_attention_lse_v128.cu" if narrow
        else "rmem_tpu_torch/csrc/bank_attention_infer.cu",
        "rmem_tpu/kernels/bank_attention.py:687")}
    if narrow:
        stages.update({
            "bank_attention_bwd_fused_dkv": (
                worst("dk", "dv"), fused,
                "rmem_tpu/kernels/bank_attention.py:155"),
            "bank_attention_bwd_fused_dq": (
                worst("dq"), fused,
                "rmem_tpu/kernels/bank_attention.py:113")})
    else:
        stages.update({
            "bank_attention_bwd_split_dq": (
                worst("dq"), bwd, "rmem_tpu/kernels/bank_attention.py:113"),
            "bank_attention_bwd_split_dk": (
                worst("dk"), bwd, "rmem_tpu/kernels/bank_attention.py:155"),
            "bank_attention_bwd_split_dv": (
                worst("dv"), bwd,
                "rmem_tpu/kernels/bank_attention.py:155")})
    entries = {}
    for stage, (err, source, replaces) in stages.items():
        name = stage + suffix
        main = timed["nine_slots"][name]
        entries[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            heads=2, values_per_head=values // 2, valid_slots=9,
            max_abs_err=err, **main,
            cases={key: rows[name] for key, rows in timed.items()
                   if name in rows})
    whole = {key: dict(rows["whole"], held=held_errs[key])
             for key, rows in timed.items() if "whole" in rows}
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries, whole


def check_nmg_train_kernels(dev):
    """Phase 2, R50-DeAOTL no_memory_gap's training rows (2 heads of 128,
    values 512 a head): K1'x2 and K2x2 (nmg_bank_train_rows); K5's backward
    at 2 heads on the training grid and a ragged one (held_k5), timed
    beside its plain version and SDPA's backward with the dense bias.
    Returns ({name: entry} without launch counts, whole-K2x2 timings)."""
    from rmem_tpu_torch.kernels import local_attention as kl
    entries, whole = nmg_bank_train_rows(dev)

    # ---- K5's backward at 2 heads: the training grid, then a ragged one ----
    k5 = k5_inputs(dev, heads=2)
    k5_errs = held_k5(*k5)
    ragged = held_k5(*k5_inputs(dev, heads=2, batch=2, grid=(13, 21)))
    print("K5x2 local_attention_bwd at the training shapes, max|kernel - "
          "plain| / max|plain|: " + ", ".join(
              f"{k} {v:.3e}" for k, v in k5_errs.items())
          + "; on a ragged 13 x 21 grid (B 2): " + ", ".join(
              f"{k} {v:.3e}" for k, v in ragged.items()))
    q, k, v, rel, g, size_2d, heads, _, scale = k5
    lib_fwd, pairs = sdpa_local(q, k, v, rel, size_2d, scale)
    lib_fwd_bwd, _ = sdpa_local(q, k, v, rel, size_2d, scale, g=g)
    lib_fwd_ms, lib_fwd_bwd_ms = cuda_ms(lib_fwd, 20), cuda_ms(lib_fwd_bwd,
                                                               20)
    b, hw, dh, dv = q.shape[0], q.shape[1], q.shape[-1], v.shape[-1]
    # q, k, v, rel and g read once, dq, dk, dv (bf16) and drel (f32)
    # written once; widths over the heads, pairs counted for every head
    b_ms, b_by = bound(2.0 * pairs * (3 * dh + 2 * dv) / heads,
                       (2 * dh + 2 * dv + rel.shape[-1]) * b * hw * 2
                       + (2 * dh + dv) * b * hw * 2 + rel.numel() * 4)
    call = lambda: kl.local_attention_bwd(*k5)
    entries["local_attention_bwd_h2"] = dict(
        name="local_attention_bwd_h2", route="cuda", heads=2,
        source="rmem_tpu_torch/csrc/local_attention.cu",
        replaces="rmem_tpu/kernels/local_attention.py:266",
        max_abs_err=max([*k5_errs.values(), *ragged.values()]),
        ms=cuda_ms(call, 20),
        plain_ms=cuda_ms(lambda: kl.local_attention_bwd_plain(*k5), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
        split_ms=kernel_split_ms(call))
    e = entries["local_attention_bwd_h2"]
    e["split"] = k5_kernel_rows(*k5, e["split_ms"])
    e["design_ms"] = sum(r["design_ms"] for r in e["split"].values())
    print(f"K5x2 backward: {e['ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, "
          f"SDPA backward with the dense bias {e['library_ms']:.4f} ms "
          f"(forward {lib_fwd_ms:.4f}), bound {b_ms:.5f} ms ({b_by}); by "
          "kernel (profiler, ms a call): " + ", ".join(
              f"{k[:40]} {x:.4f}" for k, x in e["split_ms"].items())
          + "; " + k5_rows_text(e["split"]))
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries, whole


def check_train_kernels(dev):
    """Phase 2, training rows: K1 with lse and K2's split kernels at the
    training shapes (B 4, a 30 x 30 grid, 4 valid slots of 10), K5's
    forward (K4) and backward kernels (each backward output against its
    plain version and autograd of the plain forward), and K7 (kernel
    forward, plain backward) against plain forward and backward. Returns
    ({name: entry} without launch counts, whole-K2 timings, whole-K5
    timings)."""
    import torch
    import torch.nn.functional as F

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.ops.attention import NEG_INF, _local_offset_map_on

    bf = torch.bfloat16
    g, (q, bk, bvv, cnt, dout, drec, scale) = k2_inputs(dev)

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    b, (h, w) = TRAIN_B, TRAIN_GRID
    (S, _, hw, dh), dv, count = bk.shape, bvv.shape[-1], int(cnt)
    errs = held_k2(q, bk, bvv, cnt, dout, drec, scale)
    one_group = held_k2(*k2_inputs(dev, count=2)[1])
    for n, e in ((count, errs), (2, one_group)):
        print(f"K1' (lse) + K2 at the training shapes, {n} valid slots, "
              "max|kernel - plain| / max|plain| (rec, lse absolute; the "
              "share of out on the bf16 grid): "
              + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
    entries = {}
    kv = count * hw
    out, rec, lse = kb.bank_attention_lse(q, bk, bvv, cnt, scale)
    lse_h = lse[:, None]
    delta_h = kb.bwd_delta_mh(dout, out, drec, rec[:, None])
    lse2, rterm = kb.fused_rows(lse_h, delta_h, drec)
    # bytes: inputs read once (valid slots only), outputs written once
    qb, kb_, vb = b * hw * dh * 2, kv * b * dh * 2, kv * b * dv * 2
    ob, sb = b * hw * dv * 2, b * hw * 4
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
            source="rmem_tpu_torch/csrc/bank_attention_infer.cu",
            fn=lambda: kb.bank_attention_lse(q, bk, bvv, cnt, scale),
            plain=lambda: kb.bank_attention_plain(q, bk, bvv, cnt, 1, scale),
            flops=2.0 * b * hw * kv * (dh + dv),
            nbytes=qb + kb_ + vb + 2 * ob + b * hw * S * 4 + sb,   # f32 out
            err=max(errs["out"], errs["lse"]),
            library=lambda: F.scaled_dot_product_attention(
                q[:, None], *lib_valid, scale=scale)),
    }
    # K2's split kernels, dq with the sum of its slot groups' partials
    split = split_stages(
        (q, bk, bvv, cnt, dout, lse2, rterm, scale),
        (q, bk[:count], bvv[:count], cnt, dout, lse_h, delta_h,
         drec[..., :count].contiguous(), scale),
        "", b, hw, hw, S, count, dh, dv, b * lse2.shape[-1] * (1 + count) * 4,
        None)
    for name, r in split.items():
        role = name.rsplit("_", 1)[1]
        r.update(source="rmem_tpu_torch/csrc/bank_attention_bwd.cu",
                 replaces="rmem_tpu/kernels/bank_attention.py:"
                 + ("113" if role == "dq" else "155"), err=errs[role])
    rows.update(split)
    for name, r in rows.items():
        b_ms, b_by = bound(r["flops"], r["nbytes"])
        entries[name] = dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], max_abs_err=r["err"],
            ms=cuda_ms(r["fn"], 20), plain_ms=cuda_ms(r["plain"], 3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=(None if r["library"] is None
                        else cuda_ms(r["library"], 10)))
        if "design_flops" in r:
            entries[name]["design_ms"] = (r["design_flops"] / PEAK_BF16_FLOPS
                                          * 1e3)

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
        split_ms=kernel_split_ms(k2), held=errs)
    for name in split:
        entries[name]["sdpa_bwd_ms"] = whole["library_bwd_ms"]
    print(f"K2 whole backward: {whole['ms']:.3f} ms (plain autograd "
          f"{whole['plain_ms']:.3f} ms, library attention backward over the "
          f"{count} valid slots {whole['library_bwd_ms']:.3f} ms, over all "
          f"{S} with a mask {whole['library_bwd_masked_ms']:.3f} ms, bound "
          f"{whole['bound_ms']:.3f} ms); by kernel (profiler, ms a call): "
          + ", ".join(f"{k[:48]} {x:.4f}"
                      for k, x in whole["split_ms"].items())
          + "; by role: " + ", ".join(
              f"{name} {entries[name]['ms']:.4f} (design at the peak rate "
              f"{entries[name]['design_ms']:.4f})" for name in split))

    # ---- K5: the local attention's forward (K4) and backward kernels ----
    k5_args = k5_inputs(dev)
    (lq_, lk_, lv, rel, gl), largs = k5_args[:5], k5_args[5:]
    k5_errs = held_k5(*k5_args)
    k5_ragged = held_k5(*k5_inputs(dev, batch=2, grid=(13, 21)))
    print("K5 local_attention_bwd at the training shapes, max|kernel - "
          "plain| / max|plain|: " + ", ".join(f"{k} {v:.3e}"
                                               for k, v in k5_errs.items())
          + "; on a ragged 13 x 21 grid (B 2): " + ", ".join(
              f"{k} {v:.3e}" for k, v in k5_ragged.items()))

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
    pairs = b * (omap < 225).sum().item()      # in-image (query, key) pairs
    relp = torch.cat([rel, torch.full((b, hw, 1), NEG_INF, dtype=bf,
                                      device=dev)], dim=2)
    dense_bias = torch.gather(relp, 2, omap.expand(b, hw, hw))[:, None]
    lib_ins = [t.detach().requires_grad_() for t in (lq_, lk_, lv)]

    def lib_local(backward: bool):
        o = F.scaled_dot_product_attention(
            lib_ins[0][:, None], lib_ins[1][:, None], lib_ins[2][:, None],
            attn_mask=dense_bias, scale=scale)
        if backward:
            torch.autograd.grad(o, lib_ins, gl[:, None])

    lib_fwd_ms = cuda_ms(lambda: lib_local(False), 20)
    lib_fwd_bwd_ms = cuda_ms(lambda: lib_local(True), 20)
    # q, k, v and rel read once; the forward writes the output once, the
    # backward also reads g once and writes dq, dk, dv (bf16) and drel (f32)
    # once
    reads = (2 * dh + dv + 225) * b * hw * 2
    k5_rows = {
        "local_attention_fwd_train": dict(
            replaces="rmem_tpu/kernels/local_attention.py:237",
            fn=lambda: kl.local_attention(lq_, lk_, lv, rel, *largs),
            plain=lambda: kl.local_attention_plain(lq_, lk_, lv, rel,
                                                   *largs),
            flops=2.0 * pairs * (dh + dv),
            nbytes=reads + b * hw * dv * 2, err=rel_err(got[0], ref[0]),
            library_ms=lib_fwd_ms, graph=True),
        "local_attention_bwd": dict(
            replaces="rmem_tpu/kernels/local_attention.py:266",
            fn=lambda: kl.local_attention_bwd(lq_, lk_, lv, rel, gl, *largs),
            plain=lambda: kl.local_attention_bwd_plain(lq_, lk_, lv, rel, gl,
                                                       *largs),
            flops=2.0 * pairs * (3 * dh + 2 * dv),
            nbytes=(reads + b * hw * dv * 2 + (2 * dh + dv) * b * hw * 2
                    + b * hw * 225 * 4),
            err=max([*k5_errs.values(), *k5_ragged.values()]),
            # the library's backward: forward + backward less forward
            library_ms=lib_fwd_bwd_ms - lib_fwd_ms),
    }
    for name, r in k5_rows.items():
        b_ms, b_by = bound(r["flops"], r["nbytes"])
        entries[name] = dict(
            name=name, route="cuda",
            source="rmem_tpu_torch/csrc/local_attention.cu",
            replaces=r["replaces"], max_abs_err=r["err"],
            ms=(graph_ms(r["fn"], 20) if r.get("graph")
                else cuda_ms(r["fn"], 20)),
            plain_ms=cuda_ms(r["plain"], 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"])
        if r.get("graph"):     # a CUDA graph's time, as K4's
            entries[name]["eager_ms"] = cuda_ms(r["fn"], 20)
    k5_whole = dict(
        ms=cuda_ms(lambda: fwd_bwd(kl.local_attention_trainable), 20),
        plain_ms=cuda_ms(lambda: fwd_bwd(kl.local_attention_plain), 5),
        library_ms=lib_fwd_bwd_ms, held=k5_errs)
    k5_whole["library_ratio"] = k5_whole["ms"] / lib_fwd_bwd_ms
    k5_whole["backward_split_ms"] = kernel_split_ms(
        lambda: kl.local_attention_bwd(lq_, lk_, lv, rel, gl, *largs))
    k5_whole["backward_split"] = k5_kernel_rows(
        *k5_args, k5_whole["backward_split_ms"])
    entries["local_attention_bwd"]["design_ms"] = sum(
        r["design_ms"] for r in k5_whole["backward_split"].values())
    print("K5 backward by kernel (profiler, ms a call): " + ", ".join(
        f"{k[:40]} {v:.4f}" for k, v in k5_whole["backward_split_ms"].items())
        + "; " + k5_rows_text(k5_whole["backward_split"]))
    print(f"K5 forward + backward through autograd: {k5_whole['ms']:.3f} ms "
          f"(forward {entries['local_attention_fwd_train']['ms']:.3f}, "
          f"backward {entries['local_attention_bwd']['ms']:.3f}); SDPA "
          f"forward + backward with the dense bias {lib_fwd_bwd_ms:.3f} ms "
          f"(forward {lib_fwd_ms:.3f}), so {k5_whole['library_ratio']:.3f}x;"
          f" plain {k5_whole['plain_ms']:.3f} ms")

    # ---- K7: the stem's training forward and its backward over B*T
    # frames ----
    sargs = stem_inputs(dev, g, TRAIN_B * TRAIN_T, *TRAIN_HW, train=True)
    k7 = held_k7(*sargs, g)
    print(f"K7 stem_trainable (fwd + bwd) over {sargs[0].shape[0]} frames: "
          + ", ".join(f"{k} {v:.3e}" for k, v in k7["errs"].items())
          + f" (max rel err); {k7['ms']:.3f} ms (forward {k7['fwd_ms']:.3f},"
          f" backward {k7['bwd_ms']:.3f}), plain chain "
          f"{k7['plain_ms']:.3f} ms, library chain forward + backward "
          f"{k7['library_ms']:.3f} ms, bound {k7['bound_ms']:.4f} ms")
    print("K7 backward by kernel (profiler, ms a call): " + ", ".join(
        f"{k[:48]} {v:.4f}" for k, v in k7["bwd_split_ms"].items()))
    entries["stem_trainable"] = dict(
        name="stem_trainable", route="cuda",
        source="rmem_tpu_torch/csrc/stem.cu",
        replaces="rmem_tpu/kernels/stem.py:210",
        max_abs_err=max(k7["errs"].values()),
        **{k: k7[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "fwd_ms", "bwd_ms",
                              "bwd_split_ms")},
        library="autograd of cuDNN bf16 conv2d (channels-last, folded "
                "bias), relu, max_pool2d: a chain of three calls")
    for e in entries.values():
        e["kernel_ms"] = e["ms"]
    return entries, whole, k5_whole


def held_k7(x, wt, sc, bi, g, timed: bool = True) -> dict:
    """K7 on one batch: the kernel forward (the pooled map held against the
    plain version) and the gradients of weight, scale and bias from
    `stem_bwd` on its saved state, against autograd of the plain chain
    (max rel err each, failing the run past GRAD_TOL). With `timed`, also
    the times of the whole, its forward and backward, the plain chain and
    the library's chain (forward + backward through autograd), and the
    bound. Returns a dict."""
    import torch

    from rmem_tpu_torch.kernels import stem as ks
    bf = torch.bfloat16
    gs = None

    def fwd_bwd(fn):
        nonlocal gs
        ins = [t.detach().requires_grad_() for t in (wt, sc, bi)]
        o = fn(x, *ins) if fn is ks.stem_trainable else fn(
            x, *(t.to(bf) for t in ins))
        if gs is None:
            gs = torch.randn(o.shape, generator=g, device=o.device).to(bf)
        return (o, *torch.autograd.grad(o, ins, gs))

    got, ref = fwd_bwd(ks.stem_trainable), fwd_bwd(ks.stem_plain)
    held("stem", got[0], ref[0])
    errs = {name: rel_err(a, r) for name, a, r in
            zip(("dweight", "dscale", "dbias"), got[1:], ref[1:])}
    for name, err in errs.items():
        check(err <= GRAD_TOL, f"K7 {name}: {err} (tolerance {GRAD_TOL})")
    if not timed:
        return dict(errs=errs)
    w16, s16, b16 = (t.to(bf) for t in (wt, sc, bi))
    saved = ks.stem(x, w16, s16, b16, save=True)
    chain, wl, bl = stem_library(x, wt, sc, bi)

    def library():
        ins = [t.detach().requires_grad_() for t in (wl, bl)]
        torch.autograd.grad(chain(*ins), ins, gs.permute(0, 3, 1, 2))

    b_ms, b_by = stem_bound(x, got[0], train=True)
    bwd_split = kernel_split_ms(lambda: ks.stem_bwd(
        x, *saved[1:], saved[0], w16, s16, gs), 3)
    return dict(
        errs=errs, ms=cuda_ms(lambda: fwd_bwd(ks.stem_trainable), 5),
        bwd_split_ms=dict(sorted(bwd_split.items(), key=lambda kv: -kv[1])),
        fwd_ms=cuda_ms(lambda: ks.stem(x, w16, s16, b16, save=True), 5),
        bwd_ms=cuda_ms(lambda: ks.stem_bwd(x, *saved[1:], saved[0], w16, s16,
                                           gs), 5),
        plain_ms=cuda_ms(lambda: fwd_bwd(ks.stem_plain), 3),
        library_ms=cuda_ms(library, 5), bound_ms=b_ms, bound_by=b_by)


def reference_inputs(dev):
    import numpy as np
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    mask = np.zeros((1, *IN_HW), np.int32)
    for i in range(NUM_OBJECTS):          # 10 object stripes
        mask[:, :, i * 80:i * 80 + 60] = i + 1
    img0 = torch.rand((1, *IN_HW, 3), generator=g, device=dev)
    return img0, mask, g


# the served configurations: phase 3's and 4's, phase 9's and 10's, phase
# 13's and 14's (R50-DeAOTL with no_memory_gap: 2 heads of 128, values 512
# a head) and phase 17's and 18's (R50-AOTL with no_memory_gap: 2 heads of
# 128 in the long- and short-term attention, values 128 a head)
SERVED = {"r50_deaotl": dict(model="r50_deaotl"),
          "r50_aotl": dict(model="r50_aotl"),
          "r50_deaotl_nmg": dict(model="r50_deaotl", no_memory_gap=True),
          "r50_aotl_nmg": dict(model="r50_aotl", no_memory_gap=True)}


def build_engine(dev, model: str = "r50_deaotl"):
    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.engine import InferenceEngine
    from rmem_tpu_torch.models import build_vos_model, init_params
    cfg = get_config("pre_vost", **SERVED[model])
    model = init_params(build_vos_model(cfg.model_vos, cfg), seed=0)
    return InferenceEngine(model, cfg, device=dev), cfg


def evaluator_gap(cfg, num_frames: int) -> int:
    """The long-term write gap the evaluator serves a video of num_frames
    frames with (rmem_tpu/managers/evaluator.py:328-331): one write in
    about 30 frames, at least every 5, and a quarter of that with
    no_memory_gap. The evaluator is not ported; phase 13 serves with it."""
    gap = max(int(round(num_frames / 30)), 5)
    if cfg.no_memory_gap:
        gap = int(round(gap / 4))
    return gap


def served_gap(cfg, num_frames: int) -> int:
    """Phases 3 and 9 serve with the preset's gap (5), phases 13 and 14
    with the evaluator's (1 with no_memory_gap)."""
    return (evaluator_gap(cfg, num_frames) if cfg.no_memory_gap
            else cfg.test_long_term_mem_gap)


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
        # the port's own kernels, whether or not they made the table
        print("profile: the port's kernels, device ms and calls per unit: "
              + ", ".join(f"{e.key.split('(')[0]} "
                          f"{e.self_device_time_total / (1e3 * n):.4f} "
                          f"({e.count / n:g})"
                          for e in events
                          if e.device_type == DeviceType.CUDA
                          and "rmem" in e.key))
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


# the serving phases' models: each kernel wrapper's launches per served
# frame (the reference frame included); 0 where the model must not reach it
SERVED_LAUNCHES = {
    "r50_deaotl": dict(bank_attention_infer=3, local_attention=3, stem=1,
                       bank_attention_infer_mh=0, bank_attention_qminor=0),
    "r50_aotl": dict(bank_attention_infer_mh=3, stem=1,
                     bank_attention_infer=0, local_attention=0,
                     bank_attention_qminor=0),
    "r50_deaotl_nmg": dict(bank_attention_infer=3, local_attention=3, stem=1,
                           bank_attention_infer_mh=0,
                           bank_attention_qminor=0),
    "r50_aotl_nmg": dict(bank_attention_infer=3, stem=1,
                         bank_attention_infer_mh=0, local_attention=0,
                         bank_attention_qminor=0),
}
# the head shape (heads, key width, value width a head) of every launch of
# K1's template on each served path: the wrapper's one counter covers the
# template's instantiations, so the shape tells K1x2v128 from K1 and K1x2
SERVED_SHAPES = {"r50_deaotl": (1, 128, 1024), "r50_aotl": None,
                 "r50_deaotl_nmg": (2, 128, 512),
                 "r50_aotl_nmg": (2, 128, 128)}
PHASE_LABEL = {"r50_deaotl": "main path", "r50_aotl": "phase 9 (AOT)",
               "r50_deaotl_nmg": "phase 13 (no_memory_gap)",
               "r50_aotl_nmg": "phase 17 (AOT no_memory_gap)"}


def main_path(dev, frames: int, card: str, profile: bool,
              model: str = "r50_deaotl"):
    """Phase 3 (R50-DeAOTL), phase 9 (R50-AOTL), phase 13 (R50-DeAOTL with
    no_memory_gap, the evaluator's gap of 1) or phase 17 (R50-AOTL with
    no_memory_gap, the same gap): returns (launch counts, per-window
    frames/s)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks

    phase = PHASE_LABEL[model]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, cfg = build_engine(dev, model)
    img0, mask, g = reference_inputs(dev)
    imgs = torch.rand((frames, 1, *IN_HW, 3), generator=g, device=dev)
    torch.cuda.synchronize()
    print(f"{phase}: {model} built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in engine.model.parameters())} weights")

    wrappers = (kb.bank_attention_infer, kb.bank_attention_infer_mh,
                kb.bank_attention_qminor, kl.local_attention, ks.stem)
    for fn in wrappers:
        fn.launches = 0
    gap = served_gap(cfg, frames + 1)
    # the head shape of each launch of K1's template, by a spy on the
    # wrapper's launch helper (the counters stay the wrappers' own)
    shapes, slots_call = [], kb._slots_call

    def spied_slots_call(q, bank_k, bank_v, count, num_heads, *a, **kw):
        shapes.append((num_heads, q.shape[-1] // num_heads,
                       bank_v.shape[-1] // num_heads))
        return slots_call(q, bank_k, bank_v, count, num_heads, *a, **kw)

    spy = mock.patch.object(kb, "_slots_call", spied_slots_call)
    spy.start()
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
    spy.stop()
    counts = {fn.__name__: fn.launches for fn in wrappers}
    window_fps = [WINDOW / (b - a) for a, b in zip(marks, marks[1:])]
    fps = statistics.median(window_fps)

    labels = torch.stack(labels)
    evictions = int(evictions)
    # the reference fills slot 1; a write every `gap` frames fills the rest
    scheduled = frames // gap - (slots - 1)
    print(f"{phase}: {frames} frames, a long-term write every {gap}, "
          f"launches {counts}, bank count "
          f"{int(state.bank.count)}, order {state.bank.order.tolist()}, "
          f"times {state.bank.times.tolist()}")
    expected = {name: n * (frames + 1)
                for name, n in SERVED_LAUNCHES[model].items()}
    check(counts == expected, f"{phase} launches {counts}, expected "
          f"{expected}")
    shape = SERVED_SHAPES[model]
    check(set(shapes) == ({shape} if shape else set()) and len(shapes)
          == counts["bank_attention_infer"], f"{phase}: K1's template "
          f"launched at head shapes {sorted(set(shapes))} ({len(shapes)} "
          f"launches), expected only {shape}")
    check(int(state.bank.count) == slots, "bank not full")
    check(evictions >= 1 and evictions == scheduled,
          f"{evictions} evictions, {scheduled} scheduled")
    check(labels.shape == (frames, *OUT_HW), f"labels {tuple(labels.shape)}")
    check(int(labels.min()) >= 0 and int(labels.max()) <= NUM_OBJECTS,
          "labels out of [0, 10]")
    check(bool(torch.isfinite(state.logits4x).all()), "non-finite logits")
    print(f"{phase}: {evictions} evictions counted on the device "
          f"({scheduled} scheduled); labels in "
          f"[{int(labels.min())}, {int(labels.max())}]; per-frame label "
          f"histogram of the last frame "
          f"{torch.bincount(labels[-1].flatten().long(), minlength=11).tolist()}")
    print(f"{phase}: {fps:.3f} frames/s, median of {windows} windows of "
          f"{WINDOW} frames ("
          + ", ".join(f"{x:.3f}" for x in window_fps)
          + f"; the last is the last {WINDOW} frames) at 481x849 in, "
          f"480x854 out, 10 objects, {model}, on {card}; host {host}; "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if profile:
        def five_frames():
            for t in range(5):
                engine.step(state, imgs[t], OUT_HW)
        device_busy_table(five_frames, 5, 1e3 / fps, "per frame")
    return counts, window_fps


# phases 4, 10, 14 and 18: the frames through which the kernel and plain
# engines are held frame by frame. With a write every 5 frames the bank
# fills at frame 40 and AGREE_FRAMES stops before the first eviction; with
# no_memory_gap's write every frame it fills at frame 8, whose write is the
# first eviction, so phases 14 and 18 hold frames 0 to 8 (the eviction's
# victim may follow a near tie in the slot mass, which the bf16 rounding
# inside the kernels can flip)
PLAIN_FRAMES = {"r50_deaotl": AGREE_FRAMES, "r50_aotl": AGREE_FRAMES,
                "r50_deaotl_nmg": 9, "r50_aotl_nmg": 9}
AGREE_PHASE = {"r50_deaotl": "phase 4", "r50_aotl": "phase 10",
               "r50_deaotl_nmg": "phase 14", "r50_aotl_nmg": "phase 18"}


def holding(calls: dict, name: str, kernel, plain_fn):
    """A stand-in for a kernel wrapper that runs it and holds each call
    against its plain version on the same inputs (see held), appending the
    result to calls[name]. The wrapper counts its launches on the name it
    has in its module, which is then this function's: `.launches`."""
    def call(*args, **kwargs):
        got = kernel(*args, **kwargs)
        calls[name].append(held(name, got, plain_fn(*args, **kwargs)))
        return got
    call.launches = 0
    return call


def plain_agreement(dev, model: str = "r50_deaotl"):
    """Phase 4 (R50-DeAOTL), phase 10 (R50-AOTL), phase 14 (R50-DeAOTL
    with no_memory_gap) or phase 18 (R50-AOTL with no_memory_gap, K1's
    template at values 128 a head): the same weights and frames through the
    kernel
    engine, each of whose kernel calls is held against its plain version on
    the same inputs, and through an engine whose kernels are their plain
    versions. The plain engine is teacher-forced with the kernel engine's
    labels, so both banks take the same writes and the logits of every
    frame compare, with 1 to 9 valid slots, through PLAIN_FRAMES. Returns
    (per-kernel worst call, per-frame relative logit error with the
    reference frame first, per-frame label agreement)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.ops.resize import resize_nearest, upsample_argmax

    phase = AGREE_PHASE[model]
    bank = ("bank_attention", kb, "bank_attention_infer",
            kb.bank_attention_plain)
    stem = ("stem", ks, "stem", ks.stem_plain)
    local = ("local_attention", kl, "local_attention",
             kl.local_attention_plain)
    kernels = {
        "r50_deaotl": (bank, local, stem),
        # the LSTT calls bank_attention_infer, which routes 8 heads to K1h
        "r50_aotl": (("bank_attention_mh",) + bank[1:], stem),
        "r50_deaotl_nmg": (bank, local, stem),
        "r50_aotl_nmg": (bank, stem),
    }[model]
    calls = {name: [] for name, *_ in kernels}
    kb.bank_attention_infer_mh.launches = 0

    img0, mask, g = reference_inputs(dev)
    imgs = torch.rand((AGREE_FRAMES, 1, *IN_HW, 3), generator=g, device=dev)
    runs = []
    for plain in (False, True):
        with ExitStack() as stack:
            for name, mod, attr, plain_fn in kernels:
                fn = (plain_fn if plain
                      else holding(calls, name, getattr(mod, attr), plain_fn))
                stack.enter_context(mock.patch.object(mod, attr, fn))
            engine, cfg = build_engine(dev, model)
            state, logits = engine.add_reference(
                img0, mask, [NUM_OBJECTS],
                gap=served_gap(cfg, AGREE_FRAMES + 1))
            frame_logits, labels = [logits.float()], []
            for t in range(AGREE_FRAMES if not plain
                           else PLAIN_FRAMES[model]):
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
        if name in ("bank_attention", "bank_attention_mh"):
            worst[name]["slot_mass_err"] = max(m for *_, m in errs)
    print(f"{phase}, every kernel call on the path against its plain "
          f"version: {worst}")
    if model == "r50_aotl":
        check(kb.bank_attention_infer_mh.launches
              == len(calls["bank_attention_mh"]) > 0,
              f"{phase}: {kb.bank_attention_infer_mh.launches} K1h launches "
              f"for {len(calls['bank_attention_mh'])} held calls")
    else:
        check(kb.bank_attention_infer_mh.launches == 0,
              f"{phase}: {kb.bank_attention_infer_mh.launches} K1h launches")
    (lk, yk, count), (lp, yp, count_p) = runs
    # zip stops at the plain run's last frame
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(lk, lp)]
    agree = [(a == b).float().mean().item() for a, b in zip(yk, yp)]
    print(f"{phase}, kernel vs plain engine, max|logits diff| / max|plain "
          "logits| per frame (reference first): "
          + ", ".join(f"{e:.3e}" for e in errs))
    print(f"{phase}, kernel vs plain engine, label agreement per frame: "
          + ", ".join(f"{a:.5f}" for a in agree))
    slots = cfg.former_mem_len + cfg.latter_mem_len
    check(count == count_p == slots, f"{phase} bank counts {count}, "
          f"{count_p}")
    check(all(w["calls"] > 0 for w in worst.values()), f"calls {worst}")
    check(max(errs) <= LOGIT_TOL, f"{phase} logits {max(errs)}")
    check(min(agree) >= AGREE_FLOOR, f"{phase} label agreement {min(agree)}")
    return worst, errs, agree


# phase 14's K3 part: frames after the reference frame, every K3 call held
NMG_QMINOR_FRAMES = 12


def nmg_qminor_agreement(dev):
    """Phase 14, K3 at 2 heads: phase 13's engine built with
    RMEM_BANK_QMINOR set, the reference frame and NMG_QMINOR_FRAMES frames,
    every K3 call held against its plain version on the same inputs. Each
    frame launches K3 3 times (the reference frame included) and K1 never.
    Returns (K3 launches, worst call)."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb

    calls = {"bank_attention_qminor": []}
    k3 = holding(calls, "bank_attention_qminor", kb.bank_attention_qminor,
                 kb.bank_attention_qminor_plain)
    img0, mask, g = reference_inputs(dev)
    imgs = torch.rand((NMG_QMINOR_FRAMES, 1, *IN_HW, 3), generator=g,
                      device=dev)
    kb.bank_attention_infer.launches = 0
    with mock.patch.dict(os.environ, {"RMEM_BANK_QMINOR": "1"}), \
            mock.patch.object(kb, "bank_attention_qminor", k3):
        engine, cfg = build_engine(dev, "r50_deaotl_nmg")
        check(engine.route["qminor"], f"phase 14 routes {engine.route}")
        state, _ = engine.add_reference(
            img0, mask, [NUM_OBJECTS],
            gap=served_gap(cfg, NMG_QMINOR_FRAMES + 1))
        for t in range(NMG_QMINOR_FRAMES):
            state, label = engine.step(state, imgs[t], OUT_HW)
        torch.cuda.synchronize()
    errs = calls["bank_attention_qminor"]
    expected = 3 * (NMG_QMINOR_FRAMES + 1)
    worst = dict(calls=len(errs), launches=k3.launches,
                 rel_err=max(e / top for e, top, _ in errs),
                 slot_mass_err=max(m for *_, m in errs))
    print(f"phase 14, K3 at 2 heads over the reference and "
          f"{NMG_QMINOR_FRAMES} frames, every call against its plain "
          f"version: {worst}; K1 launches {kb.bank_attention_infer.launches}")
    check(k3.launches == len(errs) == expected,
          f"phase 14: {k3.launches} K3 launches, {len(errs)} held, "
          f"{expected} expected")
    check(kb.bank_attention_infer.launches == 0,
          f"phase 14: K1 launched {kb.bank_attention_infer.launches} times "
          "with RMEM_BANK_QMINOR set")
    return k3.launches, worst


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
    video through the kernel engine, each of whose K3, K8 and K4 calls is
    held
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
        ("gated_dwconv", kd, kd.gated_dwconv_plain),
        ("local_attention", kl, kl.local_attention_plain))
    plain_only = ((ks, "stem", ks.stem_plain),)
    calls = {name: [] for name, *_ in held_kernels}

    cfg = optin_config()
    raw, mask = optin_inputs()
    runs = []
    for plain in (False, True):
        with ExitStack() as stack:
            for name, mod, plain_fn in held_kernels:
                fn = (plain_fn if plain
                      else holding(calls, name, getattr(mod, name),
                                   plain_fn))
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
    print(f"phase 7, every K3, K8 and K4 call of the first "
          f"{OPTIN_AGREE_FRAMES} frames against its plain version: {worst}")
    print("phase 7, kernel vs plain engine, max|logits diff| / max|plain "
          "logits| per frame (unmasked channels, all augs): "
          + ", ".join(f"{e:.3e}" for e in logit_errs))
    print("phase 7, kernel vs plain engine, label agreement per frame: "
          + ", ".join(f"{a:.5f}" for a in agree))
    layers = cfg.model_lstt_num
    steps = len(augs) * (1 + OPTIN_AGREE_FRAMES)
    check(worst["bank_attention_qminor"]["calls"] == layers * steps
          and worst["local_attention"]["calls"] == layers * steps
          and worst["gated_dwconv"]["calls"] == 3 * layers * steps,
          f"calls {worst}")
    check(max(logit_errs) <= LOGIT_TOL, f"phase 7 logits {max(logit_errs)}")
    check(min(agree) >= AGREE_FLOOR, f"phase 7 label agreement {min(agree)}")
    return worst, logit_errs, agree


TRAIN_KERNELS = (("bank_attention", "bank_attention_lse"),
                 ("bank_attention", "bank_attention_bwd_split"),
                 ("local_attention", "local_attention"),
                 ("local_attention", "local_attention_bwd"),
                 ("stem", "stem"),
                 ("bank_attention", "bank_attention_lse_mh"),
                 ("bank_attention", "bank_attention_bwd_mh"),
                 ("bank_attention", "bank_attention_bwd_fused"))
# each training wrapper's launches in every step of the training phases: 3
# layers' bank (and DeAOT's local) attention forward over 15 frames and
# again over the 14 checkpointed ones, its backward over 15, the stem once
# over the clip's 60 frames; no_memory_gap's (phases 15 and 19) at 2 heads
# of 128 through the same wrappers; K2's backward is one wrapper call (the
# split route: the dq kernel and its sum, the dk and the dv kernel), and
# R50-AOTL's backward (values 128 a head) goes through the fused pair (one
# wrapper call: the dkv kernel, the dq kernel and its sum) instead
_FWD, _BWD = 3 * (2 * TRAIN_T - 1), 3 * TRAIN_T
TRAIN_LAUNCHES = {
    "r50_deaotl": dict(bank_attention_lse=_FWD, bank_attention_bwd_split=_BWD,
                       local_attention=_FWD, local_attention_bwd=_BWD,
                       stem=1, bank_attention_lse_mh=0,
                       bank_attention_bwd_mh=0, bank_attention_bwd_fused=0),
    "r50_aotl": dict(bank_attention_lse=0, bank_attention_bwd_split=0,
                     local_attention=0, local_attention_bwd=0, stem=1,
                     bank_attention_lse_mh=_FWD,
                     bank_attention_bwd_mh=_BWD, bank_attention_bwd_fused=0),
}
TRAIN_LAUNCHES["r50_deaotl_nmg"] = dict(TRAIN_LAUNCHES["r50_deaotl"])
TRAIN_LAUNCHES["r50_aotl_nmg"] = dict(TRAIN_LAUNCHES["r50_deaotl"],
                                      local_attention=0,
                                      local_attention_bwd=0,
                                      bank_attention_bwd_split=0,
                                      bank_attention_bwd_fused=_BWD)
TRAIN_PHASE = {"r50_deaotl": ("phase 5", "R50-DeAOTL"),
               "r50_aotl": ("phase 11", "R50-AOTL"),
               "r50_deaotl_nmg": ("phase 15",
                                  "R50-DeAOTL with no_memory_gap"),
               "r50_aotl_nmg": ("phase 19", "R50-AOTL with no_memory_gap")}
# the held kernel step against the all-plain step of each trained model
HELD_PHASE = {"r50_deaotl": "phase 6", "r50_aotl": "phase 12",
              "r50_deaotl_nmg": "phase 16", "r50_aotl_nmg": "phase 20"}


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


def train_config(model: str = "r50_deaotl"):
    """pre_vost `model` (a key of SERVED: r50_deaotl_nmg and r50_aotl_nmg
    are R50-DeAOTL and R50-AOTL with no_memory_gap) at the card's batch,
    with train_total_steps set so that the use_prev_pred curriculum (from
    half the total) starts inside a run of TRAIN_STEPS steps."""
    from rmem_tpu_torch.config import get_config
    return get_config("pre_vost", **SERVED[model], train_batch_size=TRAIN_B,
                      train_total_steps=TRAIN_STEPS + 2)


def fifo_evictions(cfg) -> int:
    """The FIFO evictions of one training clip: frames 1 .. T-1 write every
    train_long_term_mem_gap frames after the reference's slot, and each
    write past former + latter slots evicts (engine/training.py)."""
    writes = (cfg.data_seq_len - 1) // cfg.train_long_term_mem_gap
    return max(0, 1 + writes - cfg.former_mem_len - cfg.latter_mem_len)


def train_phase(dev, card: str, profile: bool, model: str = "r50_deaotl"):
    """Phase 5 (R50-DeAOTL), phase 11 (R50-AOTL), phase 15 (R50-DeAOTL
    with no_memory_gap: 2 heads of 128, a long-term write every frame) or
    phase 19 (R50-AOTL with no_memory_gap, the same, values 128 a head):
    TRAIN_STEPS training steps on synthetic clips (465 x 465, 15 frames, 4
    clips), random weights from a seed. Launch counts are zeroed just
    before and read just after, and each step's must equal
    TRAIN_LAUNCHES[model]; the FIFO evictions each step makes (counted on
    the host at the bank's out-of-place compaction) must equal the
    schedule's (fifo_evictions: phases 15's and 19's 6 a clip). With
    `profile`, one more step runs under torch.profiler. Returns (launch
    counts by wrapper, per-step seconds, peak GiB)."""
    import importlib

    import torch

    from rmem_tpu_torch.managers.trainer import Trainer, train_step
    from rmem_tpu_torch.memory import eviction

    steps = TRAIN_STEPS
    phase, name = TRAIN_PHASE[model]
    cfg = train_config(model)
    check(cfg.data_seq_len == TRAIN_T
          and tuple(cfg.data_randomcrop) == TRAIN_HW, "pre_vost's shapes")
    check(not cfg.no_memory_gap or (
        cfg.model_att_heads, cfg.train_long_term_mem_gap) == (2, 1),
        f"{phase}: {cfg.model_att_heads} heads, a write every "
        f"{cfg.train_long_term_mem_gap}")
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
    compact, evictions = eviction.bank_compact, []

    def counted_compact(*a, **kw):
        evictions[-1] += 1
        return compact(*a, **kw)

    times, losses, per_step = [], [], []
    with mock.patch.object(eviction, "bank_compact", counted_compact):
        for i, (batch, shuffle) in enumerate(batches):
            counts0 = [fn.launches for fn in wrappers]
            evictions.append(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(trainer.state, batch, shuffle, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            per_step.append([fn.launches - c
                             for fn, c in zip(wrappers, counts0)])
            print(f"{phase}: train step {i} (curriculum "
                  f"{'on' if i >= seq_start else 'off'}"
                  f"): loss {losses[-1]:.4f}, grad norm "
                  f"{float(metrics['grad_norm']):.3f}, iou "
                  f"{float(metrics['iou']):.4f}, {times[-1]:.3f} s, "
                  f"{evictions[-1]} FIFO evictions, launches "
                  + str(dict(zip((fn for _, fn in TRAIN_KERNELS),
                                 per_step[-1]))))
    counts = {fn: w.launches for (_, fn), w in zip(TRAIN_KERNELS, wrappers)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in trainer.state.model.named_parameters())
    expected = [TRAIN_LAUNCHES[model][fn] for _, fn in TRAIN_KERNELS]
    check(cfg.model_lstt_num == 3 and all(s == expected for s in per_step),
          f"{phase} launches per step {per_step}, expected {expected}")
    check(evictions == [fifo_evictions(cfg)] * steps,
          f"{phase} FIFO evictions per step {evictions}, expected "
          f"{fifo_evictions(cfg)}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(moved > 0, "the parameters did not change")
    check(seq_start < steps, "the curriculum did not start")
    timed = times[1:]     # the first step includes cuDNN's autotuning
    print(f"{phase}: {steps} steps of {name} pre_vost at 465x465, T "
          f"{TRAIN_T}, B {TRAIN_B} (the reference's 16 over 4 GPUs), "
          f"{cfg.model_att_heads} heads, a long-term write every "
          f"{cfg.train_long_term_mem_gap} frames, {evictions[0]} FIFO "
          f"evictions a clip, the curriculum from step {seq_start:g}; "
          f"{statistics.median(timed):.3f}"
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


def held_train_step(dev, model: str = "r50_deaotl"):
    """Phase 6 (R50-DeAOTL), phase 12 (R50-AOTL), phase 16 (R50-DeAOTL
    with no_memory_gap) or phase 20 (R50-AOTL with no_memory_gap): one step
    of the kernel model, every K2 call and every K5 forward (K4) call
    (R50-DeAOTL), every K2h call (R50-AOTL), every K1'x2, K2x2, K5x2
    forward and K5x2 backward call (R50-DeAOTL with no_memory_gap) or
    every K1'x2v128 and K2x2v128 call (R50-AOTL with no_memory_gap) of
    which is held against its plain version on the same inputs, and one
    step of a model whose kernels are all their plain versions (computed in
    f32 from the same bf16 inputs), on the same batch, weights and shuffle.
    Holds the loss and the global gradient norm of the two. Returns a
    summary."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.managers.trainer import Trainer, train_step

    cfg = train_config(model)
    phase = HELD_PHASE[model]
    bf = torch.bfloat16
    calls, fwd_calls, lse_calls, k5_calls = [], [], [], []
    kernel_bwd = kb.bank_attention_bwd
    kernel_fwd = kl.local_attention
    kernel_bwd_mh = kb.bank_attention_bwd_mh
    kernel_lse = kb.bank_attention_lse
    kernel_bwd_la = kl.local_attention_bwd

    def held_bwd(q, bank_k, bank_v, count, out, rec, lse, dout, drec, scale,
                 num_heads=1):
        if num_heads == 1:
            calls.append(held_k2(q, bank_k, bank_v, count, dout, drec,
                                 scale))
            return kernel_bwd(q, bank_k, bank_v, count, out, rec, lse, dout,
                              drec, scale)
        # K2x2 on this call's own forward: its split kernels against their
        # plain form
        delta_h = kb.bwd_delta_mh(dout, out, drec, rec)
        got, errs = held_k2x2_call(q, bank_k, bank_v, count, dout, lse,
                                   delta_h, drec, scale)
        calls.append(errs)
        return got

    def held_lse(q, bank_k, bank_v, count, scale, num_heads=1):
        # the forward runs under the trainer's bf16 autocast: the plain
        # version computes in f32 outside it
        with torch.autocast(q.device.type, enabled=False):
            got, errs = held_k1ph(q, bank_k, bank_v, count, scale, num_heads,
                                  kernel=kernel_lse)
        lse_calls.append(errs)
        return got

    def held_bwd_la(*args):
        # against the plain version and autograd of the plain forward
        got, errs = held_k5(*args, kernel=kernel_bwd_la)
        k5_calls.append(errs)
        return got

    def held_fwd(*args):
        got = kernel_fwd(*args)
        fwd_calls.append(held("local_attention", got,
                              kl.local_attention_plain(*args)))
        return got

    def held_bwd_mh(*args):
        got, errs = held_k2h_call(*args, kernel=kernel_bwd_mh)
        calls.append(errs)
        return got
    # a wrapper counts its launches on the name it has in its module, which
    # is now the held function's
    held_fwd.launches = held_bwd_mh.launches = 0
    held_lse.launches = held_bwd_la.launches = 0
    held_patches = {
        "r50_deaotl": [((kb, "bank_attention_bwd"), held_bwd),
                       ((kl, "local_attention"), held_fwd),
                       ((kl, "local_attention_bwd"), held_bwd_la)],
        "r50_aotl": [((kb, "bank_attention_bwd_mh"), held_bwd_mh)],
        "r50_deaotl_nmg": [((kb, "bank_attention_lse"), held_lse),
                           ((kb, "bank_attention_bwd"), held_bwd),
                           ((kl, "local_attention"), held_fwd),
                           ((kl, "local_attention_bwd"), held_bwd_la)],
        "r50_aotl_nmg": [((kb, "bank_attention_lse"), held_lse),
                         ((kb, "bank_attention_bwd"), held_bwd)],
    }[model]

    # the plain versions take the inputs in bf16, as the kernels do
    plain = {
        (kb, "bank_attention_train"): lambda q, k, v, c, scale, num_heads=1:
            kb.bank_attention_plain(q.to(bf), k.to(bf), v.to(bf), c,
                                    num_heads, scale),
        (kl, "local_attention_trainable"): lambda q, k, v, r, *a:
            kl.local_attention_plain(q.to(bf), k.to(bf), v.to(bf), r.to(bf),
                                     *a),
        (ks, "stem_trainable"): lambda x, w, s, b: ks.stem_plain(
            x, w.to(bf), s.to(bf), b.to(bf)),
    }
    runs = []
    for use_plain in (False, True):
        with ExitStack() as stack:
            patches = plain.items() if use_plain else held_patches
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
    k2 = {"r50_deaotl": "K2", "r50_aotl": "K2h",
          "r50_deaotl_nmg": "K2x2", "r50_aotl_nmg": "K2x2v128"}[model]
    k5 = "K5x2" if cfg.no_memory_gap else "K5"

    def worst_of(held_calls):
        return {key: max(c[key] for c in held_calls)
                for key in (held_calls[0] if held_calls else ())}

    worst = worst_of(calls)
    fwd_worst = max((e / top for e, top, _ in fwd_calls), default=None)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    gn_err = abs(gn_k - gn_p) / gn_p
    print(f"{phase}: kernel step loss {loss_k:.6f}, grad norm {gn_k:.6f}; "
          f"plain step loss {loss_p:.6f}, grad norm {gn_p:.6f}; relative "
          f"differences {loss_err:.3e} and {gn_err:.3e}; {len(calls)} {k2} "
          f"calls held, worst of each check: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + (f"; {len(fwd_calls)} K5 forward calls held, worst "
             f"{fwd_worst:.3e} of max|plain|" if fwd_calls else "")
          + (f"; {len(lse_calls)} K1'x2 calls held, worst: " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst_of(lse_calls).items())
             if lse_calls else "")
          + (f"; {len(k5_calls)} {k5} backward calls held, worst: "
             + ", ".join(f"{k} {v:.3e}"
                         for k, v in worst_of(k5_calls).items())
             if k5_calls else ""))
    layers_frames = cfg.model_lstt_num * TRAIN_T
    deaot = cfg.model_vos == "deaot"
    check(len(calls) == layers_frames, f"{len(calls)} {k2} calls on the path")
    check(not deaot or len(fwd_calls) >= layers_frames,
          f"{len(fwd_calls)} K5 forward calls on the path")
    check(not cfg.no_memory_gap or (
        len(lse_calls) == TRAIN_LAUNCHES[model]["bank_attention_lse"]),
        f"{len(lse_calls)} K1'x2 calls on the path")
    check(len(k5_calls) == (layers_frames if deaot else 0),
          f"{len(k5_calls)} {k5} backward calls on the path")
    check(loss_err <= STEP_LOSS_TOL, f"step loss {loss_err}")
    check(gn_err <= STEP_GNORM_TOL, f"step grad norm {gn_err}")
    return dict(loss=[loss_k, loss_p], grad_norm=[gn_k, gn_p],
                k2_calls=len(calls), k2_worst=worst,
                k5_forward_calls=len(fwd_calls), k5_forward_worst=fwd_worst,
                k1p_calls=len(lse_calls), k1p_worst=worst_of(lse_calls),
                k5_backward_calls=len(k5_calls),
                k5_backward_worst=worst_of(k5_calls))


# --mutants: for each kernel source, the per-call checks of phase 2 that
# must catch its one-line mutants, and the mutants (a list of (line,
# replacement), or (line, replacement, file) for a line of the source's
# Python wrapper)
MUTANTS = {
    "bank_attention_bwd": ("k2", {
        # the dk kernel's ds drops the row term (delta and the slot mass)
        "dk_no_rterm": [("gg[4 * j + q] = p0 * (gg[4 * j + q] + r);",
                         "gg[4 * j + q] = p0 * gg[4 * j + q];"),
                        ("gg[4 * j + 2 + q] = p1 * (gg[4 * j + 2 + q] + r);",
                         "gg[4 * j + 2 + q] = p1 * gg[4 * j + 2 + q];")],
        # the row term without the slot mass's share (the wrapper's line)
        "rterm_no_drec": [
            ("    rterm[..., :lq] = (drec.transpose(1, 2)[:, None] / heads\n"
             "                       - delta_h[:, :, None])\n",
             "    rterm[..., :lq] = -delta_h[:, :, None]\n",
             "rmem_tpu_torch/kernels/bank_attention.py")],
        # dq is not multiplied by the logit scale
        "dq_scale": [("      (const float*)part, (const int*)count, "
                      "(bf16*)dq, n8, S, scale);",
                      "      (const float*)part, (const int*)count, "
                      "(bf16*)dq, n8, S, 1.f);")],
        # dq and dk without the lo plane of ds
        "no_lo": [("      mul_ab(acc, la, xw);\n", "")],
        # head 1 reads head 0's resident values (dq: dO; dk: V)
        "head0_resident_values": [
            ("tma_load(x + TILE + a * ATOM, my, resbar, a * 64, h, r, zr);",
             "tma_load(x + TILE + a * ATOM, my, resbar, a * 64, 0, r, zr);")],
        # head 1 reads head 0's resident queries (dq) or keys (dk)
        "head0_resident_rows": [
            ("tma_load(x + a * ATOM, mx, resbar, a * 64, h, r, zr);",
             "tma_load(x + a * ATOM, mx, resbar, a * 64, 0, r, zr);")],
        # every value group of the dv kernel reads the first group's dO
        "dv_group_offset": [("                   grp * NV + a * 64, h, i * BW, "
                             "b);",
                             "                   a * 64, h, i * BW, b);")],
        # the sum of dq's partials drops a last group of one slot
        "dq_sum_drops_a_group": [
            ("  const int ng = (clamp_count(count_ptr, S) + G - 1) / G;",
             "  const int ng = clamp_count(count_ptr, S) / G;")],
        # the invalid slots' dk is computed, not zeroed
        "dk_invalid_slots_written": [
            ("    if (s0 >= count) {   // an invalid slot: exact zeros",
             "    if (false) {")],
        # the invalid slots' dv is computed, not zeroed
        "dv_invalid_slots_written": [
            ("  if (s >= clamp_count(count_ptr, S)) {   // an invalid slot: "
             "exact zeros", "  if (s >= S) {")]}),
    "local_attention": ("k4_k5", {
        # K4: the accumulator is not rescaled when a row's maximum grows
        "k4_no_rescale": [
            ("        o[i][0] *= a0; o[i][1] *= a0; o[i][2] *= a1; "
             "o[i][3] *= a1;\n", "")],
        # K4: the bias is read at the transposed offset (dx, dy)
        "k4_bias_transposed": [
            ("return __bfloat162float(row[wy * WIN + wx])",
             "return __bfloat162float(row[wx * WIN + wy])")],
        # K4 at 2 heads: head 1 reads head 0's bias rows
        "k4x2_head0_bias": [
            ("const size_t rbase = ((size_t)b * H + h) * Hg * Wg;",
             "const size_t rbase = (size_t)b * H * Hg * Wg;")],
        # K5: dq is not multiplied by the logit scale
        "dq_scale": [("const float dq_mul = scale;",
                      "const float dq_mul = 1.f;")],
        # K5: the key side reads the bias and ds at the key's offset from
        # the query, not at the mirrored one
        "unflipped": [
            ("    return (ty - (hq >> 5) + 2 * M) * WIN + 2 * M - (hq & 31);",
             "    return WIN2 - 8 - ((ty - (hq >> 5) + 2 * M) * WIN + 2 * M - "
             "(hq & 31));")],
        # K5: ds = p dp, without the row term delta
        "no_delta": [
            ("ds[e] = ok ? p * (acc[a][nt][e] - dl[a][e >> 1]) : 0.f;",
             "ds[e] = ok ? p * acc[a][nt][e] : 0.f;")],
        # K5 at 2 heads: the query side writes head 1's ds into head 0's
        # columns of drel
        "k5x2_drel_head0": [("  drel += (size_t)h * WIN2;  // ds out\n",
                             "")],
        # K5: the query side's lse drops the row maximum
        "k5_lse_no_max": [("lse_out[qy * Wg + qx] = lse2 * LN2;",
                           "lse_out[qy * Wg + qx] = (lse2 - mx) * LN2;")],
        # K5: the dk role re-indexes its drel sub-rows unmirrored (the
        # keys of a tile row reversed)
        "k5_reindex_unmirrored": [
            ("cD + jt * L::DSUB + cO[jt] + 4 * (rk % TILE))",
             "cD + jt * L::DSUB + cO[jt] + 4 * (7 - rk % TILE))")],
        # K5 at 2 heads: the key side reads head 0's drel columns for head 1
        "k5x2_key_drel_head0": [("  drel += (size_t)h * WIN2;  // ds in\n",
                                 "")]}),
    "bank_attention_infer": ("k1_k3_k1p", {
        # K1: the slot-PE bias is dropped
        "k1_no_bias": [("if (kBias && qbias != nullptr) {", "if (false) {")],
        # K1: the keys are masked at Lk, not at true_lk
        "k1_mask_at_lk": [("(OT*)part_o, B, H, Lq, S, true_lk, DV,",
                           "(OT*)part_o, B, H, Lq, S, Lk, DV,")],
        # K1 and K3 at 2 heads: head 1 reads head 0's keys (the head
        # coordinate of the key map dropped)
        "k1x2_head0_keys": [
            ("tma_load(sk + a * ATOM, &tm_k, &full[st], a * 64, h, key0, z);",
             "tma_load(sk + a * ATOM, &tm_k, &full[st], a * 64, 0, key0, z);")],
        # K1 and K3 at 2 heads: the slot mass is head 0's, not the heads'
        # mean (the wrapper's line)
        "k1x2_mass_not_averaged": [
            ("rec_h[:, 0] if num_heads == 1 else rec_h.mean(dim=1)",
             "rec_h[:, 0]", "rmem_tpu_torch/kernels/bank_attention.py")],
        # K1 and K3: the zero keys that TMA fills past Lk are not masked
        "no_key_mask": [
            ("const bool ok = key0 + i * 8 + 2 * t4 + e < true_lk;",
             "const bool ok = true;")],
        # K1 and K3: one quarter of the accumulator is not rescaled as the
        # max grows
        "no_rescale": [("        o[4 * i] *= a0;\n", "")],
        # K1': the training partial outputs pass through bf16
        "k1p_bf16_partials": [
            ("*reinterpret_cast<float2*>(p) = make_float2(a, b);",
             "*reinterpret_cast<float2*>(p) = make_float2("
             "__bfloat162float(__float2bfloat16_rn(a)), "
             "__bfloat162float(__float2bfloat16_rn(b)));")],
        # K1': the lse without the log of the sum
        "k1p_lse_no_sum": [("lse[row] = (M + log2f(Lsum)) * LN2;",
                            "lse[row] = M * LN2;")],
        # K1'x2: the merge writes head 0's lse only
        "k1px2_lse_head0_only": [
            ("if (kF32 && blockIdx.y == 0 && threadIdx.x == 0)",
             "if (kF32 && h == 0 && blockIdx.y == 0 && threadIdx.x == 0)")]}),
    "bank_attention_infer_v128": ("k1v128", {
        # head 1 reads head 0's values
        "k1v128_head0_values": [
            ("          tma_load(sk + TILE + a * ATOM, &tm_v, &full[st], "
             "a * 64, h, key0,",
             "          tma_load(sk + TILE + a * ATOM, &tm_v, &full[st], "
             "a * 64, 0, key0,")],
        # the P.V product's V descriptor steps 8 keys a 16-key slice of P,
        # so slices read the wrong keys' values
        "k1v128_v_desc_half_step": [
            ("wgmma_rs_m64n128(o, pa[kk], desc_sw128(sv + kk * 2048, 8192, "
             "1024));",
             "wgmma_rs_m64n128(o, pa[kk], desc_sw128(sv + kk * 1024, 8192, "
             "1024));")],
        # a rank's range starts a chunk late: the chunk at each cut is lost
        "range_off_by_one": [
            ("  const int p0 = (int)((long long)n * rank / CL);",
             "  const int p0 = (int)((long long)n * rank / CL) + (rank > 0);")],
        # rank 1's per-slot sums left out of the merge
        "rank1_slot_sums_dropped": [
            ("      for (int r = 0; r < CL; ++r) {",
             "      for (int r = 0; r < CL; r += r == 0 ? 2 : 1) {")],
        # the bias skipped on ranks > 0
        "bias_rank0_only": [
            ("      if (kBias && qbias != nullptr) {",
             "      if (kBias && qbias != nullptr && rank == 0) {")],
        # the key mask on a slot's first chunk, not its last
        "mask_wrong_chunk": [
            ("    const bool edge = key0 + BK > true_lk;",
             "    const bool edge = key0 == 0;")],
        # the merge weighs every rank's output by rank 0's weight
        "merge_rank0_weight": [
            ("      const float w = wgt[r * TQ + row];",
             "      const float w = wgt[row];")]}),
    "gated_dwconv": ("k8", {
        # a band's last output row unwritten
        "k8_last_row_unwritten": [
            ("      if (y0 + j < H) {", "      if (y0 + j < H && j < RB - 1) {")],
        # the rows below the image not skipped: stale ring rows as the
        # bottom halo
        "k8_bottom_halo": [
            ("    const bool inside = yy >= 0 && yy < H;",
             "    const bool inside = yy >= 0;")],
        # the taps summed in reverse dx order
        "k8_dx_reversed": [
            ("const bf162 pr = __hmul2_rn(t[k + dx], wr[dy * 5 + dx]);",
             "const bf162 pr = __hmul2_rn(t[k + 4 - dx], wr[dy * 5 + 4 - dx]);")],
        # each channel takes its neighbour's weights
        "k8_wrong_pair_weights": [
            ("    wr[k] = __halves2bfloat162(w[(size_t)c * 25 + k],\n"
             "                               w[(size_t)(c + 1) * 25 + k]);",
             "    wr[k] = __halves2bfloat162(w[(size_t)(c + 1) * 25 + k],\n"
             "                               w[(size_t)c * 25 + k]);")],
        # the gate never multiplied in
        "k8_no_gate": [
            ("        for (int e = 0; e < 4; ++e) a2[e] = __hmul2_rn(a2[e], "
             "g2[e]);", "        for (int e = 0; e < 4; ++e) a2[e] = a2[e];")]}),
    "bank_attention_mh": ("k1h", {
        # K1h: the slot-PE bias is dropped
        "k1h_no_bias": [("if (!kTrain && qbias != nullptr && key0 == 0) {",
                         "if (false) {")],
        # K1h: a slot's sum is not rescaled when the row's maximum grows
        "k1h_slot_sum_unrescaled": [
            ("la[j] = la[j] * a0 + (j == js ? ps0 : 0.f);",
             "la[j] = la[j] + (j == js ? ps0 : 0.f);"),
            ("lb[j] = lb[j] * a1 + (j == js ? ps1 : 0.f);",
             "lb[j] = lb[j] + (j == js ? ps1 : 0.f);")],
        # K1h: the zero keys TMA fills past true_lk are not masked
        "k1h_no_key_mask": [
            ("const bool ok = key0 + n * 8 + 2 * t + e < true_lk;",
             "const bool ok = true;")],
        # K1h, K3h, K1'h: ldmatrix reads the tiles unswizzled
        "k1h_swizzle_off": [
            ("return tile + r * ROW + ((ch ^ ((r >> 1) & 3)) << 4);",
             "return tile + r * ROW + (ch << 4);")],
        # the merge weighs every group by the first group's maximum
        "k1h_merge_wrong_group_max": [
            ("exp2f(part_m[((size_t)gi * BH + bh) * Lq + qi] - M) * lg;",
             "exp2f(part_m[((size_t)0 * BH + bh) * Lq + qi] - M) * lg;")],
        # the merge takes a slot's mass relative to the next group's maximum
        "k1h_mass_wrong_group": [
            ("r = exp2f(part_m[((size_t)(s / G) * BH + bh) * Lq + qi] - M) *",
             "r = exp2f(part_m[((size_t)((s / G + 1) % ng) * BH + bh) * Lq "
             "+ qi] - M) *")],
        # K1'h: the f32 partial outputs and output stored through bf16
        "k1ph_out_bf16": [
            ("*reinterpret_cast<float2*>(p) = make_float2(a, b);",
             "*reinterpret_cast<float2*>(p) = make_float2("
             "__bfloat162float(__float2bfloat16_rn(a)), "
             "__bfloat162float(__float2bfloat16_rn(b)));")],
        # K1'h: the lse without the log of the sum
        "k1ph_lse_no_sum": [
            ("if (kTrain && seg == 0) lse[row] = (M + log2f(Lsum)) * LN2;",
             "if (kTrain && seg == 0) lse[row] = M * LN2;")],
        # K3h: the keys masked a chunk short of Lk (the wrapper's line)
        "k3h_true_lk_short": [
            ("out = _mh_call(q, bank_k, bank_v, count, num_heads, scale)\n",
             "out = _mh_call(q, bank_k, bank_v, count, num_heads, scale,\n"
             "                       bank_k.shape[2] - 64)\n",
             "rmem_tpu_torch/kernels/bank_attention.py")]}),
    "bank_attention_bwd_fused": ("k2_fused", {
        # dq without the lo plane of ds
        "fused_dq_no_lo": [("      mul_ab(dqa, la, sk);\n", "")],
        # the invalid slots' dk and dv are computed, not zeroed
        "fused_invalid_slots_written": [
            ("  if (s >= clamp_count(count_ptr, S)) {   // an invalid slot: "
             "exact zeros", "  if (s >= S) {")],
        # the sum of dq's partials drops a last group of one slot
        "fused_sum_drops_a_group": [
            ("  const int ng = (clamp_count(count_ptr, S) + G - 1) / G;",
             "  const int ng = clamp_count(count_ptr, S) / G;")],
        # head 1's dk and dv read head 0's queries
        "fused_dkv_head0_q": [
            ("          tma_load(sq + a * ATOM, &tm_q, &full[st], a * 64, h, "
             "i * BW, b);",
             "          tma_load(sq + a * ATOM, &tm_q, &full[st], a * 64, 0, "
             "i * BW, b);")],
        # the row term without the slot mass's share (the wrapper's line)
        "fused_rterm_no_drec": [
            ("    rterm[..., :lq] = (drec.transpose(1, 2)[:, None] / heads\n"
             "                       - delta_h[:, :, None])\n",
             "    rterm[..., :lq] = -delta_h[:, :, None]\n",
             "rmem_tpu_torch/kernels/bank_attention.py")]}),
    "bank_attention_mh_bwd": ("k2h", {
        # K2h: the rows kernel's rterm drops the slot-mass term
        "no_drec": [("rt[(size_t)s * LqP] = dr[s] * (1.f / H) - delta;",
                     "rt[(size_t)s * LqP] = -delta;")],
        # K2h: the row term the rows kernel computes drops the slot mass's
        # share
        "delta_no_mass": [
            ("  for (int s = 0; s < S; ++s) delta += dr[s] * (1.f / H) * "
             "rc[s];\n", "")],
        # K2h: dq is not multiplied by the logit scale
        "dq_scale": [("(const float*)part, (const int*)count, (bf16*)dq, "
                      "n8, S, scale);",
                      "(const float*)part, (const int*)count, (bf16*)dq, "
                      "n8, S, 1.f);")],
        # K2h: dq without the lo plane of ds
        "dq_no_lo": [("      mul_ab(dqa, la[kk], sk, kk, hoff);\n", "")],
        # K2h: the sum of dq's partials drops a last group of one slot
        "dq_sum_drops_a_group": [
            ("  const int ng = (clamp_count(count_ptr, S) + G - 1) / G;",
             "  const int ng = clamp_count(count_ptr, S) / G;")],
        # K2h: the dkv kernel's S^T reads the other head's queries
        "dkv_other_head_q": [("    mul_abt(sc, smem, sq, hoff);",
                              "    mul_abt(sc, smem, sq, 2 * D - hoff);")],
        # K2h: dq's product reads the other head's keys
        "dq_other_head_k": [("      mul_ab(dqa, ha[kk], sk, kk, hoff);",
                             "      mul_ab(dqa, ha[kk], sk, kk, 2 * D - hoff);")],
        # K2h: the invalid slots' dk and dv are computed, not zeroed
        "invalid_slots_written": [
            ("  if (s >= clamp_count(count_ptr, S)) {   // an invalid slot: "
             "exact zeros", "  if (s >= S) {")],
        # K2h: the invalid slots' dk is left unwritten
        "invalid_dk_unwritten": [
            ("      *reinterpret_cast<uint4*>(dk + off) = "
             "make_uint4(0, 0, 0, 0);\n", "")]}),
    "bank_attention_lse_v128": ("k1pv128", {
        # the zero keys TMA fills past Lk are not masked
        "no_key_mask": [("const bool ok = key0 + n * 8 + 2 * t4 + e < Lk;",
                         "const bool ok = true;")],
        # a quarter of the accumulator is not rescaled as the max grows
        "no_rescale": [("      o[4 * n] *= a0;\n", "")],
        # a slot's mass is booked to its neighbour
        "mass_to_neighbour": [
            ("      my_l[slot * BQ + ra] = a;",
             "      my_l[((slot + 1) % S) * BQ + ra] = a;")],
        # the merge drops the second consumer's output
        "merge_drops_second": [
            ("          (w0 * o[4 * n] + v0 * xo[(4 * n) * 128 + tid]) * i0,",
             "          (w0 * o[4 * n]) * i0,")],
        # the lse without the log of the sum
        "lse_no_sum": [
            ("    if (qa < Lq) lse[row_a] = (M0 + log2f(T0)) * LN2;",
             "    if (qa < Lq) lse[row_a] = M0 * LN2;")],
        # head 1 reads head 0's values
        "head0_values": [
            ("          tma_load(sk + TILE + a * ATOM, &tm_v, &full[st], "
             "a * 64, h, key0,",
             "          tma_load(sk + TILE + a * ATOM, &tm_v, &full[st], "
             "a * 64, 0, key0,")]}),
    "stem": ("stem", {
        # conv positions outside the conv grid enter the pool
        "pool_out_of_grid": [
            ("const bool in_grid = cy >= 0 && cy < ho && cx >= 0 && cx < wo;",
             "const bool in_grid = true;")],
        # the 13 pad taps carry nonzero weights
        "pad_tap_weights": [("pad ? __float2bfloat16_rn(0.f)",
                             "pad ? __float2bfloat16_rn(0.25f)")]}),
}


def k1_k3_k1p_check(dev):
    """The template's instantiations: K1's phase-2 calls with the bias and
    with padded keys, at one head and at two, K3's at one head and at two,
    then K1' (with K2) at 2 and 4 valid slots, and K1'x2 at 4 with values
    512 a head."""
    errs = {f"{key}_h{heads}": held_k1(*k1_inputs(dev, heads=heads,
                                                 **K1_CASES[key]))
            for key in ("main", "padded") for heads in (1, 2)}
    errs["k3"] = held_k3(*k3_inputs(dev))
    errs["k3_h2"] = held_k3(*k3_inputs(dev, heads=2))
    for count in (2, 4):
        errs[f"k1p_{count}"] = held_k2(*k2_inputs(dev, count)[1])
    q, bk, bv, cnt, _, _, scale = k2x2_inputs(dev, count=4)
    errs["k1px2_4_v512"] = held_k1ph(q, bk, bv, cnt, scale, 2)[1]
    return errs


def k1v128_check(dev):
    """K1x2v128 (csrc/bank_attention_infer_v128.cu) at K1's six phase-2
    calls, each at the cluster size the launcher picks (4 at batch 1, 2 at
    batch 2), and the main call and one slot at clusters of 3 (a cut inside
    a slot; with one slot of 27 chunks, ranges of 9)."""
    from unittest import mock

    from rmem_tpu_torch.kernels import bank_attention as kb
    errs = {key: held_k1(*k1x2v128_inputs(dev, **kw))
            for key, kw in K1_CASES.items()}
    with mock.patch.object(kb, "v128_cluster", lambda *a, **k: 3):
        for key in ("main", "count_1"):
            errs[f"{key}_cl3"] = held_k1(*k1x2v128_inputs(dev,
                                                          **K1_CASES[key]))
    return errs


def k8_check(dev):
    """K8 (csrc/gated_dwconv.cu) at phase 2's three shapes and on a ragged
    13 x 21 grid of 128 channels at batch 2: held within one bf16 ulp, and
    bit for bit (the kernel keeps the plain version's roundings and order,
    so a changed order shows here)."""
    import torch

    from rmem_tpu_torch.kernels import dwconv as kd
    g = torch.Generator(device=dev).manual_seed(8)
    errs = {}
    for key, (b, gh, gw, c) in {"b1_31x54": (1, 31, 54, 1024),
                                "b2_31x54": (2, 31, 54, 1024),
                                "b2_40x70": (2, 40, 70, 1024),
                                "b2_13x21": (2, 13, 21, 128)}.items():
        x, gate = (torch.randn((b, gh * gw, c), generator=g, device=dev)
                   .bfloat16() for _ in range(2))
        wt = (torch.randn((c, 1, 5, 5), generator=g, device=dev) * 0.2
              ).bfloat16()
        out = kd.gated_dwconv(x, gate, wt, (gh, gw))
        ref = kd.gated_dwconv_plain(x, gate, wt, (gh, gw))
        errs[key] = held("gated_dwconv", out, ref)[0]
        check(torch.equal(out, ref), f"K8 {key}: "
              f"{int((out != ref).sum())} values differ from the plain "
              "version's bits")
    return errs


def k1pv128_check(dev):
    """K1'x2v128 (csrc/bank_attention_lse_v128.cu) at phase 2's calls: 9
    valid slots of 10, 4, and the reference frame's one."""
    errs = {}
    for key, kw in K1PX2_CASES.items():
        q, bk, bv, cnt, _, _, scale = k2x2_inputs(dev, values=256, **kw)
        errs[key] = held_k1ph(q, bk, bv, cnt, scale, 2)[1]
    return errs


def stem_check(dev):
    """K6 at phase 2's two shapes, then K7 over 8 training frames."""
    import torch

    from rmem_tpu_torch.kernels import stem as ks
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for key, hw in K6_SHAPES.items():
        sargs = stem_inputs(dev, g, *hw)
        errs[key] = held("stem", ks.stem(*sargs), ks.stem_plain(*sargs))[0]
    errs["k7"] = held_k7(*stem_inputs(dev, g, 8, *TRAIN_HW, train=True), g,
                         timed=False)["errs"]
    return errs


def k4_k5_check(dev):
    """K4 at the main path's call and on a ragged grid, at one head and at
    two, then K5's backward at one head and at two, on the training grid
    and a ragged one."""
    errs = {f"{key}_h{heads}": held_k4(*k4_inputs(dev, *shape, heads=heads))
            for key, shape in (("b1_31x54", (1, 31, 54)),
                               ("b2_13x21", (2, 13, 21)))
            for heads in (1, 2)}
    for heads in (1, 2):
        errs[f"k5_h{heads}"] = held_k5(*k5_inputs(dev, heads=heads))
        errs[f"k5_h{heads}_13x21"] = held_k5(*k5_inputs(
            dev, heads=heads, batch=2, grid=(13, 21)))
    return errs


def k1h_check(dev):
    """K1h at phase 2's main call, one slot, the reference frame's shape
    and with keys padded past true_lk; K3h at its main call, one slot and
    the reference frame's shape; K1'h at K1PH_CASES."""
    errs = {key: held_k1h(*k1h_inputs(dev, **K1_CASES[key]))
            for key in ("main", "count_1", "reference", "padded")}
    for key in ("main", "count_1", "reference"):
        errs[f"k3h_{key}"] = held_k3h(*k1h_inputs(dev, **K3H_CASES[key]))
    for key, kw in K1PH_CASES.items():
        q, bk, bv, cnt, _, _, scale = k1ph_inputs(dev, **kw)
        errs[f"k1ph_{key}"] = held_k1ph(q, bk, bv, cnt, scale)[1]
    return errs


MUTANT_CHECKS = {
    # K2 at one head (4 valid slots), then K1'x2 + K2x2 at values 512 a
    # head (the split route's shapes) at 9 valid slots (a last dq group of
    # one slot), and at 9 on keys that cancel, fed the plain forward
    "k2": lambda dev: dict(
        h1=held_k2(*k2_inputs(dev)[1]),
        h2=held_k2h(*k2x2_inputs(dev), heads=2),
        cancelling=held_k2h(*k2x2_inputs(dev, cancel=True), heads=2,
                            plain_forward=True)),
    "k1h": k1h_check,
    # K1'x2v128 + K2x2v128 at 4 valid slots, and at 9 on keys that cancel
    "k2_fused": lambda dev: dict(
        four=held_k2h(*k2x2_inputs(dev, count=4, values=256), heads=2),
        cancelling=held_k2h(*k2x2_inputs(dev, values=256, cancel=True),
                            heads=2, plain_forward=True)),
    # K1'h + K2h at 4 valid slots and at the reference frame's one, and
    # on keys that cancel fed the plain forward
    "k2h": lambda dev: dict(
        four=held_k2h(*k1ph_inputs(dev)),
        reference=held_k2h(*k1ph_inputs(dev, slots=1, count=1)),
        cancelling=held_k2h(*k1ph_inputs(dev, cancel=True),
                            plain_forward=True)),
    "k1pv128": k1pv128_check,
    "k1v128": k1v128_check,
    "k8": k8_check,
    "k1_k3_k1p": k1_k3_k1p_check,
    "stem": stem_check,
    "k4_k5": k4_k5_check,
}
# runs in a copy: the copy's chip_smoke and package come first on the path
MUTANT_RUN = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
try:
    errs = chip_smoke.MUTANT_CHECKS[sys.argv[2]](torch.device("cuda", 0))
    print(json.dumps({"caught": None, "errs": errs}))
except RuntimeError as e:
    print(json.dumps({"caught": str(e)}))
"""
def mutation_check(sources=tuple(MUTANTS)) -> int:
    """`--mutants`: for each kernel source in `sources`, copies the package
    into a temporary directory once unchanged and once per mutant, changes
    the mutant's lines there, and runs the source's per-call check (on its
    phase-2 inputs) in each copy, all copies at once. 0 when every mutant
    fails its check and every unchanged copy passes."""
    import shutil
    import tempfile
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            check_name, mutants = MUTANTS[source]
            path = f"rmem_tpu_torch/csrc/{source}.cu"
            for name, edits in {"original": [], **mutants}.items():
                copy = Path(tmp, f"{source}-{name}")
                shutil.copytree(ROOT / "rmem_tpu_torch",
                                copy / "rmem_tpu_torch",
                                ignore=shutil.ignore_patterns("__pycache__"))
                shutil.copy(ROOT / "chip_smoke.py", copy)
                for old, new, *where in edits:
                    target = copy / (where[0] if where else path)
                    text = target.read_text()
                    check(text.count(old) == 1, f"{source} {name}: {old!r} "
                          "not one line")
                    target.write_text(text.replace(old, new))
                proc = subprocess.Popen(
                    [sys.executable, "-c", MUTANT_RUN, str(copy), check_name],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                runs.append((source, name, proc))
        wrong = []
        for source, name, proc in runs:
            out, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"{source} {name}: the check did "
                  f"not run\n{out}\n{err}")
            result = json.loads(out.strip().splitlines()[-1])
            print(f"mutant {source} {name}: {json.dumps(result)}")
            if (result["caught"] is None) == (name != "original"):
                wrong.append(f"{source} {name}")
    if wrong:
        print(f"mutants: wrong outcome for {wrong}")
        return 1
    print("mutants: every mutant failed its per-call check, every original "
          "passed")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=BANK_FULL + 3 * WINDOW)
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of 5 steady frames "
                         "of phases 3, 7, 9, 13 and 17 and of one training "
                         "step of phases 5, 11, 15 and 19")
    ap.add_argument("--mutants", action="store_true",
                    help="only the mutation check of the per-call K2, K4, "
                         "K5, K1, K3, K1', K1h, K3h, K1'h, K2h, K2x2v128, "
                         "K1'x2v128, K1x2v128, K8, K6 and K7 checks (K1, K3, "
                         "K4, K1', K2 and K5's backward at one head and at "
                         "two); prints no result line")
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
        for line in ptxas_lines(path.with_suffix(".log").read_text()):
            print(f"  {name}: {line}")

    t0 = time.perf_counter()
    entries = check_kernels(dev)
    entries.update(check_optin_kernels(dev))
    entries.update(check_two_head_kernels(dev))
    train_entries, k2_whole, k5_whole = check_train_kernels(dev)
    aot_train_entries = check_aot_train_kernels(dev)
    nmg_train_entries, k2x2_whole = check_nmg_train_kernels(dev)
    entries.update(check_aot_nmg_serving_kernels(dev))
    aot_nmg_train_entries, k2x2v128_whole = nmg_bank_train_rows(
        dev, values=256, suffix="_h2v128")
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, window_fps = main_path(dev, args.frames, card, args.profile)
    for key, fn_name in (("bank_attention", "bank_attention_infer"),
                         ("local_attention", "local_attention"),
                         ("stem", "stem")):
        entries[key]["launches"] = counts[fn_name]
    on_path, logit_errs, agree = plain_agreement(dev)
    print(f"phases 3 and 4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_counts, step_times, peak = train_phase(dev, card, args.profile)
    # the trainable wrappers launch K4 and K6 forwards; K2's split kernels
    # launch in one wrapper call
    for key in train_entries:
        fn_name = {"local_attention_fwd_train": "local_attention",
                   "stem_trainable": "stem"}.get(key, key)
        if fn_name.startswith("bank_attention_bwd_split"):
            fn_name = "bank_attention_bwd_split"
        train_entries[key]["launches"] = train_counts[fn_name]
    held_step = held_train_step(dev)
    entries.update(train_entries)
    print(f"phases 5 and 6: {time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    aot_counts, aot_fps = main_path(dev, args.frames, card, args.profile,
                                    model="r50_aotl")
    aot_worst, aot_logit_errs, aot_agree = plain_agreement(dev, "r50_aotl")
    print(f"phases 9 and 10: {time.perf_counter() - t0:.1f} s")
    entries["bank_attention_mh"]["launches"] = aot_counts[
        "bank_attention_infer_mh"]
    t0 = time.perf_counter()
    aot_train_counts, aot_step_times, aot_peak = train_phase(
        dev, card, args.profile, model="r50_aotl")
    for key, e in aot_train_entries.items():
        e["launches"] = aot_train_counts[key]
    entries.update(aot_train_entries)
    aot_held_step = held_train_step(dev, "r50_aotl")
    print(f"phases 11 and 12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nmg_counts, nmg_fps = main_path(dev, args.frames, card, args.profile,
                                    model="r50_deaotl_nmg")
    nmg_worst, nmg_logit_errs, nmg_agree = plain_agreement(
        dev, "r50_deaotl_nmg")
    nmg_k3_launches, nmg_k3_worst = nmg_qminor_agreement(dev)
    print(f"phases 13 and 14: {time.perf_counter() - t0:.1f} s")
    for key, fn_name in (("bank_attention_h2", "bank_attention"),
                         ("local_attention_h2", "local_attention")):
        entries[key]["launches"] = nmg_counts[
            "bank_attention_infer" if fn_name == "bank_attention"
            else fn_name]
        entries[key]["phase14_launches"] = nmg_worst[fn_name]["calls"]
    entries["bank_attention_qminor_h2"].update(
        launches=nmg_k3_launches, launches_from="phase 14, RMEM_BANK_QMINOR "
        "set: K3 is the opt-in route")
    t0 = time.perf_counter()
    nmg_train_counts, nmg_step_times, nmg_peak = train_phase(
        dev, card, args.profile, model="r50_deaotl_nmg")
    for key, e in nmg_train_entries.items():
        fn_name = key.removesuffix("_h2")
        if fn_name.startswith("bank_attention_bwd_split"):
            fn_name = "bank_attention_bwd_split"
        e["launches"] = nmg_train_counts[fn_name]
    entries.update(nmg_train_entries)
    nmg_held_step = held_train_step(dev, "r50_deaotl_nmg")
    print(f"phases 15 and 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aot_nmg_counts, aot_nmg_fps = main_path(dev, args.frames, card,
                                            args.profile,
                                            model="r50_aotl_nmg")
    aot_nmg_worst, aot_nmg_logit_errs, aot_nmg_agree = plain_agreement(
        dev, "r50_aotl_nmg")
    print(f"phases 17 and 18: {time.perf_counter() - t0:.1f} s")
    entries["bank_attention_h2v128"].update(
        launches=aot_nmg_counts["bank_attention_infer"],
        phase18_launches=aot_nmg_worst["bank_attention"]["calls"])
    # no engine path reaches K3 at 8 heads (neither package sends AOT to
    # the q-minor route): phase 17's count, 0, and phase 2's direct calls
    entries["bank_attention_qminor_mh"].update(
        launches=aot_nmg_counts["bank_attention_qminor"],
        launches_from="phase 17; no path reaches K3h, held by direct calls "
        "in phase 2")
    t0 = time.perf_counter()
    aot_nmg_train_counts, aot_nmg_step_times, aot_nmg_peak = train_phase(
        dev, card, args.profile, model="r50_aotl_nmg")
    for key, e in aot_nmg_train_entries.items():
        fn_name = key.removesuffix("_h2v128")
        # the fused pair's two kernels launch in one wrapper call
        if fn_name.startswith("bank_attention_bwd_fused"):
            fn_name = "bank_attention_bwd_fused"
        e["launches"] = aot_nmg_train_counts[fn_name]
    entries.update(aot_nmg_train_entries)
    aot_nmg_held_step = held_train_step(dev, "r50_aotl_nmg")
    print(f"phases 19 and 20: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"fps_windows": window_fps,
                      "fps_median": statistics.median(window_fps),
                      "on_path": on_path, "logit_rel_err": logit_errs,
                      "label_agreement": agree,
                      "train_step_s": step_times,
                      "train_step_s_median": statistics.median(
                          step_times[1:]),
                      "train_peak_gib": peak, "train_launches": train_counts,
                      "k2_whole": k2_whole, "k5_whole": k5_whole,
                      "held_step": held_step,
                      "optin_fps_windows": optin_fps,
                      "optin_fps_median": statistics.median(optin_fps),
                      "optin_launches": optin_counts,
                      "optin_on_path": optin_worst,
                      "optin_logit_rel_err": optin_logit_errs,
                      "optin_label_agreement": optin_agree,
                      "route_turns": turns,
                      "aot_fps_windows": aot_fps,
                      "aot_fps_median": statistics.median(aot_fps),
                      "aot_launches": aot_counts,
                      "aot_on_path": aot_worst,
                      "aot_logit_rel_err": aot_logit_errs,
                      "aot_label_agreement": aot_agree,
                      "aot_train_step_s": aot_step_times,
                      "aot_train_step_s_median": statistics.median(
                          aot_step_times[1:]),
                      "aot_train_peak_gib": aot_peak,
                      "aot_train_launches": aot_train_counts,
                      "aot_held_step": aot_held_step,
                      "nmg_fps_windows": nmg_fps,
                      "nmg_fps_median": statistics.median(nmg_fps),
                      "nmg_launches": nmg_counts,
                      "nmg_on_path": nmg_worst,
                      "nmg_logit_rel_err": nmg_logit_errs,
                      "nmg_label_agreement": nmg_agree,
                      "nmg_k3_on_path": nmg_k3_worst,
                      "k2x2_whole": k2x2_whole,
                      "nmg_train_step_s": nmg_step_times,
                      "nmg_train_step_s_median": statistics.median(
                          nmg_step_times[1:]),
                      "nmg_train_peak_gib": nmg_peak,
                      "nmg_train_launches": nmg_train_counts,
                      "nmg_held_step": nmg_held_step,
                      "aot_nmg_fps_windows": aot_nmg_fps,
                      "aot_nmg_fps_median": statistics.median(aot_nmg_fps),
                      "aot_nmg_launches": aot_nmg_counts,
                      "aot_nmg_on_path": aot_nmg_worst,
                      "aot_nmg_logit_rel_err": aot_nmg_logit_errs,
                      "aot_nmg_label_agreement": aot_nmg_agree,
                      "k2x2v128_whole": k2x2v128_whole,
                      "aot_nmg_train_step_s": aot_nmg_step_times,
                      "aot_nmg_train_step_s_median": statistics.median(
                          aot_nmg_step_times[1:]),
                      "aot_nmg_train_peak_gib": aot_nmg_peak,
                      "aot_nmg_train_launches": aot_nmg_train_counts,
                      "aot_nmg_held_step": aot_nmg_held_step,
                      "card": card, "host": host_line()}))
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

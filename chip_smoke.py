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
   and every key valid, beside SDPA over the valid slots), and the JPEG
   colour kernel (csrc/jpeg_color.cu: libjpeg's chroma upsampling and
   YCbCr to RGB on the planes nvJPEG decodes, at 4:2:0 480x854 and
   479x853 and 4:4:4, bit for bit against its plain version, timed in a
   CUDA graph; it replaces the JAX readers' cv2 decode, no TPU kernel). K1h, K3h and
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
   CPU and load. From its second frame the engine serves by CUDA-graph
   replays (rmem_tpu_torch/engine/graphs.py), which add each graph's
   recorded launches to the counters; the phases that hold each kernel call
   (4, 10, 14, 18, the holds of 7, 23, 24 and 26) and phase 30's eager
   engine build theirs with graphs=False;
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
   the all-plain model: loss and global gradient norm;
21. the evaluator on the card: a VOST tree of two videos at 480x854
   (seq0, 90 frames with 10 objects; seq1, 60 frames with 3), seeded
   frames encoded to JPEG on the card by nvJPEG (quality 95, 4:2:0) and
   an annotation for every frame written by the package's PNG writer;
   then `python -m rmem_tpu_torch.tools.eval --stage pre_vost_2 --model
   r50_deaotl --dataset vost --ckpt_path test --score --metrics J J_last F
   --opt eval_fps_window=30` in a process of its own, through a spy that
   counts launches from 0 and copies every frame the evaluator fed the
   engine. Checks: nvJPEG's frames at least 35 dB PSNR against the
   source; launches exact (K1 and K4 3, K6 1 for every propagated frame,
   the last chunk's padding included, and every reference frame; K1h, K3
   and K8 never); the fed frames equal a synchronous decode bit for bit;
   a palette PNG with the label colormap for every frame at 480x854, ids
   within each video's objects, the first annotation copied byte for
   byte; J, J_tr and F finite in [0, 1]; on frame 1 of each video the
   kernel route's labels agree with the plain route's (an evaluator with
   the engine's plain versions, on the card) on at least 0.98 of pixels,
   and the mean J of the two over every frame is printed. Prints
   all_frame_fps, each video's and each window's frames/s, peak_hbm_gb
   and nvJPEG's decode ms a frame beside the card (`--profile`: a traced
   CLI run of seq0's first 48 frames, the device's busy ms a frame and
   idle share).
22. weights in and out, and the single-video tools: a reference-layout
   .pth of R50-DeAOTL and of R50-AOTL written from seeded tensors (the
   converter's inverse over the port's state dict: BN running statistics,
   the LSTT's linear weights as 1x1 convs, an 11-channel id bank,
   `module.` prefixes under `state_dict`, one dead TIME_ENCODE key), each
   loaded through `load_model_params`: nothing skipped or unexpected, the
   dead key reported, every folded BN within 1e-6 of the fold in f64, every
   other weight the file's, id-bank channel 11 zero; then `python -m
   rmem_tpu_torch.tools.demo` on the R50-DeAOTL .pth over 40 seeded
   480x854 frames with 10 objects (phase 21's writer, JPEG-encoded on the
   card) in a process of its own that counts launches (K1 3, K4 3, K6 1 a
   frame; K1h, K3, K8 never), a mask and an overlay for every frame, frame
   0's mask the first mask, every mask equal to the evaluator's per-frame
   path (`force_slow`) on the same frames and .pth; the demo for R50-AOTL
   over 10 frames (K1h 3, K6 1); `python -m rmem_tpu_torch.tools.video`
   over both demos' masks, the mp4 read back by cv2 as 40 frames of 480 x
   2562; 6 of phase 5's training steps from the .pth (first parameters
   load_model_params's, phase 5's launches a step) saving the checkpoint
   stream every 2 steps and keeping 2, a new trainer auto-resuming at step
   6 with the saved state, at step 4 past a truncated save, and the EMA
   stream's file served by an evaluator. Prints the .pth load seconds, the
   demo's frames/s beside phase 3's, and a stream save's seconds and MB.

23. AOT-L + RMem on MobileNetV2, the default encoder, at full width
   (`get_config("pre_vost", model="aotl")`: 3 LSTT layers of 8 heads of
   32, encoder dims (24, 32, 96, 1280), 1 + 8 slots) on phase 3's
   traffic: frames/s per window, peak memory (`--profile`: device busy ms
   a frame), exact launches a frame (K1h 3; K6, K1, K3, K4, K8 never; the
   stem is a 3x3/s2 conv); then phase 4's hold (every K1h call against its
   plain version, the engine against the all-plain engine); then a
   reference-layout AOT-L .pth (MobileNetV2's `features` names) written
   from seeded tensors, loaded through `load_model_params` with nothing
   skipped or unexpected, and served for 5 frames.
24. every other preset, each on phase 3's traffic for 20 frames and held
   against its all-plain engine through the reference and 8 frames: aott,
   aots, aotb (MobileNetV2 at 1, 2, 3 LSTT layers: K1h 1, 2, 3 a frame),
   deaott (K1 and K4 1), aotl_v3 (MobileNetV3), r101_aotl (ResNet-101: K6
   1 a frame, the only one), rs101_aotl (ResNeSt-101), swinb_aotl (Swin-B
   at 480 x 848: its VALID patch embed's 30 x 53 grid, 1590 tokens; at 481
   x 849 its grid is a row and a column short of the id bank's) and
   r50_topdown_aotl (the top-down ResNet-50, its stem plain). Prints each
   preset's frames/s over the last 10 frames and its seconds.
25. training: AOT-L on MobileNetV2 for 6 of phase 11's steps (K1'h 87 and
   K2h 45 a step, no K7), s/step and peak memory, its kernel step held
   against the plain step as phase 12; then 2 steps each of DeAOT-T (K1'
   and K4 29, K2 and K5's backward 15), AOT-L on ResNet-101 (K7 1), on
   the top-down ResNet-50, whose var_loss must be finite, above 0 and in
   the loss at weight 0.01, on MobileNetV3, on ResNeSt-101 and on Swin-B
   (at 464x464: at 465 Swin's VALID patch embed misses the id bank's
   grid by a row and a column), each with K1'h 87 and K2h 45 a step,
   finite losses, changed parameters, s/step and peak memory.
26. R50-AOTL + RMem with the ConvGRU memory (`get_config("pre_vost",
   model="r50_aotl", gru_memory=True)`) on phase 9's traffic: exact
   launches a frame (K1h 3, K6 1; K1, K3, K4, K8 never), frames/s beside
   phase 9's; the GRU rounds (at least 17: every write after the bank
   fills at frame 40) with the hidden states changing on exactly those
   frames; the device busy ms a frame of both models over 10 steady
   frames; phase 4's hold through the first three evicting writes.
27. training on a tree: a VOST-layout tree of 3 videos of 30 frames at
   480x854 with up to 10 objects written on the card (phase 21's
   writer); the training loader's batch on the card against its CPU route
   on the same files (labels and obj_nums equal, frames >= 40 dB PSNR)
   and its ms a clip; 6 steps of R50-AOTL with the GRU memory and
   reverse_infer from the tree (latter_mem_len 2: one GRU round a clip;
   K1'h 105 and K2h 54 a step with the 3 reverse decodes), its kernel step
   held against the plain step as phase 12; 2 steps of R50-DeAOTL with
   reverse_infer and SGD (K1' and K4 105, K2 and K5's backward 54); then
   `python -m rmem_tpu_torch.tools.train --stage pre_vost_2 --data_root
   <tree> --max_steps 2` in a process of its own (launches a step exact,
   every frame decoded on the card, the config, logs/ and img_logs/
   written).

28. the static-image stage `pre`: a Static tree of 24 images at 480x640
   with 1-10 objects written on the card (nvJPEG's encoder, palette PNG
   masks); the stage's loader on the card against its CPU route on the
   same files (labels and obj_nums equal, frames >= 45 dB PSNR) and its
   ms a clip at the stage's batch; then `python -m
   rmem_tpu_torch.tools.train --stage pre --data_root <tree> --opt
   pretrain=false` for 2 steps of R50-DeAOTL at the stage's 16 clips of
   5 at 465x465 in a process of its own: s/step, peak GiB and exact
   launches a step (K1' and K4 27, K2 and K5's backward 15, K7 1).
29. processes: the training CLI with --mesh 1 (nccl) against the plain
   CLI, one step at batch 2, every state tensor bit for bit (both
   --deterministic); with --mesh 2 (two ranks on the one card over gloo)
   against one process, 2 SGD steps at global batch 4 in f32 compute
   (the last loss to 1e-4 relative, every weight to 1e-5); the evaluator's
   CLI as two ranks (gloo) over 2 short sequences against one process
   (the same masks, each sequence on one rank, the all-reduced stats).
   All seven processes run at once.
30. export: R50-DeAOTL's bf16 serving step at 481x849 through
   tools/export.py's build_exported, saved, loaded and run for 30 frames
   after the reference beside the eager engine (labels equal on >= 0.999
   of pixels, the bank count equal, launches a frame K1 3, K4 3 and K6 1
   in both, through the rmem:: custom ops in the exported program); each
   route's frames/s; the host's issue time of K1's, K4's and K6's calls
   direct and through their custom ops, in turns.
31. every serving family through torch.export (build_exported at
   481x849 in, 480x854 out, bf16, seeded weights; saved and loaded):
   R50-AOTL, R50-AOTL with the ConvGRU memory, R50-AOTL and R50-DeAOTL
   with no_memory_gap, R50-DeAOTL on the opt-in route (K3 and K8, one id
   group, one aug) and R50-DeAOTL with no_long_memory. Each program is
   handed the eager engine's state once its bank is full (40 frames at a
   write every 5, 8 at every frame; no_long_memory from the reference),
   then 30 frames run through the eager engine and through the program
   from that state: the family's rmem:: ops (and with the GRU memory one
   cond) in the graph, launches a frame exact in both (R50-AOTL and the
   GRU memory K1h 3, K6 1; R50-AOTL with no_memory_gap K1x2v128 3, K6 1;
   R50-DeAOTL with no_memory_gap K1x2 3, K4x2 3, K6 1; the opt-in route
   K3 3, K8 9, K4 3, K6 1; no_long_memory K1 3, K4 3, K6 1; each launch
   of K1's template at the family's head shape), labels equal on >= 0.999
   of pixels, the bank count and the evictions equal, with the GRU memory
   at least 5 rounds and the hidden states after each within 2e-2 of
   eager's max; frames/s of both.
32. tensor parallel: `python -m rmem_tpu_torch.tools.train --mesh 1 2
   --opt "mesh_axes=('data','model')"` on phase 28's Static tree, its two
   ranks on the one card over gloo, for R50-DeAOTL (the GPM's gated
   self-attention split: 27 split parameters) and R50-AOTL (the
   self-attention's output projection: 3), each against one unsplit
   process, 2 SGD steps at batch 2 in f32 compute: the last loss within
   1e-4 relative, every gathered weight within 1e-5, each rank's launches
   a step equal to the unsplit step's (stage pre's clips of 5: K1' and K4
   27, K2 and K5's backward 15, K7 1; K1'h 27, K2h 15, K7 1); the four
   processes at once. Prints s/step and peak GiB of each.

Phase 2 also holds K1h on Swin-B's 30 x 53 grid (1590 tokens; and keys
padded 70 past them).

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
that cancel), K1'x2v128 (held_k1ph at 9, 4 and 1 valid slots), the JPEG colour kernel
(jpeg_color_check at JPEG_CASES, bit for bit) and K6 and
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
the lse drops the log of the sum, or head 1 reads head 0's values; the
JPEG colour kernel: even outputs rounded as odd ones, a chroma row taken
as its own neighbour, G's Cr term with the wrong sign, or the last
column's neighbour read past the row;
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
    # a trace with no device activity at all is the profiler missing the
    # window (seen once on an H100 run in which every call had run and
    # been held), not a kernel's outcome: trace again, at most twice more
    for _ in range(3):
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {e.key: e.self_device_time_total / (1e3 * reps)
                 for e in p.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if split:
            return split
    return split


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


# the input of Swin-B's serving phase (swinb_aotl in phase 24): its VALID
# 4x4 patch embed gives a 30 x 53 grid at 481 x 849 where the id bank's is
# 31 x 54, so no engine serves it there; at 480 x 848 both are 30 x 53
SWIN_HW = (480, 848)
SWIN_GRID = (30, 53)

# K1 in phase 2: the main path's call (batch 1 on 31 x 54, 9 valid slots of
# 10, the slot-PE bias) and the other calls K1 takes: one slot or all ten,
# the reference frame's (one slot, no bias), two id groups, and keys padded
# 70 past true_lk (true_lk not a multiple of 64, so a mask at Lk shows)
K1_CASES = {"main": {}, "count_1": dict(count=1), "count_10": dict(count=10),
            "reference": dict(slots=1, count=1, bias=False),
            "batch_2": dict(batch=2), "padded": dict(pad=70)}
# K1h's calls on Swin-B's 30 x 53 grid (1590 tokens: swinb_aotl, phase 24),
# 9 valid slots of 10 and keys padded 70 past true_lk
K1H_EXTRA_CASES = {"swin_30x53": dict(grid=SWIN_GRID),
                   "swin_30x53_padded": dict(grid=SWIN_GRID, pad=70)}


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
               bias: bool = True, pad: int = 0, grid=None):
    """K1h's inputs at a call of the AOT serving path on the 31 x 54 grid
    (or `grid`: Swin-B's 30 x 53) (bf16, 8 heads of 32, Lq = true_lk = 1674
    (1590) and Lk = true_lk + pad): (q, bank_k, bank_v, count, heads,
    scale, true_lk, qbias [B, 8, Lq, S] or None). Phase 2 holds K1h at K1's
    cases (K1_CASES) and on Swin-B's grid (K1H_EXTRA_CASES)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    gh, gw = grid or ((IN_HW[0] - 1) // 16 + 1, (IN_HW[1] - 1) // 16 + 1)
    hw = gh * gw
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
    extra = K1H_EXTRA_CASES if name == "bank_attention_mh" else {}
    for key, kw in {**K1_CASES, **extra}.items():
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


def reference_inputs(dev, in_hw=None):
    import numpy as np
    import torch
    in_hw = in_hw or IN_HW
    g = torch.Generator(device=dev).manual_seed(1)
    mask = np.zeros((1, *in_hw), np.int32)
    for i in range(NUM_OBJECTS):          # 10 object stripes
        mask[:, :, i * 80:i * 80 + 60] = i + 1
    img0 = torch.rand((1, *in_hw, 3), generator=g, device=dev)
    return img0, mask, g


# the served configurations: phase 3's and 4's, phase 9's and 10's, phase
# 13's and 14's (R50-DeAOTL with no_memory_gap: 2 heads of 128, values 512
# a head) and phase 17's and 18's (R50-AOTL with no_memory_gap: 2 heads of
# 128 in the long- and short-term attention, values 128 a head)
SERVED = {"r50_deaotl": dict(model="r50_deaotl"),
          "r50_aotl": dict(model="r50_aotl"),
          "r50_deaotl_nmg": dict(model="r50_deaotl", no_memory_gap=True),
          "r50_aotl_nmg": dict(model="r50_aotl", no_memory_gap=True)}
# phase 23's AOT-L on MobileNetV2 (the default encoder) at full width, and
# phase 24's other presets: the AOT family on MobileNetV2 at 1, 2 and 3
# LSTT layers, DeAOT-T (one GPM layer), and AOT-L on MobileNetV3,
# ResNet-101, ResNeSt-101, Swin-B and the top-down ResNet-50
ENCODER_PRESETS = ("aott", "aots", "aotb", "deaott", "aotl_v3", "r101_aotl",
                   "rs101_aotl", "swinb_aotl", "r50_topdown_aotl")
SERVED.update({m: dict(model=m) for m in ("aotl",) + ENCODER_PRESETS})
# a served model's input where it is not IN_HW, and its 16x grid where it
# is not the id bank's usual 31 x 54 (checked on the bank's tokens)
SERVED_HW = {"swinb_aotl": SWIN_HW}
SERVED_GRID = {"swinb_aotl": SWIN_GRID}


_SEEDED = {}     # the last model's seeded weights: phases build it 3 times


def build_engine(dev, model: str = "r50_deaotl", graphs=None):
    """The served model's engine (`graphs` as InferenceEngine takes it: the
    held phases serve eagerly, so that every kernel call is a call)."""
    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.engine import InferenceEngine
    from rmem_tpu_torch.models import build_vos_model, init_params
    cfg = get_config("pre_vost", **SERVED[model])
    net = build_vos_model(cfg.model_vos, cfg)
    if model not in _SEEDED:      # init_params(net, seed=0), once a model
        _SEEDED.clear()
        _SEEDED[model] = {k: v.clone() for k, v in
                          init_params(net, seed=0).state_dict().items()}
    net.load_state_dict(_SEEDED[model])
    return InferenceEngine(net, cfg, device=dev, graphs=graphs), cfg


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
    with the evaluator's (1 with no_memory_gap); so do the presets that set
    no gap of their own (aott, aots, aotb, deaott: 9999, which the
    evaluator ignores: 5 here)."""
    return (evaluator_gap(cfg, num_frames)
            if cfg.no_memory_gap or cfg.test_long_term_mem_gap >= 9999
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
# phases 23 and 24: K1h once a frame in each LSTT layer, K6 only for
# ResNet-101 (the other encoders' stems are not its 7x7/s2 conv + max pool,
# the top-down one's runs plain, as in the JAX package); DeAOT-T's one GPM
# layer K1 and K4 once
_AOT_LAYERS = {"aott": 1, "aots": 2, "aotb": 3, "aotl": 3, "aotl_v3": 3,
               "r101_aotl": 3, "rs101_aotl": 3, "swinb_aotl": 3,
               "r50_topdown_aotl": 3}
SERVED_LAUNCHES.update({
    m: dict(bank_attention_infer_mh=n, stem=int(m == "r101_aotl"),
            bank_attention_infer=0, local_attention=0,
            bank_attention_qminor=0) for m, n in _AOT_LAYERS.items()})
SERVED_LAUNCHES["deaott"] = dict(bank_attention_infer=1, local_attention=1,
                                 stem=0, bank_attention_infer_mh=0,
                                 bank_attention_qminor=0)
# the head shape (heads, key width, value width a head) of every launch of
# K1's template on each served path: the wrapper's one counter covers the
# template's instantiations, so the shape tells K1x2v128 from K1 and K1x2
SERVED_SHAPES = {"r50_deaotl": (1, 128, 1024), "r50_aotl": None,
                 "r50_deaotl_nmg": (2, 128, 512),
                 "r50_aotl_nmg": (2, 128, 128), "deaott": (1, 128, 1024)}
SERVED_SHAPES.update({m: None for m in _AOT_LAYERS})
PHASE_LABEL = {"r50_deaotl": "main path", "r50_aotl": "phase 9 (AOT)",
               "r50_deaotl_nmg": "phase 13 (no_memory_gap)",
               "r50_aotl_nmg": "phase 17 (AOT no_memory_gap)",
               "aotl": "phase 23 (AOT-L, MobileNetV2)"}
PHASE_LABEL.update({m: f"phase 24 ({m})" for m in ENCODER_PRESETS})


def main_path(dev, frames: int, card: str, profile: bool,
              model: str = "r50_deaotl", window: int = WINDOW):
    """Phase 3 (R50-DeAOTL), phase 9 (R50-AOTL), phase 13 (R50-DeAOTL with
    no_memory_gap, the evaluator's gap of 1), phase 17 (R50-AOTL with
    no_memory_gap, the same gap), phase 23 (AOT-L on MobileNetV2) or phase
    24 (another preset, a shorter run in shorter windows: the bank does not
    fill): returns (launch counts, per-window frames/s). Frames/s are of
    the windows after the bank fills, or of the last ones where it does
    not fill."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks

    phase = PHASE_LABEL[model]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, cfg = build_engine(dev, model)
    in_hw = SERVED_HW.get(model, IN_HW)
    img0, mask, g = reference_inputs(dev, in_hw)
    imgs = torch.rand((frames, 1, *in_hw, 3), generator=g, device=dev)
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
    grid = tuple(state.logits4x.shape[1:3])
    if model in SERVED_GRID:
        gh, gw = SERVED_GRID[model]
        check(state.short_k.shape[2] == gh * gw == state.bank.k.shape[3],
              f"{phase}: {state.short_k.shape[2]} tokens a frame, expected "
              f"the {gh}x{gw} grid's {gh * gw}")
    labels = []
    windows = max(1, (frames - BANK_FULL) // window)
    first = max(0, frames - windows * window)
    host = host_line()
    marks = []
    slots = cfg.former_mem_len + cfg.latter_mem_len
    evictions = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(frames):
        if t >= first and (t - first) % window == 0:
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
    window_fps = [window / (b - a) for a, b in zip(marks, marks[1:])]
    fps = statistics.median(window_fps)

    labels = torch.stack(labels)
    evictions = int(evictions)
    # the reference fills slot 1; a write every `gap` frames fills the rest
    scheduled = max(0, frames // gap - (slots - 1))
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
    check(int(state.bank.count) == min(slots, 1 + frames // gap),
          f"bank count {int(state.bank.count)}")
    check(evictions == scheduled and (evictions >= 1 or frames < BANK_FULL),
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
          f"{window} frames ("
          + ", ".join(f"{x:.3f}" for x in window_fps)
          + f"; the last is the last {window} frames) at "
          f"{in_hw[0]}x{in_hw[1]} in ({grid[0]}x{grid[1]} logits, a "
          f"{(grid[0] - 1) // 4 + 1}x{(grid[1] - 1) // 4 + 1} grid), "
          f"480x854 out, 10 objects, {model}, on {card}; host {host}; "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if profile:
        def five_frames():
            for t in range(5):
                engine.step(state, imgs[t], OUT_HW)
        device_busy_table(five_frames, 5, 1e3 / fps, "per frame")
    del engine, state
    torch.cuda.empty_cache()
    return counts, window_fps


# phases 4, 10, 14 and 18: the frames through which the kernel and plain
# engines are held frame by frame. With a write every 5 frames the bank
# fills at frame 40 and AGREE_FRAMES stops before the first eviction; with
# no_memory_gap's write every frame it fills at frame 8, whose write is the
# first eviction, so phases 14 and 18 hold frames 0 to 8 (the eviction's
# victim may follow a near tie in the slot mass, which the bf16 rounding
# inside the kernels can flip)
PLAIN_FRAMES = {"r50_deaotl": AGREE_FRAMES, "r50_aotl": AGREE_FRAMES,
                "r50_deaotl_nmg": 9, "r50_aotl_nmg": 9, "aotl": AGREE_FRAMES}
AGREE_PHASE = {"r50_deaotl": "phase 4", "r50_aotl": "phase 10",
               "r50_deaotl_nmg": "phase 14", "r50_aotl_nmg": "phase 18",
               "aotl": "phase 23, held"}
# phase 24 holds each preset through the reference and 8 frames, the kernel
# engine's run no longer than the plain one's
PRESET_AGREE_FRAMES = 8
PLAIN_FRAMES.update({m: PRESET_AGREE_FRAMES for m in ENCODER_PRESETS})
AGREE_PHASE.update({m: f"phase 24 ({m}), held" for m in ENCODER_PRESETS})


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
    with no_memory_gap), phase 18 (R50-AOTL with no_memory_gap, K1's
    template at values 128 a head), phase 23's hold (AOT-L on MobileNetV2)
    or phase 24's (each other preset, through the reference and 8 frames,
    the bank at 2 slots): the same weights and frames through the kernel
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
    from rmem_tpu_torch.ops.resize import (resize_bilinear, resize_nearest,
                                           upsample_argmax)

    phase = AGREE_PHASE[model]
    bank = ("bank_attention", kb, "bank_attention_infer",
            kb.bank_attention_plain)
    stem = ("stem", ks, "stem", ks.stem_plain)
    local = ("local_attention", kl, "local_attention",
             kl.local_attention_plain)
    # the LSTT calls bank_attention_infer, which routes 8 heads to K1h
    mh = ("bank_attention_mh",) + bank[1:]
    launches = SERVED_LAUNCHES[model]
    kernels = tuple(k for k, n in (
        (mh, launches["bank_attention_infer_mh"]),
        (bank, launches["bank_attention_infer"]),
        (local, launches["local_attention"]), (stem, launches["stem"])) if n)
    calls = {name: [] for name, *_ in kernels}
    kb.bank_attention_infer_mh.launches = 0
    decided = []

    in_hw = SERVED_HW.get(model, IN_HW)
    frames = (PLAIN_FRAMES[model]
              if model in ENCODER_PRESETS + ("r50_aotl_gru",)
              else AGREE_FRAMES)
    img0, mask, g = reference_inputs(dev, in_hw)
    imgs = torch.rand((frames, 1, *in_hw, 3), generator=g, device=dev)
    runs = []
    for plain in (False, True):
        with ExitStack() as stack:
            for name, mod, attr, plain_fn in kernels:
                fn = (plain_fn if plain
                      else holding(calls, name, getattr(mod, attr), plain_fn))
                stack.enter_context(mock.patch.object(mod, attr, fn))
            engine, cfg = build_engine(dev, model, graphs=False)
            gap = served_gap(cfg, AGREE_FRAMES + 1)
            state, logits = engine.add_reference(img0, mask, [NUM_OBJECTS],
                                                 gap=gap)
            frame_logits, labels = [logits.float()], []
            for t in range(frames if not plain else PLAIN_FRAMES[model]):
                if not plain:
                    state, label = engine.step(state, imgs[t], OUT_HW)
                else:
                    state, logits4 = engine.propagate(state, imgs[t])
                    label = upsample_argmax(logits4, OUT_HW,
                                            cfg.model_align_corners)
                    # the pixels whose label the plain logits decide at the
                    # precision they are held to: top-2 margin above
                    # LOGIT_TOL of the largest logit
                    up = resize_bilinear(logits4.float(), OUT_HW,
                                         cfg.model_align_corners)
                    top2 = up.topk(2, dim=-1).values
                    decided.append(top2[..., 0] - top2[..., 1]
                                   > LOGIT_TOL * up.abs().max())
                    forced = runs[0][1][t]
                    engine.update_memory(state, resize_nearest(
                        forced[None, ..., None], in_hw)[..., 0])
                frame_logits.append(state.logits4x.float())
                labels.append(label)
            runs.append((frame_logits, labels, int(state.bank.count)))
            del engine, state
    worst = {}
    for name, errs in calls.items():
        worst[name] = dict(calls=len(errs),
                           rel_err=max(e / top for e, top, _ in errs))
        if name in ("bank_attention", "bank_attention_mh"):
            worst[name]["slot_mass_err"] = max(m for *_, m in errs)
    print(f"{phase}, every kernel call on the path against its plain "
          f"version: {worst}")
    if launches["bank_attention_infer_mh"]:
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
    slots = min(cfg.former_mem_len + cfg.latter_mem_len,
                1 + PLAIN_FRAMES[model] // gap)
    check(count == count_p == slots, f"{phase} bank counts {count}, "
          f"{count_p}, expected {slots}")
    check(all(w["calls"] > 0 for w in worst.values()), f"calls {worst}")
    check(max(errs) <= LOGIT_TOL, f"{phase} logits {max(errs)}")
    if model not in ENCODER_PRESETS:
        check(min(agree) >= AGREE_FLOOR,
              f"{phase} label agreement {min(agree)}")
        return worst, errs, agree
    # phase 24 holds the labels the plain logits decide: on random weights
    # the shallow presets' logits tie on a tenth of the pixels within 1 %
    # of the largest logit, under the engines' ~2 % difference (PERF.md)
    on_decided = [((a == b) & d).sum().item() / max(d.sum().item(), 1)
                  for a, b, d in zip(yk, yp, decided)]
    ties = [1 - d.float().mean().item() for d in decided]
    print(f"{phase}, label agreement per frame on the pixels the plain "
          f"logits decide (top-2 margin above {LOGIT_TOL:g} of the largest "
          "logit): " + ", ".join(f"{a:.5f}" for a in on_decided)
          + "; the tied pixels' share: " + ", ".join(f"{x:.4f}"
                                                     for x in ties))
    check(min(on_decided) >= AGREE_FLOOR,
          f"{phase} label agreement on decided pixels {min(on_decided)}")
    worst["labels"] = dict(agreement_on_decided=on_decided, tie_share=ties)
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
        engine, cfg = build_engine(dev, "r50_deaotl_nmg", graphs=False)
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


def optin_engine(dev, cfg, graphs=None):
    """The engine of phase 7 and its augs, as the evaluator builds them
    from the config: (scale, flip) for each scale and, with test_flip,
    both flips; each aug's input size by restrict_size. `graphs` as
    build_engine's."""
    from rmem_tpu_torch.data.transforms import restrict_size
    from rmem_tpu_torch.engine import InferenceEngine
    from rmem_tpu_torch.models import build_vos_model, init_params
    model = init_params(build_vos_model(cfg.model_vos, cfg), seed=0)
    engine = InferenceEngine(model, cfg, device=dev, graphs=graphs)
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
        last = states[0].last_mem_step
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
            engine, augs, in_hws = optin_engine(dev, cfg, graphs=False)
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
# phase 25: AOT-L on MobileNetV2 (no stem kernel), DeAOT-T (one GPM
# layer), AOT-L on ResNet-101 (K7) and on the top-down ResNet-50 (its stem
# plain, as in the JAX package)
_AOT_TRAIN = dict(TRAIN_LAUNCHES["r50_aotl"], stem=0)
TRAIN_LAUNCHES.update({
    "aotl": _AOT_TRAIN, "r101_aotl": dict(_AOT_TRAIN, stem=1),
    "r50_topdown_aotl": _AOT_TRAIN, "aotl_v3": _AOT_TRAIN,
    "rs101_aotl": _AOT_TRAIN, "swinb_aotl": _AOT_TRAIN,
    "deaott": dict(TRAIN_LAUNCHES["r50_deaotl"], stem=0,
                   bank_attention_lse=_FWD // 3,
                   bank_attention_bwd_split=_BWD // 3,
                   local_attention=_FWD // 3, local_attention_bwd=_BWD // 3)})
TRAIN_PHASE = {"r50_deaotl": ("phase 5", "R50-DeAOTL"),
               "r50_aotl": ("phase 11", "R50-AOTL"),
               "r50_deaotl_nmg": ("phase 15",
                                  "R50-DeAOTL with no_memory_gap"),
               "r50_aotl_nmg": ("phase 19", "R50-AOTL with no_memory_gap"),
               "aotl": ("phase 25", "AOT-L on MobileNetV2"),
               "deaott": ("phase 25", "DeAOT-T on MobileNetV2"),
               "r101_aotl": ("phase 25", "AOT-L on ResNet-101"),
               "r50_topdown_aotl": ("phase 25",
                                    "AOT-L on the top-down ResNet-50"),
               "aotl_v3": ("phase 25", "AOT-L on MobileNetV3"),
               "rs101_aotl": ("phase 25", "AOT-L on ResNeSt-101"),
               "swinb_aotl": ("phase 25", "AOT-L on Swin-B")}
# a trained model's crop where it is not TRAIN_HW: Swin's VALID patch embed
# meets the id bank's grid at a side that is a multiple of 16 (465 is one
# past), as phase 24 serves it at 480 x 848
TRAIN_CROP = {"swinb_aotl": (464, 464)}
# phase 25's other models take two steps each
ENCODER_TRAIN_STEPS = 2
# the held kernel step against the all-plain step of each trained model
HELD_PHASE = {"r50_deaotl": "phase 6", "r50_aotl": "phase 12",
              "r50_deaotl_nmg": "phase 16", "r50_aotl_nmg": "phase 20",
              "aotl": "phase 25, held"}


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


def train_config(model: str = "r50_deaotl", steps: int = TRAIN_STEPS):
    """pre_vost `model` (a key of SERVED: r50_deaotl_nmg and r50_aotl_nmg
    are R50-DeAOTL and R50-AOTL with no_memory_gap) at the card's batch,
    with train_total_steps set so that the use_prev_pred curriculum (from
    half the total) starts inside a run of `steps` steps."""
    from rmem_tpu_torch.config import get_config
    # a fresh run: never resumed from a checkpoint stream under ./results
    # (pre_vost's preset turns it off too), and no save within the phases'
    # steps (train_save_step 500)
    return get_config("pre_vost", **SERVED[model], train_batch_size=TRAIN_B,
                      train_total_steps=max(2, 2 * steps - 4),
                      train_auto_resume=False,
                      data_randomcrop=TRAIN_CROP.get(model, TRAIN_HW))


def fifo_evictions(cfg) -> int:
    """The FIFO evictions of one training clip: frames 1 .. T-1 write every
    train_long_term_mem_gap frames after the reference's slot, and each
    write past former + latter slots evicts (engine/training.py)."""
    writes = (cfg.data_seq_len - 1) // cfg.train_long_term_mem_gap
    return max(0, 1 + writes - cfg.former_mem_len - cfg.latter_mem_len)


def reverse_writes(cfg) -> int:
    """The reverse decodes of one training clip with reverse_infer: one
    after each long-term write (frames gap, 2 gap, ... of 1 .. T-1)."""
    return ((cfg.data_seq_len - 1) // cfg.train_long_term_mem_gap
            if cfg.reverse_infer else 0)


def train_phase(dev, card: str, profile: bool, model: str = "r50_deaotl",
                steps: int = TRAIN_STEPS, data_root=None):
    """Phase 5 (R50-DeAOTL), phase 11 (R50-AOTL), phase 15 (R50-DeAOTL
    with no_memory_gap: 2 heads of 128, a long-term write every frame),
    phase 19 (R50-AOTL with no_memory_gap, the same, values 128 a head) or
    phase 25 (AOT-L on MobileNetV2, and 2 steps each of DeAOT-T, AOT-L on
    ResNet-101 and on the top-down ResNet-50) or phase 27 (R50-AOTL with
    the GRU memory and reverse_infer, R50-DeAOTL with reverse_infer and
    SGD): `steps` training steps on synthetic clips, or with `data_root`
    on the clips the trainer's loader draws from the tree there (465 x
    465, 15 frames, 4 clips), random weights from a seed. Launch counts are zeroed just before and read just after, and
    each step's must equal TRAIN_LAUNCHES[model]; the FIFO evictions each
    step makes (counted on the host at the bank's out-of-place compaction)
    must equal the schedule's (fifo_evictions: phases 15's and 19's 6 a
    clip). Where the model has a var loss (the top-down encoder), each
    step's must be finite and above 0 and enter the loss at its weight.
    With `profile`, one more step runs under torch.profiler. Returns
    (launch counts by wrapper, per-step seconds, peak GiB)."""
    import importlib

    import torch

    from rmem_tpu_torch.data.synthetic import blob_batches
    from rmem_tpu_torch.managers.trainer import Trainer, train_step
    from rmem_tpu_torch.memory import eviction

    phase, name = TRAIN_PHASE[model]
    cfg = train_config(model, steps)
    crop = tuple(cfg.data_randomcrop)
    check(cfg.data_seq_len == TRAIN_T
          and crop == TRAIN_CROP.get(model, TRAIN_HW), "pre_vost's shapes")
    check(not cfg.no_memory_gap or (
        cfg.model_att_heads, cfg.train_long_term_mem_gap) == (2, 1),
        f"{phase}: {cfg.model_att_heads} heads, a write every "
        f"{cfg.train_long_term_mem_gap}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, data_root=data_root, device=dev, seed=0,
                      batches=(None if data_root
                               else blob_batches(cfg, 0, dev)))
    before = {n: p.detach().clone()
              for n, p in trainer.state.model.named_parameters()}
    batches = [trainer.next_batch() for _ in range(steps)]
    trainer.close()
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

    times, losses, per_step, var_terms = [], [], [], []
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
            if cfg.var_loss_weight > 0:
                # the loss less its other terms, against the weighted var
                # loss
                rest = float(metrics["aux_weight"] * metrics["aux_loss"]
                             + metrics["pred_loss"])
                var_terms.append((float(metrics["var_loss"]),
                                  losses[-1] - rest))
            print(f"{phase}: train step {i} (curriculum "
                  f"{'on' if i >= seq_start else 'off'}"
                  f"): loss {losses[-1]:.4f}, grad norm "
                  f"{float(metrics['grad_norm']):.3f}, iou "
                  f"{float(metrics['iou']):.4f}, {times[-1]:.3f} s, "
                  + (f"var_loss {var_terms[-1][0]:.6f} (in the loss "
                     f"{var_terms[-1][1]:.6e}), " if var_terms else "")
                  + f"{evictions[-1]} FIFO evictions, launches "
                  + str(dict(zip((fn for _, fn in TRAIN_KERNELS),
                                 per_step[-1]))))
    counts = {fn: w.launches for (_, fn), w in zip(TRAIN_KERNELS, wrappers)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in trainer.state.model.named_parameters())
    expected = [TRAIN_LAUNCHES[model][fn] for _, fn in TRAIN_KERNELS]
    check(all(s == expected for s in per_step),
          f"{phase} launches per step {per_step}, expected {expected}")
    for var_loss, term in var_terms:
        check(math.isfinite(var_loss) and var_loss > 0
              and abs(term - cfg.var_loss_weight * var_loss)
              <= 1e-5 * max(abs(losses[0]), 1.0),
              f"{phase}: var_loss {var_loss}, its term in the loss {term}")
    check(cfg.var_loss_weight == 0 or len(var_terms) == steps,
          f"{phase}: {len(var_terms)} var losses")
    check(evictions == [fifo_evictions(cfg)] * steps,
          f"{phase} FIFO evictions per step {evictions}, expected "
          f"{fifo_evictions(cfg)}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(moved > 0, "the parameters did not change")
    check(seq_start < steps, "the curriculum did not start")
    timed = times[1:]     # the first step includes cuDNN's autotuning
    print(f"{phase}: {steps} steps of {name} ({model}) pre_vost at "
          f"{crop[0]}x{crop[1]}, T "
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
    with no_memory_gap), phase 20 (R50-AOTL with no_memory_gap) or phase
    25's hold (AOT-L on MobileNetV2, as phase 12 without the stem): one step
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

    from rmem_tpu_torch.data.synthetic import blob_batches
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
        "aotl": [((kb, "bank_attention_bwd_mh"), held_bwd_mh)],
        "r50_aotl_gru_rev": [((kb, "bank_attention_bwd_mh"), held_bwd_mh)],
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
            trainer = Trainer(cfg, device=dev, seed=1,
                              batches=blob_batches(cfg, 11, dev))
            trainer.rng.seed(11)
            batch, shuffle = trainer.next_batch()
            m = train_step(trainer.state, batch, shuffle, cfg)
            runs.append((float(m["loss"]), float(m["grad_norm"])))
            del trainer
    (loss_k, gn_k), (loss_p, gn_p) = runs
    k2 = {"r50_deaotl": "K2", "r50_aotl": "K2h", "aotl": "K2h",
          "r50_aotl_gru_rev": "K2h", "r50_deaotl_nmg": "K2x2",
          "r50_aotl_nmg": "K2x2v128"}[model]
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
    # each frame's backward, and each reverse decode's
    layers_frames = cfg.model_lstt_num * (TRAIN_T + reverse_writes(cfg))
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


# the colour kernel's cases: (height, width, nvjpegChromaSubsampling_t)
# of seeded frames nvJPEG encodes: the evaluator's 4:2:0 480 x 854 frame,
# an odd 4:2:0 size (edge rows and columns), and 4:4:4
JPEG_CASES = {"420_480x854": (480, 854, 2), "420_479x853": (479, 853, 2),
              "444_480x854": (480, 854, 0)}
# integer operations a decoded pixel of the colour kernel: the chroma's
# column and row sums and the conversion, ~55 (an estimate; the kernel is
# bound by its bytes either way), at float32's non-tensor rate
JPEG_OPS_PER_PIXEL = 55
PEAK_FP32_OPS = 67e12


def jpeg_planes(dev):
    """{case: (mode, Y, Cb, Cr)}: nvJPEG's planes of seeded frames it
    encoded, for each of JPEG_CASES."""
    import torch

    from rmem_tpu_torch.data import jpeg
    out = {}
    for key, (h, w, css) in JPEG_CASES.items():
        img = eval_video(dev, 7, 1, 3)[0][0]
        if (h, w) != tuple(img.shape[:2]):
            img = img[:h, :w]
        data = jpeg.NvjpegEncoder(dev, subsampling=css).encode(img)
        out[key] = jpeg.nvjpeg().decode_planes(data, dev)
    torch.cuda.synchronize()
    return out


def jpeg_color_check(dev):
    """The colour kernel (csrc/jpeg_color.cu) at JPEG_CASES, held to its
    plain version bit for bit (both do libjpeg's integer arithmetic).
    Returns {case: max |kernel - plain|}."""
    import torch

    from rmem_tpu_torch.kernels import jpeg_color as kj
    errs = {}
    for key, (mode, y, cb, cr) in jpeg_planes(dev).items():
        got = kj.ycc_to_rgb(y, cb, cr, mode)
        ref = kj.ycc_to_rgb_plain(y, cb, cr, mode)
        errs[key] = int((got.int() - ref.int()).abs().max())
        check(torch.equal(got, ref), f"jpeg colour {key}: "
              f"{int((got != ref).sum())} values differ from the plain "
              "version's")
    return errs


def check_jpeg_kernel(dev):
    """Phase 2's row of the colour kernel: held at JPEG_CASES, timed at
    the evaluator's frame (a CUDA graph: a launch costs the host more than
    the kernel runs), beside its plain version and its bound."""
    from rmem_tpu_torch.kernels import jpeg_color as kj
    errs = jpeg_color_check(dev)
    mode, y, cb, cr = jpeg_planes(dev)["420_480x854"]
    h, w = y.shape
    nbytes = h * w + 2 * cb.numel() + 3 * h * w
    t_bytes = nbytes / PEAK_BYTES
    t_ops = JPEG_OPS_PER_PIXEL * h * w / PEAK_FP32_OPS
    entry = dict(
        name="jpeg_ycc_to_rgb", route="cuda",
        source="rmem_tpu_torch/csrc/jpeg_color.cu",
        replaces="rmem_tpu/data/eval_datasets.py:64 (cv2.imread: the host "
        "decode of the JAX readers; no TPU kernel)",
        max_abs_err=max(errs.values()),
        ms=graph_ms(lambda: kj.ycc_to_rgb(y, cb, cr, mode), 50),
        plain_ms=cuda_ms(lambda: kj.ycc_to_rgb_plain(y, cb, cr, mode), 10),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, held=errs)
    print(f"phase 2: the JPEG colour kernel, bit for bit at {errs}; "
          f"{entry['ms']:.4f} ms a 480x854 frame (graph), plain "
          f"{entry['plain_ms']:.4f}, bound {entry['bound_ms']:.5f} "
          f"({entry['bound_by']})")
    return {"jpeg_ycc_to_rgb": entry}


# phase 21, the evaluator on the card: a VOST tree of two videos at
# 480 x 854 (seq0 with 10 objects, seq1 with 3), JPEG-encoded on the card
# by nvJPEG (quality 95, 4:2:0), an annotation for every frame
EVAL_SEQS = (("seq0", 90, 10), ("seq1", 60, 3))
EVAL_HW = RAW_HW
EVAL_CHUNK = 16          # Config.eval_scan_chunk's default
EVAL_WINDOW = 30         # --opt eval_fps_window=30
EVAL_PSNR_DB = 35.0      # nvJPEG's frames against the seeded source
EVAL_PROFILE_FRAMES = 48  # --profile: seq0's first 48 frames, traced
# the CLI run through a spy: launch counts from 0 in the fresh process,
# each frame the evaluator handed the engine copied on the engine's stream
# (after the hand-over event) into one pinned host buffer allocated before
# the run (argv[2] bytes: no allocation, no host wait a frame), and
# evaluate()'s stats
EVAL_CHILD = r"""
import hashlib, json, runpy, sys
import torch
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.kernels import dwconv as kd
from rmem_tpu_torch.kernels import jpeg_color as kj
from rmem_tpu_torch.kernels import local_attention as kl
from rmem_tpu_torch.kernels import stem as ks
from rmem_tpu_torch.managers import evaluator as ev

report, pool_bytes = sys.argv[1], int(sys.argv[2])
sys.argv = ["rmem_tpu_torch.tools.eval"] + sys.argv[3:]
fed, stats, used = {}, {}, [0]
pool = torch.empty(pool_bytes, dtype=torch.uint8,
                   pin_memory=torch.cuda.is_available())
frames, evaluate = ev.Evaluator._frames, ev.Evaluator.evaluate


def spied_frames(self, seq, max_frames):
    for i, frame in frames(self, seq, max_frames):
        n = frame.image.numel() * frame.image.element_size()
        host = pool[used[0]:used[0] + n].view(frame.image.dtype).view(
            frame.image.shape)
        used[0] += n
        host.copy_(frame.image, non_blocking=True)
        fed[seq.name + "/" + frame.name] = host
        yield i, frame


def spied_evaluate(self, *a, **kw):
    stats.update(evaluate(self, *a, **kw))
    return stats


ev.Evaluator._frames = spied_frames
ev.Evaluator.evaluate = spied_evaluate
wrappers = (kb.bank_attention_infer, kb.bank_attention_infer_mh,
            kb.bank_attention_qminor, kl.local_attention, ks.stem,
            kd.gated_dwconv, kj.ycc_to_rgb)
for fn in wrappers:
    fn.launches = 0
runpy.run_module("rmem_tpu_torch.tools.eval", run_name="__main__")
counts = {fn.__name__: fn.launches for fn in wrappers}
if torch.cuda.is_available():
    torch.cuda.synchronize()
with open(report, "w") as f:
    json.dump({"launches": counts, "stats": stats,
               "fed": {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                       for k, v in fed.items()}}, f)
"""


def eval_video(dev, seed: int, frames: int, objects: int, hw=None):
    """Seeded frames as parity/make_dataset.py draws them, on the card: a
    smooth background (low-resolution noise, cubic-upsampled 8x) with
    `objects` moving blobs; the blobs' masks (above 0.55, later blobs on
    top) are the annotations. Returns (uint8 [T, H, W, 3] frames on the
    card, uint8 [T, H, W] labels on the host), at hw (default EVAL_HW)."""
    import numpy as np
    import torch

    from rmem_tpu_torch.ops.resize import resize_cubic
    h, w = hw or EVAL_HW
    rng = np.random.RandomState(seed)
    start = rng.uniform(0.15, 0.85, (objects, 2))
    speed = rng.uniform(-0.004, 0.004, (objects, 2))
    size = rng.uniform(0.05, 0.09, (objects, 2))
    color = torch.from_numpy(rng.uniform(0.2, 0.45, (objects, 3))).float()
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    imgs, labels = [], []
    for t in range(frames):
        g = torch.Generator(device=dev).manual_seed(seed * 10_000 + t)
        low = torch.rand((1, h // 8, w // 8, 3), generator=g, device=dev)
        img = resize_cubic(low, (h, w))[0] * 0.5
        lab = torch.zeros((h, w), dtype=torch.uint8, device=dev)
        for i in range(objects):
            cy, cx = (start[i] + speed[i] * t) * (h, w)
            blob = torch.exp(-(((yy - cy) / (size[i, 0] * h)) ** 2
                               + ((xx - cx) / (size[i, 1] * w)) ** 2))
            img = img + blob[..., None] * color[i].to(dev)
            lab[blob > 0.55] = i + 1
        imgs.append((img.clamp(0, 1) * 255.0).round().to(torch.uint8))
        labels.append(lab)
    return torch.stack(imgs), torch.stack(labels).cpu().numpy()


def eval_tree(dev, root: Path, seqs=EVAL_SEQS, split: str = "val"):
    """Write phase 21's VOST tree (phase 27's: `seqs` listed as the train
    split); returns (its source frames by video, nvJPEG's encode ms a
    frame)."""
    from rmem_tpu_torch.data.jpeg import encode_jpeg
    from rmem_tpu_torch.utils.image import encode_png_pal8, label_colormap
    (root / "ImageSets").mkdir(parents=True)
    (root / "ImageSets" / f"{split}.txt").write_text(
        "\n".join(name for name, *_ in seqs) + "\n")
    sources, enc_s, n = {}, 0.0, 0
    for seed, (name, frames, objects) in enumerate(seqs):
        imgs, labels = eval_video(dev, seed, frames, objects)
        img_dir = root / "JPEGImages_10fps" / name
        ann_dir = root / "Annotations" / name
        img_dir.mkdir(parents=True)
        ann_dir.mkdir(parents=True)
        for t in range(frames):
            t0 = time.perf_counter()
            data = encode_jpeg(imgs[t])
            enc_s += time.perf_counter() - t0
            n += 1
            (img_dir / f"{t:05d}.jpg").write_bytes(data)
            (ann_dir / f"{t:05d}.png").write_bytes(
                encode_png_pal8(labels[t], label_colormap()))
        check(split != "val"
              or len(set(labels[0].flatten().tolist())) == objects + 1,
              f"{name}: {objects} objects not all in the first annotation")
        sources[name] = imgs
    return sources, 1e3 * enc_s / n


def run_eval_cli(root: Path, out: Path, report: Path, *extra):
    """The CLI through EVAL_CHILD in a process of its own; returns
    (report, seconds)."""
    pool = sum(f for _, f, _ in EVAL_SEQS) * EVAL_HW[0] * EVAL_HW[1] * 3
    cmd = [sys.executable, "-c", EVAL_CHILD, str(report), str(pool), "--stage",
           "pre_vost_2", "--model", "r50_deaotl", "--dataset", "vost",
           "--data_root", str(root.parent), "--ckpt_path", "test",
           "--output_root", str(out), "--exp_name", "chip_smoke",
           "--opt", f"dir_root={out.parent / 'results'}",
           f"eval_fps_window={EVAL_WINDOW}", *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    secs = time.perf_counter() - t0
    print(f"phase 21: the CLI ({' '.join(extra) or 'scoring'}) exited "
          f"{r.returncode} after {secs:.1f} s; its output:\n"
          + "\n".join("  | " + ln for ln in r.stdout.splitlines()[-40:]))
    if r.returncode != 0:
        print(r.stderr[-6000:], file=sys.stderr)
    check(r.returncode == 0, f"the eval CLI exited {r.returncode}")
    return json.loads(report.read_text()), secs


def trace_busy_ms(trace: Path) -> float:
    """The device's busy time in a torch.profiler chrome trace: the sum of
    its kernels', copies' and memsets' durations."""
    events = json.loads(trace.read_text())["traceEvents"]
    return sum(e.get("dur", 0) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3


def eval_phase(dev, card: str, profile: bool):
    """Phase 21: the evaluator's CLI over a VOST tree written on the card,
    then its outputs checked (see the module docstring). Returns a dict of
    what it measured."""
    import hashlib
    import tempfile

    import numpy as np
    import torch

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.data.jpeg import read_jpeg
    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.managers.evaluator import Evaluator
    from rmem_tpu_torch.utils.image import decode_png, label_colormap

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        tmp = Path(tmp)
        root, out = tmp / "data" / "VOST", tmp / "out"
        t0 = time.perf_counter()
        sources, enc_ms = eval_tree(dev, root)
        print(f"phase 21: wrote {sum(f for _, f, _ in EVAL_SEQS)} frames at "
              f"{EVAL_HW[0]}x{EVAL_HW[1]} in {time.perf_counter() - t0:.1f} "
              f"s (nvJPEG encode {enc_ms:.3f} ms a frame)")

        # nvJPEG's frames: the source's PSNR, the time of a synchronous
        # decode, and the bits a synchronous decode gives
        psnr, sync_sha, dec_s, n = {}, {}, 0.0, 0
        for name, frames, _ in EVAL_SEQS:
            worst = math.inf
            for t in range(frames):
                data = (root / "JPEGImages_10fps" / name
                        / f"{t:05d}.jpg").read_bytes()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = read_jpeg(data, dev)
                torch.cuda.synchronize()
                dec_s += time.perf_counter() - t0
                n += 1
                mse = ((img.float() - sources[name][t].float()) ** 2).mean()
                worst = min(worst, 10 * math.log10(255.0 ** 2 / float(mse)))
                sync_sha[f"{name}/{t:05d}.jpg"] = hashlib.sha256(
                    img.cpu().numpy().tobytes()).hexdigest()
            psnr[name] = worst
        dec_ms = 1e3 * dec_s / n
        print(f"phase 21: nvJPEG decode {dec_ms:.3f} ms a frame "
              f"(synchronous, bytes in host memory) on {card}; lowest PSNR "
              "against the source " + ", ".join(
                  f"{k} {v:.2f} dB" for k, v in psnr.items()))
        check(min(psnr.values()) >= EVAL_PSNR_DB,
              f"nvJPEG PSNR {psnr} under {EVAL_PSNR_DB} dB")

        report, cli_s = run_eval_cli(root, out, tmp / "report.json",
                                     "--score", "--metrics", "J", "J_last",
                                     "F")
        stats, counts = report["stats"], report["launches"]

        # launches: every propagated frame (the padding of each video's
        # last chunk included) and every reference frame runs the path once
        steps = sum(-(-(f - 1) // EVAL_CHUNK) * EVAL_CHUNK
                    for _, f, _ in EVAL_SEQS) + len(EVAL_SEQS)
        expected = {name: n * steps
                    for name, n in SERVED_LAUNCHES["r50_deaotl"].items()}
        expected["gated_dwconv"] = 0
        # the colour kernel once a decoded frame
        expected["ycc_to_rgb"] = sum(f for _, f, _ in EVAL_SEQS)
        print(f"phase 21: launches {counts} over {steps} frames of the "
              "path (references and padding included) and "
              f"{expected['ycc_to_rgb']} decoded frames")
        check(counts == expected, f"phase 21 launches {counts}, expected "
              f"{expected}")

        # the frames the evaluator fed, against the synchronous decode
        diff = sorted(k for k in sync_sha if report["fed"].get(k)
                      != sync_sha[k])
        check(sorted(report["fed"]) == sorted(sync_sha) and not diff,
              f"fed frames differ from a synchronous decode: {diff[:5]} "
              f"({len(report['fed'])} fed)")

        # the masks: one palette PNG a frame at the frame's size, ids in
        # what the evaluator can write (the first annotation's ids, with
        # unused id channels written as 0), the first copied byte for byte
        for name, frames, objects in EVAL_SEQS:
            pngs = sorted((out / name).glob("*.png"))
            check([p.name for p in pngs]
                  == [f"{t:05d}.png" for t in range(frames)],
                  f"{name}: {len(pngs)} masks for {frames} frames")
            check(pngs[0].read_bytes() == (root / "Annotations" / name
                                           / "00000.png").read_bytes(),
                  f"{name}: first annotation not copied byte for byte")
            ids = set()
            for p in pngs:
                pix, pal = decode_png(p.read_bytes())
                check(pix.shape == EVAL_HW and pal is not None
                      and np.array_equal(pal, label_colormap()),
                      f"{p}: shape {pix.shape} or palette")
                ids |= set(np.unique(pix).tolist())
            check(ids <= set(range(objects + 1)),
                  f"{name}: ids {sorted(ids)} past its {objects} objects")

        # the scores the CLI wrote
        lines = (out / "global_results-val.csv").read_text().splitlines()
        scores = dict(zip(lines[0].split(","), map(float,
                                                   lines[1].split(","))))
        for key in ("J-Mean", "J-Recall", "J_last-Mean", "J_last-Recall",
                    "F-Mean", "F-Recall"):
            check(math.isfinite(scores[key]) and 0 <= scores[key] <= 1,
                  f"{key} {scores[key]}")
        print(f"phase 21: scores of random weights on {card}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in scores.items()))

        # the plain route (the engine's plain versions, on the card) over
        # the same tree: frame 1 must agree; later frames drift apart
        plain_out = tmp / "plain"
        cfg = get_config("pre_vost_2", "chip_smoke", "r50_deaotl",
                         test_dataset="vost", test_ckpt_path="test",
                         dir_root=str(tmp / "results"))
        with ExitStack() as stack:
            for mod, attr, fn in ((kb, "bank_attention_infer",
                                   kb.bank_attention_plain),
                                  (kl, "local_attention",
                                   kl.local_attention_plain),
                                  (ks, "stem", ks.stem_plain)):
                stack.enter_context(mock.patch.object(mod, attr, fn))
            Evaluator(cfg, data_root=str(root.parent),
                      output_root=str(plain_out), log=lambda *a: None,
                      device=dev).evaluate()
        agree1, ious = {}, []
        for name, frames, objects in EVAL_SEQS:
            for t in range(1, frames):
                a = decode_png((out / name / f"{t:05d}.png").read_bytes())[0]
                b = decode_png((plain_out / name
                                / f"{t:05d}.png").read_bytes())[0]
                if t == 1:
                    agree1[name] = float((a == b).mean())
                for k in range(1, objects + 1):
                    union = ((a == k) | (b == k)).sum()
                    ious.append(((a == k) & (b == k)).sum() / union
                                if union else 1.0)
        mean_j = float(np.mean(ious))
        print(f"phase 21: frame 1, kernel route against the plain route, "
              f"label agreement {agree1}; mean J of the kernel route's "
              f"masks against the plain route's over every frame {mean_j:.4f}")
        check(min(agree1.values()) >= AGREE_FLOOR,
              f"phase 21 frame-1 agreement {agree1}")

        fps = stats["per_seq_fps"]
        check(dev.type != "cuda" or "peak_hbm_gb" in stats,
              "no peak_hbm_gb in the evaluator's stats")
        print(f"phase 21: all_frame_fps {stats['all_frame_fps']:.3f}, "
              + ", ".join(f"{k} {v:.3f}" for k, v in fps.items())
              + f" frames/s; window fps {stats['per_seq_window_fps']}; "
              f"peak_hbm_gb {stats.get('peak_hbm_gb')}; nvJPEG {dec_ms:.3f} ms "
              f"a frame; R50-DeAOTL 481x849 in, 480x854 out, on {card}; "
              f"host {host_line()}")
        result = dict(all_frame_fps=stats["all_frame_fps"], per_seq_fps=fps,
                      window_fps=stats["per_seq_window_fps"],
                      peak_hbm_gb=stats.get("peak_hbm_gb"), nvjpeg_ms=dec_ms,
                      nvjpeg_encode_ms=enc_ms, psnr_db=psnr, scores=scores,
                      launches=counts, frame1_agreement=agree1,
                      mean_j_vs_plain=mean_j, cli_s=cli_s)
        if profile:
            prof_dir = tmp / "profile"
            report, _ = run_eval_cli(
                root, tmp / "out_profiled", tmp / "report_profiled.json",
                "--max_seqs", "1", "--max_frames", str(EVAL_PROFILE_FRAMES),
                "--profile", str(prof_dir))
            busy = trace_busy_ms(prof_dir / "trace.json") / \
                EVAL_PROFILE_FRAMES
            wall = 1e3 / fps["seq0"]
            print(f"profile: phase 21, device busy {busy:.3f} ms a frame "
                  f"(seq0's first {EVAL_PROFILE_FRAMES} frames, traced); "
                  f"against the untraced {wall:.3f} ms a frame of seq0 the "
                  f"device idles {100 * (1 - busy / wall):.1f} % on {card}")
            result.update(busy_ms=busy, idle_share=1 - busy / wall)
    return result


# phase 22, weights in and out and the single-video tools: a reference-
# layout .pth of R50-DeAOTL and of R50-AOTL written from seeded tensors by
# the converter's inverse over the port's state dict, each loaded through
# load_model_params; the demo CLI over DEMO_FRAMES of phase 21's seeded
# frames with 10 objects (R50-AOTL's over the first DEMO_AOT_FRAMES); the
# video CLI over their masks; 6 of phase 5's training steps from the .pth
# with the checkpoint stream, then auto-resume
DEMO_FRAMES = 40
DEMO_AOT_FRAMES = 10
DEMO_OBJECTS = 10
PTH_DEAD_KEY = "LSTT.layers.0.Q_time_encode.0.weight"
BN_FOLD_TOL = 1e-6      # max |folded - f64 formula| / max |f64 formula|
STREAM_SAVE_STEP = 2
STREAM_KEEP = 2
# the demo's CLI through a spy: launch counts from 0 in the fresh process
# (argv[1]: the report's path; the rest: the demo's arguments)
DEMO_CHILD = r"""
import json, runpy, sys
import torch
from rmem_tpu_torch.kernels import bank_attention as kb
from rmem_tpu_torch.kernels import dwconv as kd
from rmem_tpu_torch.kernels import jpeg_color as kj
from rmem_tpu_torch.kernels import local_attention as kl
from rmem_tpu_torch.kernels import stem as ks

report = sys.argv[1]
sys.argv = ["rmem_tpu_torch.tools.demo"] + sys.argv[2:]
wrappers = (kb.bank_attention_infer, kb.bank_attention_infer_mh,
            kb.bank_attention_qminor, kl.local_attention, ks.stem,
            kd.gated_dwconv, kj.ycc_to_rgb)
for fn in wrappers:
    fn.launches = 0
runpy.run_module("rmem_tpu_torch.tools.demo", run_name="__main__")
if torch.cuda.is_available():
    torch.cuda.synchronize()
with open(report, "w") as f:
    json.dump({fn.__name__: fn.launches for fn in wrappers}, f)
"""


def mobilenetv2_reference_name(p) -> str:
    """The reference's name of a MobileNetV2 encoder leaf's module
    (`features.N` Sequentials: the stem 0, blocks 1-17, the head 18; a
    block's conv Sequential (pw, dw) ConvBNReLU pairs, pw_linear, bn_out;
    block 1, expansion 1, has no pw)."""
    if p[1] in ("stem", "head"):
        return (f"encoder.features.{0 if p[1] == 'stem' else 18}."
                f"{0 if p[2] == 'conv' else 1}")
    idx = int(p[1][len("block"):])
    seq = ("pw", "dw") if idx > 1 else ("dw",)
    base = f"encoder.features.{idx}.conv"
    if p[2] in seq:
        return f"{base}.{seq.index(p[2])}.{0 if p[3] == 'conv' else 1}"
    return f"{base}.{len(seq) + (p[2] == 'bn_out')}"


def reference_name(path, model_vos: str, encoder: str = "resnet50") -> str:
    """The reference module name of a flax path's leaf (the inverse of
    utils/checkpoint.py's converter: its layer names, `downsample.0/1`,
    MobileNetV2's `features`, the LSTT's attention modules, DeAOT's
    GroupNorm1D `.gn`)."""
    p = list(path)
    if p[0] == "encoder" and encoder == "mobilenetv2":
        return mobilenetv2_reference_name(p)
    if p[0] == "encoder":
        if p[1].startswith("layer"):
            stage, idx = p[1].split("_")
            sub = {"downsample_conv": "downsample.0",
                   "downsample_bn": "downsample.1"}.get(p[2], p[2])
            return f"encoder.{stage}.{idx}.{sub}"
        return f"encoder.{p[1]}"
    if p[0] == "lstt":
        if p[1].startswith("decoder_norm"):
            gn = ".gn" if model_vos == "deaot" else ""
            return f"LSTT.decoder_norms.{p[1][len('decoder_norm'):]}{gn}"
        mid = tuple(p[2:-1])
        mid = {("long_proj",): "long_term_attn.projection",
               ("short_proj",): "short_term_attn.projection",
               ("long_tail", "dw_conv", "conv"): "long_term_attn.dw_conv.conv",
               ("long_tail", "projection"): "long_term_attn.projection",
               ("short_tail", "dw_conv", "conv"):
                   "short_term_attn.dw_conv.conv",
               ("short_tail", "projection"): "short_term_attn.projection",
               ("relative_emb_k",): "short_term_attn.relative_emb_k",
               ("self_attn", "tail", "dw_conv", "conv"):
                   "self_attn.dw_conv.conv",
               ("self_attn", "tail", "projection"): "self_attn.projection",
               }.get(mid, ".".join(mid))
        return f"LSTT.layers.{p[1][len('block'):]}.{mid}"
    return ".".join(p[:-1]) if len(p) > 1 else p[0]


def reference_checkpoint(model, seed: int):
    """A reference-layout state dict for `model` (port names -> the
    reference's, port layouts are torch's), seeded: BN as weight, bias,
    running_mean and running_var (above 0.5, so the fold divides by
    something other than 1), the LSTT's `linear_*` weights as 1x1 convs
    (the converter squeezes them), the id bank's 11 input channels, and one
    dead TIME_ENCODE key. Returns {name: f32 CPU tensor}."""
    import torch

    from rmem_tpu_torch.utils.checkpoint import flax_path
    vos, encoder = model.cfg.model_vos, model.cfg.model_encoder
    g = torch.Generator().manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=g)
    sd = {}
    # scaled as trained weights are, so that training from them stays
    # finite: weights N(0, 1/fan_in), norm and BN scales near 1, small
    # biases and means
    for name, t in model.state_dict().items():
        path = flax_path(name)
        ref = reference_name(path, vos, encoder)
        if path[0] == "encoder" and "bn" in path[-2]:
            if f"{ref}.running_var" not in sd:
                c = t.shape[0]
                sd[f"{ref}.weight"] = 1 + 0.1 * randn(c)
                sd[f"{ref}.bias"] = 0.1 * randn(c)
                sd[f"{ref}.running_mean"] = 0.1 * randn(c)
                sd[f"{ref}.running_var"] = randn(c).abs() + 0.5
        elif path[-1] == "kernel":
            w = randn(*t.shape) / math.sqrt(t[0].numel())
            if path[0] == "lstt" and path[-2].startswith("linear_"):
                w = w[:, :, None, None]
            if path[0] == "patch_wise_id_bank":
                w = w[:, :11]
            sd[f"{ref}.weight"] = w.contiguous()
        elif path[-1] == "scale":
            sd[f"{ref}.weight"] = 1 + 0.1 * randn(*t.shape)
        elif path[-1] == "bias":
            sd[f"{ref}.bias"] = 0.1 * randn(*t.shape)
        else:                               # cur_pos_emb, mem_pos_emb
            sd[ref] = 0.05 * randn(*t.shape)
    sd[PTH_DEAD_KEY] = randn(8, 8)
    return sd


def check_loaded(model, sd, rep: dict, label: str) -> float:
    """Phase 22 (b): nothing skipped or unexpected, one dead key; every
    folded BN against the fold in f64 (returns the worst relative
    difference); every other weight the written tensor (squeezed,
    padded); id-bank input channel 11 zero."""
    import torch

    from rmem_tpu_torch.utils.checkpoint import flax_path
    check(rep["skipped"] == [] and rep["unexpected_keys"] == [],
          f"{label}: skipped {rep['skipped'][:5]}, unexpected "
          f"{rep['unexpected_keys'][:5]}")
    check(rep["dead_keys"] == [PTH_DEAD_KEY], f"{label}: dead keys "
          f"{rep['dead_keys']}")
    worst, vos = 0.0, model.cfg.model_vos
    for name, t in model.state_dict().items():
        path = flax_path(name)
        ref = reference_name(path, vos, model.cfg.model_encoder)
        if path[0] == "encoder" and "bn" in path[-2]:
            f64 = {k: sd[f"{ref}.{k}"].double() for k in
                   ("weight", "bias", "running_mean", "running_var")}
            scale = f64["weight"] / torch.sqrt(f64["running_var"] + 1e-5)
            want = (scale if path[-1] == "scale"
                    else f64["bias"] - f64["running_mean"] * scale)
            worst = max(worst, float((t.double() - want).abs().max()
                                     / want.abs().max()))
            continue
        src = sd[f"{ref}.weight" if path[-1] in ("kernel", "scale")
                 else f"{ref}.bias" if path[-1] == "bias" else ref]
        if path[0] == "patch_wise_id_bank" and path[-1] == "kernel":
            check(not t[:, 11:].any(), f"{label}: id-bank channel 11 not "
                  "zero")
            t = t[:, :11]
        check(torch.equal(t, src.reshape(t.shape)), f"{label}: {name} is "
              "not the checkpoint's")
    check(worst <= BN_FOLD_TOL, f"{label}: folded BN off the f64 fold by "
          f"{worst:.3e}")
    return worst


def run_cli(child: str, args, label: str, timeout: int = 900):
    """`child` (a spy script) in a process of its own with `args`; returns
    (its stdout, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", child, *map(str, args)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t0
    print(f"phase 22: {label} exited {r.returncode} after {secs:.1f} s; "
          "its last lines:\n"
          + "\n".join("  | " + ln for ln in r.stdout.splitlines()[-4:]))
    if r.returncode != 0:
        print(r.stderr[-6000:], file=sys.stderr)
    check(r.returncode == 0, f"{label} exited {r.returncode}")
    return r.stdout, secs


def run_demo_cli(frames: Path, first: Path, out: Path, report: Path,
                 *extra):
    """The demo's CLI through DEMO_CHILD: (launch counts, frames/s it
    printed, seconds of the process)."""
    stdout, secs = run_cli(DEMO_CHILD, [report, "--frames_dir", frames,
                                        "--first_mask", first,
                                        "--output_dir", out, *extra],
                           f"the demo ({' '.join(map(str, extra))})")
    fps = float(re.search(r"\(([\d.]+) frames/s on ",
                          stdout.splitlines()[-1]).group(1))
    return json.loads(report.read_text()), fps, secs


def demo_outputs(frames: Path, out: Path, n: int, dev):
    """The demo's files for the first n frames: a mask PNG and an overlay
    JPEG each, the overlay decoding to the frame's size."""
    from rmem_tpu_torch.data.jpeg import read_jpeg
    from rmem_tpu_torch.utils.image import read_png
    names = sorted(p.stem for p in frames.glob("*.jpg"))[:n]
    masks = {}
    for stem in names:
        masks[stem] = read_png(str(out / "masks" / f"{stem}.png"))
        over = read_jpeg((out / f"{stem}_overlay.jpg").read_bytes(), dev)
        check(tuple(over.shape) == (*EVAL_HW, 3) and masks[stem].shape
              == EVAL_HW, f"{out}/{stem}: overlay {tuple(over.shape)}, "
              f"mask {masks[stem].shape}")
    check(len(list((out / "masks").glob("*.png"))) == n
          and len(list(out.glob("*_overlay.jpg"))) == n,
          f"{out}: not {n} masks and overlays")
    return masks


def stream_phase(dev, pth: Path, tmp: Path, card: str):
    """Phase 22 (e): Trainer from the .pth with the checkpoint stream,
    phase 5's steps and launches, then auto-resume (also past a truncated
    save) and the EMA stream served by an Evaluator. Returns a dict of
    what it measured."""
    import importlib

    import torch

    from rmem_tpu_torch.data.synthetic import blob_batches
    from rmem_tpu_torch.managers import trainer as trainer_mod
    from rmem_tpu_torch.models import build_vos_model, load_model_params

    base = train_config("r50_deaotl").replace(
        pretrain_model=str(pth), train_save_step=STREAM_SAVE_STEP,
        train_max_keep_ckpt=STREAM_KEEP, dir_root=str(tmp / "results"))
    check(base.pretrain and not base.train_auto_resume, "pre_vost presets")
    ref = build_vos_model(base.model_vos, base)
    load_model_params(ref, str(pth), log=lambda s: None)
    lines = []
    trainer = trainer_mod.Trainer(base, device=dev, seed=0,
                                  log=lines.append,
                                  batches=blob_batches(base, 0, dev))
    want = ref.state_dict()
    for name, p in trainer.state.model.named_parameters():
        check(torch.equal(p.detach().cpu(), want[name]),
              f"phase 22: the trainer's {name} is not load_model_params's")
    wrappers = [getattr(importlib.import_module(
        f"rmem_tpu_torch.kernels.{mod}"), fn) for mod, fn in TRAIN_KERNELS]
    step, save = trainer_mod.train_step, trainer_mod.save_checkpoint
    per_step, saves = [], []

    def counted_step(*a, **kw):
        before = [fn.launches for fn in wrappers]
        out = step(*a, **kw)
        per_step.append([fn.launches - c for fn, c in zip(wrappers, before)])
        return out

    def timed_save(obj, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(obj, *a, **kw)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))
        return path

    t0 = time.perf_counter()
    with mock.patch.object(trainer_mod, "train_step", counted_step), \
            mock.patch.object(trainer_mod, "save_checkpoint", timed_save):
        metrics = trainer.train(max_steps=TRAIN_STEPS)
    train_s = time.perf_counter() - t0
    expected = [TRAIN_LAUNCHES["r50_deaotl"][fn] for _, fn in TRAIN_KERNELS]
    check(per_step == [expected] * TRAIN_STEPS,
          f"phase 22 launches per step {per_step}, expected {expected}")
    check(math.isfinite(metrics["loss"]), f"phase 22 loss {metrics}")
    listing = {d: sorted(os.listdir(d)) for d in (trainer.ckpt_dir,
                                                  trainer.ema_dir)}
    check(listing == {trainer.ckpt_dir: ["save_step_4.pt", "save_step_6.pt"],
                      trainer.ema_dir: ["ema_step_4.pt", "ema_step_6.pt"]},
          f"phase 22 streams {listing}")
    # the state as the last save wrote it, and a new trainer resuming
    state = trainer.state.state_dict()
    lines.clear()
    resumed = trainer_mod.Trainer(base.replace(train_auto_resume=True),
                                  device=dev, seed=5, log=lines.append)
    got = resumed.state.state_dict()
    check(got["step"] == TRAIN_STEPS and all(
        torch.equal(got[k][n], state[k][n]) for k in ("params", "mu", "nu",
                                                      "ema")
        for n in state[k]), f"phase 22 resume: step {got['step']}, or a "
          "leaf differs from the saved state")
    check(lines[-1].startswith("auto-resumed from ") and lines[-1].endswith(
        f"(step {TRAIN_STEPS})"), f"phase 22 resume log {lines[-1:]}")
    del resumed
    newest = Path(trainer.ckpt_dir, f"save_step_{TRAIN_STEPS}.pt")
    data = newest.read_bytes()
    newest.write_bytes(data[:len(data) // 2])
    lines.clear()
    fallback = trainer_mod.Trainer(base.replace(train_auto_resume=True),
                                   device=dev, seed=5, log=lines.append)
    check(fallback.state.step == TRAIN_STEPS - STREAM_SAVE_STEP
          and any(f"save_step_{TRAIN_STEPS}.pt unreadable" in ln
                  for ln in lines)
          and lines[-1].endswith(f"(step {TRAIN_STEPS - STREAM_SAVE_STEP})"),
          f"phase 22 fallback: step {fallback.state.step}, log {lines}")
    ema = {n: t.detach().cpu() for n, t in trainer.state.ema.items()}
    del trainer, fallback
    torch.cuda.empty_cache()
    ema_file = Path(base.dir_result, "ema_ckpt", f"ema_step_{TRAIN_STEPS}.pt")
    load_model_params(ref, str(ema_file), log=lambda s: None)
    check(all(torch.equal(t, ema[n]) for n, t in ref.state_dict().items()),
          "phase 22: the EMA stream's file is not the trainer's EMA")
    return dict(saves=saves, train_s=train_s, ema_file=ema_file,
                per_step=per_step[0])


def weights_phase(dev, card: str, served_fps: float):
    """Phase 22: the reference's .pth files loaded, the demo and video
    CLIs, and training with the checkpoint stream (see the module
    docstring). Returns a dict of what it measured."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.data.jpeg import write_jpeg
    from rmem_tpu_torch.managers.evaluator import Evaluator
    from rmem_tpu_torch.models import build_vos_model, load_model_params
    from rmem_tpu_torch.utils.image import (encode_png_pal8, label_colormap,
                                            read_png)

    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_weights_") as tmp:
        tmp = Path(tmp)
        # (a) and (b): a .pth a model, written and loaded
        pths, loaded = {}, {}
        for model_name, seed in (("r50_deaotl", 11), ("r50_aotl", 12)):
            cfg = get_config("pre_vost_2", model=model_name)
            sd = reference_checkpoint(build_vos_model(cfg.model_vos, cfg),
                                      seed)
            pths[model_name] = tmp / f"{model_name}.pth"
            # the reference's wrapping: `module.` prefixes under state_dict
            torch.save({"state_dict": {f"module.{k}": v
                                       for k, v in sd.items()}},
                       pths[model_name])
            model = build_vos_model(cfg.model_vos, cfg)
            rep, lines = {}, []
            t0 = time.perf_counter()
            load_model_params(model, str(pths[model_name]), report=rep,
                              log=lines.append)
            load_s = time.perf_counter() - t0
            worst = check_loaded(model, sd, rep, f"phase 22 {model_name}")
            mb = pths[model_name].stat().st_size / 2 ** 20
            print(f"phase 22: {model_name} .pth ({len(sd)} tensors, "
                  f"{mb:.1f} MB) loaded in {load_s:.3f} s (torch.load, the "
                  "converter, the merge; host) on the machine of "
                  f"{card}; {len(rep['extra'])} extra, dead "
                  f"{rep['dead_keys']}, folded BN within {worst:.2e} of "
                  "the f64 fold")
            loaded[model_name] = dict(load_s=load_s, mb=mb, bn_rel=worst)
        result["pth"] = loaded

        # (c): the demo CLI over seeded frames (phase 21's writer)
        vost = tmp / "data" / "VOST"
        frames = vost / "JPEGImages_10fps" / "demo"
        ann = vost / "Annotations" / "demo"
        frames.mkdir(parents=True)
        ann.mkdir(parents=True)
        (vost / "ImageSets").mkdir()
        (vost / "ImageSets" / "val.txt").write_text("demo\n")
        imgs, labels = eval_video(dev, 7, DEMO_FRAMES, DEMO_OBJECTS)
        for t in range(DEMO_FRAMES):
            write_jpeg(frames / f"{t:05d}.jpg", imgs[t])
        first = ann / "00000.png"
        first.write_bytes(encode_png_pal8(labels[0], label_colormap()))
        check(len(np.unique(labels[0])) == DEMO_OBJECTS + 1,
              "phase 22: not every object in the first mask")
        out = tmp / "demo_out"
        counts, fps, cli_s = run_demo_cli(
            frames, first, out, tmp / "demo.json", "--model", "r50_deaotl",
            "--ckpt_path", pths["r50_deaotl"])
        expected = {name: n * DEMO_FRAMES for name, n in
                    SERVED_LAUNCHES["r50_deaotl"].items()}
        expected.update(gated_dwconv=0, ycc_to_rgb=DEMO_FRAMES)
        check(counts == expected, f"phase 22 demo launches {counts}, "
              f"expected {expected}")
        masks = demo_outputs(frames, out, DEMO_FRAMES, dev)
        check((out / "masks" / "00000.png").read_bytes()
              == first.read_bytes(), "phase 22: the demo's frame 0 mask is "
              "not the first mask")
        # the evaluator's per-frame path on the same frames and weights;
        # this process has cuDNN's TF32 off and the demo's PyTorch's
        # default (on), so equal masks also show that the served path does
        # not depend on the flag
        cfg = get_config("pre_vost_2", "chip_smoke", "r50_deaotl",
                         test_dataset="vost",
                         test_ckpt_path=str(pths["r50_deaotl"]),
                         dir_root=str(tmp / "results"))
        ev = Evaluator(cfg, data_root=str(vost.parent),
                       output_root=str(tmp / "ev"), log=lambda *a: None,
                       device=dev)
        ev.force_slow = True
        ev.evaluate()
        differ = [stem for stem, m in masks.items() if not np.array_equal(
            m, read_png(str(tmp / "ev" / "demo" / f"{stem}.png")))]
        check(not differ, f"phase 22: the demo's masks differ from the "
              f"evaluator's per-frame path at {differ[:5]}")
        ids = set(np.unique(np.stack(list(masks.values()))).tolist())
        del ev
        torch.cuda.empty_cache()
        aot_out = tmp / "demo_aot"
        aot_counts, aot_fps, aot_s = run_demo_cli(
            frames, first, aot_out, tmp / "demo_aot.json", "--model",
            "r50_aotl", "--ckpt_path", pths["r50_aotl"], "--max_frames",
            DEMO_AOT_FRAMES)
        aot_expected = {name: n * DEMO_AOT_FRAMES for name, n in
                        SERVED_LAUNCHES["r50_aotl"].items()}
        aot_expected.update(gated_dwconv=0, ycc_to_rgb=DEMO_AOT_FRAMES)
        check(aot_counts == aot_expected, f"phase 22 AOT demo launches "
              f"{aot_counts}, expected {aot_expected}")
        demo_outputs(frames, aot_out, DEMO_AOT_FRAMES, dev)
        print(f"phase 22: the demo, R50-DeAOTL from its .pth, {DEMO_FRAMES} "
              f"frames at {EVAL_HW[0]}x{EVAL_HW[1]} with {DEMO_OBJECTS} "
              f"objects: launches {counts}; masks equal the evaluator's "
              f"per-frame path on every pixel (ids {sorted(ids)}); "
              f"{fps:.3f} frames/s (host clock, the process's first use "
              f"included; the CLI process {cli_s:.1f} s) beside phase 3's "
              f"{served_fps:.3f}; R50-AOTL over {DEMO_AOT_FRAMES} frames: "
              f"launches {aot_counts}, {aot_fps:.3f} frames/s; on {card}")

        # (d): the video CLI, read back
        mp4 = tmp / "cmp.mp4"
        stdout, video_s = run_cli(
            "import runpy, sys\nsys.argv = ['video'] + sys.argv[1:]\n"
            "runpy.run_module('rmem_tpu_torch.tools.video', "
            "run_name='__main__')\n",
            ["--frames_dir", frames, "--masks_a", out / "masks", "--masks_b",
             aot_out / "masks", "--output", mp4], "the video tool")
        cap = cv2.VideoCapture(str(mp4))
        shapes = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            shapes.append(frame.shape)
        cap.release()
        check(shapes == [(EVAL_HW[0], 3 * EVAL_HW[1], 3)] * DEMO_FRAMES,
              f"phase 22 video: {len(shapes)} frames of {set(shapes)}")
        print(f"phase 22: the video tool wrote {mp4.stat().st_size} bytes, "
              f"read back as {len(shapes)} frames of {shapes[0][:2]} "
              f"({video_s:.1f} s)")

        # (e): training from the .pth with the checkpoint stream
        stream = stream_phase(dev, pths["r50_deaotl"], tmp, card)
        ev = Evaluator(cfg.replace(test_ckpt_path=str(stream["ema_file"])),
                       data_root=str(vost.parent),
                       output_root=str(tmp / "ev_ema"), log=lambda *a: None,
                       device=dev)
        ev.evaluate(max_frames=3)
        served = sorted(p.name for p in (tmp / "ev_ema" / "demo").glob(
            "*.png"))
        check(served == [f"{t:05d}.png" for t in range(3)],
              f"phase 22: the EMA stream's evaluator wrote {served}")
        del ev
        torch.cuda.empty_cache()
        save_s = [s for s, _ in stream["saves"]]
        save_mb = [b / 2 ** 20 for _, b in stream["saves"]]
        print(f"phase 22: {TRAIN_STEPS} steps of R50-DeAOTL pre_vost from "
              f"its .pth in {stream['train_s']:.1f} s, launches a step "
              f"{stream['per_step']} (phase 5's); a stream save (state, "
              f"then EMA) took " + ", ".join(
                  f"{s:.3f} s for {m:.1f} MB" for s, m in zip(save_s,
                                                              save_mb))
              + f"; resumed at step {TRAIN_STEPS}, and at "
              f"{TRAIN_STEPS - STREAM_SAVE_STEP} past a truncated save; "
              f"the EMA file served 3 frames; on {card}")
        result.update(demo_fps=fps, demo_cli_s=cli_s, demo_aot_fps=aot_fps,
                      demo_launches=counts, demo_aot_launches=aot_counts,
                      served_fps=served_fps, video_s=video_s,
                      stream_save_s=save_s, stream_save_mb=save_mb,
                      stream_train_s=stream["train_s"])
    return result


# --mutants: for each kernel source, the per-call checks of phase 2 that
# must catch its one-line mutants, and the mutants (a list of (line,
# replacement), or (line, replacement, file) for a line of the source's
# Python wrapper)
# phase 23's served frames from the seeded reference-layout AOT-L .pth
PTH_SERVED_FRAMES = 5


def aotl_pth_phase(dev, card: str) -> dict:
    """Phase 23 (c): a reference-layout AOT-L (MobileNetV2) .pth written
    from seeded tensors (reference_checkpoint: MobileNetV2's `features`
    names, BN running statistics, the LSTT's linear weights as 1x1 convs,
    an 11-channel id bank, one dead key), loaded through load_model_params
    (check_loaded: nothing skipped or unexpected, every folded BN within
    BN_FOLD_TOL of the f64 fold, every other weight the file's), then
    served: the reference frame and PTH_SERVED_FRAMES frames at 481 x 849
    with 10 objects, K1h 3 a frame and nothing else, finite logits."""
    import tempfile

    import torch

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.engine import InferenceEngine
    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.models import build_vos_model, load_model_params

    cfg = get_config("pre_vost", model="aotl")
    sd = reference_checkpoint(build_vos_model(cfg.model_vos, cfg), 23)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aotl_") as tmp:
        pth = Path(tmp) / "aotl.pth"
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   pth)
        model = build_vos_model(cfg.model_vos, cfg)
        rep, lines = {}, []
        t0 = time.perf_counter()
        load_model_params(model, str(pth), report=rep, log=lines.append)
        load_s = time.perf_counter() - t0
        mb = pth.stat().st_size / 2 ** 20
    worst = check_loaded(model, sd, rep, "phase 23 aotl")
    engine = InferenceEngine(model, cfg, device=dev)
    wrappers = (kb.bank_attention_infer, kb.bank_attention_infer_mh,
                kb.bank_attention_qminor, kl.local_attention, ks.stem)
    for fn in wrappers:
        fn.launches = 0
    img0, mask, g = reference_inputs(dev)
    state, logits = engine.add_reference(img0, mask, [NUM_OBJECTS])
    for _ in range(PTH_SERVED_FRAMES):
        state, label = engine.step(
            state, torch.rand((1, *IN_HW, 3), generator=g, device=dev),
            OUT_HW)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in wrappers}
    expected = {name: n * (PTH_SERVED_FRAMES + 1)
                for name, n in SERVED_LAUNCHES["aotl"].items()}
    check(counts == expected, f"phase 23 .pth serving launches {counts}, "
          f"expected {expected}")
    check(bool(torch.isfinite(state.logits4x).all()), "phase 23 .pth "
          "serving: non-finite logits")
    check(int(label.min()) >= 0 and int(label.max()) <= NUM_OBJECTS,
          "phase 23 .pth serving: labels out of [0, 10]")
    print(f"phase 23: an AOT-L (MobileNetV2) .pth ({len(sd)} tensors, "
          f"{mb:.1f} MB) loaded in {load_s:.3f} s (host) on the machine of "
          f"{card}: nothing skipped or unexpected, dead {rep['dead_keys']}, "
          f"folded BN within {worst:.2e} of the f64 fold; served "
          f"{PTH_SERVED_FRAMES} frames, launches {counts}")
    del engine, state, model
    torch.cuda.empty_cache()
    return dict(load_s=load_s, mb=mb, bn_rel=worst, launches=counts)


def aotl_phase(dev, frames: int, card: str, profile: bool) -> dict:
    """Phase 23: AOT-L + RMem on MobileNetV2 at full width (3 LSTT layers of
    8 heads of 32, encoder dims (24, 32, 96, 1280), 1 + 8 slots) on phase
    3's traffic: main_path (exact launches a frame: K1h 3; K6, K1, K3, K4
    and K8 never), its hold against the all-plain engine (plain_agreement,
    every K1h call held), then aotl_pth_phase."""
    counts, fps = main_path(dev, frames, card, profile, model="aotl")
    worst, logit_errs, agree = plain_agreement(dev, "aotl")
    return dict(launches=counts, fps_windows=fps,
                fps_median=statistics.median(fps), on_path=worst,
                logit_rel_err=logit_errs, label_agreement=agree,
                pth=aotl_pth_phase(dev, card))


# phase 24's frames a preset (phase 3's traffic, shorter) and its windows
PRESET_FRAMES = 20
PRESET_WINDOW = 10


def presets_phase(dev, card: str) -> dict:
    """Phase 24: every other preset (ENCODER_PRESETS) on phase 3's traffic
    for PRESET_FRAMES frames (Swin-B at SWIN_HW: its 30 x 53 grid, checked
    on the bank), exact launches a frame and the frames/s of the last
    PRESET_WINDOW frames, then held against its all-plain engine through
    the reference and PRESET_AGREE_FRAMES frames: logits within LOGIT_TOL
    of the largest, and labels agreeing on AGREE_FLOOR of the pixels whose
    label the plain logits decide at that precision (top-2 margin above
    LOGIT_TOL of the largest logit; the raw agreement is printed beside
    it). Returns each preset's numbers."""
    import torch
    out = {}
    for model in ENCODER_PRESETS:
        t0 = time.perf_counter()
        counts, fps = main_path(dev, PRESET_FRAMES, card, False, model=model,
                                window=PRESET_WINDOW)
        worst, logit_errs, agree = plain_agreement(dev, model)
        labels = worst.pop("labels")
        out[model] = dict(launches=counts, fps=fps[-1], on_path=worst,
                          logit_rel_err=max(logit_errs),
                          label_agreement=min(agree),
                          label_agreement_on_decided=min(
                              labels["agreement_on_decided"]),
                          tie_share=max(labels["tie_share"]),
                          seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    grid = SWIN_GRID[0] * SWIN_GRID[1]
    check(out["swinb_aotl"]["launches"]["bank_attention_infer_mh"] > 0,
          "phase 24: Swin-B launched no K1h")
    print("phase 24: " + "; ".join(
        f"{m} {o['fps']:.3f} frames/s, logits {o['logit_rel_err']:.2e}, "
        f"labels >= {o['label_agreement']:.5f} (on decided pixels >= "
        f"{o['label_agreement_on_decided']:.5f}, ties <= "
        f"{o['tie_share']:.4f}), {o['seconds']:.1f} s"
        for m, o in out.items()) + f"; Swin-B on its {SWIN_GRID[0]}x"
        f"{SWIN_GRID[1]} grid ({grid} tokens); on {card}")
    return out


def encoder_train_phase(dev, card: str, profile: bool) -> dict:
    """Phase 25: AOT-L on MobileNetV2 for TRAIN_STEPS steps (phase 11's
    traffic: K1'h 87 and K2h 45 a step, no K7) and its kernel step held
    against the plain step; then ENCODER_TRAIN_STEPS steps each of DeAOT-T
    (K1' and K4 29, K2 and K5's backward 15), AOT-L on ResNet-101 (K7 1 a
    step), on the top-down ResNet-50 (the var loss finite, above 0, in the
    loss at weight 0.01), on MobileNetV3, on ResNeSt-101 and on Swin-B (at
    TRAIN_CROP's 464x464). Returns the numbers."""
    counts, times, peak = train_phase(dev, card, profile, model="aotl")
    out = {"aotl": dict(launches=counts, step_s=times,
                        step_s_median=statistics.median(times[1:]),
                        peak_gib=peak, held=held_train_step(dev, "aotl"))}
    for model in ("deaott", "r101_aotl", "r50_topdown_aotl", "aotl_v3",
                  "rs101_aotl", "swinb_aotl"):
        counts, times, peak = train_phase(dev, card, False, model=model,
                                          steps=ENCODER_TRAIN_STEPS)
        out[model] = dict(launches=counts, step_s=times, peak_gib=peak)
    return out


# phase 26: R50-AOTL + RMem with the ConvGRU memory on phase 9's traffic. A
# write every 5 frames fills the 1 + 8 slots at frame 40; every later write
# appends, folds the victim into slot 1 through each layer's two GRU cells
# and compacts. Phase 4's hold runs through the first three such writes
SERVED["r50_aotl_gru"] = dict(model="r50_aotl", gru_memory=True)
SERVED_LAUNCHES["r50_aotl_gru"] = dict(SERVED_LAUNCHES["r50_aotl"])
SERVED_SHAPES["r50_aotl_gru"] = None
PHASE_LABEL["r50_aotl_gru"] = "phase 26 (AOT, GRU memory)"
PLAIN_FRAMES["r50_aotl_gru"] = BANK_FULL + 15
AGREE_PHASE["r50_aotl_gru"] = "phase 26, held"
GRU_MIN_ROUNDS = 17
BUSY_FRAMES = 10            # steady frames under the profiler, 2 writes


def gru_rounds(dev, frames: int) -> dict:
    """Phase 26's schedule: the GRU engine over `frames` of phase 9's
    frames, counting the GRU rounds (calls of the LSTT's compress_evicted)
    and, after every frame, whether each hidden state changed: they must
    change on exactly the frames with a round, and the rounds must be the
    schedule's evicting writes (at least GRU_MIN_ROUNDS)."""
    import torch

    engine, cfg = build_engine(dev, "r50_aotl_gru")
    img0, mask, g = reference_inputs(dev)
    imgs = torch.rand((frames, 1, *IN_HW, 3), generator=g, device=dev)
    gap = served_gap(cfg, frames + 1)
    state, _ = engine.add_reference(img0, mask, [NUM_OBJECTS], gap=gap)
    lstt = engine.model.lstt
    compress, rounds, changed = lstt.compress_evicted, [], []

    def counted(*a, **kw):
        rounds[-1] = True
        return compress(*a, **kw)

    with mock.patch.object(lstt, "compress_evicted", counted):
        for t in range(frames):
            rounds.append(False)
            hk, hv = state.gru_hid_k.clone(), state.gru_hid_v.clone()
            state, _ = engine.step(state, imgs[t], OUT_HW)
            changed.append(torch.stack([(state.gru_hid_k != hk).any(),
                                        (state.gru_hid_v != hv).any()]))
    changed = torch.stack(changed).cpu().tolist()
    slots = cfg.former_mem_len + cfg.latter_mem_len
    scheduled = [(t + 1) % gap == 0 and 1 + (t + 1) // gap > slots
                 for t in range(frames)]
    n = sum(rounds)
    print(f"phase 26: {n} GRU rounds over {frames} frames (a write every "
          f"{gap}, the bank full at {slots} slots), at frames "
          f"{[t + 1 for t, r in enumerate(rounds) if r]}; hidden states "
          f"changed on {sum(k or v for k, v in changed)} frames")
    check(rounds == scheduled, "phase 26: GRU rounds off the schedule")
    check(all(k == v == r for (k, v), r in zip(changed, rounds)),
          "phase 26: a hidden state changed off a GRU round, or not on one")
    check(n >= GRU_MIN_ROUNDS, f"phase 26: {n} GRU rounds")
    del engine, state
    torch.cuda.empty_cache()
    return dict(rounds=n, round_frames=[t + 1 for t, r in enumerate(rounds)
                                        if r])


def busy_beside(dev, models=("r50_aotl", "r50_aotl_gru")) -> dict:
    """Each model's device busy ms a frame (torch.profiler, the sum of its
    kernels) and host ms a frame over BUSY_FRAMES steady frames after the
    bank fills (frames 46-55: the writes at 50 and 55 evict), in one
    run."""
    import torch
    out = {}
    for model in models:
        engine, cfg = build_engine(dev, model)
        img0, mask, g = reference_inputs(dev)
        n = BANK_FULL + 5 + BUSY_FRAMES
        imgs = torch.rand((n, 1, *IN_HW, 3), generator=g, device=dev)
        state, _ = engine.add_reference(img0, mask, [NUM_OBJECTS],
                                        gap=served_gap(cfg, n + 1))
        for t in range(BANK_FULL + 5):
            state, _ = engine.step(state, imgs[t], OUT_HW)

        def steady():
            for t in range(BANK_FULL + 5, n):
                engine.step(state, imgs[t], OUT_HW)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steady()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / BUSY_FRAMES
        # the state moved on: the profiled frames are the next ten
        busy = device_busy_ms(steady, BUSY_FRAMES)
        out[model] = dict(busy_ms=busy, host_ms=wall)
        del engine, state
        torch.cuda.empty_cache()
    return out


def gru_served_phase(dev, frames: int, card: str, profile: bool,
                     aot_fps: float) -> dict:
    """Phase 26: R50-AOTL with the GRU memory on phase 9's traffic through
    main_path (exact launches: K1h 3 and K6 1 a frame; K1, K3, K4, K8
    never; the evictions the schedule's), the GRU rounds and hidden states
    (gru_rounds), the busy ms a frame beside phase 9's model, and phase
    4's hold through the first three evicting writes (every K1h and K6
    call held, the engine against the all-plain engine, labels >= 0.98)."""
    counts, fps = main_path(dev, frames, card, profile, model="r50_aotl_gru")
    rounds = gru_rounds(dev, frames)
    busy = busy_beside(dev)
    worst, logit_errs, agree = plain_agreement(dev, "r50_aotl_gru")
    fps_median = statistics.median(fps)
    print(f"phase 26: {fps_median:.3f} frames/s beside phase 9's "
          f"{aot_fps:.3f}; device busy ms a frame "
          + ", ".join(f"{m} {b['busy_ms']:.3f} (host {b['host_ms']:.3f})"
                      for m, b in busy.items())
          + f"; on {card}")
    return dict(launches=counts, fps_windows=fps, fps_median=fps_median,
                phase9_fps_median=aot_fps, busy=busy, on_path=worst,
                logit_rel_err=logit_errs, label_agreement=agree, **rounds)


# phase 27: training from a VOST-layout tree written on the card (phase
# 21's writer): the loader on the card against its CPU route, 6 steps of
# R50-AOTL with the GRU memory and reverse_infer (latter_mem_len 2, so
# each clip's third write, at frame 12, evicts through the GRU: with the
# preset's 8 latter slots a clip of 15 never fills the bank), its kernel
# step held against the plain one, 2 steps of R50-DeAOTL with
# reverse_infer and SGD, and the training CLI in a process of its own
TREE_SEQS = (("train0", 30, 10), ("train1", 30, 3), ("train2", 30, 6))
TREE_SEED = 7               # the loaders' seed
LOADER_PSNR_DB = 40.0       # the card's clips against the CPU route's
LOADER_TIMED = 3            # batches timed on the card
TREE_STEPS = 2              # R50-DeAOTL's steps and the CLI's
SERVED["r50_aotl_gru_rev"] = dict(model="r50_aotl", gru_memory=True,
                                  reverse_infer=True, latter_mem_len=2)
SERVED["r50_deaotl_rev_sgd"] = dict(model="r50_deaotl", reverse_infer=True,
                                    train_opt="sgd")
_REV = reverse_writes(type("c", (), dict(
    data_seq_len=TRAIN_T, train_long_term_mem_gap=4, reverse_infer=True)))
# each reverse decode runs the LSTT forward twice (under its checkpoint)
# and backward once, in every layer
TRAIN_LAUNCHES["r50_aotl_gru_rev"] = dict(
    TRAIN_LAUNCHES["r50_aotl"],
    bank_attention_lse_mh=_FWD + 6 * _REV,
    bank_attention_bwd_mh=_BWD + 3 * _REV)
TRAIN_LAUNCHES["r50_deaotl_rev_sgd"] = dict(
    TRAIN_LAUNCHES["r50_deaotl"], bank_attention_lse=_FWD + 6 * _REV,
    bank_attention_bwd_split=_BWD + 3 * _REV,
    local_attention=_FWD + 6 * _REV, local_attention_bwd=_BWD + 3 * _REV)
TRAIN_PHASE.update({
    "r50_aotl_gru_rev": ("phase 27", "R50-AOTL, GRU memory, reverse_infer"),
    "r50_deaotl_rev_sgd": ("phase 27", "R50-DeAOTL, reverse_infer, SGD")})
HELD_PHASE["r50_aotl_gru_rev"] = "phase 27, held"
# the CLI child: launches from 0 in the fresh process, each step's by a spy
# on train_step, the colour kernel's in all (the loader's thread decodes
# while steps run)
TRAIN_CHILD = r"""
import importlib, json, runpy, sys, time
import torch
import torch.multiprocessing as mp
from rmem_tpu_torch.kernels import jpeg_color as kj
from rmem_tpu_torch.managers import trainer as tm

report, names = sys.argv[1], json.loads(sys.argv[2])
sys.argv = ["rmem_tpu_torch.tools.train"] + sys.argv[3:]
wrappers = [getattr(importlib.import_module("rmem_tpu_torch.kernels." + m),
                    f) for m, f in names]
for fn in wrappers + [kj.ycc_to_rgb]:
    fn.launches = 0
step, per_step, step_s, split = tm.train_step, [], [], []


def counted(state, *a, **kw):
    if not split:       # the tensor-parallel split's parameters, if any
        tp = getattr(state.model, "tp_split", None)
        split.append(0 if tp is None else len(tp.index))
    before = [fn.launches for fn in wrappers]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(state, *a, **kw)
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
    per_step.append([fn.launches - b for fn, b in zip(wrappers, before)])
    return out


def dump(path):
    with open(path, "w") as f:
        json.dump({"per_step": per_step, "ycc_to_rgb": kj.ycc_to_rgb.launches,
                   "step_s": step_s, "split": split[0] if split else None,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}, f)


def forked(fn, args=(), nprocs=1, join=True, **kw):
    # --mesh's ranks forked, not spawned, so that each keeps this spy (the
    # parent has not touched the card); each writes report.<rank>
    def ranked(rank, *a):
        try:
            fn(rank, *a)
        finally:
            dump(f"{report}.{rank}")
    return mp.start_processes(ranked, args, nprocs, join,
                              start_method="fork")


tm.train_step = counted
mp.spawn = forked
runpy.run_module("rmem_tpu_torch.tools.train", run_name="__main__")
dump(report)
"""


def psnr(a, b) -> float:
    """PSNR in dB of two frame stacks in pixel levels 0..255."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def loader_phase(dev, data_root: Path, cfg) -> dict:
    """The loader on the card against its CPU route on the same files and
    seed: labels and obj_nums equal, frames (back in pixel levels) at least
    LOADER_PSNR_DB apart; then the card's clip-preparation ms over
    LOADER_TIMED batches (decode, scale, crop, flip, merge, normalise)."""
    import torch

    from rmem_tpu_torch.data.train_datasets import (InlineBatchLoader,
                                                    build_train_dataset)
    from rmem_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    ds = build_train_dataset(cfg, str(data_root))
    loaders = [InlineBatchLoader(ds, cfg.train_batch_size, TREE_SEED,
                                 cfg.model_max_obj_num, device=d)
               for d in (dev, "cpu")]
    t0 = time.perf_counter()
    card, host = (next(ld) for ld in loaders)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    mean = torch.as_tensor(IMAGENET_MEAN * 255.0)
    std = torch.as_tensor(IMAGENET_STD * 255.0)
    level = lambda x: x.float().cpu() * std + mean
    db = psnr(level(card["imgs"]), level(host["imgs"]))
    same = all(torch.equal(card[k].cpu(), host[k]) for k in ("labels",
                                                             "obj_nums"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOADER_TIMED):
        next(loaders[0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (LOADER_TIMED
                                             * cfg.train_batch_size)
    print(f"phase 27: the loader's batch of {cfg.train_batch_size} clips of "
          f"{cfg.data_seq_len} at {cfg.data_randomcrop}: labels and obj_nums "
          f"{'equal' if same else 'DIFFER'} on the card and the CPU "
          f"(obj_nums {card['obj_nums'].tolist()}), frames {db:.2f} dB "
          f"apart; {ms:.2f} ms a clip prepared on the card (mean of "
          f"{LOADER_TIMED} batches; the first pair of batches with the CPU "
          f"route {first_s:.1f} s)")
    check(same, "phase 27: the card's labels or obj_nums differ from the "
          "CPU route's")
    check(db >= LOADER_PSNR_DB, f"phase 27: loader PSNR {db:.2f} dB")
    return dict(psnr_db=db, clip_ms=ms, obj_nums=card["obj_nums"].tolist())


def run_train_cli(data_root: Path, out: Path, report: Path,
                  stage: str = "pre_vost_2", steps: int = TREE_STEPS,
                  batch=TRAIN_B, extra=("train_tblog_step=1",),
                  phase: str = "phase 27"):
    """The training CLI through TRAIN_CHILD in a process of its own (at
    the stage's own batch where `batch` is None); returns (report,
    seconds)."""
    cmd = [sys.executable, "-c", TRAIN_CHILD, str(report),
           json.dumps(TRAIN_KERNELS), "--stage", stage,
           "--data_root", str(data_root), "--max_steps", str(steps),
           *(["--batch_size", str(batch)] if batch else []),
           "--opt", f"dir_root={out}", "train_log_step=1", *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    secs = time.perf_counter() - t0
    print(f"{phase}: the training CLI exited {r.returncode} after "
          f"{secs:.1f} s; its output:\n"
          + "\n".join("  | " + ln for ln in r.stdout.splitlines()[-12:]))
    if r.returncode != 0:
        print(r.stderr[-6000:], file=sys.stderr)
    check(r.returncode == 0, f"{phase}: the training CLI exited "
          f"{r.returncode}")
    return json.loads(report.read_text()), secs


def tree_train_phase(dev, card: str) -> dict:
    """Phase 27 (see the module docstring). Returns what it measured."""
    import tempfile

    import torch

    from rmem_tpu_torch.config import get_config
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        _, enc_ms = eval_tree(dev, tmp / "VOST", TREE_SEQS, "train")
        out["tree_s"] = time.perf_counter() - t0
        print(f"phase 27: a VOST tree of {len(TREE_SEQS)} videos of "
              f"{TREE_SEQS[0][1]} frames at {EVAL_HW[0]}x{EVAL_HW[1]} "
              f"written in {out['tree_s']:.1f} s ({enc_ms:.2f} ms a JPEG)")
        cfg = train_config("r50_aotl_gru_rev")
        out["loader"] = loader_phase(dev, tmp, cfg)
        for model, steps in (("r50_aotl_gru_rev", TRAIN_STEPS),
                             ("r50_deaotl_rev_sgd", TREE_STEPS)):
            counts, times, peak = train_phase(dev, card, False, model,
                                              steps, data_root=str(tmp))
            out[model] = dict(launches=counts, step_s=times, peak_gib=peak,
                              step_s_median=statistics.median(
                                  times[1:] or times))
        out["r50_aotl_gru_rev"]["held"] = held_train_step(
            dev, "r50_aotl_gru_rev")
        report, secs = run_train_cli(tmp, tmp / "results",
                                     tmp / "train_report.json")
        run = tmp / "results"
        stage = next(run.iterdir()) / "pre_vost_2"
        logs = sorted((stage / "logs").iterdir())
        imgs = sorted(p.name for p in (stage / "img_logs").iterdir())
        cli_cfg = get_config("pre_vost_2", model="r50_deaotl")
        t = cli_cfg.data_seq_len
        want = dict(TRAIN_LAUNCHES["r50_deaotl"],
                    bank_attention_lse=3 * (2 * t - 1),
                    bank_attention_bwd_split=3 * t,
                    local_attention=3 * (2 * t - 1),
                    local_attention_bwd=3 * t)
        expected = [want[fn] for _, fn in TRAIN_KERNELS]
        text = logs[0].read_text() if logs else ""
        print(f"phase 27: the CLI's launches per step {report['per_step']} "
              f"(expected {expected}), {report['ycc_to_rgb']} frames "
              f"decoded on the card; logs {[p.name for p in logs]}; "
              f"img_logs {imgs}")
        check(report["per_step"] == [expected] * TREE_STEPS,
              f"phase 27 CLI launches {report['per_step']}")
        check(report["ycc_to_rgb"] >= TREE_STEPS * TRAIN_B * t,
              f"phase 27 CLI decoded {report['ycc_to_rgb']} frames")
        check(len(logs) == 1 and f"step {TREE_STEPS}/" in text
              and (stage / "config.json").is_file(), "phase 27 CLI logs")
        check(imgs == sorted(f"{s:08d}_{k}.png" for s in
                             range(1, TREE_STEPS + 1)
                             for k in ("gt", "img", "pred")),
              f"phase 27 img_logs {imgs}")
        out["cli"] = dict(per_step=report["per_step"][0], seconds=secs,
                          decoded=report["ycc_to_rgb"])
    torch.cuda.empty_cache()
    return out


# phase 28: the static-image stage `pre` on a Static tree written on the
# card: STATIC_IMAGES JPEG images at STATIC_HW with 1-10 blob objects each
STATIC_IMAGES = 24
STATIC_HW = (480, 640)
STATIC_SEED = 11            # the loaders' seed
STATIC_LOADER_B = 4         # clips held between the card and the CPU route
STATIC_PSNR_DB = 45.0       # the card's clips against the CPU route's
PRE_STEPS = 2
# the stage's clips of 5: K1' and K4 over 5 frames and the 4 checkpointed
# ones in each of the 3 GPM layers, their backwards over 5, K7 once over
# the batch's frames
_PRE_T = 5
PRE_LAUNCHES = dict(TRAIN_LAUNCHES["r50_deaotl"],
                    bank_attention_lse=3 * (2 * _PRE_T - 1),
                    bank_attention_bwd_split=3 * _PRE_T,
                    local_attention=3 * (2 * _PRE_T - 1),
                    local_attention_bwd=3 * _PRE_T)
# phase 29: the multi-process runs on the Static tree
MESH_B = 4                  # the global batch of the two-rank run
MESH_STEPS = 2
MESH_PARAM_ATOL = 1e-5      # two ranks against one process, every weight
MESH_LOSS_RTOL = 1e-4
# f32 compute and SGD, whose update is linear in the gradient (Adam's
# first steps are sign-like: a near-zero gradient's rounding would move
# its weight by up to twice the learning rate)
MESH_OPTS = ("compute_dtype=float32", "train_opt=sgd")
MESH_EVAL_SEQS = (("seq0", 10, 3), ("seq1", 8, 2))
# phase 30: the exported serving step
EXPORT_FRAMES = 30
EXPORT_AGREE = 0.999        # the share of label pixels equal to eager's
HOST_TIMED_CALLS = 200      # host issue time: calls a turn


def static_tree(dev, root: Path) -> float:
    """Phase 28's tree under root/Static: STATIC_IMAGES JPEG images
    (nvJPEG's encoder) at STATIC_HW, image i with 1 + i % 10 blob objects
    (eval_video's generator), and palette PNG masks. Returns the encode ms
    an image."""
    from rmem_tpu_torch.data.jpeg import encode_jpeg
    from rmem_tpu_torch.utils.image import encode_png_pal8, label_colormap
    img_dir = root / "Static" / "JPEGImages"
    ann_dir = root / "Static" / "Annotations"
    img_dir.mkdir(parents=True)
    ann_dir.mkdir(parents=True)
    enc_s = 0.0
    for i in range(STATIC_IMAGES):
        imgs, labels = eval_video(dev, 100 + i, 1, 1 + i % 10, STATIC_HW)
        t0 = time.perf_counter()
        data = encode_jpeg(imgs[0])
        enc_s += time.perf_counter() - t0
        (img_dir / f"img{i:03d}.jpg").write_bytes(data)
        (ann_dir / f"img{i:03d}.png").write_bytes(
            encode_png_pal8(labels[0], label_colormap()))
    return 1e3 * enc_s / STATIC_IMAGES


def static_loader_check(dev, root: Path, cfg) -> dict:
    """The stage's loader on the card against its CPU route on the same
    files and seed (STATIC_LOADER_B clips): labels and obj_nums equal,
    frames at least STATIC_PSNR_DB apart; then the card's ms a clip over
    one batch of the stage's own size."""
    import torch

    from rmem_tpu_torch.data.train_datasets import (InlineBatchLoader,
                                                    build_train_dataset)
    from rmem_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    ds = build_train_dataset(cfg, str(root))
    card, host = (next(InlineBatchLoader(ds, STATIC_LOADER_B, STATIC_SEED,
                                         cfg.model_max_obj_num, device=d))
                  for d in (dev, "cpu"))
    mean = torch.as_tensor(IMAGENET_MEAN * 255.0)
    std = torch.as_tensor(IMAGENET_STD * 255.0)
    level = lambda x: x.float().cpu() * std + mean
    db = psnr(level(card["imgs"]), level(host["imgs"]))
    same = all(torch.equal(card[k].cpu(), host[k]) for k in ("labels",
                                                             "obj_nums"))
    loader = InlineBatchLoader(ds, cfg.train_batch_size, STATIC_SEED,
                               cfg.model_max_obj_num, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = next(loader)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / cfg.train_batch_size
    print(f"phase 28: the static loader's {STATIC_LOADER_B} clips of "
          f"{cfg.data_seq_len} at {cfg.data_randomcrop}: labels and "
          f"obj_nums {'equal' if same else 'DIFFER'} on the card and the "
          f"CPU (obj_nums {card['obj_nums'].tolist()}), frames {db:.2f} dB "
          f"apart; a batch of {cfg.train_batch_size} clips in "
          f"{ms:.2f} ms a clip on the card (imgs "
          f"{tuple(batch['imgs'].shape)})")
    check(same, "phase 28: the card's labels or obj_nums differ from the "
          "CPU route's")
    check(db >= STATIC_PSNR_DB, f"phase 28: loader PSNR {db:.2f} dB")
    return dict(psnr_db=db, clip_ms=ms, obj_nums=card["obj_nums"].tolist())


def pre_phase(dev, card: str, tmp: Path) -> dict:
    """Phase 28 (see the module docstring). Returns what it measured."""
    from rmem_tpu_torch.config import get_config
    out = {}
    t0 = time.perf_counter()
    enc_ms = static_tree(dev, tmp)
    print(f"phase 28: a Static tree of {STATIC_IMAGES} images at "
          f"{STATIC_HW[0]}x{STATIC_HW[1]} written in "
          f"{time.perf_counter() - t0:.1f} s ({enc_ms:.2f} ms a JPEG)")
    cfg = get_config("pre", model="r50_deaotl", pretrain=False)
    check((cfg.datasets, cfg.data_seq_len) == (("static",), _PRE_T),
          f"the stage pre: {cfg.datasets}, clips of {cfg.data_seq_len}")
    out["loader"] = static_loader_check(dev, tmp, cfg)
    report, secs = run_train_cli(
        tmp, tmp / "results_pre", tmp / "pre_report.json", stage="pre",
        steps=PRE_STEPS, batch=None, extra=("pretrain=false",),
        phase="phase 28")
    expected = [PRE_LAUNCHES[fn] for _, fn in TRAIN_KERNELS]
    timed = report["step_s"][1:] or report["step_s"]
    print(f"phase 28: {PRE_STEPS} steps of R50-DeAOTL, stage pre, "
          f"{cfg.train_batch_size} clips of {cfg.data_seq_len} at "
          f"{cfg.data_randomcrop}: {statistics.median(timed):.3f} s/step "
          f"after the first (each: "
          + ", ".join(f"{t:.3f}" for t in report["step_s"])
          + f"), peak {report['peak_gib']:.2f} GiB; launches a step "
          f"{report['per_step']} (K1', K2, K4, K5's backward, K6/K7 "
          f"first: expected {expected}); {report['ycc_to_rgb']} images "
          f"decoded on the card; on {card}")
    check(report["per_step"] == [expected] * PRE_STEPS,
          f"phase 28 launches {report['per_step']}")
    check(report["ycc_to_rgb"] >= PRE_STEPS * cfg.train_batch_size,
          f"phase 28 decoded {report['ycc_to_rgb']} images")
    out.update(step_s=report["step_s"], peak_gib=report["peak_gib"],
               per_step=report["per_step"][0], cli_s=secs)
    return out


def _train_cmd(data_root: Path, out: Path, steps: int, batch: int, *extra,
               opts=()):
    return [sys.executable, "-m", "rmem_tpu_torch.tools.train", "--stage",
            "pre", "--data_root", str(data_root), "--max_steps", str(steps),
            "--batch_size", str(batch), "--save", "--deterministic", *extra,
            "--opt", "pretrain=false", f"dir_root={out}", "train_log_step=1",
            *opts]


def _saved_stream(out: Path, step: int) -> dict:
    import torch
    (run,) = list(out.iterdir())
    return torch.load(run / "pre" / "ckpt" / f"save_step_{step}.pt",
                      map_location="cpu", weights_only=True)["state"]


def _final_loss(out: Path) -> float:
    """The last step's loss as the run's log prints it (the final
    metrics, full precision)."""
    import ast
    (run,) = list(out.iterdir())
    (log,) = list((run / "pre" / "logs").iterdir())
    line = [ln for ln in log.read_text().splitlines()
            if ln.startswith("final metrics:")][-1]
    return float(ast.literal_eval(line.split(":", 1)[1].strip())["loss"])


def mesh_phase(dev, card: str, tmp: Path) -> dict:
    """Phase 29 (see the module docstring): the training CLI as one rank
    and as two, and the evaluator's CLI as two ranks, each against one
    process, all started at once on the one card. Returns what it
    measured."""
    import hashlib
    import socket

    import torch
    runs = {
        "plain": _train_cmd(tmp, tmp / "m_plain", 1, 2),
        "mesh1": _train_cmd(tmp, tmp / "m_mesh1", 1, 2, "--mesh", "1"),
        "one_f32": _train_cmd(tmp, tmp / "m_one", MESH_STEPS, MESH_B,
                              opts=MESH_OPTS),
        "two_f32": _train_cmd(tmp, tmp / "m_two", MESH_STEPS, MESH_B,
                              "--mesh", "2", opts=MESH_OPTS),
    }
    vroot = tmp / "veval" / "VOST"
    eval_tree(dev, vroot, MESH_EVAL_SEQS)
    pool = sum(f for _, f, _ in MESH_EVAL_SEQS) * EVAL_HW[0] * EVAL_HW[1] * 3

    def eval_cmd(report: str, masks: str):
        return [sys.executable, "-c", EVAL_CHILD, str(tmp / f"{report}.json"),
                str(pool), "--stage", "pre_vost_2", "--model", "r50_deaotl",
                "--dataset", "vost", "--data_root", str(vroot.parent),
                "--ckpt_path", "test", "--output_root", str(tmp / masks),
                "--exp_name", "chip_smoke",
                "--opt", f"dir_root={tmp / 'eval_results'}"]

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = {}
    t0 = time.perf_counter()
    with ExitStack() as stack:
        stack.callback(lambda: [(p.kill(), p.wait()) for p, _ in
                                procs.values() if p.poll() is None])
        for name, cmd in runs.items():
            procs[name] = (subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), cmd)
        procs["eval_one"] = (subprocess.Popen(
            eval_cmd("eval_one", "eval_one"), cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            None)
        for r in range(2):
            procs[f"eval_rank{r}"] = (subprocess.Popen(
                eval_cmd(f"eval_rank{r}", "eval_two"),
                cwd=ROOT, env=dict(env, RANK=str(r), WORLD_SIZE="2",
                                   MASTER_ADDR="localhost",
                                   MASTER_PORT=str(port)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), None)
        outs = {}
        for name, (p, _) in procs.items():
            outs[name] = p.communicate(timeout=900)[0]
            if p.returncode != 0:
                print(f"phase 29: {name} exited {p.returncode}:\n"
                      + outs[name][-6000:], file=sys.stderr)
            check(p.returncode == 0, f"phase 29: {name} exited "
                  f"{p.returncode}")
    secs = time.perf_counter() - t0
    out = {"seconds": secs}
    # one rank over nccl against the plain run: bit for bit
    a, b = _saved_stream(tmp / "m_plain", 1), _saved_stream(tmp / "m_mesh1",
                                                             1)
    diff = [k + "/" + n for k in ("params", "mu", "nu", "ema")
            for n in a[k] if not torch.equal(a[k][n], b[k][n])]
    print(f"phase 29: tools/train.py --mesh 1 (nccl) against the plain "
          f"Trainer, one step at batch 2 (--deterministic): "
          f"{len(diff)} of {4 * len(a['params'])} state tensors differ "
          f"{diff[:5]}")
    check(not diff, f"phase 29: --mesh 1 differs from the plain step in "
          f"{diff[:5]}")
    out["mesh1_bitwise"] = not diff
    # two ranks over gloo against one process at the same global batch
    one = _saved_stream(tmp / "m_one", MESH_STEPS)
    two = _saved_stream(tmp / "m_two", MESH_STEPS)
    pdiff = max((one["params"][n] - two["params"][n]).abs().max().item()
                for n in one["params"])
    l1, l2 = _final_loss(tmp / "m_one"), _final_loss(tmp / "m_two")
    logs = {k: [ln for ln in outs[k].splitlines() if ln.startswith("step ")]
            for k in ("one_f32", "two_f32")}
    print(f"phase 29: two ranks over gloo on the one card (2 clips each) "
          f"against one process, {MESH_STEPS} SGD steps of R50-DeAOTL, "
          f"stage pre, global batch {MESH_B}, f32 compute: the last loss "
          f"{l2!r} "
          f"against {l1!r}, the largest weight difference {pdiff:.3e} "
          f"(held to {MESH_PARAM_ATOL:g}; the loss to {MESH_LOSS_RTOL:g} "
          f"relative); the logs {logs}")
    check(abs(l1 - l2) <= MESH_LOSS_RTOL * abs(l1),
          f"phase 29: two-rank loss {l2} against {l1}")
    check(pdiff <= MESH_PARAM_ATOL, f"phase 29: two-rank weights differ "
          f"by {pdiff:.3e}")
    out.update(two_rank_loss=l2, one_loss=l1, weight_diff=pdiff)
    # two-rank evaluation against one process: the same masks, the stats
    # summed
    def pngs(root: Path) -> dict:
        return {str(p.relative_to(root)): hashlib.sha256(
            p.read_bytes()).hexdigest() for p in root.rglob("*.png")}
    one_masks, two_masks = pngs(tmp / "eval_one"), pngs(tmp / "eval_two")
    reps = [json.loads((tmp / f"eval_rank{r}.json").read_text())
            for r in range(2)]
    total = sum(f - 1 for _, f, _ in MESH_EVAL_SEQS)
    seqs = [sorted(r["stats"]["per_seq_fps"]) for r in reps]
    print(f"phase 29: tools/eval.py as two ranks (gloo) over "
          f"{len(MESH_EVAL_SEQS)} sequences: rank sequences {seqs}, "
          f"{len(two_masks)} masks ({len(one_masks)} from one process), "
          f"{'equal' if one_masks == two_masks else 'DIFFERENT'}; global "
          f"frames {[r['stats'].get('global_frames') for r in reps]} "
          f"(expected {total}), global seqs "
          f"{[r['stats'].get('global_seqs') for r in reps]}, "
          f"{secs:.1f} s for the phase's processes; on {card}")
    check(one_masks == two_masks and len(one_masks) == total
          + len(MESH_EVAL_SEQS), "phase 29: two-rank masks differ from one "
          "process's")
    check(all(r["stats"].get("global_frames") == total
              and r["stats"].get("global_seqs") == len(MESH_EVAL_SEQS)
              for r in reps), "phase 29: the all-reduced stats")
    check(sorted(seqs[0] + seqs[1]) == sorted(n for n, *_ in
                                              MESH_EVAL_SEQS)
          and not set(seqs[0]) & set(seqs[1]), f"phase 29: ranks' "
          f"sequences {seqs}")
    out["eval_masks_equal"] = True
    return out


def issue_us(fn, calls: int = HOST_TIMED_CALLS) -> float:
    """The host's time to issue one call of fn, in microseconds (no wait
    on the card inside the loop)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def export_phase(dev, card: str, tmp: Path) -> dict:
    """Phase 30 (see the module docstring). Returns what it measured."""
    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import ops as kops
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.tools.export import build_exported

    engine, cfg = build_engine(dev, "r50_deaotl", graphs=False)
    t0 = time.perf_counter()
    exported, _, _ = build_exported(cfg, _SEEDED["r50_deaotl"], IN_HW,
                                    device=dev)
    export_s = time.perf_counter() - t0
    path = tmp / "step.pt2"
    torch.export.save(exported, str(path))
    step = torch.export.load(str(path)).module()
    ops = sorted({str(n.target) for n in exported.graph.nodes
                  if str(n.target).startswith("rmem.")})
    print(f"phase 30: R50-DeAOTL's bf16 step at {IN_HW[0]}x{IN_HW[1]} "
          f"exported in {export_s:.1f} s, saved ({path.stat().st_size / 2**20:.1f}"
          f" MB) and loaded; its custom ops {ops}")
    check({"rmem.bank_attention_infer.default", "rmem.local_attention.default",
           "rmem.stem.default"} <= set(ops), f"phase 30: ops {ops}")
    img0, mask, g = reference_inputs(dev)
    imgs = torch.rand((EXPORT_FRAMES, 1, *IN_HW, 3), generator=g, device=dev)
    gap = served_gap(cfg, EXPORT_FRAMES + 1)
    eager, _ = engine.add_reference(img0, mask, [NUM_OBJECTS], gap=gap)
    sched, _ = engine.add_reference(img0, mask, [NUM_OBJECTS], gap=gap)
    tensors = engine.state_tensors(sched)
    flags = {b: torch.tensor(b, device=dev) for b in (False, True)}
    wrappers = (kb.bank_attention_infer, kl.local_attention, ks.stem)
    runs = {}
    for name in ("eager", "exported"):
        for fn in wrappers:
            fn.launches = 0
        labels = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for t in range(EXPORT_FRAMES):
                if name == "eager":
                    eager, lab = engine.step(eager, imgs[t], IN_HW)
                else:
                    *tensors, lab = step(*tensors, imgs[t],
                                         flags[engine.write_due(sched)])
                labels.append(lab)
        torch.cuda.synchronize()
        runs[name] = dict(fps=EXPORT_FRAMES / (time.perf_counter() - t0),
                          launches={fn.__name__: fn.launches
                                    for fn in wrappers},
                          labels=torch.stack(labels))
    share = (runs["eager"]["labels"] == runs["exported"]["labels"]
             ).float().mean().item()
    want = {"bank_attention_infer": 3 * EXPORT_FRAMES,
            "local_attention": 3 * EXPORT_FRAMES, "stem": EXPORT_FRAMES}
    count_x, count_e = int(tensors[2]), int(eager.bank.count)
    print(f"phase 30: {EXPORT_FRAMES} frames after the reference: the "
          f"exported program {runs['exported']['fps']:.3f} frames/s, the "
          f"eager engine {runs['eager']['fps']:.3f} (first frames "
          f"included); launches {runs['exported']['launches']} (eager "
          f"{runs['eager']['launches']}); labels equal on {share:.6f} of "
          f"pixels; bank count {count_x} (eager {count_e}); on {card}")
    for name in runs:
        check(runs[name]["launches"] == want, f"phase 30: {name} launches "
              f"{runs[name]['launches']}, expected {want}")
    check(share >= EXPORT_AGREE and count_x == count_e,
          f"phase 30: labels equal on {share}, counts {count_x}, {count_e}")
    # the dispatcher's cost: each kernel's call as the engine makes it,
    # issued directly and through its custom op, in turns
    calls = {}
    spies = [mock.patch.object(mod, name, _capture(calls, name, getattr(
        mod, name))) for mod, name in ((kb, "bank_attention_infer"),
                                       (kl, "local_attention"),
                                       (ks, "stem"))]
    for s in spies:
        s.start()
    with torch.no_grad():
        engine.step(eager, imgs[0], IN_HW)
    for s in spies:
        s.stop()
    issue = {}
    for name, (a, kw) in calls.items():
        direct = lambda: getattr(kb if "bank" in name else kl
                                 if "local" in name else ks, name)(*a, **kw)
        op = getattr(kops, name)
        via_op = lambda: op(*a, **kw)
        turns = [issue_us(direct), issue_us(via_op), issue_us(via_op),
                 issue_us(direct)]
        issue[name] = dict(direct_us=[turns[0], turns[3]],
                           op_us=[turns[1], turns[2]])
    print("phase 30: host issue time a call, direct ctypes wrapper against "
          "the rmem:: custom op (turns direct, op, op, direct; "
          f"{HOST_TIMED_CALLS} calls a turn): "
          + "; ".join(f"{n} {v['direct_us'][0]:.1f}, {v['op_us'][0]:.1f}, "
                      f"{v['op_us'][1]:.1f}, {v['direct_us'][1]:.1f} us"
                      for n, v in issue.items()) + f"; on {card}")
    del engine, exported, step
    torch.cuda.empty_cache()
    return dict(export_s=export_s, fps={k: v["fps"] for k, v in
                                        runs.items()},
                launches=runs["exported"]["launches"], label_share=share,
                issue_us=issue)


def _capture(calls: dict, name: str, fn):
    """A stand-in for a wrapper that keeps its first call's arguments."""
    def call(*a, **kw):
        calls.setdefault(name, (a, kw))
        return fn(*a, **kw)
    call.launches = 0
    return call


# phase 31: every serving family through torch.export at phase 30's sizes,
# 481x849 in and 480x854 out. Each exported step is handed the eager
# engine's state once its bank is full, so its writes evict (with the GRU
# memory each write is a round); the opt-in route runs with
# RMEM_BANK_QMINOR set while its engines are built
SERVED["r50_deaotl_optin"] = dict(model="r50_deaotl", use_pallas_dwconv=True)
SERVED["r50_deaotl_nolong"] = dict(model="r50_deaotl", no_long_memory=True)
_BANK, _LOCAL, _STEM = ("rmem.bank_attention_infer.default",
                        "rmem.local_attention.default", "rmem.stem.default")
# each family: the rmem:: ops its graph must hold, and each wrapper's
# launches a frame (the others' 0)
EXPORT_FAMILIES = {
    "r50_aotl": ({_BANK, _STEM}, dict(bank_attention_infer_mh=3, stem=1)),
    "r50_aotl_gru": ({_BANK, _STEM},
                     dict(bank_attention_infer_mh=3, stem=1)),
    "r50_aotl_nmg": ({_BANK, _STEM}, dict(bank_attention_infer=3, stem=1)),
    "r50_deaotl_nmg": ({_BANK, _LOCAL, _STEM},
                       dict(bank_attention_infer=3, local_attention=3,
                            stem=1)),
    "r50_deaotl_optin": ({"rmem.bank_attention_qminor.default",
                          "rmem.gated_dwconv.default", _LOCAL, _STEM},
                         dict(bank_attention_qminor=3, gated_dwconv=9,
                              local_attention=3, stem=1)),
    "r50_deaotl_nolong": ({_BANK, _LOCAL, _STEM},
                          dict(bank_attention_infer=3, local_attention=3,
                               stem=1)),
}
# K3 at one head runs K1's template too
SERVED_SHAPES.update({"r50_deaotl_nolong": (1, 128, 1024),
                      "r50_deaotl_optin": (1, 128, 1024)})
# the kernels line's entries that phase 31 reaches: the counter and the
# families whose launches are that entry's kernel at its head shape
PHASE31_ENTRIES = {
    "bank_attention": ("bank_attention_infer", ("r50_deaotl_nolong",)),
    "bank_attention_h2": ("bank_attention_infer", ("r50_deaotl_nmg",)),
    "bank_attention_h2v128": ("bank_attention_infer", ("r50_aotl_nmg",)),
    "bank_attention_mh": ("bank_attention_infer_mh",
                          ("r50_aotl", "r50_aotl_gru")),
    "bank_attention_qminor": ("bank_attention_qminor", ("r50_deaotl_optin",)),
    "local_attention": ("local_attention",
                        ("r50_deaotl_optin", "r50_deaotl_nolong")),
    "local_attention_h2": ("local_attention", ("r50_deaotl_nmg",)),
    "gated_dwconv": ("gated_dwconv", ("r50_deaotl_optin",)),
    "stem": ("stem", tuple(EXPORT_FAMILIES)),
}
GRU_EXPORT_ROUNDS = 5       # GRU rounds held in 30 frames at a gap of 5
HID_TOL = 2e-2              # max |exported - eager| / max |eager|, hidden


def export_family(dev, model: str, card: str, tmp: Path) -> dict:
    """Phase 31 for one family: build_exported, saved and loaded; the eager
    engine over the reference and the frames that fill its bank; then
    EXPORT_FRAMES frames from that state through the eager engine and
    through the loaded program, launches counted from 0 in each. Returns
    what it measured."""
    import dataclasses

    import torch

    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import dwconv as kd
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    from rmem_tpu_torch.tools.export import build_exported

    want_ops, per_frame = EXPORT_FAMILIES[model]
    optin = model == "r50_deaotl_optin"
    with mock.patch.dict(os.environ,
                         {"RMEM_BANK_QMINOR": "1"} if optin else {}):
        engine, cfg = build_engine(dev, model)
        t0 = time.perf_counter()
        exported, _, _ = build_exported(cfg, _SEEDED[model], IN_HW,
                                        device=dev, out_hw=OUT_HW)
        export_s = time.perf_counter() - t0
    check(engine.route == dict(qminor=optin, fused_dw=optin),
          f"phase 31: {model}'s routes {engine.route}")
    path = tmp / f"{model}.pt2"
    torch.export.save(exported, str(path))
    step = torch.export.load(str(path)).module()
    ops = {str(n.target) for n in exported.graph.nodes
           if str(n.target).startswith("rmem.")}
    conds = sum(str(n.target) == "cond" for n in exported.graph.nodes)
    check(ops == want_ops and conds == int(cfg.gru_memory_active),
          f"phase 31: {model}'s graph holds {sorted(ops)} and {conds} "
          f"cond, expected {sorted(want_ops)}")
    slots = cfg.former_mem_len + cfg.latter_mem_len
    img0, mask, g = reference_inputs(dev)
    gap = served_gap(cfg, 1 + BANK_FULL + EXPORT_FRAMES)
    prefill = 0 if cfg.no_long_memory else (slots - 1) * gap
    imgs = torch.rand((prefill + EXPORT_FRAMES, 1, *IN_HW, 3), generator=g,
                      device=dev)
    state, _ = engine.add_reference(img0, mask, [NUM_OBJECTS], gap=gap)
    for t in range(prefill):
        state, _ = engine.step(state, imgs[t], OUT_HW)
    start = int(state.bank.count)
    check(cfg.no_long_memory or start == slots,
          f"phase 31: {model}'s bank holds {start} slots")
    sched = dataclasses.replace(state)   # the write schedule, for the flags
    tensors = [t.clone() for t in engine.state_tensors(state)]
    fields = engine.state_fields()
    flags = {b: torch.tensor(b, device=dev) for b in (False, True)}
    wrappers = (kb.bank_attention_infer, kb.bank_attention_infer_mh,
                kb.bank_attention_qminor, kl.local_attention, ks.stem,
                kd.gated_dwconv)
    shapes, slots_call = [], kb._slots_call

    def spied_slots_call(q, bank_k, bank_v, count, num_heads, *a, **kw):
        shapes.append((num_heads, q.shape[-1] // num_heads,
                       bank_v.shape[-1] // num_heads))
        return slots_call(q, bank_k, bank_v, count, num_heads, *a, **kw)

    runs = {}
    for name in ("eager", "exported"):
        for fn in wrappers:
            fn.launches = 0
        shapes.clear()
        labels, hidden = [], []
        evictions = torch.zeros((), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(kb, "_slots_call", spied_slots_call), \
                torch.inference_mode():
            for t in range(prefill, prefill + EXPORT_FRAMES):
                if name == "eager":
                    was_full = state.bank.count >= slots
                    state, lab = engine.step(state, imgs[t], OUT_HW)
                    wrote = state.last_mem_step == state.frame_step
                    hid = (state.gru_hid_k, state.gru_hid_v)
                else:
                    wrote = engine.write_due(sched)
                    was_full = tensors[2] >= slots
                    *tensors, lab = step(*tensors, imgs[t], flags[wrote])
                    hid = tuple(tensors[fields.index(f)] for f in
                                engine.GRU_FIELDS if f in fields)
                if wrote and not cfg.no_long_memory:
                    evictions += was_full
                    if cfg.gru_memory_active:
                        hidden.append(tuple(h.clone() for h in hid))
                labels.append(lab)
        torch.cuda.synchronize()
        fps = EXPORT_FRAMES / (time.perf_counter() - t0)
        runs[name] = dict(fps=fps, launches={fn.__name__: fn.launches
                                             for fn in wrappers},
                          labels=torch.stack(labels), hidden=hidden,
                          evictions=int(evictions), shapes=set(shapes),
                          k1_template=len(shapes))
    eager, exp = runs["eager"], runs["exported"]
    share = (eager["labels"] == exp["labels"]).float().mean().item()
    want = {fn.__name__: per_frame.get(fn.__name__, 0) * EXPORT_FRAMES
            for fn in wrappers}
    count_x, count_e = int(tensors[2]), int(state.bank.count)
    hid_err = 0.0
    for (xk, xv), (ek, ev) in zip(exp["hidden"], eager["hidden"]):
        for x, e in ((xk, ek), (xv, ev)):
            hid_err = max(hid_err, ((x.float() - e.float()).abs().max()
                                    / e.float().abs().max()).item())
    rounds = len(exp["hidden"])
    print(f"phase 31: {model} exported in {export_s:.1f} s "
          f"({path.stat().st_size / 2**20:.1f} MB saved; ops "
          f"{sorted(ops)}, {conds} cond), handed the eager state after "
          f"{prefill} frames (bank {start} slots, a write every {gap}); "
          f"{EXPORT_FRAMES} frames: exported "
          f"{exp['fps']:.3f} frames/s, eager {eager['fps']:.3f}; launches "
          f"{exp['launches']} (eager {eager['launches']}); labels equal on "
          f"{share:.6f} of pixels; bank count {count_x} (eager {count_e}); "
          f"evictions {exp['evictions']} (eager {eager['evictions']})"
          + (f"; {rounds} GRU rounds (eager {len(eager['hidden'])}), "
             f"hidden states within {hid_err:.3e} of max"
             if cfg.gru_memory_active else "") + f"; on {card}")
    for name, run in runs.items():
        check(run["launches"] == want, f"phase 31: {model} {name} launches "
              f"{run['launches']}, expected {want}")
        shape = SERVED_SHAPES.get(model)
        check(run["shapes"] == ({shape} if shape else set())
              and run["k1_template"] == run["launches"][
                  "bank_attention_infer"] + run["launches"][
                  "bank_attention_qminor"],
              f"phase 31: {model} {name}: K1's template at "
              f"{sorted(run['shapes'])}")
    check(share >= EXPORT_AGREE, f"phase 31: {model} labels equal on "
          f"{share}")
    check(count_x == count_e and exp["evictions"] == eager["evictions"],
          f"phase 31: {model} counts {count_x}, {count_e}, evictions "
          f"{exp['evictions']}, {eager['evictions']}")
    check(cfg.no_long_memory or eager["evictions"] >= 1,
          f"phase 31: {model} evicted nothing")
    if cfg.gru_memory_active:
        check(rounds == len(eager["hidden"]) == exp["evictions"]
              >= GRU_EXPORT_ROUNDS and hid_err <= HID_TOL,
              f"phase 31: {model} {rounds} GRU rounds, hidden states "
              f"{hid_err:.3e} apart")
    del engine, exported, step, state, tensors, runs
    torch.cuda.empty_cache()
    return dict(export_s=export_s, fps_exported=exp["fps"],
                fps_eager=eager["fps"], launches=exp["launches"],
                label_share=share, evictions=exp["evictions"],
                gru_rounds=rounds, hid_rel_err=hid_err, prefill=prefill)


def export_families_phase(dev, card: str, tmp: Path) -> dict:
    """Phase 31 (see the module docstring): each of EXPORT_FAMILIES."""
    return {m: export_family(dev, m, card, tmp) for m in EXPORT_FAMILIES}


# phase 32: the tensor-parallel split (parallel/tp.py) on its first card
# run: the training CLI with --mesh 1 2 and the ("data", "model") axes, its
# two ranks on the one card over gloo, against one unsplit process, for
# R50-DeAOTL (the GPM's gated self-attention split) and R50-AOTL (the
# self-attention's output projection split); all four processes at once
TP_B = 2                    # the batch each rank (and the unsplit run) takes
TP_OPTS = MESH_OPTS + ("mesh_axes=('data','model')",)
_AOT_PRE = dict(TRAIN_LAUNCHES["r50_aotl"],
                bank_attention_lse_mh=3 * (2 * _PRE_T - 1),
                bank_attention_bwd_mh=3 * _PRE_T)
# each model: the split's parameters (3 layers: the GPM's 4 column-parallel
# weights and biases and its projection; AOT's projection) and the
# launches a step at the stage pre's clips of 5, in each rank as unsplit
TP_MODELS = {"r50_deaotl": (3 * (2 * 4 + 1), PRE_LAUNCHES),
             "r50_aotl": (3, _AOT_PRE)}


def tp_phase(dev, card: str, tmp: Path) -> dict:
    """Phase 32 (see the module docstring). Returns what it measured."""
    import torch
    procs, out = {}, {}
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    with ExitStack() as stack:
        stack.callback(lambda: [(p.kill(), p.wait()) for p in
                                procs.values() if p.poll() is None])
        for model in TP_MODELS:
            for run, mesh in (("tp", ("--mesh", "1", "2")), ("one", ())):
                key = f"{run}_{model}"
                cmd = _train_cmd(tmp, tmp / key, MESH_STEPS, TP_B, *mesh,
                                 "--model", model, opts=TP_OPTS if mesh
                                 else MESH_OPTS)
                procs[key] = subprocess.Popen(
                    [sys.executable, "-c", TRAIN_CHILD,
                     str(tmp / f"{key}.json"), json.dumps(TRAIN_KERNELS)]
                    + cmd[3:], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
        logs = {}
        for key, p in procs.items():
            logs[key] = p.communicate(timeout=900)[0]
            if p.returncode != 0:
                print(f"phase 32: {key} exited {p.returncode}:\n"
                      + logs[key][-6000:], file=sys.stderr)
            check(p.returncode == 0, f"phase 32: {key} exited "
                  f"{p.returncode}")
    out["seconds"] = time.perf_counter() - t0
    for model, (n_split, launches) in TP_MODELS.items():
        one = json.loads((tmp / f"one_{model}.json").read_text())
        ranks = [json.loads((tmp / f"tp_{model}.json.{r}").read_text())
                 for r in range(2)]
        expected = [launches[fn] for _, fn in TRAIN_KERNELS]
        a = _saved_stream(tmp / f"one_{model}", MESH_STEPS)["params"]
        b = _saved_stream(tmp / f"tp_{model}", MESH_STEPS)["params"]
        pdiff = max((a[n] - b[n]).abs().max().item() for n in a)
        l1 = _final_loss(tmp / f"one_{model}")
        l2 = _final_loss(tmp / f"tp_{model}")
        steps = [ln for ln in logs[f"tp_{model}"].splitlines()
                 if ln.startswith("step ")]
        print(f"phase 32: {model} split across the (1, 2) mesh's \"model\" "
              f"axis, two ranks over gloo on the one card ({ranks[0]['split']}"
              f" and {ranks[1]['split']} split parameters, {n_split} "
              f"expected), {MESH_STEPS} SGD steps at batch {TP_B}, stage "
              f"pre, f32 compute, against one unsplit process: the last "
              f"loss {l2!r} against {l1!r}, the largest gathered weight "
              f"difference {pdiff:.3e} (held to {MESH_PARAM_ATOL:g}; the "
              f"loss to {MESH_LOSS_RTOL:g} relative); launches a step, rank "
              f"0 {ranks[0]['per_step']}, rank 1 {ranks[1]['per_step']}, "
              f"unsplit {one['per_step']} (expected {expected}); s/step "
              f"ranks {[r['step_s'] for r in ranks]}, unsplit "
              f"{one['step_s']}; peak GiB ranks "
              f"{[round(r['peak_gib'], 2) for r in ranks]}, unsplit "
              f"{one['peak_gib']:.2f}; the log {steps}; on {card}")
        check(set(a) == set(b) and all(a[n].shape == b[n].shape for n in a),
              f"phase 32: {model}'s gathered weights differ in shape")
        check(all(r["split"] == n_split for r in ranks)
              and one["split"] == 0, f"phase 32: {model} split "
              f"{[r['split'] for r in ranks]}, unsplit {one['split']}")
        check(all(r["per_step"] == [expected] * MESH_STEPS
                  for r in ranks + [one]),
              f"phase 32: {model} launches a step")
        check(abs(l1 - l2) <= MESH_LOSS_RTOL * abs(l1),
              f"phase 32: {model} split loss {l2} against {l1}")
        check(pdiff <= MESH_PARAM_ATOL, f"phase 32: {model} split weights "
              f"differ by {pdiff:.3e}")
        out[model] = dict(loss=l2, one_loss=l1, weight_diff=pdiff,
                          split=ranks[0]["split"],
                          per_step=ranks[0]["per_step"][0],
                          step_s=[r["step_s"] for r in ranks],
                          one_step_s=one["step_s"],
                          peak_gib=[r["peak_gib"] for r in ranks])
    torch.cuda.empty_cache()
    return out


def last_phases(dev, card: str) -> dict:
    """Phases 28 to 32 in one temporary directory (29 and 32 train on 28's
    Static tree)."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_") as tmp:
        tmp = Path(tmp)
        for n, key, fn in ((28, "pre", pre_phase), (29, "mesh", mesh_phase),
                           (30, "export", export_phase),
                           (31, "export_families", export_families_phase),
                           (32, "tp", tp_phase)):
            t0 = time.perf_counter()
            out[key] = fn(dev, card, tmp)
            print(f"phase {n}: {time.perf_counter() - t0:.1f} s")
    return out


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
    "jpeg_color": ("jpeg", {
        # even outputs rounded as odd ones
        "jpeg_even_rounding": [("    up[p][0] = (3 * s + sl + 8) >> 4;",
                                "    up[p][0] = (3 * s + sl + 7) >> 4;")],
        # the chroma row's own row taken as its nearer neighbour
        "jpeg_near_row": [
            ("  const int near = (row & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);",
             "  const int near = i;")],
        # G takes cr's term with the wrong sign
        "jpeg_g_sign": [
            ("  out[1] = clamp255(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));",
             "  out[1] = clamp255(y + ((-22554 * cb + 32768 + 46802 * cr) >> 16));")],
        # the last column's right neighbour read past the row
        "jpeg_last_column": [
            ("  const int jl = max(j - 1, 0), jr = min(j + 1, cw - 1);",
             "  const int jl = max(j - 1, 0), jr = j + 1;")]}),
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
    "jpeg": jpeg_color_check,
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
    with tempfile.TemporaryDirectory() as tmp, ExitStack() as procs:
        # a copy that fails to set up stops the run: the checks already
        # started are killed, not left running
        procs.callback(lambda: [(proc.kill(), proc.wait())
                                for *_, proc in runs if proc.poll() is None])
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
                         "step of phases 5, 11, 15 and 19, and phase 21's "
                         "device busy time a frame from a traced CLI run")
    ap.add_argument("--mutants", action="store_true",
                    help="only the mutation check of the per-call K2, K4, "
                         "K5, K1, K3, K1', K1h, K3h, K1'h, K2h, K2x2v128, "
                         "K1'x2v128, K1x2v128, K8, JPEG colour, K6 and K7 "
                         "checks (K1, K3, "
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
    entries.update(check_jpeg_kernel(dev))
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
    t0 = time.perf_counter()
    evaluated = eval_phase(dev, card, args.profile)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    entries["jpeg_ycc_to_rgb"].update(
        launches=evaluated["launches"]["ycc_to_rgb"],
        launches_from="phase 21: one a decoded frame")
    t0 = time.perf_counter()
    weights = weights_phase(dev, card, statistics.median(window_fps))
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aotl = aotl_phase(dev, args.frames, card, args.profile)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    presets = presets_phase(dev, card)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    encoder_train = encoder_train_phase(dev, card, args.profile)
    print(f"phase 25: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gru_served = gru_served_phase(dev, args.frames, card, args.profile,
                                  statistics.median(aot_fps))
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tree_train = tree_train_phase(dev, card)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s")
    last = last_phases(dev, card)
    # the launches of phases 23-25 beside each kernel's main-path count
    mh = entries["bank_attention_mh"]
    mh["phase23_launches"] = aotl["launches"]["bank_attention_infer_mh"]
    mh["phase24_launches"] = {
        m: o["launches"]["bank_attention_infer_mh"]
        for m, o in presets.items()}
    for key, fn_name in (("bank_attention", "bank_attention_infer"),
                         ("local_attention", "local_attention"),
                         ("stem", "stem")):
        entries[key]["phase24_launches"] = {
            m: o["launches"][fn_name] for m, o in presets.items()
            if o["launches"][fn_name]}
    for key, e in list(train_entries.items()) + list(
            aot_train_entries.items()):
        fn_name = {"local_attention_fwd_train": "local_attention",
                   "stem_trainable": "stem"}.get(key, key)
        if fn_name.startswith("bank_attention_bwd_split"):
            fn_name = "bank_attention_bwd_split"
        e["phase25_launches"] = {m: o["launches"][fn_name]
                                 for m, o in encoder_train.items()
                                 if o["launches"].get(fn_name)}
        e["phase27_launches"] = {
            m: tree_train[m]["launches"][fn_name]
            for m in ("r50_aotl_gru_rev", "r50_deaotl_rev_sgd")
            if tree_train[m]["launches"].get(fn_name)}
        idx = [fn for _, fn in TRAIN_KERNELS].index(fn_name)
        e["phase32_launches_a_rank_a_step"] = {
            m: last["tp"][m]["per_step"][idx] for m in TP_MODELS
            if last["tp"][m]["per_step"][idx]}
    entries["jpeg_ycc_to_rgb"]["phase27_cli_launches"] = tree_train["cli"][
        "decoded"]
    # phase 26's launches beside each serving kernel's main-path count
    mh["phase26_launches"] = gru_served["launches"]["bank_attention_infer_mh"]
    entries["stem"]["phase26_launches"] = gru_served["launches"]["stem"]
    # phase 30's: the exported step's custom ops, K1, K4 and K6
    for key, fn_name in (("bank_attention", "bank_attention_infer"),
                         ("local_attention", "local_attention"),
                         ("stem", "stem")):
        entries[key]["phase30_launches"] = last["export"]["launches"][
            fn_name]
    # phase 31's: each exported family's kernels through the rmem:: ops;
    # phase 32's: each rank's training kernels a step under the split
    for key, (fn_name, models) in PHASE31_ENTRIES.items():
        entries[key]["phase31_launches"] = {
            m: last["export_families"][m]["launches"][fn_name]
            for m in models}

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
                      "eval": evaluated, "weights": weights,
                      "aotl": aotl, "presets": presets,
                      "encoder_train": encoder_train,
                      "gru_served": gru_served, "tree_train": tree_train,
                      "pre": last["pre"], "mesh": last["mesh"],
                      "export": last["export"],
                      "export_families": last["export_families"],
                      "tp": last["tp"],
                      "card": card, "host": host_line()}))
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

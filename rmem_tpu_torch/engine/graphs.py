"""A served frame as CUDA-graph replays of the engine's pieces.

`InferenceEngine.step` and `step_multi` serve a set of states (one per
aug) through `FrameGraphs` once each state has served one frame eagerly
(which builds the kernels, fills the tables the ops cache and lets cuDNN
pick its algorithms). The next frame captures the pieces as it runs them,
and every later frame replays them. For each aug:

- `encode`: the encoder and the id-group broadcast of the aug's static
  input image, in the span `rmem.model.encode`;
- `stage0` .. `stageL`: the propagation stack (models/stages.py) cut at
  each block's bank attention, in `rmem.model.propagation`: the slot
  temporal PE and block 0's `pre_bank`, then each block's `post_bank` with
  the next block's `pre_bank`, then the last `post_bank` with the stack's
  norms. Between two stages the block's `BankQuery.attend` is called
  eagerly (the kernel wrapper, as the kernels module holds it then) and its
  output copied into the next stage's static input;
- `decode`, in `rmem.model.decode`;

then one `label` graph for the frame (its label, and each aug's label at
the aug's input size, split into its id groups), and one `memory` graph
for each aug, in `rmem.engine.update_memory` and inside the long-term
write's span: the id embedding, the short-term memory and the in-place
bank write, whose flag it reads from a static device bool that the host
copies from its write schedule each frame. The ConvGRU memory's write
(host-decided rounds) runs eagerly after its graph.

Every graph of a frame goes into one memory pool and replays in the order
of its capture. The state's tensors (the bank, the short-term memory) are
written in place and never rebound, so each graph reads them where it was
captured; the record, the logits and the pending memories are the pieces'
static outputs. The graphs live on the states (`EngineState.graphs`) and
are freed with them.

The kernel wrappers count their launches (`.launches`) when they are
called, which a replay does not do: each graph keeps the launches its
capture made on its own thread (kernels/launches.py), off the counters,
and adds them on each replay.

Off CUDA (`InferenceEngine(..., graphs=True)` on the CPU) each piece is
a plain call on every frame whose tensors are copied into the first
frame's: the same route, for the CPU tests.
"""

from __future__ import annotations

import functools
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves

from rmem_tpu_torch.kernels.launches import tallied
from rmem_tpu_torch.memory.bank import MemoryBank
from rmem_tpu_torch.memory.eviction import update_bank_inplace
from rmem_tpu_torch.models.stages import BankQuery
from rmem_tpu_torch.utils.trace import span

BANK_FIELDS = ("k", "v", "count", "score", "scored", "times", "order")


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


@functools.lru_cache(maxsize=None)
def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream a device's graphs are captured on, one a process,
    with its cuBLAS and cuBLASLt workspaces made before any capture: a
    workspace made during a capture would come from the graphs' pool and
    hold it for the life of the process."""
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.ones((16, 16), dtype=dtype, device=device)
            torch.nn.functional.linear(x, x, x[0])
            torch.mm(x, x)
    stream.synchronize()
    return stream


class Graph:
    """fn() captured as a CUDA graph into `pool` on `stream`, then
    replayed once: `out` is fn's result, whose tensors every replay
    rewrites in place."""

    def __init__(self, fn: Callable, pool, stream: torch.cuda.Stream):
        self.graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.stream(stream), tallied() as self.launches:
            # another thread's CUDA calls (the evaluator's decoders) may go
            # on during a capture
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.out = fn()
            finally:
                self.graph.capture_end()
        self.replay()

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n


class Eager:
    """fn() as a plain call on every replay, its tensors copied into the
    first call's (`out`), which the later pieces read."""

    def __init__(self, fn: Callable, pool=None, stream=None):
        self.fn = fn
        self.out = fn()

    def replay(self) -> None:
        for old, new in zip(_tensors(self.out), _tensors(self.fn())):
            if new.data_ptr() != old.data_ptr():
                old.copy_(new)


class FrameGraphs:
    """The graphs of a frame of `len(in_hws)` augs served together by
    `step` (`multi` False: `_merged_label`) or `step_multi` (`aug_label`),
    at fixed input sizes, output size and flips."""

    def __init__(self, engine, in_hws: Sequence[Tuple[int, int]],
                 out_hw: Tuple[int, int], flips: Sequence[bool], multi: bool,
                 groups: int):
        self.engine = engine
        self.in_hws = [tuple(hw) for hw in in_hws]
        self.out_hw, self.flips = tuple(out_hw), tuple(flips)
        self.multi, self.groups = multi, groups
        cuda = engine.device.type == "cuda"
        self.piece = Graph if cuda else Eager
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = capture_stream(engine.device) if cuda else None
        self.pieces: Dict[str, object] = {}

    def fits(self, states, imgs, out_hw, flips, multi: bool) -> bool:
        """Whether this frame's graphs serve these states in this order at
        these shapes."""
        if (multi != self.multi or tuple(out_hw) != self.out_hw
                or tuple(flips) != self.flips
                or len(states) != len(self.in_hws)):
            return False
        return all(st.graphs is not None and st.graphs.frame is self
                   and st.graphs.index == i and tuple(img.shape[1:3]) == hw
                   for i, (st, img, hw) in enumerate(zip(states, imgs,
                                                          self.in_hws)))

    def run(self, pieces: Dict[str, object], key: str, fn: Callable):
        """The outputs of piece `key` of `pieces`: captured from fn (and so
        computed) the first time, replayed after."""
        piece = pieces.get(key)
        if piece is None:
            piece = pieces[key] = self.piece(fn, self.pool, self.stream)
            self.engine.graph_captures += 1
        else:
            piece.replay()
            self.engine.graph_replays += 1
        return piece.out

    def label(self, logits4s: Sequence[torch.Tensor]) -> torch.Tensor:
        """The frame's label [H, W] int32 from its augs' logits (each
        aug's static decode output); also each aug's label at its input
        size (`label_in`)."""
        eng = self.engine

        def fn():
            if self.multi:
                full = eng.aug_label(logits4s, self.out_hw, self.flips)
            else:
                full = eng._merged_label(logits4s[0], self.out_hw)
            return full, [eng._label_in(full, hw, flip, self.groups)
                          for hw, flip in zip(self.in_hws, self.flips)]

        return self.run(self.pieces, "label", fn)[0]

    def label_in(self, index: int) -> Optional[torch.Tensor]:
        piece = self.pieces.get("label")
        return None if piece is None else piece.out[1][index]

    def label_full(self) -> Optional[torch.Tensor]:
        piece = self.pieces.get("label")
        return None if piece is None else piece.out[0]


class AugGraphs:
    """One aug's pieces (`EngineState.graphs`): its static tensors and
    the graphs of its propagation and memory update."""

    def __init__(self, frame: FrameGraphs, index: int, state, img):
        self.frame, self.index = frame, index
        self.bank: MemoryBank = state.bank
        self.short = (state.short_k, state.short_v)
        self.obj_nums = state.obj_nums
        self.img = img.clone()
        self.flag = torch.zeros((), dtype=torch.bool, device=img.device)
        self.pieces: Dict[str, object] = {}
        # the bank attentions' outputs, the next stages' static inputs; the
        # first block's record
        self.attended: List[torch.Tensor] = []
        self.record: Optional[torch.Tensor] = None

    def propagate(self, state, img) -> Tuple[object, torch.Tensor]:
        """`InferenceEngine.propagate` by the aug's pieces."""
        eng, run = self.frame.engine, self.frame.run
        model, groups = eng.model, self.frame.groups
        if img.data_ptr() != self.img.data_ptr():
            self.img.copy_(img)
        with span("rmem.model.encode"):
            xs, feat, size_2d = run(
                self.pieces, "encode", lambda: eng._encode(self.img, groups))
        bank, stages = self.bank, {}

        def first():
            stages["run"] = model.lstt.stages(
                feat, (bank.k, bank.v), bank.count, self.short, None,
                *eng._temporal_pes(bank), size_2d,
                self_pos=model.get_pos_emb(*size_2d), **eng.route)
            return next(stages["run"])

        def send(i):
            def fn():
                try:
                    return stages["run"].send(
                        (self.attended[i], self.record if i == 0 else None))
                except StopIteration as done:
                    return done.value
            return fn

        with span("rmem.model.propagation"):
            out = run(self.pieces, "stage0", first)
            i = 0
            while isinstance(out, BankQuery):
                attended, record = out.attend()
                if i == len(self.attended):
                    self.attended.append(attended)
                    if i == 0:
                        self.record = record
                else:
                    self.attended[i].copy_(attended)
                    if i == 0:
                        self.record.copy_(record)
                i += 1
                out = run(self.pieces, f"stage{i}", send(i - 1))
            intermediates, mems, _ = out
        with span("rmem.model.decode"):
            logits = run(self.pieces, "decode", lambda: eng._decode(
                intermediates, xs, self.obj_nums))
        state.frame_step += 1
        state.mems, state.record, state.logits4x = mems, self.record, logits
        return state, logits

    def update_memory(self, state, label: torch.Tensor):
        """`InferenceEngine.update_memory` by the aug's memory graph: the
        label (unless it is the label graph's own output for this aug)
        copied into the graph's input, the write flag from the host's
        schedule into its static bool."""
        eng, cfg = self.frame.engine, self.frame.engine.cfg
        label_in = self.frame.label_in(self.index)
        if label is not label_in:
            label_in.copy_(label)
        gru, no_long = cfg.gru_memory_active, cfg.no_long_memory
        do_long = state.frame_step - state.last_mem_step >= state.gap
        mems, logits, record = state.mems, state.logits4x, self.record
        bank, (short_k, short_v) = self.bank, self.short
        size_2d = eng._enc_hw(state)

        def fn():
            id_emb = eng._id_emb(label_in)
            lk, lv, sk, sv = eng.model.write_memories(mems, id_emb)
            short_k.copy_(sk)
            short_v.copy_(sv)
            if gru:
                return lk, lv
            if not no_long:
                work = replace(bank)
                update_bank_inplace(work, lk, lv, self.flag,
                                    cfg.former_mem_len, cfg.latter_mem_len,
                                    record, eng._fg_prob(logits, size_2d, lk))
                into(bank, work)
            return None

        if no_long or (gru and not do_long):
            self.frame.run(self.pieces, "memory", fn)
            return state
        self.flag.copy_(eng._write_flag[do_long])
        with span(eng._write_span(state, do_long)):
            out = self.frame.run(self.pieces, "memory", fn)
            if gru:
                # the round is the host's: eagerly, on a working copy of
                # the bank, whose new values then go into its tensors
                state.bank = replace(bank)
                eng._write_gru(state, *out,
                               eng._fg_prob(logits, size_2d, out[0]))
                into(bank, state.bank)
                state.bank = bank
        if do_long:
            state.last_mem_step = state.frame_step
            state.long_writes += 1
        return state


def into(bank: MemoryBank, new: MemoryBank) -> None:
    """new's values into bank's tensors, field by field."""
    for name in BANK_FIELDS:
        old, value = getattr(bank, name), getattr(new, name)
        if value is not old:
            old.copy_(value)

"""The program's spans, on the clock of a torch.profiler trace.

`span(name)` is a profiler range while a profiler is running and no graph
is being traced (`torch.compile`, `torch.export`); otherwise it is one
shared null context, so with no profiler a span costs one test of the
profiler's flag. The range is the event `torch.profiler.record_function`
makes (a user-scope record function: the trace's `user_annotation`),
entered through the autograd profiler's direct binding, which costs the
host a third or less of `record_function`'s call through the dispatcher.
That matters where the profiler records the card's activity alone: the
flag is up there too, so each span is entered with nothing recording it.
The profiler is the only recorder: the spans sit in its trace beside the
card's operations, on the same clock, and nothing is kept here.
`spanned(name)` is the decorator form.

A span entered while autograd runs a backward (torch.utils.checkpoint
recomputing a training frame's forward, the kernels' forward wrappers
inside it included) takes the suffix `.recompute`, so that the backward's
time is not put down to the forward's layers; the backward's own spans
(`backward=True`: the kernels' backward wrappers) keep their names.

The names, from the entry points down (PERF.md, "Spans and counters"):
`rmem.engine.*` (engine/inference.py), `rmem.model.*` (models/,
engine/training.py), `rmem.memory.write.*` (the long-term write, named by
its outcome), `rmem.kernel.<wrapper>` (kernels/), `rmem.kernels.build`,
`rmem.train.*` (managers/trainer.py, engine/train_state.py) and
`rmem.eval.*` (managers/evaluator.py).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
import torch.autograd.profiler as _profiler

RECOMPUTE = ".recompute"
_NULL = contextlib.nullcontext()
_enter = torch._C._autograd._record_function_with_args_enter
_exit = torch._C._autograd._record_function_with_args_exit


class _Range:
    """One profiler range `name` (RecordScope.USER_SCOPE), ended on exit
    whatever the block raised."""

    __slots__ = ("_name", "_handle")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._handle = _enter(self._name)
        return self

    def __exit__(self, *exc) -> bool:
        _exit(self._handle)
        return False


def span(name: str, backward: bool = False):
    """A profiler span `name` around the `with` block while a profiler
    runs, else a null context. Inside a backward it is named
    `name.recompute` unless `backward` says it belongs to the backward."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _NULL
    if not backward and torch._C._current_graph_task_id() != -1:
        name += RECOMPUTE
    return _Range(name)


def spanned(name: str,
            backward: bool = False) -> Callable[[Callable], Callable]:
    """Decorator: each call of the function inside `span(name,
    backward)`."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, backward):
                return fn(*args, **kwargs)
        return inner

    return wrap

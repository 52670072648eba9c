"""The kernel wrappers' launch counters under CUDA graphs.

Each wrapper adds `launched(wrapper)` to its counter `wrapper.launches`
when it launches: 1, or 0 while the calling thread captures a CUDA graph
inside `tallied()`, whose tally takes the launch instead. The graph adds
its tally to the counters on each replay (engine/graphs.py), so a capture
counts neither its own calls nor the launches of another thread (the
evaluator's decoder) that fall inside it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator

_local = threading.local()


def launched(wrapper: Callable) -> int:
    """What a launch of `wrapper` adds to its counter on this thread."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        return 1
    tally[wrapper] = tally.get(wrapper, 0) + 1
    return 0


@contextlib.contextmanager
def tallied() -> Iterator[Dict[Callable, int]]:
    """The launches of this thread's wrappers inside the block, by
    wrapper, kept off their counters."""
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = None

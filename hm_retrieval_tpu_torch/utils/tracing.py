"""Spans and counters inside the program.

``count(name, n)`` adds ``n`` to ``COUNTS[name]``. Counters are always on,
like the kernel wrappers' ``LAUNCHES``: each counts what the host already
knows, and none reads the device. ``reset_counts()`` clears them.

``span(name)`` is a context manager around one step of the work. Outside a
``collect()`` block it returns one shared no-op context manager: a flag
test, with no allocation and no clock read. Inside one, it records a
``Span``: its name, its start and end on ``time.time_ns`` (the clock that
``torch.profiler`` puts the card's activity on), the index of the span that
was open in the same thread when it started (``parent``, -1 for none) and
that of the outermost one (``root``), which every span of one call shares.

``collect()`` is the only way to turn spans on::

    with tracing.collect() as spans:
        index.topk_from_embeddings(q)
    # spans: [Span("exact_topk", ...), Span("exact_topk.prep", ...), ...]

The list fills when the block closes, in the order the spans started. A
span times the host: where the host runs ahead of the card, it holds the
time to issue the work, and where it reads a value back, the wait.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

# Counts of each counter since the last reset_counts().
COUNTS: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n


def reset_counts() -> None:
    COUNTS.clear()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the enclosing span, -1 at the outermost
    root: int  # index of the outermost span of the same call


_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()  # .stack: indices of this thread's open spans
_records: Optional[List[list]] = None  # [name, start, end, parent, root]


class _Timed:
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        with _lock:
            i = len(_records)
            parent = stack[-1] if stack else -1
            root = _records[parent][4] if parent >= 0 else i
            self.record = [self.name, 0, 0, parent, root]
            _records.append(self.record)
        stack.append(i)
        self.record[1] = time.time_ns()

    def __exit__(self, *exc) -> bool:
        self.record[2] = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str):
    if _records is None:
        return _NOOP
    return _Timed(name)


@contextlib.contextmanager
def collect() -> Iterator[List[Span]]:
    """Records every span opened inside the block, in any thread, into the
    list it yields, once the block closes."""
    global _records
    if _records is not None:
        raise RuntimeError("tracing.collect() is already open")
    out: List[Span] = []
    _records = []
    try:
        yield out
    finally:
        records, _records = _records, None
        out.extend(Span(*r) for r in records)

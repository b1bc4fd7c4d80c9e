"""The measured window and what set-up logs: ``Ctx`` (a cell's run),
``Recorder`` (the benchmark's spans and CUDA events around its calls into
the program), ``timed_loop`` (the window, traced or not) and ``stage``
(set-up's steps on standard error, with the process's age). The kinds
and ``run`` share them.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, to its
    clock tick), so ``setup_s`` counts the interpreter's start and every
    import."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - ticks / os.sysconf("SC_CLK_TCK"))


def stage(name: str) -> None:
    """Logs a step of set-up with the process's age, on standard error."""
    print(f"portbench: {process_age():9.3f} s  {name}", file=sys.stderr,
          flush=True)


@dataclass
class Ctx:
    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: "object"
    traced: bool


@dataclass
class Window:
    """What the timed loop measured. The measured part is the whole window
    of an untraced run and what follows the traced part of a traced one."""

    calls: int = 0
    seconds: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    device_spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    launch_shapes: List[tuple] = field(default_factory=list)
    trace: Optional[object] = None
    ctx: Optional[Ctx] = None


class Recorder:
    """The benchmark's spans around the calls into the program: host
    seconds a span (``span``) or, on a card, CUDA-event milliseconds
    (``device_span``), kept while ``on``; while ``tracing``, each span's
    (name, start, end) on the trace's clock (``time.time_ns``)."""

    def __init__(self, device):
        self.device = device
        self.on = False
        self.tracing = False
        self.spans: Dict[str, List[float]] = {}
        self.traced: List[tuple] = []
        self._events: Dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        if self.tracing:
            self.traced.append((name, n0, time.time_ns()))
        if self.on:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def device_span(self, name: str):
        if not (self.on and self.device.type == "cuda"):
            with self.span(name):
                yield
            return
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with self.span(name):
            start.record()
            yield
            end.record()
        self._events.setdefault(name, []).append((start, end))

    def device_ms(self) -> Dict[str, List[float]]:
        """CUDA-event milliseconds a span; call after a synchronize."""
        return {n: [a.elapsed_time(b) for a, b in pairs]
                for n, pairs in self._events.items()}


def timed_loop(ctx: Ctx, seconds: float, call: Callable[[int, Recorder], None],
               sync: Callable[[], None], first: int = 0,
               launches: Optional[Callable[[], Dict[str, int]]] = None,
               shapes: Optional[Callable] = None) -> Window:
    """Calls ``call(i, recorder)`` for i = first, first + 1, ... until
    ``seconds`` have passed, then ``sync()``. A traced run first runs
    ``trace_seconds`` under the profiler (``shapes``, a context manager,
    records the kernel launches' shapes there), then measures spans for
    the rest of ``seconds``, the profiler's start and stop left out."""
    from portbench import trace as tr

    rec = Recorder(ctx.device)
    win = Window(ctx=ctx)
    i = first
    measure_s = seconds
    if ctx.traced:
        trace_s = min(float(ctx.traffic["trace_seconds"]), seconds)
        shape_log: List[tuple] = []
        with tr.profiled(ctx.device) as prof:
            with (shapes(shape_log) if shapes else contextlib.nullcontext()):
                rec.tracing = True
                w0 = time.time_ns()
                while (time.time_ns() - w0) * 1e-9 < trace_s:
                    call(i, rec)
                    i += 1
                sync()
                w1 = time.time_ns()
                rec.tracing = False
        win.trace = tr.read_trace(prof, i - first, w0, w1, rec.traced)
        win.launch_shapes = shape_log
        rec.on = True
        measure_s = seconds - trace_s
    before = launches() if launches else {}
    m0 = time.perf_counter()
    n0 = i
    while time.perf_counter() - m0 < measure_s:
        c0 = time.perf_counter()
        call(i, rec)
        win.latencies_s.append(time.perf_counter() - c0)
        i += 1
    sync()
    win.seconds = time.perf_counter() - m0
    win.calls = i - n0
    if launches:
        after = launches()
        win.counters = {n: after[n] - before.get(n, 0) for n in after}
    win.spans = rec.spans
    win.device_spans = rec.device_ms()
    return win

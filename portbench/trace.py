"""The traced window: ``torch.profiler`` over the card's activity alone,
read back as device intervals beside the benchmark's own host spans.

The host side is not profiled: recording every operator on the host
doubled a training step's host time on the card, against 1.4x for the
device's activity alone. The benchmark takes its spans itself, on the
same clock as the trace (``time.time_ns``): the window, which ends in a
synchronize, and each kind's spans around its calls into the program.
The profiler's events are read from its Kineto results directly, without
building its per-event tree.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    """Device operations and host spans of one traced window, in seconds
    from the window's start."""

    window_s: float
    calls: int  # the kind's calls inside the window
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host_spans: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        """Device operations that are kernels (no copy, no memset)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of the device operations' intervals, clipped to the
        window."""
        spans = sorted((max(0.0, t0), min(self.window_s, t0 + d))
                       for _, t0, d in self.device_ops)
        merged: List[Tuple[float, float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, by name, and the
        device's idle time by the host span it fell in (the span around
        the start of each gap; ``outside`` where none was open)."""
        by_op: Dict[str, float] = {}
        for name, _, d in self.device_ops:
            by_op[name] = by_op.get(name, 0.0) + d
        gaps, prev = [], 0.0
        for a, b in self.busy_intervals() + [(self.window_s, self.window_s)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        starts = [s0 for _, s0, _ in self.host_spans]
        by_span: Dict[str, float] = {}
        for a, b in gaps:
            i = bisect.bisect_right(starts, a) - 1
            name = "outside"
            if i >= 0 and a < self.host_spans[i][2]:
                name = self.host_spans[i][0]
            by_span[name] = by_span.get(name, 0.0) + (b - a)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in idle]}


@contextlib.contextmanager
def profiled(device: torch.device):
    """``torch.profiler`` over the card's activity (the host's on a CPU,
    which records no device operation)."""
    from torch.profiler import ProfilerActivity, profile

    act = (ProfilerActivity.CUDA if device.type == "cuda"
           else ProfilerActivity.CPU)
    with profile(activities=[act], record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        yield prof


def read_trace(prof, calls: int, w0: int, w1: int,
               host_spans: List[Tuple[str, int, int]]) -> Trace:
    """The ``Trace`` of the window [w0, w1) (``time.time_ns``) in
    ``prof``'s results: every device operation that starts in it, and the
    host spans (name, start, end in ns)."""
    cpu = torch.autograd.DeviceType.CPU
    trace = Trace(window_s=(w1 - w0) * 1e-9, calls=calls)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu or e.is_user_annotation():
            continue
        if w0 <= e.start_ns() < w1:
            trace.device_ops.append(
                (e.name(), (e.start_ns() - w0) * 1e-9, e.duration_ns() * 1e-9))
    trace.host_spans = sorted(
        ((name, (a - w0) * 1e-9, (b - w0) * 1e-9) for name, a, b in host_spans),
        key=lambda s: s[1])
    return trace

"""Profiler trace window over a step range.

Counterpart of the JAX package's ``utils/profiling.py`` on
``torch.profiler``: captures a trace between two global steps (the
reference's Keras TensorBoard ``profile_batch="20,40"``, ref:
pkg/modelling/runner.py:63-67) and writes it into the log directory as a
Chrome trace (``trace_from_step_<first>.json``), which
``chrome://tracing`` and Perfetto read. The card's activity is traced when
a card is present, the host's always.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

logger = logging.getLogger(__name__)


class StepProfiler:
    def __init__(
        self,
        logdir: Optional[str],
        window: Optional[Tuple[int, int]],
    ):
        if window is not None and logdir is None:
            raise ValueError("a profile window needs a log directory")
        self.logdir = logdir
        self.window = window
        self._prof = None
        self._first = None
        self._done = False

    def on_step(self, step: int) -> None:
        if self.window is None:
            return
        start, stop = self.window
        # Threshold tests, not equality: callers may observe steps at a
        # stride (chunked dispatch advances the step by steps_per_dispatch),
        # so the counter can jump past `start`, or past the whole window.
        # The trace starts at the first observed step >= start and stops at
        # the next observed step >= stop, so a stride wider than the window
        # still captures one dispatch's worth of trace instead of none.
        if self._prof is None and not self._done and step >= start:
            logger.info(
                "Starting profiler trace (steps %d..%d) -> %s",
                start,
                stop,
                self.logdir,
            )
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._first = step
        elif self._prof is not None and step >= stop:
            self._stop()
            logger.info("Stopped profiler trace at step %d", step)

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace_from_step_{self._first}.json")
        prof.export_chrome_trace(path)
        logger.info("Profiler trace -> %s", path)

    def close(self) -> None:
        """Stop and write a trace still open; afterwards no step can start
        one. Idempotent."""
        if self._prof is not None:
            self._stop()
        self._done = True

"""Profiling and tracing hooks, the counterparts of
``pointasnl_tpu/train/profiling.py``, on ``torch.profiler``:

- `trace(logdir)`: context manager around a profiler that records the host
  and the card and writes a Chrome trace (Perfetto, chrome://tracing) into
  logdir; `start_trace` / `stop_trace` are its two halves for loop windows;
- `StepTimer`: EMA step timing with points/sec readout, each step timed to
  its completion on the card;
- `annotate(name)`: a ``record_function`` span, so custom spans show in
  traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_active = None  # the profiler between start_trace and stop_trace, and its logdir


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_trace(logdir: str) -> None:
    """Begin a trace of the host and, where there is one, the card."""
    global _active
    if _active is not None:
        raise RuntimeError("a trace is already running")
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active = (prof, logdir)


def stop_trace() -> str:
    """End the trace, once the card has finished its work, and write it to
    ``<logdir>/trace_<pid>_<ns>.json``; returns the file's path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace is running")
    prof, logdir = _active
    _active = None
    _sync()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace into logdir (view with Perfetto or chrome://tracing)."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """Named span that shows up inside traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """EMA over train/eval steps (replaces the manual EMA timing in
    test_scannet_grid.py:126-160). A step is timed from start() to the end
    of the card's work: stop() waits for the card, as the JAX package's
    caller blocks on a step's result."""

    def __init__(self, ema: float = 0.95, points_per_step: Optional[int] = None):
        self.ema = ema
        self.points_per_step = points_per_step
        self.avg = None
        self._t0 = None
        self.steps = 0

    def start(self):
        _sync()  # the work queued before the step is not the step's
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        _sync()
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        self.steps += 1
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> str:
        if self.avg is None:
            return "no steps timed"
        msg = f"avg step {self.avg * 1e3:.2f} ms over {self.steps} steps"
        if self.points_per_step:
            msg += f" ({self.points_per_step / self.avg / 1e6:.2f} M points/sec)"
        return msg


class StepTraceWindow:
    """``--profile`` support for a train loop: trace the first `steps`
    dispatches of the loop into `logdir`.

    Usage inside the loop body: `win.before()` ahead of the dispatch,
    `win.after()` past it; `win.close()` in a `finally` block so an
    interrupted window still ends the trace. All methods are no-ops unless
    `enabled`, so call sites need no flag checks. The trace ends once the
    card has finished the window's work (``stop_trace``); `sync_obj` is
    accepted for the JAX package's signature and not needed.
    """

    def __init__(self, logdir: str, enabled: bool, steps: int = 3, log=print):
        self.logdir = logdir
        self.enabled = enabled
        self.steps = steps
        self.log = log
        self.path = None  # the trace file, once written
        self._seen = 0
        self._tracing = False

    def before(self) -> None:
        if self.enabled and self._seen == 0 and not self._tracing:
            start_trace(self.logdir)
            self._tracing = True

    def after(self, sync_obj=None) -> None:
        if not self.enabled:
            return
        self._seen += 1
        if self._tracing and self._seen >= self.steps:
            self._finish()

    def close(self, sync_obj=None) -> None:
        if self._tracing:
            self._finish()

    def traced(self, thunk):
        """Run one dispatch inside the window: `before()`/thunk/`after()`,
        ending the trace if the dispatch itself raises."""
        self.before()
        try:
            result = thunk()
        except BaseException:
            if self._tracing:
                stop_trace()
                self._tracing = False
            # Kill the window: a caller that catches the error and keeps
            # looping must not reopen a fresh trace into the same logdir.
            self._seen = self.steps
            raise
        self.after(result)
        return result

    def _finish(self) -> None:
        self.path = stop_trace()
        self._tracing = False
        self.log(f"profile trace written to {self.path}")

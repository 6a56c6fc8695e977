"""Profiling hooks, the port of latticeboltzmann_tpu/utils/profiler.py:
the counterpart of the reference's self-timing (GetWallTime,
src/latticeboltzmann.c:643-648) and its externally traced MPI timelines
(img/comms-*.png). trace() records a torch.profiler trace (the host's
activity, and the card's kernels when a card is in use) and writes it
into a directory as a chrome trace (`*.pt.trace.json`, viewable in
Perfetto or chrome://tracing); annotate() names a span in it; StepTimer
is a simple step timer.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed block into log_dir, the card's
    activity included when a card is available:

        with profiler.trace('/tmp/lbm-trace'):
            sim.run(1000)

    Yields the torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    # one cycle: acc_events keeps its events (and torch's warning about
    # clearing them between cycles away)
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (a span in the timeline): a
    torch.profiler.record_function, and an NVTX range when a card is
    present."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step timing with monotonic clock: GetWallTime's role."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps: list[float] = []

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - (self.t0 + sum(self.laps))
        self.laps.append(dt)
        return dt

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

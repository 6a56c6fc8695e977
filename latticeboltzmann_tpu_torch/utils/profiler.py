"""Tracing of the port, the port of latticeboltzmann_tpu/utils/profiler.py:
the counterpart of the reference's self-timing (GetWallTime,
src/latticeboltzmann.c:643-648) and its externally traced MPI timelines
(img/comms-*.png).

One span mechanism names the program's regions: `span(name, **attrs)`.
It does nothing, past one check, unless one of two things is on:

- a recording (`record_spans()`): each span appends a `Span` record to
  the recording's bounded buffer, stamped by `time.time_ns()` at its
  start and end, with the index of its enclosing span, the index of its
  outermost span (all spans of one facade call share it) and its
  attributes;
- a torch.profiler: each span also opens a `record_function(name)`, so
  a trace taken with CPU activity (`trace()`, the CLI's --profile-dir)
  shows it as a `user_annotation` event.

The program's spans: the facade's calls (`Simulation.run`,
`Simulation.run_probed`, `Simulation.reynolds`), the kernel session's
`Session.advance` (attributes steps, launches, depth),
`Session.probe_values` (one a probe sample) and `Session.state` (the
whole-state copy `reynolds()` reads), `wait` around each host call that
blocks on the card (`Session.block`'s synchronize, `run_probed`'s
series fetch, `reynolds()`'s scalar), and the halo exchange
(parallel/sharded.HALO_SPAN). Counters beside them: `Simulation.counters()`
(the kernel session's launches, steps and probe samples).

A recording's stamps share the clock of a torch.profiler chrome trace,
whose events are microseconds after its `baseTimeNanoseconds`
(`trace_us`), the card's events included. So each idle gap of the card
in a trace can be put down to the program's span the host was in:

    with profiler.record_spans() as rec:
        sim.run(1000)
        re = sim.reynolds()
    for s in rec.spans:
        print(s.name, (s.end_ns - s.start_ns) / 1e3, "us", s.attrs)
    print(sim.counters())   # {'launches': ..., 'steps': ..., 'samples': ...}

`trace(log_dir)` records a torch.profiler trace (the host's activity,
and the card's kernels when a card is in use) and writes it into a
directory as a chrome trace (`*.pt.trace.json`, viewable in Perfetto or
chrome://tracing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import time

import torch

# records a recording keeps; spans past it are counted in `dropped`
SPAN_LIMIT = 1 << 16


@dataclasses.dataclass(slots=True)
class Span:
    """One span of a recording: stamps in time.time_ns(), end_ns None
    while it is open; parent and root are indices into the recording's
    spans (parent None, and root its own index, for an outermost span)."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    root: int
    attrs: dict


class Recording:
    """The spans of one record_spans() block, in the order they opened;
    at most SPAN_LIMIT, the rest counted in `dropped`."""

    def __init__(self):
        self.spans: list[Span] = []
        self.dropped = 0
        self._open: list[int | None] = []  # indices of the open spans, None if dropped

    def _enter(self, name: str, attrs: dict) -> None:
        if len(self.spans) >= SPAN_LIMIT:
            # the buffer only grows, so a dropped span's children drop too
            self.dropped += 1
            self._open.append(None)
            return
        parent = self._open[-1] if self._open else None
        i = len(self.spans)
        record = Span(name, 0, None, parent, i if parent is None else self.spans[parent].root,
                      attrs)
        self.spans.append(record)
        self._open.append(i)
        record.start_ns = time.time_ns()

    def _exit(self) -> None:
        t = time.time_ns()
        i = self._open.pop()
        if i is not None:
            self.spans[i].end_ns = t


_recording: Recording | None = None
_NOOP = contextlib.nullcontext()


class _Open:
    """An open span: record_function outside, the recording's stamps
    inside it."""

    __slots__ = ("_name", "_attrs", "_rec", "_fn")

    def __init__(self, name: str, attrs: dict, rec: Recording | None):
        self._name, self._attrs, self._rec, self._fn = name, attrs, rec, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(self._name)
            self._fn.__enter__()
        if self._rec is not None:
            self._rec._enter(self._name, self._attrs)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is not None:
            self._rec._exit()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A named region of the program (a context manager): a record in the
    current recording, and a record_function while a torch.profiler
    runs; when neither is on, a shared no-op."""
    if _recording is None and not torch.autograd._profiler_enabled():
        return _NOOP
    return _Open(name, attrs, _recording)


@contextlib.contextmanager
def record_spans():
    """Record the program's spans while the block runs; yields the
    Recording. An inner block records apart and hands back to the outer
    one when it ends."""
    global _recording
    outer, _recording = _recording, Recording()
    try:
        yield _recording
    finally:
        _recording = outer


def trace_us(t_ns: int, base_ns: int) -> float:
    """A time.time_ns() stamp on the time axis of a torch.profiler chrome
    trace whose `baseTimeNanoseconds` is base_ns: its events' `ts`, in
    microseconds."""
    return (t_ns - base_ns) / 1e3


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

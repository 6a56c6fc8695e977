"""The traced slice of a --trace 1 run: a torch.profiler capture of a
few steady chunks, reduced in memory to events, spans and shares.

The capture records the card's activity and the runtime calls (not the
host's operators), and is written as a chrome trace into a temporary
directory (under TMPDIR), read and deleted at once: a few MB a run. Kernels are
classified by their function name, as the program's
scripts/scaling.py classifies them (kernel_function is a copy of it):
the card names a kernel "void (anonymous namespace)::lbm_...<...>(...)",
so a step kernel is a kernel whose function starts with STEP_PREFIX.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_PREFIX = "lbm_"
# the host call that marks a traced chunk's start, the end of its steps
# and the end of its readback (mark() below); the program makes none
MARK_CALL = "cudaEventQuery"
MARKS_PER_CHUNK = 3


def kernel_function(name: str) -> str:
    """The function of a demangled kernel name, without its return type,
    scopes, template arguments and parameters: "void (anonymous
    namespace)::lbm_temporal_steps<float, 2>(float const*, ...)" ->
    "lbm_temporal_steps"."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)", ""), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else ""


@dataclasses.dataclass(frozen=True)
class Event:
    cat: str
    name: str
    start: float  # microseconds, the host clock of the trace
    end: float
    correlation: int | None

    @property
    def dur(self) -> float:
        return self.end - self.start


def events_of(chrome_trace: dict) -> list[Event]:
    out = []
    for e in chrome_trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        ts = float(e.get("ts", 0.0))
        out.append(Event(e.get("cat", ""), e.get("name", ""), ts, ts + float(e.get("dur", 0.0)),
                         e.get("args", {}).get("correlation")))
    return out


def merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceView:
    """The events of a traced slice of chunks, with the lookups the
    per-layer readers need. Times are microseconds. A chunk's spans come
    from its three marks: steps from the first to the second, readback
    from the second to the third; without three marks a chunk, the view
    has no spans and the readers find nothing."""

    def __init__(self, events: list[Event]):
        self.events = events
        self.launches = sorted((e for e in events if e.cat in LAUNCH_CATS),
                               key=lambda e: e.start)
        marks = [e for e in self.launches if e.name == MARK_CALL]
        if not marks or len(marks) % MARKS_PER_CHUNK:
            marks = []
        triples = [marks[i:i + MARKS_PER_CHUNK] for i in range(0, len(marks), MARKS_PER_CHUNK)]
        self.steps = [(a.end, b.start) for a, b, _ in triples]
        self.readback = [(b.end, c.start) for _, b, c in triples]
        self.chunks = [(a.end, c.start) for a, _, c in triples]
        self.start = self.chunks[0][0] if triples else 0.0
        self.end = self.chunks[-1][1] if triples else 0.0
        self.device = sorted((e for e in events if e.cat in DEVICE_CATS
                              and e.end > self.start and e.start < self.end),
                             key=lambda e: e.start)
        self._by_corr = {}
        for e in self.launches:
            if e.correlation is not None:
                self._by_corr.setdefault(e.correlation, e)

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        """The union of the card's kernels, copies and sets inside the
        slice."""
        return sum(b - a for a, b in merged(
            (max(e.start, self.start), min(e.end, self.end)) for e in self.device))

    def is_step_kernel(self, e: Event) -> bool:
        return e.cat == "kernel" and kernel_function(e.name).startswith(STEP_PREFIX)

    def launched_in(self, e: Event, spans) -> bool:
        """Whether the host call that launched device event e lies inside
        one of the (start, end) spans."""
        call = self._by_corr.get(e.correlation)
        return call is not None and any(a <= call.start <= b for a, b in spans)

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the part of the chunk, and
        the runtime call that covers t, if one does."""
        part = next((name for name, spans in (("steps", self.steps), ("readback", self.readback))
                     if any(a <= t <= b for a, b in spans)), "between chunks")
        call = next((e.name for e in self.launches if e.start <= t <= e.end), "host code")
        return f"{part}: {call}"

    def breakdown(self) -> dict:
        """The card's ten costliest operations, and its ten longest idle
        gaps summed by what the host was doing, in seconds."""
        ops: dict[str, float] = {}
        for e in self.device:
            name = kernel_function(e.name) if e.cat == "kernel" else e.name
            ops[name] = ops.get(name, 0.0) + e.dur * 1e-6
        gaps: dict[str, float] = {}
        busy = merged((max(e.start, self.start), min(e.end, self.end)) for e in self.device)
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        holes = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                        if edges[i + 1] > edges[i]), reverse=True)
        for length, at in holes[:10]:
            name = self.host_at(at + length / 2)
            gaps[name] = gaps.get(name, 0.0) + length * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


class Profiler:
    """A torch.profiler capture started and stopped around the traced
    chunks; view() exports it as a chrome trace into a temporary
    directory (under TMPDIR), reads it and deletes it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # the card's activity alone: recording every host operator would
        # slow the host-paced parts of a chunk (the probe gather) by half
        activities = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
        self._prof = profile(activities=activities, acc_events=True)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()

    def view(self) -> TraceView:
        with tempfile.TemporaryDirectory(prefix="lbm_bench_trace_") as tmp:
            path = pathlib.Path(tmp) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            return TraceView(events_of(json.loads(path.read_text())))


def mark() -> None:
    """One mark in the trace: a runtime call (MARK_CALL) on an event of
    its own, which puts no work on the card."""
    import torch

    if torch.cuda.is_available():
        ev = torch.cuda.Event()
        ev.record()
        ev.query()

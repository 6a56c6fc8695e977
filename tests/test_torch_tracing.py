"""The port's tracing (utils/profiler.py): span() off and on, a
recording's records and its bound, its stamps against a torch.profiler
trace's clock, the kernel session's counters, and the facade's spans.
On a card (-m cuda): every step-kernel launch of a CUDA-only capture,
the kind lbm_bench takes, lies inside a Session.advance span, and every
span inside its chunk's marks: the spans and the card's trace share a
clock.

This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.parallel.sharded import HALO_SPAN
from latticeboltzmann_tpu_torch.utils import profiler

# a recording's stamps against the trace's events, after trace_us: the
# chrome trace prints microseconds to 3 decimals
CLOCK_US = 1.0


def _names(rec):
    return [s.name for s in rec.spans]


def test_span_off_records_nothing_and_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = profiler.span("x"), profiler.span("y", steps=3)
    assert a is b is profiler._NOOP
    with a:
        pass
    with profiler.record_spans() as rec:
        pass
    with profiler.span("after"):
        pass
    assert rec.spans == [] and rec.dropped == 0 and profiler._recording is None


def test_nested_spans_record_name_order_parent_root_and_attrs():
    with profiler.record_spans() as rec:
        with profiler.span("outer", steps=3):
            with profiler.span("a"):
                with profiler.span("a1"):
                    pass
            with profiler.span("b", depth=6, kind="x"):
                pass
        with profiler.span("second"):
            pass
    assert _names(rec) == ["outer", "a", "a1", "b", "second"]
    assert [s.parent for s in rec.spans] == [None, 0, 1, 0, None]
    assert [s.root for s in rec.spans] == [0, 0, 0, 0, 4]
    assert [s.attrs for s in rec.spans] == [{"steps": 3}, {}, {}, {"depth": 6, "kind": "x"}, {}]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    starts = [s.start_ns for s in rec.spans]
    assert starts == sorted(starts)
    assert rec.spans[3].start_ns >= rec.spans[1].end_ns and rec.dropped == 0


def test_span_closes_its_record_when_the_block_raises():
    with profiler.record_spans() as rec:
        with pytest.raises(ValueError):
            with profiler.span("outer"):
                with profiler.span("inner"):
                    raise ValueError("x")
        with profiler.span("next"):
            pass
    assert _names(rec) == ["outer", "inner", "next"]
    assert all(s.end_ns is not None for s in rec.spans)
    assert rec.spans[2].parent is None and rec.spans[2].root == 2


def test_recording_bound_counts_dropped_spans(monkeypatch):
    assert profiler.SPAN_LIMIT == 1 << 16
    monkeypatch.setattr(profiler, "SPAN_LIMIT", 3)
    with profiler.record_spans() as rec:
        with profiler.span("r"):
            for i in range(4):
                with profiler.span(f"c{i}"):
                    with profiler.span("leaf"):
                        pass
    assert _names(rec) == ["r", "c0", "leaf"]
    assert [s.parent for s in rec.spans] == [None, 0, 1]
    assert rec.dropped == 6 and all(s.end_ns is not None for s in rec.spans)


def test_inner_recording_hands_back_to_the_outer():
    with profiler.record_spans() as outer:
        with profiler.span("x"):
            with profiler.record_spans() as inner:
                with profiler.span("y"):
                    pass
        with profiler.span("z"):
            pass
    assert _names(outer) == ["x", "z"] and _names(inner) == ["y"]
    assert inner.spans[0].parent is None and profiler._recording is None


def _chrome_trace(prof, tmp_path) -> dict:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_span_stamps_lie_inside_the_user_annotation_they_open(tmp_path):
    """The clock: inside a CPU torch.profiler capture each recorded span
    opens a record_function, and its time_ns stamps, put on the trace's
    axis by trace_us, lie within that user_annotation to CLOCK_US."""
    with profile(activities=[ProfilerActivity.CPU], acc_events=True) as prof:
        with profiler.record_spans() as rec:
            for _ in range(3):
                with profiler.span("Simulation.run", steps=2):
                    with profiler.span("Session.advance"):
                        float(torch.ones(64, 64).sum())
                    with profiler.span("wait"):
                        float(torch.ones(8).sum())
    doc = _chrome_trace(prof, tmp_path)
    base = doc["baseTimeNanoseconds"]
    found = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation":
            found.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    assert {k: len(v) for k, v in found.items()} == {"Simulation.run": 3, "Session.advance": 3,
                                                    "wait": 3}
    seen = {}
    for s in rec.spans:
        a, b = sorted(found[s.name])[seen.setdefault(s.name, 0)]
        seen[s.name] += 1
        start, end = profiler.trace_us(s.start_ns, base), profiler.trace_us(s.end_ns, base)
        assert a - CLOCK_US <= start <= end <= b + CLOCK_US, (s.name, a, start, end, b)


def test_span_under_a_profiler_alone_records_no_spans(tmp_path):
    """A torch.profiler without a recording: the span is a user_annotation
    (the CLI's --profile-dir trace) and nothing is kept in memory."""
    with profile(activities=[ProfilerActivity.CPU], acc_events=True) as prof:
        assert profiler.span("x") is not profiler._NOOP
        with profiler.span("lbm_probe_span", steps=1):
            float(torch.ones(4).sum())
    names = [e.get("name") for e in _chrome_trace(prof, tmp_path)["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("lbm_probe_span") == 1 and profiler._recording is None


def _cpu_session(temporal=None):
    cfg = LatticeConfig(nx=8, ny=16)
    sess = fk.Session(cfg, geometry.channel(8, 16), device="cpu", temporal=temporal)
    sess.load(torch.as_tensor(initial_state(cfg)))
    return sess


@pytest.mark.parametrize("temporal, depth, launches", [(None, 1, 1000), (6, 6, 167)])
def test_session_counts_launches_and_steps_from_its_pass_plan(temporal, depth, launches):
    sess = _cpu_session(temporal)
    assert (sess.launches, sess.steps, sess.samples) == (0, 0, 0)
    with profiler.record_spans() as rec:
        sess.advance(1000)
    assert sess.temporal == depth and (sess.launches, sess.steps) == (launches, 1000)
    assert _names(rec) == ["Session.advance"]
    assert rec.spans[0].attrs == {"steps": 1000, "launches": launches, "depth": depth}
    sess.advance(5)
    assert (sess.launches, sess.steps) == (launches + (5 if depth == 1 else 1), 1005)


def test_session_counts_probe_samples_and_spans_its_copy():
    sess = _cpu_session()
    sites = sess.probe_sites(np.array([[3, 4], [5, 9]]))
    with profiler.record_spans() as rec:
        for _ in range(3):
            sess.advance(2)
            sess.probe_values(sites)
        sess.block()  # a CPU session waits on nothing
        f = sess.state()
    assert sess.samples == 3 and (sess.launches, sess.steps) == (6, 6)
    assert _names(rec) == ["Session.advance", "Session.probe_values"] * 3 + ["Session.state"]
    assert torch.equal(f, sess._a) and f.data_ptr() != sess._a.data_ptr()


def test_simulation_counters_none_without_a_kernel_session():
    cfg = LatticeConfig(nx=8, ny=16)
    sim = Simulation(cfg, geometry.channel(8, 16), backend="torch")
    sim.run(3)
    assert sim.counters() is None


def test_facade_spans_share_one_root_per_call():
    """The facade's spans on the torch backend: one outermost span per
    call, the series fetch and Re's scalar as `wait` spans inside it."""
    cfg = LatticeConfig(nx=8, ny=16)
    sim = Simulation(cfg, geometry.channel(8, 16), backend="torch")
    with profiler.record_spans() as rec:
        sim.run(2)
        series = sim.run_probed(4, np.array([[3, 4]]), every=2)
        sim.reynolds()
    assert series.shape == (2, 1, 3)
    assert _names(rec) == ["Simulation.run", "Simulation.run_probed", "wait",
                           "Simulation.reynolds", "wait"]
    assert [s.root for s in rec.spans] == [0, 1, 1, 3, 3]
    assert rec.spans[0].attrs == {"steps": 2}
    assert rec.spans[1].attrs == {"steps": 4, "every": 2}


def test_facade_over_a_cpu_kernel_session_spans_and_counts():
    """The facade over a fused_kernel.Session on CPU tensors (the session
    takes step_reference there): every session span under its facade
    call, and counters() reading the session."""
    cfg = LatticeConfig(nx=8, ny=16)
    sim = Simulation(cfg, geometry.channel(8, 16), backend="torch")
    sim._session = _cpu_session()
    with profiler.record_spans() as rec:
        sim.run(3)
        sim.run_probed(4, np.array([[3, 4], [4, 5]]), every=2)
        sim.reynolds()
    assert sim.counters() == {"launches": 7, "steps": 7, "samples": 2}
    assert _names(rec) == [
        "Simulation.run", "Session.advance",
        "Simulation.run_probed", "Session.advance", "Session.probe_values",
        "Session.advance", "Session.probe_values", "wait",
        "Simulation.reynolds", "Session.state", "wait"]
    roots = [rec.spans[s.root].name for s in rec.spans]
    assert roots == ["Simulation.run"] * 2 + ["Simulation.run_probed"] * 6 + \
        ["Simulation.reynolds"] * 3


def test_halo_exchange_is_a_recorded_span():
    cfg = LatticeConfig(nx=16, ny=16)
    sim = Simulation(cfg, geometry.channel(16, 16), backend="sharded-sync")
    with profiler.record_spans() as rec:
        sim.run(2)
    halo = [s for s in rec.spans if s.name == HALO_SPAN]
    assert halo and all(rec.spans[s.root].name == "Simulation.run" for s in halo)


# --- on a card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step kernel has no CPU mode")
    return torch.device("cuda")


def _mark():
    """lbm_bench's chunk mark: a runtime call on an event of its own."""
    ev = torch.cuda.Event()
    ev.record()
    ev.query()


@pytest.mark.cuda
def test_spans_and_the_card_trace_share_a_clock(card, tmp_path):
    from latticeboltzmann_tpu_torch.scripts.scaling import kernel_function

    cfg = LatticeConfig(nx=64, ny=256)
    sim = Simulation(cfg, geometry.channel_with_barrier(64, 256), backend="cuda")
    sim.run(10)
    sim.reynolds()
    chunks, steps = 3, 40
    before = sim.counters()
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    prof.start()
    with profiler.record_spans() as rec:
        for _ in range(chunks):
            _mark()
            sim.run(steps)
            _mark()
            sim.reynolds()
            _mark()
    torch.cuda.synchronize()
    prof.stop()
    after = sim.counters()
    launches = chunks * -(-steps // sim._session.temporal)  # passes of the default depth
    assert after["steps"] - before["steps"] == chunks * steps
    assert after["launches"] - before["launches"] == launches

    doc = _chrome_trace(prof, tmp_path)
    base = doc["baseTimeNanoseconds"]
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    marks = sorted((e for e in events if e.get("name") == "cudaEventQuery"), key=lambda e: e["ts"])
    steps_k = [e for e in events if e.get("cat") == "kernel"
               and kernel_function(e["name"]).startswith("lbm_")]
    assert len(marks) == 3 * chunks and len(steps_k) == launches
    us = lambda s: (profiler.trace_us(s.start_ns, base), profiler.trace_us(s.end_ns, base))
    advance = [us(s) for s in rec.spans if s.name == "Session.advance"]
    assert len(advance) == chunks
    for k in steps_k:
        call = calls[k["args"]["correlation"]]
        a, b = call["ts"], call["ts"] + call["dur"]
        assert any(s - CLOCK_US <= a and b <= e + CLOCK_US for s, e in advance), (a, b, advance)
    roots = sorted({s.root for s in rec.spans})
    assert len(roots) == 2 * chunks  # run and reynolds, a chunk
    for s in rec.spans:
        c = roots.index(s.root) // 2
        first, third = marks[3 * c], marks[3 * c + 2]
        start, end = us(s)
        assert first["ts"] + first["dur"] - CLOCK_US <= start <= end <= third["ts"] + CLOCK_US, \
            (s.name, c)
    names = {s.name for s in rec.spans}
    assert names == {"Simulation.run", "Session.advance", "wait", "Simulation.reynolds",
                     "Session.state"}

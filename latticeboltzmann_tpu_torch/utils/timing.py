"""Timing on a CUDA card by CUDA events. Host clocks around launches
time the enqueue, not the card, so every timer here brackets the work
with events on the current stream and synchronizes before reading them.
Nothing here runs without a card.
"""

from __future__ import annotations

import torch


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def event_ms(fn, n):
    """Milliseconds per call of fn over n calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = _events()
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def queued_ms(fn, n, sleep_cycles=60_000_000):
    """Device milliseconds per call of fn over n calls: the card first
    spins for sleep_cycles (about 30 ms), long enough for the host to
    queue all n calls behind it, so the events time the launches back to
    back and not the host's launch rate (a step of many small launches is
    host-bound, and event_ms would time the host)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = _events()
    torch.cuda._sleep(sleep_cycles)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def call_ms(fn_of_n, n, reps=3):
    """Best milliseconds of one call fn_of_n(n) over reps calls, by CUDA
    events."""
    best = float("inf")
    for _ in range(reps):
        t0, t1 = _events()
        t0.record()
        fn_of_n(n)
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def timed_slope(fn_of_n, n1, n2, steps_per_n=1, reps=3):
    """Seconds per step from the slope between two call sizes, which
    cancels every fixed cost of a call (the launch, a block's load and
    store): (t(n2) - t(n1)) / ((n2 - n1) * steps_per_n), each t the best
    of reps calls by CUDA events, after one warm call."""
    fn_of_n(n1)
    torch.cuda.synchronize()
    t1 = call_ms(fn_of_n, n1, reps)
    t2 = call_ms(fn_of_n, n2, reps)
    return (t2 - t1) * 1e-3 / ((n2 - n1) * steps_per_n)

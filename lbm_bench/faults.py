"""Faults planted in the timed path, for the check to catch: the program
wrapped so that the entries the traffic drives go wrong underneath,
once for each fault a one-card lattice run can have. No benchmark run
plants one: the tests do at a tiny size, and control.py --fault at a
cell's own size on the card.

- unchanged: the steps return the state unchanged;
- half_rows: the steps advance only the first half of the rows (the
  lattice's half left out);
- reynolds: the Reynolds number off by one where it is produced;
- series: the last probe sample's density off by 1%;
- late_nan: Re not a number from window chunk LATE_NAN_CHUNK on, past
  any checked chunk k: a flow that blows up after the chunk the
  reference replays.

A one-card cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import numpy as np

from . import harness

FAULTS = ("unchanged", "half_rows", "reynolds", "series", "late_nan")
# the first window chunk whose Re late_nan spoils; the warm-up chunk
# reads Re once before the window
LATE_NAN_CHUNK = 5


class Broken:
    """The program, with one fault planted in the entries the traffic
    drives (f, run, run_probed, reynolds)."""

    def __init__(self, sim, fault: str):
        self.sim, self.fault = sim, fault
        self.readbacks = 0

    def __getattr__(self, name):
        return getattr(self.sim, name)

    @property
    def f(self):
        return self.sim.f

    @f.setter
    def f(self, value):
        self.sim.f = value

    def _advance(self, call):
        if self.fault == "unchanged":
            return None
        before = self.sim.f.clone() if self.fault == "half_rows" else None
        out = call()
        if before is not None:
            f = self.sim.f
            half = f.shape[1] // 2
            f[:, half:] = before[:, half:]
            del before
            self.sim.f = f
        return out

    def run(self, n_steps, **kw):
        self._advance(lambda: self.sim.run(n_steps, **kw))
        return self

    def run_probed(self, n_steps, probes, *, every=1, **kw):
        series = self._advance(lambda: self.sim.run_probed(n_steps, probes, every=every, **kw))
        if series is None:  # unchanged: the moments of the same state every sample
            series = np.repeat(self.sim.probe_values(probes)[None], n_steps // every, axis=0)
        if self.fault == "series":
            series = series.copy()
            series[-1, 0, 0] *= 1.01
        return series

    def reynolds(self, *a, **kw):
        re = self.sim.reynolds(*a, **kw)
        self.readbacks += 1
        if self.fault == "late_nan" and self.readbacks > LATE_NAN_CHUNK + 1:
            return float("nan")
        return re + 1.0 if self.fault == "reynolds" else re


def broken(fault: str, program=harness.default_program):
    """A program factory (harness.run_cell's `program=`) with `fault`
    planted; "none" plants nothing."""
    return lambda *args: Broken(program(*args), fault)

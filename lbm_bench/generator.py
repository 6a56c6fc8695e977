"""The one general generator: what a seed makes, and the closed loop
that a traffic file describes.

A traffic file (traffic/<mix>.json) holds only parameters:

    {"steps_per_chunk": 1000,         # steps a chunk asks of the program
     "probes": null | {"count": 3, "every": 100,
                       "rows": [20, 220], "cols": [110, 600]},
     "check_chunk_below": 4,          # the checked chunk k is drawn in [0, this)
     "trace_chunks": 6,               # chunks the --trace 1 run profiles
     "steps_per_run": 10000}          # steps from one start of the flow to
                                      # the next (absent: the whole window)

Each chunk is one call of the program's entry (Simulation.run, or
Simulation.run_probed when the mix names probes) followed by the
readback (Simulation.reynolds() at the central column). The loop is
closed: the next chunk starts when the host holds the last readback.
A run is steps_per_run steps of chunks from the window's start state:
before the first chunk of every run after the first, the harness loads
that state back into the program, as a user starts the next run of a
flow, so no chunk runs later into a flow than a run's length.

The seed makes the inputs, the same for the same seed on any card: a
density field of smooth bumps about the configuration's initial density,
made on the device by a torch.Generator, whose rest equilibrium is the
initial state; the probe sites; and the chunk the check samples. Every
seed gives the same lattice, steps and chunks: only the data differs.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import torch

from .reference import d2q9

# the density field: BUMPS Gaussian bumps of relative height up to
# BUMP_HEIGHT and width between BUMP_WIDTH of NX, on the initial density
BUMPS = 16
BUMP_HEIGHT = 0.02
BUMP_WIDTH = (1 / 16, 1 / 4)


def _seed64(seed: int) -> int:
    return seed % 2**64


@dataclasses.dataclass(frozen=True)
class Traffic:
    steps_per_chunk: int
    probes: dict | None = None
    check_chunk_below: int = 4
    trace_chunks: int = 6
    steps_per_run: int | None = None

    @classmethod
    def load(cls, path) -> "Traffic":
        spec = json.loads(pathlib.Path(path).read_text())
        unknown = set(spec) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"{path}: unknown traffic keys {sorted(unknown)}")
        t = cls(**spec)
        if t.steps_per_chunk < 1:
            raise ValueError(f"{path}: steps_per_chunk must be at least 1")
        if t.probes is not None and t.steps_per_chunk % t.probes["every"]:
            raise ValueError(f"{path}: probes.every must divide steps_per_chunk")
        if t.check_chunk_below < 1:
            raise ValueError(f"{path}: check_chunk_below must be at least 1")
        if t.steps_per_run is not None:
            if t.steps_per_run < 1 or t.steps_per_run % t.steps_per_chunk:
                raise ValueError(f"{path}: steps_per_run must be a positive multiple of "
                                 "steps_per_chunk")
            if max(t.check_chunk_below, t.trace_chunks) > t.chunks_per_run:
                raise ValueError(f"{path}: the checked and the traced chunks must fit in "
                                 "steps_per_run")
        return t

    @property
    def chunks_per_run(self) -> int | None:
        """Chunks from one load of the window's start state to the next;
        None: one run for the whole window."""
        return None if self.steps_per_run is None else self.steps_per_run // self.steps_per_chunk

    def starts_run(self, i: int) -> bool:
        """Whether window chunk i is the first of a run."""
        return i % self.chunks_per_run == 0 if self.chunks_per_run else i == 0

    @property
    def samples_per_chunk(self) -> int:
        return self.steps_per_chunk // self.probes["every"] if self.probes else 0


def initial_state(nx: int, ny: int, params: d2q9.Params, dtype: torch.dtype, seed: int,
                  device) -> torch.Tensor:
    """The seed's initial state, (9, NX, NY) of `dtype` on `device`: the
    rest equilibrium of a density field of BUMPS smooth bumps, drawn
    from the seed in a few calls on the device."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(_seed64(seed))
    u = torch.rand((BUMPS, 4), generator=g, device=device, dtype=torch.float32)
    height = BUMP_HEIGHT * (2 * u[:, 0] - 1)
    ci, cj = u[:, 1] * nx, u[:, 2] * ny
    width = nx * (BUMP_WIDTH[0] + (BUMP_WIDTH[1] - BUMP_WIDTH[0]) * u[:, 3])
    ii = torch.arange(nx, device=device, dtype=torch.float32)[:, None]
    jj = torch.arange(ny, device=device, dtype=torch.float32)[None, :]
    rel = torch.zeros((nx, ny), device=device, dtype=torch.float32)
    for b in range(BUMPS):
        r2 = (ii - ci[b]) ** 2 + (jj - cj[b]) ** 2
        rel += height[b] * torch.exp(-r2 / (2 * width[b] ** 2))
    rho = params.initial_density * (1 + rel)
    return d2q9.rest_state((nx, ny), rho, params, dtype, device)


def probe_sites(traffic: Traffic, seed: int) -> np.ndarray | None:
    """The mix's probe sites, (P, 2) int64 (i, j), drawn from the seed
    inside its rows and columns (distinct sites)."""
    if traffic.probes is None:
        return None
    pr = traffic.probes
    (r0, r1), (c0, c1) = pr["rows"], pr["cols"]
    rng = np.random.default_rng([_seed64(seed), 1])
    flat = rng.choice((r1 - r0) * (c1 - c0), size=pr["count"], replace=False)
    return np.stack([r0 + flat // (c1 - c0), c0 + flat % (c1 - c0)], axis=1).astype(np.int64)


def checked_chunk(traffic: Traffic, seed: int) -> int:
    """The chunk k in [0, check_chunk_below) whose start and end the
    check takes from the program."""
    return int(np.random.default_rng([_seed64(seed), 2]).integers(0, traffic.check_chunk_below))


@dataclasses.dataclass
class Chunk:
    """One chunk's host times (perf_counter seconds) and what it read."""

    start: float
    steps_done: float
    end: float
    reynolds: float
    series: np.ndarray | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def readback_s(self) -> float:
        return self.end - self.steps_done


def run_chunk(sim, traffic: Traffic, probes, mark=None) -> Chunk:
    """One chunk of the closed loop: the steps through the program's
    entry, then the readback. `mark()`, where given, is called at the
    start, after the steps and after the readback (the traced run's
    marks)."""
    mark = mark or (lambda: None)
    mark()
    start = time.perf_counter()
    if traffic.probes is None:
        sim.run(traffic.steps_per_chunk)
        series = None
    else:
        series = sim.run_probed(traffic.steps_per_chunk, probes, every=traffic.probes["every"])
    steps_done = time.perf_counter()
    mark()
    re = sim.reynolds()
    end = time.perf_counter()
    mark()
    return Chunk(start, steps_done, end, re, series)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

"""How `correct` is decided: the window's outputs against the plain
reference (reference/d2q9), once the window has closed and the
program's state is freed.

A chunk's answers are the state it leaves, the Reynolds number the
facade reads from that state, and (in a probed mix) the series of probe
moments the gather took along it. Three things are checked in every run:

- the start: the state the program holds when the window opens, against
  the seed's own state, exactly (start_err, the largest gap of a value);
- chunk k, drawn from the seed in [0, check_chunk_below), replayed by
  the reference from the program's state before it (for k = 0 the start
  just checked). There the reference follows the program from the
  program's own state, as a time-stepper can only be followed (see
  PERF.md); the chunks before k are checked by the state they hand on,
  and by the runs that draw them;
- every chunk of the window: its Re, and in a probed mix every sample
  of its series, is finite (nonfinite_chunks, the count of chunks that
  are not, limit 0 in every cell; the readings name the first such
  chunk as first_nonfinite_chunk). A flow that has blown up is no flow
  the program claims to simulate, whatever chunk k read.

The reference replays the chunk at the configuration's storage
precision and in its arithmetic, on the card, on the configuration's
walls (reference/scene.py), and these numbers are compared, each against
its cell's limit (limits/<workload>.json):

- state_err: |f - f_ref| / |f_ref - f_start| (Euclidean norms over the
  whole state): the error over the chunk's own change. A step that
  leaves the state unchanged reads 1.
- re_err: |Re - Re_ref| / Re_scale, with Re_ref the reference's
  Reynolds number of its own end state and Re_scale the same mean taken
  of |u_y| over every fluid site of the lattice: the central column may
  still be at rest (Re exactly 0) in the first chunks.
- momentum_err: |P - P_ref| / |P_ref - P_start|, P the lattice's total
  momentum along the channel: what the forcing put in over the chunk
  and the walls took out, a sum in which rounding of either sign
  cancels. A step that leaves the state unchanged reads 1.
- probe_err (probed mixes): the largest |s - s_ref| over samples and
  sites, per moment over the largest change |s_ref - s_start| of that
  moment along the chunk; an unchanged state reads 1.

A cell's limits file names the numbers it compares (and start_err);
a number that is not finite fails.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import generator
from .reference import d2q9, scene

# every number the check works out; a cell's limits file names those it
# compares, and FINITE is compared in every cell against 0
FINITE = "nonfinite_chunks"
NUMBERS = ("start_err", "state_err", "momentum_err", "re_err", "probe_err", FINITE)

@dataclasses.dataclass
class Outputs:
    """What the window produced that the check reads."""

    reynolds: dict      # chunk -> the Re the facade returned
    series: dict        # chunk -> its (samples, P, 3) probe series
    states: dict        # chunk -> the program's state after it (host): its tensors
    chunks_run: int


@dataclasses.dataclass
class Verdict:
    correct: bool
    failed: int
    numbers: dict       # name -> {"value": ..., "limit": ...}: those compared
    readings: dict      # name -> value: every number the check worked out


def rel_norm(a: torch.Tensor, b: torch.Tensor, base: torch.Tensor) -> float:
    """|a - b| / |b - base| in float64, a plane at a time."""
    num = den = 0.0
    for s in range(a.shape[0]):
        bs = b[s].double()
        num += float(((a[s].double() - bs) ** 2).sum())
        den += float(((bs - base[s].double()) ** 2).sum())
    return ratio(math.sqrt(num), math.sqrt(den))


def ratio(num: float, den: float) -> float:
    """num / den; 0 for 0 / 0 and inf for a gap over no change."""
    if den > 0:
        return num / den
    return 0.0 if num == 0 else math.inf


def state_of(tensors, storage: torch.dtype, device) -> torch.Tensor:
    """A snapshot's state on `device` in `storage`: its one tensor, or
    its (hi, lo) pair summed in float64."""
    if len(tensors) == 1:
        return tensors[0].to(device).to(storage)
    return sum(t.to(device).double() for t in tensors).to(storage)


def momentum_y(f: torch.Tensor) -> float:
    """The lattice's total momentum along the channel (+y), summed in
    float64 over every site."""
    plane = lambda s: f[s].double().sum()
    return float(plane(5) + plane(1) + plane(8) - plane(6) - plane(3) - plane(7))


def chunk_numbers(start, end, re, series, walls, params, traffic, probes, device,
                  compute=torch.float32) -> dict:
    """Every number of one checked chunk that the check knows; a cell's
    limits file names those it compares."""
    pr = None if probes is None else torch.as_tensor(probes, device=device)
    every = traffic.probes["every"] if traffic.probes else 1
    ref_end, ref_series = d2q9.run(start, walls, params, traffic.steps_per_chunk,
                                   compute=compute, probes=pr, every=every)
    p_ref = momentum_y(ref_end)
    out = {"state_err": rel_norm(end, ref_end, start),
           "momentum_err": ratio(abs(momentum_y(end) - p_ref), abs(p_ref - momentum_y(start)))}
    re_ref = d2q9.reynolds(ref_end, walls, params)
    out["re_err"] = ratio(abs(re - re_ref), d2q9.speed_scale(ref_end, walls, params))
    del ref_end
    if pr is not None:
        s_ref = ref_series.cpu().numpy()
        s0 = d2q9.moments(start[:, pr[:, 0], pr[:, 1]]).cpu().numpy()
        change = np.abs(s_ref - s0[None]).max(axis=(0, 1))
        gap = np.abs(np.asarray(series, np.float64) - s_ref).max(axis=(0, 1))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(change > 0, gap / change, np.where(gap > 0, np.inf, 0.0))
        out["probe_err"] = float(rel.max())
    return out


def nonfinite_chunks(outputs: Outputs) -> list[int]:
    """The chunks whose Re, or a sample of whose series, is not finite."""
    return [i for i in range(outputs.chunks_run)
            if not math.isfinite(outputs.reynolds[i])
            or (i in outputs.series and not np.isfinite(outputs.series[i]).all())]


def judge(cell, traffic, params, seed: int, k: int, probes, outputs: Outputs, device) -> Verdict:
    """The start, exactly, chunk k (when the window reached it),
    replayed with the reference, held to the cell's limits, and every
    chunk's answers finite."""
    cfg = cell.config
    walls = d2q9.walls_tensor(scene.walls(cfg.walls, cfg.nx, cfg.ny), device)
    storage = getattr(torch, cfg.dtype)
    compute = getattr(torch, cfg.arithmetic)
    loaded = state_of(outputs.states[-1], storage, device)
    seeded = generator.initial_state(cfg.nx, cfg.ny, params, storage, seed, device)
    nums = {"start_err": float((loaded.double() - seeded.double()).abs().max())}
    del seeded
    blown = nonfinite_chunks(outputs)
    nums[FINITE] = len(blown)
    if blown:
        nums["first_nonfinite_chunk"] = blown[0]
    reached = k < outputs.chunks_run
    if reached:
        start = loaded if k == 0 else state_of(outputs.states[k - 1], storage, device)
        end = state_of(outputs.states[k], storage, device)
        del loaded
        nums.update(chunk_numbers(start, end, outputs.reynolds[k], outputs.series.get(k), walls,
                                  params, traffic, probes, device, compute))
    limits = dict(cell.limits, **{FINITE: 0})
    compared = {name: v for name, v in nums.items() if name in limits}
    bad = {name for name, v in compared.items() if not math.isfinite(v) or v > limits[name]}
    failed = int("start_err" in bad) + int(bool(bad - {"start_err", FINITE})) + int(FINITE in bad)
    numbers = {name: {"value": v, "limit": limits[name]} for name, v in compared.items()}
    return Verdict(correct=reached and not bad and compared.keys() == limits.keys(),
                   failed=failed, numbers=numbers, readings=nums)

"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the per-layer readers and the check.

The program under test is latticeboltzmann_tpu_torch: a cell builds
Simulation(LatticeConfig(...), walls, backend=<the config's>) as its
users do, with the program's defaults (its default depth), loads the
seed's state through Simulation.f, and drives it chunk after chunk
(generator.run_chunk), loading the window's start state back at the
start of every run of the traffic's steps_per_run. `program=` replaces
that constructor: the control and the tests put another program in its
place.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time

import numpy as np
import torch

from . import check, generator, manifest, trace
from .reference import d2q9, scene

# the traced slice starts at the first chunk of a run once this share of
# the window has passed, so no reload falls inside it; the profiler's
# first start (5.9-7.6 s of CUPTI set-up on an H100) falls in
# the window of a --trace 1 run, which reports no end-to-end metric, and
# a second session in one process ran the probed chunks half again slower
TRACE_AFTER = 0.4


@dataclasses.dataclass
class Context:
    """What a metric's reader (end_to_end/<metric>.py,
    layer_metrics/<metric>.py) reads."""

    cell: manifest.Cell
    traffic: generator.Traffic
    chunks: list            # every chunk of the window (generator.Chunk)
    window_s: float         # the window's wall time
    setup_s: float
    peak_bytes: int         # the program's peak of max_memory_allocated
    traced: list            # indices of the traced chunks
    untraced: list          # indices of the chunks before the profiler started
    view: trace.TraceView | None
    plane: bool             # whether the step kernels read a class plane

    @property
    def traced_steps(self) -> int:
        return len(self.traced) * self.traffic.steps_per_chunk


def params_of(config: manifest.Config) -> d2q9.Params:
    return d2q9.Params(tau=config.tau, csq=config.csq, accel=config.accel,
                       initial_density=config.initial_density)


def default_program(config: manifest.Config, lattice, walls, device):
    from latticeboltzmann_tpu_torch import Simulation

    return Simulation(lattice, walls, backend=config.backend, device=device)


def program_counters() -> dict:
    """The program's launch and step counters (ops/fused_kernel)."""
    from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

    return {"launches": fk.LAUNCHES, "temporal_launches": fk.TEMPORAL_LAUNCHES,
            "temporal_steps": fk.TEMPORAL_STEPS}


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, printed
    beside the run's numbers (a card set below 700 W runs slower)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def parts(state) -> tuple:
    """The tensors of a program's state: itself, or the (hi, lo) float32
    pair that the ds backends keep."""
    return tuple(state) if isinstance(state, tuple) else (state,)


def as_program_state(f: torch.Tensor, like):
    """f in the form of the program's state `like`: f itself, or, where
    the program keeps a (hi, lo) pair, the pair whose sum is f."""
    if not isinstance(like, tuple):
        return f
    hi = f.float()
    return type(like)(hi, (f - hi.double()).float())


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool, t_start: float, *,
             device="cuda", program=default_program, storage: str | None = None,
             emit=print) -> dict:
    """One run; returns the result's fields (correct, attempted, failed,
    metrics, device, breakdown, checks), the check's readings and the
    window's times (window: window_s, chunks_s, runs, reload_s, and the
    traced chunks). `storage` overrides the configuration's storage
    dtype (the control's lower precision)."""
    from latticeboltzmann_tpu_torch import LatticeConfig

    cfg = cell.config
    traffic = generator.Traffic.load(cell.traffic_path)
    params = params_of(cfg)
    storage = storage or cfg.dtype
    on_card = torch.device(device).type == "cuda"
    lattice = LatticeConfig(nx=cfg.nx, ny=cfg.ny, tau=cfg.tau, csq=cfg.csq, accel=cfg.accel,
                            initial_density=cfg.initial_density,
                            dtype={"float32": np.float32, "float64": np.float64}.get(storage, storage))
    walls = scene.walls(cfg.walls, cfg.nx, cfg.ny)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sim = program(cfg, lattice, walls, device)
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    dtype = getattr(torch, storage)
    template = sim.f
    layout = [(t.shape, t.dtype) for t in parts(template)]
    pair = type(template) if isinstance(template, tuple) else None

    def load_seed_state():
        sim.f = as_program_state(
            generator.initial_state(cfg.nx, cfg.ny, params, dtype, seed, device), template)

    load_seed_state()
    probes = generator.probe_sites(traffic, seed)
    k = generator.checked_chunk(traffic, seed)
    # warm-up: one chunk of the mix builds and loads every kernel the
    # window runs; then the seed's state again
    generator.run_chunk(sim, traffic, probes)
    load_seed_state()
    del template
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counters0 = program_counters()
    setup_s = time.perf_counter() - t_start

    # the check's copies of the state before and after the checked
    # chunks, in host memory: allocated after set-up is read, and taken
    # between chunks with their time left out of the window
    snaps = {i: [torch.empty(shape, dtype=dt, pin_memory=on_card) for shape, dt in layout]
             for i in sorted({-1, k - 1, k})}

    def snapshot(i):
        for buf, part in zip(snaps[i], parts(sim.f)):
            buf.copy_(part)

    def restart():
        """The window's start state back into the program, copied from
        the pinned host snapshot into its buffers (a copy on the CPU,
        where a program could keep the buffer itself)."""
        state = [buf if on_card else buf.clone() for buf in snaps[-1]]
        sim.f = state[0] if pair is None else pair(*state)
        if on_card:
            torch.cuda.synchronize()

    snapshot(-1)  # the state the window starts from, and every run after
    chunks, traced_idx, profiler = [], [], None
    paused = reload_s = 0.0
    t_win = time.perf_counter()
    while True:
        i = len(chunks)
        if i and traffic.starts_run(i):
            t0 = time.perf_counter()
            restart()
            dt = time.perf_counter() - t0
            reload_s += dt
            paused += dt
        if (traced and profiler is None and i > k
                and (traffic.steps_per_run is None or traffic.starts_run(i))
                and time.perf_counter() - t_win - paused >= TRACE_AFTER * seconds):
            profiler = trace.Profiler()
            profiler.start()
        if profiler is not None and len(traced_idx) < traffic.trace_chunks:
            chunks.append(generator.run_chunk(sim, traffic, probes, mark=trace.mark))
            traced_idx.append(i)
            if len(traced_idx) == traffic.trace_chunks:
                profiler.stop()
        else:
            chunks.append(generator.run_chunk(sim, traffic, probes))
        if i in snaps:
            t0 = time.perf_counter()
            snapshot(i)
            paused += time.perf_counter() - t0
        busy_tracing = profiler is not None and len(traced_idx) < traffic.trace_chunks
        if time.perf_counter() - t_win - paused >= seconds and not busy_tracing and (
                not traced or profiler is not None):
            break
    window_s = time.perf_counter() - t_win - paused
    n = len(chunks)
    runs = sum(traffic.starts_run(i) for i in range(n))
    counters = {name: v - counters0[name] for name, v in program_counters().items()}
    peak = max(peak_setup, torch.cuda.max_memory_allocated()) if on_card else 0
    session = getattr(sim, "_session", None)
    emit(f"depth that ran: temporal={getattr(session, 'temporal', None)} "
         f"(requested {getattr(sim, 'temporal', None)}); window launches {counters}; "
         f"chunks {n} of {traffic.steps_per_chunk} steps in {window_s:.6f} s; "
         f"runs {runs} of {traffic.steps_per_run or n * traffic.steps_per_chunk} steps; "
         f"checked chunk {k}; outside the window: {runs - 1} reloads {reload_s:.6f} s, "
         f"snapshots {paused - reload_s:.6f} s; "
         "chunk ms p5/p50/p95/max "
         + "/".join(f"{generator.percentile([c.seconds for c in chunks], q) * 1e3:.3f}"
                    for q in (5, 50, 95, 100)))
    if on_card:
        emit(f"card: {card_power_limit()}")

    view = profiler.view() if profiler is not None else None
    ctx = Context(cell=cell, traffic=traffic, chunks=chunks, window_s=window_s, setup_s=setup_s,
                  peak_bytes=peak, traced=traced_idx,
                  untraced=list(range(traced_idx[0] if traced_idx else n)), view=view,
                  plane=getattr(sim, "wall_spec", None) is None and bool(walls.any()))
    kind, wanted = ("layer_metrics", cell.per_layer) if traced else ("end_to_end", cell.end_to_end)
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"], cell.root, kind)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if view is not None:
        dev["busy_s"] = view.busy_us() * 1e-6
        dev["window_s"] = view.window_us * 1e-6
        breakdown = view.breakdown()

    # the check, once the program's state is freed
    outputs = check.Outputs(reynolds={i: chunks[i].reynolds for i in range(n)},
                            series={i: chunks[i].series for i in range(n)
                                    if chunks[i].series is not None},
                            states=snaps, chunks_run=n)
    del sim
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.judge(cell, traffic, params, seed, k, probes, outputs, device)
    emit(f"check of chunk {k} by the reference: {time.perf_counter() - t_check:.3f} s")
    window = {"window_s": window_s, "chunks_s": sum(c.seconds for c in chunks), "runs": runs,
              "reload_s": reload_s, "traced": traced_idx}
    return {"correct": verdict.correct, "attempted": n, "failed": verdict.failed,
            "metrics": metrics, "device": dev, "breakdown": breakdown,
            "checks": verdict.numbers, "readings": verdict.readings, "window": window}

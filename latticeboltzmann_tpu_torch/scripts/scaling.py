"""Sharded scaling and the halo exchange's share of a step: twin of the
JAX package's scripts/scaling.py, the counterpart of the reference's MPI
scaling table (mpi-runtimes.dat) and its comm-overlap traces
(img/comms-no-overlap.png, img/comms-overlap.png, README.md:44-57).
Four modes, each a function that takes a mesh (mode_cpu: the shard
counts of its CPU meshes):

  --mode cpu      the sharded paths on virtual CPU shards (1, 2, 4, 8) of
                  a 256x200 float32 channel_with_barrier: "sharded",
                  "sharded-sync" and the float32 kernel session on its plain
                  versions (the counterpart of sharded-pallas-interpret),
                  each row bitwise to its unsharded path (the "torch" engine;
                  for the kernel session fused_kernel.run_steps, itself
                  within ENGINE_BAR of the engine)
  --mode gpu      (mode_tpu there) MLUPS of cuda, sharded-cuda, sharded and
                  sharded-sync at 400x2000 float32 reference_barrier over a
                  mesh (the kernel rows by slope, the eager rows by the
                  host clock over --steps), then a torch.profiler trace of sharded and
                  sharded-cuda: the halo exchange's share of the card's
                  time, the top five events, and the share of the halo time
                  that overlaps a compute kernel
  --mode ab       the overlap schedule (sharded-cuda) against the sync one
                  (sharded-cuda-fused) at 400x2000 and 800x4000: slope
                  us/step, MLUPS and the trace's shares
  --mode predict  a 1/2/4/8-card table labelled PREDICTED (the
                  mpi-runtimes.dat analog for one card): per-shard times
                  measured on this card plus an NVLink model, and the
                  pair-DP section; with two or more cards visible, rows
                  measured over D cards beside it

The trace's classification (read_trace): the halo exchange is the card's
events (copies: gpu_memcpy, or copy kernels where a copy is strided)
launched inside the span HaloExchange.start opens
(parallel/sharded.HALO_SPAN); compute is the kernel events named lbm_*
(the port's kernels); device time is every kernel, copy and set event.
The eager paths ("sharded", "sharded-sync") run no lbm_ kernel: their
compute is every kernel outside the span. A trace without such compute
raises: a share is never read off a trace that holds no device work.

gpu, ab and predict raise without a card; only cpu runs on the CPU. A
row that fails prints FAILED with its exception, and the mode raises
once every row has run, so the script exits non-zero.

Usage: python -m latticeboltzmann_tpu_torch.scripts.scaling --mode cpu|gpu|ab|predict
           [--steps 1200] [--trace-dir DIR] [--virtual-shards N]
--virtual-shards N runs gpu and ab over N virtual shards of card 0
(default 0: a mesh of every visible card). Tables go to stdout, each
under the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import re
import sys
import time

import numpy as np
import torch

# the slope's two run lengths: multiples of every pass depth in use (3
# and 2 for sharded-cuda in f32 and bf16, 4 for the ds passes), so no
# timed run ends in a shorter pass
SLOPE_STEPS = (240, 720)
# the best of this many runs of each length: the sharded paths are bound
# by the host's enqueue, whose pace on a shared host drifts by tens of
# percent from one run to the next
SLOPE_REPS = 3
# untimed steps before a host-clock window (the eager rows of mode gpu)
WARMUP = 24
# steps before a trace (builds and first launches outside it), and the
# traced steps of gpu and ab
TRACE_WARMUP = 16
GPU_TRACE_STEPS = 64
AB_TRACE_STEPS = 60
# traces of one measurement, when the profiler records no event of the
# card (traced)
TRACE_ATTEMPTS = 3
# the eager paths launch thousands of small kernels a step (a trace of
# "sharded" over 4 shards at 400x2000 holds 3.6 MB a step on an H100), so
# they are traced for at most this many steps
EAGER_TRACE_STEPS = 4
# the steps whose enqueue is timed: few enough that the launches and
# copies of 8 shards (40 a pass) stay inside the card's launch queue
ENQUEUE_STEPS = 24
SHARD_COUNTS = (1, 2, 4, 8)
CPU_SCENE = (256, 200)
GPU_SCENE = (400, 2000)
AB_SCENES = ((400, 2000), (800, 4000))
PREDICT_SCENES = ((400, 2000), (800, 4000))
DP_SCENE = (800, 4000)
# NVLink on an H100 SXM: 900 GB/s in all (NVIDIA's data sheet), 450 GB/s
# each way; a ring's two halo directions run on their own links
NVLINK_BYTES_PER_S = 450e9
# the reference's 13-node DP MPI run, overlap mode (mpi-runtimes.dat:76)
REFERENCE_DP_MLUPS = 1205.7
# the bar of fused_kernel.run_steps (the kernel session's unsharded path)
# against the "torch" engine, which associate the collision differently:
# measured 2.24e-8 at 24x40 and 2.61e-8 at 32x48 after 6 steps, 8.20e-8
# at 256x200 after 1200 steps (channel_with_barrier, f32, on a CPU), so
# about 12 times the largest (JAX's own bar for its sharded rows, :105
# there, is 1e-4)
ENGINE_BAR = 1e-6
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
COMPUTE_PREFIX = "lbm_"


def _require_card(mode: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"scaling --mode {mode} runs on a CUDA card, and "
                           "torch.cuda.is_available() is False (only --mode cpu runs on the CPU)")


@contextlib.contextmanager
def backends_over(mesh):
    """The facade's sharded backends ("sharded", "sharded-sync",
    "sharded-cuda", "sharded-cuda-fused", "sharded-cuda-ds64") over `mesh`
    while the block runs, with their capability sets (wall spec, fast
    math) as they are; the registry is restored after."""
    from ..models import engine
    from ..parallel import sharded

    saved = dict(engine._BACKENDS)
    engine._BACKENDS.update({
        "sharded": sharded.make_backend(mesh, overlap=True),
        "sharded-sync": sharded.make_backend(mesh, overlap=False),
        "sharded-cuda": sharded.make_cuda_backend(mesh, overlap=True),
        "sharded-cuda-fused": sharded.make_cuda_backend(mesh, overlap=False),
        "sharded-cuda-ds64": sharded.make_cuda_ds_backend(mesh),
    })
    try:
        yield
    finally:
        engine._BACKENDS.clear()
        engine._BACKENDS.update(saved)


def _simulation(nx, ny, backend, *, dtype=np.float32, scene="reference", device="cuda"):
    from ..core import geometry
    from ..core.spec import LatticeConfig
    from ..models.engine import Simulation

    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
    return Simulation(cfg, geometry.build(scene, nx, ny), backend=backend, device=device)


def host_seconds(sim, steps: int, warmup: int = WARMUP) -> float:
    """Seconds per step of sim.run(steps) by the host clock, after `warmup`
    untimed steps: for the eager paths, whose steps take milliseconds."""
    sim.run(warmup)
    t0 = time.perf_counter()
    sim.run(steps)
    return (time.perf_counter() - t0) / steps


def slope_seconds(sim, n1: int = SLOPE_STEPS[0], n2: int = SLOPE_STEPS[1],
                  reps: int = SLOPE_REPS) -> float:
    """Seconds per step of sim.run (which ends in its barrier) from the
    slope between runs of n1 and n2 steps (utils/timing.timed_slope: CUDA
    events, the best of reps runs each, after one warm run of n1)."""
    from ..utils.timing import timed_slope

    return timed_slope(sim.run, n1, n2, reps=reps)


def enqueue_seconds(sim, n: int = ENQUEUE_STEPS, reps: int = 3) -> float:
    """Host seconds per step to enqueue n steps (run(block=False)) on an
    idle card, the best of reps."""
    best = float("inf")
    for _ in range(reps):
        sim.run(0)  # the card finished what came before
        t0 = time.perf_counter()
        sim.run(n, block=False)
        best = min(best, time.perf_counter() - t0)
    sim.run(0)
    return best / n


# --- mode cpu -------------------------------------------------------------


def mode_cpu(nx: int = CPU_SCENE[0], ny: int = CPU_SCENE[1], steps: int = 1200,
             counts=SHARD_COUNTS, emit=print) -> list[dict]:
    """The sharded paths on meshes of `counts` virtual CPU shards, float32
    channel_with_barrier, `steps` steps each. Returns the rows; raises
    unless every row is bitwise equal to its unsharded path and within
    ENGINE_BAR of the "torch" engine."""
    from ..core import geometry
    from ..core.spec import LatticeConfig
    from ..models import engine
    from ..models.engine import Simulation, initial_state
    from ..ops import fused_kernel
    from ..parallel import sharded

    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float32)
    walls = geometry.channel_with_barrier(nx, ny)
    ref = Simulation(cfg, walls, backend="torch", device="cpu").run(steps).state()
    kernel_ref = fused_kernel.run_steps(
        torch.as_tensor(initial_state(cfg)), walls, cfg, steps).numpy()
    emit(f"devices: virtual CPU shards; lattice {nx}x{ny} f32 channel_with_barrier, {steps} steps")
    emit("")
    emit("| shards | backend | max abs dev vs unsharded torch engine | vs its unsharded path "
         "| steps/s (CPU, relative only) |")
    emit("|---|---|---|---|---|")
    rows = []
    for n in counts:
        mesh = sharded.make_mesh(devices=["cpu"] * n)
        for backend, run, own in (
                ("sharded", sharded.make_backend(mesh, overlap=True), ref),
                ("sharded-sync", sharded.make_backend(mesh, overlap=False), ref),
                ("sharded-cuda session (plain versions)",
                 sharded.make_cuda_backend(mesh, overlap=True), kernel_ref)):
            engine.register_backend("_scaling", run)
            try:
                t0 = time.perf_counter()
                got = Simulation(cfg, walls, backend="_scaling", device="cpu").run(steps).state()
                dt = time.perf_counter() - t0
            finally:
                engine._BACKENDS.pop("_scaling")
            row = {"shards": n, "backend": backend,
                   "dev_engine": float(np.abs(got - ref).max()),
                   "dev_own": float(np.abs(got - own).max()), "steps_per_s": steps / dt}
            emit(f"| {n} | {backend} | {row['dev_engine']:.2e} | {row['dev_own']:.1e} | "
                 f"{row['steps_per_s']:.1f} |")
            if not np.array_equal(got, own) or row["dev_engine"] >= ENGINE_BAR:
                raise AssertionError(f"{backend} on {n} CPU shards diverged: {row}")
            rows.append(row)
    emit("\nevery sharded configuration is bitwise equal to its unsharded path")
    return rows


# --- the trace reader -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceShares:
    """What read_trace finds in one trace (microseconds of device time)."""

    device_us: float  # every kernel, copy and set event of the card
    halo_us: float  # the card's events launched inside HALO_SPAN
    compute_us: float  # the compute kernels (outside the span)
    overlap_us: float  # halo time during which a compute kernel ran
    names: dict  # device us by event name
    halo_names: dict  # the halo events' us by name

    @property
    def halo_share(self) -> float:
        return self.halo_us / self.device_us

    @property
    def overlap_share(self) -> float:
        """The share of the halo time that overlaps a compute kernel (0
        without halo events)."""
        return self.overlap_us / self.halo_us if self.halo_us else 0.0

    def top(self, n: int = 5) -> list[tuple[str, float]]:
        return sorted(self.names.items(), key=lambda kv: -kv[1])[:n]


def kernel_function(name: str) -> str:
    """The function of a demangled kernel name, without its return type,
    scopes, template arguments and parameters: "void (anonymous
    namespace)::lbm_temporal_steps_ext<float, 2>(float const*, ...)" ->
    "lbm_temporal_steps_ext"."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)", ""), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else ""


def short_name(name: str) -> str:
    """An event's name for a table: a kernel's function (kernel_function),
    with the PyTorch functor it runs where it names one
    (direct_copy_kernel_cuda: a strided copy); other events as they
    are."""
    if not name.startswith("void "):
        return name
    functor = re.search(r"at::native::(\w+_kernel_cuda)", name)
    return kernel_function(name) + (f" [{functor.group(1)}]" if functor else "")


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(a, b, merged) -> float:
    return sum(max(0.0, min(b, d) - max(a, c)) for c, d in merged)


def read_trace(path, compute_prefix: str = COMPUTE_PREFIX) -> TraceShares:
    """The shares of a torch.profiler chrome trace (`*.pt.trace.json`,
    utils/profiler.trace): halo = the card's events whose launch (a
    cuda_runtime or cuda_driver event with the same correlation id) lies
    inside a HALO_SPAN span of its thread; compute = the kernel events
    whose function (kernel_function) is named compute_prefix* outside it
    ("" for every kernel); device = every
    kernel, copy and set event. Raises ValueError when the trace holds no
    compute kernel."""
    from ..parallel.sharded import HALO_SPAN

    events = [e for e in json.loads(pathlib.Path(path).read_text()).get("traceEvents", [])
              if e.get("ph") == "X"]

    def span(e):
        ts = float(e.get("ts", 0.0))
        return ts, ts + float(e.get("dur", 0.0))

    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == HALO_SPAN:
            spans.setdefault((e.get("pid"), e.get("tid")), []).append(span(e))
    halo_ids = set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            t = span(e)[0]
            if any(a <= t <= b for a, b in spans.get((e.get("pid"), e.get("tid")), ())):
                halo_ids.add(corr)
    device, halo, compute, names, halo_names = 0.0, [], [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = span(e)
        name = e.get("name", "")
        device += b - a
        names[name] = names.get(name, 0.0) + (b - a)
        if e.get("args", {}).get("correlation") in halo_ids:
            halo.append((a, b))
            halo_names[name] = halo_names.get(name, 0.0) + (b - a)
        elif e.get("cat") == "kernel" and kernel_function(name).startswith(compute_prefix):
            compute.append((a, b))
    if not compute:
        what = f"{compute_prefix}* kernel" if compute_prefix else "kernel"
        raise ValueError(f"{path}: no {what} event: the trace holds no compute of the card, "
                         "so it gives no share")
    merged = _merged(compute)
    return TraceShares(
        device_us=device, halo_us=sum(b - a for a, b in halo),
        compute_us=sum(b - a for a, b in compute),
        overlap_us=sum(_covered(a, b, merged) for a, b in halo), names=names,
        halo_names=halo_names)


def _device_events(path) -> int:
    return sum(e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               for e in json.loads(pathlib.Path(path).read_text()).get("traceEvents", []))


def traced(sim, steps: int, trace_dir, compute_prefix: str = COMPUTE_PREFIX,
           emit=print) -> TraceShares:
    """read_trace of a trace of sim.run(steps) (after TRACE_WARMUP
    untraced steps) written into trace_dir. A trace in which the profiler
    recorded no event of the card at all (CUPTI delivered none of its
    activity: seen on an H100 once in some 20 traces) is taken again, up
    to TRACE_ATTEMPTS traces, each attempt printed; read_trace then raises
    on the last as on any trace without compute."""
    from ..utils import profiler

    trace_dir = pathlib.Path(trace_dir)
    sim.run(TRACE_WARMUP)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = set(trace_dir.glob("*.pt.trace.json"))
        with profiler.trace(str(trace_dir)):
            sim.run(steps)
        new = sorted(set(trace_dir.glob("*.pt.trace.json")) - before)
        if len(new) != 1:
            raise RuntimeError(f"{trace_dir}: {len(new)} new traces, expected 1")
        if attempt == TRACE_ATTEMPTS or not torch.cuda.is_available() or _device_events(new[0]):
            return read_trace(new[0], compute_prefix)
        emit(f"  {new[0].name}: the profiler recorded no event of the card (attempt {attempt} of "
             f"{TRACE_ATTEMPTS}); traced again")


def shares_text(s: TraceShares, compute_prefix: str = COMPUTE_PREFIX) -> str:
    kind = f"{compute_prefix}* kernel" if compute_prefix else "compute kernel"
    return (f"halo {s.halo_us / 1e3:.3f} ms of {s.device_us / 1e3:.3f} ms device time = "
            f"{100 * s.halo_share:.2f}%; {100 * s.overlap_share:.1f}% of the halo time "
            f"overlaps a {kind}")


# --- mode gpu ---------------------------------------------------------------


# (backend, timed by slope (else by the host clock), note)
GPU_ROWS = (
    ("cuda", True, "the unsharded session at its default depth (passes of "
                   "fused_kernel.DEFAULT_TEMPORAL); does not depend on the mesh"),
    ("sharded-cuda", True, "passes of 3 through the ext-halo temporal form, halos copied by "
                           "the host, overlap schedule"),
    ("sharded", False, "eager engine, overlapped exchange"),
    ("sharded-sync", False, "eager engine, exchange then compute"),
)


def _mesh_text(mesh) -> str:
    n, cards = mesh.size, len(mesh.unique_devices())
    return f"{n} shard(s) on {cards} card(s)"


def mode_gpu(mesh, steps: int = 1200, trace_dir="build/scaling_traces",
             trace_steps: int = GPU_TRACE_STEPS, backends=tuple(r[0] for r in GPU_ROWS),
             emit=print) -> dict:
    """mode_tpu's counterpart over `mesh` (a sharded.Mesh of CUDA devices):
    the MLUPS of the GPU_ROWS named in `backends` at 400x2000 float32
    reference_barrier (the kernel rows by slope_seconds; the eager rows by
    host_seconds over `steps`, rounded down to a multiple of 12), then
    trace_steps traced steps of "sharded-cuda" (and at most
    EAGER_TRACE_STEPS of "sharded") with their shares. Returns {"rows":
    {backend: MLUPS}, "shares": {backend: TraceShares}}; raises after
    printing every row when one failed."""
    _require_card("gpu")
    nx, ny = GPU_SCENE
    steps = max(12, steps - steps % 12)
    emit(f"device: {torch.cuda.get_device_name(0)}; mesh {_mesh_text(mesh)}; lattice "
         f"{nx}x{ny} f32 reference_barrier")
    emit("")
    emit("| backend | MLUPS | us/step | timed by | note |")
    emit("|---|---|---|---|---|")
    rows, failed = {}, []
    with backends_over(mesh):
        for backend, by_slope, note in GPU_ROWS:
            if backend not in backends:
                continue
            timing = (f"slope {SLOPE_STEPS[0]}/{SLOPE_STEPS[1]} steps" if by_slope
                      else f"host clock, {steps} steps after {WARMUP}")
            try:
                sim = _simulation(nx, ny, backend, device=mesh.devices[0])
                t = slope_seconds(sim) if by_slope else host_seconds(sim, steps)
                rows[backend] = nx * ny / t / 1e6
                emit(f"| {backend} | {rows[backend]:.1f} | {t * 1e6:.2f} | {timing} | {note} |")
            except Exception as e:  # noqa: BLE001 - a row prints FAILED; the mode raises below
                failed.append((backend, e))
                emit(f"| {backend} | FAILED | | {timing} | {type(e).__name__}: {str(e)[:120]} |")
        shares = {}
        for backend, prefix, n in (("sharded", "", min(trace_steps, EAGER_TRACE_STEPS)),
                                   ("sharded-cuda", COMPUTE_PREFIX, trace_steps)):
            out = pathlib.Path(trace_dir) / f"gpu_{backend}_{mesh.size}x{len(mesh.unique_devices())}"
            sim = _simulation(nx, ny, backend, device=mesh.devices[0])
            shares[backend] = s = traced(sim, n, out, prefix, emit)
            emit(f"\n{backend}, {n} traced steps: {shares_text(s, prefix)}")
            for name, us in s.top():
                emit(f"  {us / 1e3:8.3f} ms  {short_name(name)}")
            emit("  halo events: " + "; ".join(f"{short_name(name)} {us / 1e3:.3f} ms"
                                               for name, us in s.halo_names.items()))
    if failed:
        raise RuntimeError(f"scaling gpu: {len(failed)} row(s) failed: "
                           + "; ".join(f"{b}: {type(e).__name__}: {e}" for b, e in failed))
    return {"rows": rows, "shares": shares}


# --- mode ab ----------------------------------------------------------------


def mode_ab(mesh, trace_dir="build/scaling_traces", scenes=AB_SCENES,
            trace_steps: int = AB_TRACE_STEPS, emit=print) -> list[dict]:
    """The overlap schedule ("sharded-cuda") against the sync one
    ("sharded-cuda-fused") over `mesh` at each scene: slope us/step and
    MLUPS, then trace_steps traced steps and their shares. Returns the
    rows."""
    _require_card("ab")
    emit(f"device: {torch.cuda.get_device_name(0)}; mesh {_mesh_text(mesh)}")
    emit("")
    emit("| scene | schedule | backend | us/step (slope) | MLUPS (slope) | halo share of device "
         "time | halo time overlapped by lbm_ kernels |")
    emit("|---|---|---|---|---|---|---|")
    rows = []
    with backends_over(mesh):
        for nx, ny in scenes:
            for sched, backend in (("overlap", "sharded-cuda"), ("sync", "sharded-cuda-fused")):
                sim = _simulation(nx, ny, backend, device=mesh.devices[0])
                t = slope_seconds(sim)
                out = (pathlib.Path(trace_dir)
                       / f"ab_{nx}x{ny}_{sched}_{mesh.size}x{len(mesh.unique_devices())}")
                s = traced(sim, trace_steps, out, emit=emit)
                rows.append({"scene": (nx, ny), "schedule": sched, "backend": backend,
                             "us_per_step": t * 1e6, "mlups": nx * ny / t / 1e6, "shares": s})
                emit(f"| {nx}x{ny} | {sched} | {backend} | {t * 1e6:.2f} | "
                     f"{nx * ny / t / 1e6:.1f} | {100 * s.halo_share:.2f}% | "
                     f"{100 * s.overlap_share:.1f}% |")
    return rows


# --- mode predict -----------------------------------------------------------


def halo_bytes(ny: int, temporal: int, itemsize: int, components: int = 1) -> int:
    """Bytes of one direction's halo in a pass: each component's 9
    planes of `temporal` rows of NY sites (the sessions' (9, T, NY)
    blocks)."""
    return components * 9 * temporal * ny * itemsize


def shard_heights(nx: int, counts=SHARD_COUNTS) -> dict:
    """{D: NX / D}: every height the session takes as it is (no padding:
    a shard of fewer than T rows runs the one-step form)."""
    from ..parallel.sharded import shard_rows

    return {d: shard_rows(nx, d) for d in counts}


def predict_rows(nx: int, ny: int, steps: int, t_shard: dict, enqueue: dict, temporal: int,
                 halo: int, sync: bool = False) -> list[dict]:
    """The predicted rows, one per D of t_shard ({D: measured seconds per
    step of one NX/D-row shard on a mesh of one, a ring of one that issues
    its own halo copies every pass}): per pass and direction the halo
    moves `halo` bytes over NVLink, t_comm = halo / NVLINK_BYTES_PER_S / T
    per step (none on one card). The copies' card time is already in
    t_shard and their host time in the enqueue floor, so neither is added
    again. Overlap: max(t_shard, t_comm + t_edges) with t_edges = 2T / L *
    t_shard, the two T-row bands' share; sync: t_shard + t_comm. No step
    is predicted below enqueue[D], the host's seconds per step to enqueue
    the D-shard program. Speed-up and efficiency are against the first
    row."""
    rows, base = [], None
    for d in sorted(t_shard):
        L = nx // d
        t_comm = halo / NVLINK_BYTES_PER_S / temporal if d > 1 else 0.0
        t_edges = 0.0 if sync or d == 1 else 2 * temporal / L * t_shard[d]
        if d == 1:
            t_model = t_shard[d]
        elif sync:
            t_model = t_shard[d] + t_comm
        else:
            t_model = max(t_shard[d], t_comm + t_edges)
        t_pred = max(t_model, enqueue[d])
        runtime = t_pred * steps
        base = runtime if base is None else base
        rows.append({"chips": d, "rows": L, "t_shard": t_shard[d], "t_comm": t_comm,
                     "t_edges": t_edges, "enqueue": enqueue[d], "t_pred": t_pred,
                     "host_bound": enqueue[d] > t_model, "runtime_s": runtime,
                     "speedup": base / runtime, "mlups": nx * ny * steps / runtime / 1e6,
                     "efficiency": base / runtime / d})
    return rows


PREDICT_HEADER = ("#Chips\tRows\tt_shard(us/step)\tt_comm(us/step)\tt_edges(us/step)\t"
                  "enqueue(us/step)\tt_pred(us/step)\tRuntime (s)\tSpeedup\tMLUPS\t"
                  "efficiency\tsource")


def _row_text(r: dict, source: str) -> str:
    return (f"{r['chips']}\t{r['rows']}\t{r['t_shard'] * 1e6:.2f}\t{r['t_comm'] * 1e6:.3f}\t"
            f"{r['t_edges'] * 1e6:.2f}\t{r['enqueue'] * 1e6:.2f}\t{r['t_pred'] * 1e6:.2f}\t"
            f"{r['runtime_s']:.3f}\t{r['speedup']:.2f}\t{r['mlups']:.1f}\t"
            f"{r['efficiency']:.2f}\t{source}")


def copy_seconds(ny: int, temporal: int, dtype=torch.float32, rows: int = 200,
                 n: int = 200) -> tuple[float, float]:
    """(host enqueue, card time) in seconds of one halo copy as
    HaloExchange makes it on one card: a (9, T, NY) block copied out of the
    last T rows of a (9, rows, NY) shard (a strided copy). Printed beside
    the table as context: predict_rows adds neither (t_shard and the
    enqueue floor hold them)."""
    from ..utils.timing import queued_ms

    src = torch.zeros((9, rows, ny), dtype=dtype, device="cuda")
    dst = torch.empty((9, temporal, ny), dtype=dtype, device="cuda")
    block = src.narrow(1, rows - temporal, temporal)
    dst.copy_(block)
    torch.cuda.synchronize()
    torch.cuda._sleep(60_000_000)  # the copies queue behind it
    t0 = time.perf_counter()
    for _ in range(n):
        dst.copy_(block)
    host = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return host, queued_ms(lambda: dst.copy_(block), n) * 1e-3


def _measured_shards(nx, ny, backend, dtype, device) -> dict:
    """{D: slope seconds per step of `backend` over a mesh of one shard of
    NX/D rows on `device`}, the program each card of a D-card run runs."""
    from ..parallel import sharded

    out = {}
    with backends_over(sharded.make_mesh(devices=[device])):
        for d, L in shard_heights(nx).items():
            out[d] = slope_seconds(_simulation(L, ny, backend, dtype=dtype,
                                               scene="barrier", device=device))
    return out


def _enqueue_by_shards(nx, ny, backend, dtype, device) -> dict:
    """{D: host seconds per step to enqueue `backend` over D virtual shards
    of `device`}: the same launches and copies a D-card run issues."""
    from ..parallel import sharded

    out = {}
    for d in SHARD_COUNTS:
        with backends_over(sharded.make_mesh(devices=[device] * d)):
            sim = _simulation(nx, ny, backend, dtype=dtype, scene="barrier", device=device)
            sim.run(WARMUP)
            out[d] = enqueue_seconds(sim)
    return out


def _measured_over_cards(nx, ny, backend, dtype) -> dict:
    """{D: slope seconds per step of `backend` over a mesh of D cards},
    for D of SHARD_COUNTS above 1 with D cards visible."""
    from ..parallel import sharded

    out = {}
    for d in SHARD_COUNTS[1:]:
        if d <= torch.cuda.device_count():
            with backends_over(sharded.make_mesh(d)):
                out[d] = slope_seconds(_simulation(nx, ny, backend, dtype=dtype,
                                                   scene="barrier"))
    return out


def _emit_table(emit, rows, measured, nx, ny, steps, ref_dp=None):
    emit(PREDICT_HEADER)
    overtaken = False
    for r in rows:
        mark = ""
        if ref_dp is not None and not overtaken and r["mlups"] > ref_dp:
            mark = f"  <- overtakes the reference's 13-node DP cluster ({ref_dp})"
            overtaken = True
        emit(_row_text(r, "PREDICTED from this card's measured shard"
                          + (" (host-bound: enqueue)" if r["host_bound"] else "")) + mark)
    base = rows[0]["runtime_s"]
    for d, t in sorted(measured.items()):
        runtime = t * steps
        emit(f"{d}\t{nx // d}\t\t\t\t\t{t * 1e6:.2f}\t{runtime:.3f}\t{base / runtime:.2f}\t"
             f"{nx * ny * steps / runtime / 1e6:.1f}\t{base / runtime / d:.2f}\t"
             f"measured over {d} cards")


def mode_predict(steps: int = 1200, scenes=PREDICT_SCENES, device="cuda", emit=print) -> dict:
    """The PREDICTED scaling table (see predict_rows) for `sharded-cuda` in
    float32 at each scene and for `sharded-cuda-ds64` (sync schedule,
    passes of DS_TEMPORAL) at DP_SCENE, from shard times measured on
    `device`; with two or more cards visible, rows measured over D cards
    beside them. Returns {("f32", nx, ny) or ("ds64", nx, ny): rows}."""
    _require_card("predict")
    from ..ops.fused_ds_kernel import DS_TEMPORAL
    from ..parallel.sharded import SHARDED_TEMPORAL

    device = torch.device(device)
    emit(f"device: {torch.cuda.get_device_name(device)} (table PREDICTED from one card's "
         f"shard measurements and an NVLink model, {NVLINK_BYTES_PER_S / 1e9:.0f} GB/s each "
         "way: the H100 SXM data sheet's 900 GB/s in all)")
    out = {}
    T = SHARDED_TEMPORAL[torch.float32]
    with torch.cuda.device(device):
        for nx, ny in scenes:
            halo = halo_bytes(ny, T, 4)
            host, card = copy_seconds(ny, T, rows=nx // max(SHARD_COUNTS))
            t_shard = _measured_shards(nx, ny, "sharded-cuda", np.float32, device)
            enqueue = _enqueue_by_shards(nx, ny, "sharded-cuda", np.float32, device)
            rows = predict_rows(nx, ny, steps, t_shard, enqueue, T, halo)
            out["f32", nx, ny] = rows
            emit(f"\n#{nx}x{ny}, {steps} steps SP (f32, sharded-cuda, overlap schedule, passes "
                 f"of T={T}), PREDICTED from measured shards + NVLink model")
            emit(_comm_text(halo, T, "one copy", host, card))
            _fit(emit, nx, t_shard)
            _emit_table(emit, rows, _measured_over_cards(nx, ny, "sharded-cuda", np.float32),
                        nx, ny, steps)

        nx, ny = DP_SCENE
        T = DS_TEMPORAL
        halo = halo_bytes(ny, T, 4, components=2)
        host, card = copy_seconds(ny, T, rows=nx // max(SHARD_COUNTS))
        t_shard = _measured_shards(nx, ny, "sharded-cuda-ds64", np.float64, device)
        enqueue = _enqueue_by_shards(nx, ny, "sharded-cuda-ds64", np.float64, device)
        rows = predict_rows(nx, ny, steps, t_shard, enqueue, T, halo, sync=True)
        out["ds64", nx, ny] = rows
        emit(f"\n#{nx}x{ny}, {steps} steps DP (ds64 pair, sharded-cuda-ds64, sync schedule, "
             f"passes of T={T}), PREDICTED from measured shards + NVLink model")
        emit(_comm_text(halo, T, "hi and lo: 2 copies", host, card))
        _fit(emit, nx, t_shard)
        _emit_table(emit, rows, _measured_over_cards(nx, ny, "sharded-cuda-ds64", np.float64),
                    nx, ny, steps, ref_dp=REFERENCE_DP_MLUPS)
    return out


def _comm_text(halo, temporal, copies, host, card) -> str:
    return (f"#halo {halo:,} B/direction/pass ({copies}); t_comm = halo / "
            f"{NVLINK_BYTES_PER_S / 1e9:.0f} GB/s / T = "
            f"{halo / NVLINK_BYTES_PER_S / temporal * 1e6:.3f} us/step; one halo copy "
            f"{host * 1e6:.2f} us host enqueue + {card * 1e6:.2f} us card, measured here, not "
            "added: t_shard holds the copies (a mesh of one issues them too) and the enqueue "
            "column their host time")


def _fit(emit, nx, t_shard):
    ls = np.array([nx // d for d in sorted(t_shard)], dtype=float)
    ts = np.array([t_shard[d] for d in sorted(t_shard)])
    b, a = np.polyfit(ls, ts, 1)
    emit("#measured shards: " + ", ".join(f"{nx // d} rows = {t_shard[d] * 1e6:.2f} us/step"
                                          for d in sorted(t_shard)))
    emit(f"#fit t(L) = {a * 1e6:.2f} us + {b * 1e9:.2f} ns/row (context only; every table row "
         "is measured)")


# --- main -------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="latticeboltzmann_tpu_torch.scripts.scaling")
    ap.add_argument("--mode", choices=("cpu", "gpu", "ab", "predict"), required=True)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--trace-dir", default=str(pathlib.Path(__file__).resolve().parents[2]
                                               / "build" / "scaling_traces"),
                    help="where the gpu and ab modes write their torch.profiler traces")
    ap.add_argument("--virtual-shards", type=int, default=0,
                    help="gpu, ab: a mesh of N virtual shards of card 0 (0: every visible card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "cpu":
        mode_cpu(steps=args.steps)
        return 0
    _require_card(args.mode)
    from ..bench import card_info
    from ..parallel import sharded

    print(f"card: {card_info()}")
    if args.mode == "predict":
        mode_predict(args.steps)
        return 0
    mesh = (sharded.make_mesh(devices=["cuda:0"] * args.virtual_shards)
            if args.virtual_shards else sharded.make_mesh())
    if args.mode == "gpu":
        mode_gpu(mesh, args.steps, args.trace_dir)
    else:
        mode_ab(mesh, args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line runner: `python -m latticeboltzmann_tpu_torch`, the port
of latticeboltzmann_tpu/cli.py with every one of its flags.

Every compile-time #define of the reference (src/latticeboltzmann.c:
36-65: NX, NY, TAU, CSQ, NTIMESTEPS, PRINTSTATSEVERY, SAVELATTICE[EVERY],
ACCEL, INITIALDENSITY, precision-header choice) is a runtime flag here.
Extras over the reference, as in the JAX CLI: |u|^2 snapshots and the
movie (utils/viz.py), raw checkpoints and --resume
(utils/checkpoint.py), probe series, backend selection, torch.profiler
traces (utils/profiler.py; the warmup and every chunk a named span) and
--debug-nans. The run goes in chunks
between events, each chunk to the earliest step at which an event is
due, so every event fires at multiples of its own interval.

Two differences from the JAX CLI: --debug-nans checks the state for
non-finite values on the device after each chunk (the JAX flag traps
inside jit), and --checkpoint-format orbax (a JAX library) is refused,
as is --movie where matplotlib does not import: both exit 2 before any
step runs.

Usage:
    python -m latticeboltzmann_tpu_torch [--nx 400 --ny 2000 ...]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

PRECISIONS = {"f32": np.float32, "f64": np.float64, "bf16": "bfloat16"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="latticeboltzmann_tpu_torch",
        description="D2Q9 lattice-Boltzmann (BGK) channel flow in PyTorch and CUDA",
    )
    p.add_argument("--nx", type=int, default=400)
    p.add_argument("--ny", type=int, default=2000)
    p.add_argument("--tau", type=float, default=0.7)
    p.add_argument("--csq", type=float, default=1.0)
    p.add_argument("--accel", type=float, default=0.005)
    p.add_argument("--density", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--precision", choices=sorted(PRECISIONS), default="f32",
                   help="bf16 is bf16 storage with float32 arithmetic")
    p.add_argument("--backend", default="auto",
                   help="auto|torch|cuda|torch-ds64|cuda-ds64|sharded|sharded-sync"
                        "|sharded-cuda|sharded-cuda-fused|sharded-cuda-ds64"
                        "|sharded-cuda-rdma (experimental: the halo exchange inside "
                        "the kernel; naming it here is the opt-in, see models/engine.py) "
                        "(the ds64 backends are pair-DP; use with --precision f64; the "
                        "sharded ones split the rows over every visible card)")
    p.add_argument("--geometry", default="barrier",
                   help="empty|channel|barrier|reference|cylinder")
    p.add_argument("--print-stats-every", type=int, default=1000)
    p.add_argument("--save-lattice-every", type=int, default=0,
                   help="snapshot |u|^2 CSV every N steps (0 = off)")
    p.add_argument("--snapshot-dir", default="data")
    p.add_argument("--movie", default=None,
                   help="render snapshots to this gif after the run (needs matplotlib; "
                        "refused before any step without it)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--checkpoint-format", choices=("raw", "orbax"), default="raw",
                   help="raw (<step>.lbmckpt/, read by either package); orbax is the "
                        "JAX package's and is refused here")
    p.add_argument("--probe", action="append", default=None, metavar="I,J",
                   help="record (rho,u_x,u_y) at site i,j every "
                        "--probe-every steps (repeatable)")
    p.add_argument("--probe-every", type=int, default=100)
    p.add_argument("--probe-out", default="probes.csv")
    p.add_argument("--resume", default=None,
                   help="path to a .lbmckpt directory (or 'latest'); its config wins "
                        "over the lattice flags and --precision")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here (a chrome trace; "
                        "the card's kernels too when a card is in use)")
    p.add_argument("--fast-math", action="store_true",
                   help="approximate 1/rho in the cuda kernel (the reference's "
                        "-Ofast analog, Makefile:2); other backends ignore it")
    p.add_argument("--skew", dest="skew", action="store_true", default=None,
                   help="the JAX package's wavefront time-skewing knob, accepted for "
                        "its command lines: the schedules it selects there are "
                        "bitwise equal, so it changes nothing here; --no-skew "
                        "likewise")
    p.add_argument("--no-skew", dest="skew", action="store_false")
    p.add_argument("--debug-nans", action="store_true",
                   help="abort on NaN/inf like the reference's feenableexcept trap "
                        "(src/latticeboltzmann.c:129): the state is checked on the "
                        "device at every chunk boundary (the JAX flag traps inside "
                        "jit), and the run exits 1 naming the step")
    p.add_argument("--warmup", type=int, default=8,
                   help="steps run once before timing starts to absorb the "
                        "kernel build and first-launch costs (state is reset "
                        "afterwards); 0 disables")
    return p


def resolve_backend(name: str, dtype=np.float32) -> str:
    """"auto" is "cuda" for float32 and bf16 when a CUDA card is
    available, else "torch" (which then runs on the card if there is
    one): the kernel takes those two storage dtypes, and the JAX package
    sends float64 to its plain engine on the accelerator too. Any other
    name is returned as it is, so an explicit choice that cannot run
    raises instead of rerouting. An explicit "cuda" with float64 runs:
    the facade takes it to the same "torch" engine on the card
    (Simulation.form "torch-f64"), so a float64 checkpoint resumes under
    --backend cuda too."""
    if name != "auto":
        return name
    import torch

    from .utils.interop import storage_dtype

    if torch.cuda.is_available() and storage_dtype(dtype) in (torch.float32, torch.bfloat16):
        return "cuda"
    return "torch"




_PRECISION_NAMES = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}


def _refusal(args) -> str | None:
    """Why the command line cannot run to its end, found before any step:
    an orbax checkpoint, or a movie without matplotlib; else None."""
    if args.checkpoint_format == "orbax":
        return ("--checkpoint-format orbax: the orbax format is the JAX package's and is "
                "not ported; its counterpart in the port, a row-sharded state saved shard by "
                "shard, is utils/checkpoint.save(..., format='sharded'); use "
                "--checkpoint-format raw")
    if args.movie:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            return f"--movie needs matplotlib, which does not import here ({e})"
    return None


def _copy_state(f):
    """A copy of Simulation.f, leaf by leaf: a tensor, or the ds
    backends' DS pair."""
    if isinstance(f, tuple):
        return type(f)(*(x.clone() for x in f))
    return f.clone()


def _finite(f) -> bool:
    """Whether every value of the state (both planes of a DS pair) is
    finite, reduced on its device: one value crosses to the host."""
    import torch

    leaves = f if isinstance(f, tuple) else (f,)
    return bool(torch.stack([torch.isfinite(x).all() for x in leaves]).all())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2

    from .core import geometry
    from .core.spec import LatticeConfig
    from .models.engine import Simulation
    from .utils import checkpoint, profiler, stats, viz
    from .utils.interop import storage_dtype

    start_step = 0
    f0 = None
    if args.resume:
        path = args.resume
        if path == "latest":
            path = checkpoint.latest(args.checkpoint_dir)
            if path is None:
                print(f"no checkpoint found in {args.checkpoint_dir}", file=sys.stderr)
                return 2
        try:
            start_step, f0, walls, cfg = checkpoint.load(path)
        except NotImplementedError as e:
            print(f"{path}: {e}", file=sys.stderr)
            return 2
        print(f"resumed from {path} at step {start_step}")
    else:
        cfg = LatticeConfig(
            nx=args.nx, ny=args.ny, tau=args.tau, csq=args.csq,
            accel=args.accel, initial_density=args.density,
            dtype=PRECISIONS[args.precision],
        )
        walls = geometry.build(args.geometry, cfg.nx, cfg.ny)
    backend = resolve_backend(args.backend, cfg.dtype)
    # an experimental backend typed out on the command line is opted in to
    sim = Simulation(cfg, walls, backend=backend, f0=f0, fast_math=args.fast_math,
                     skew=args.skew, allow_experimental=backend == args.backend)

    # size and precision of the config actually used (on --resume the
    # checkpoint's dtype wins over --precision)
    itemsize = storage_dtype(cfg.dtype).itemsize
    mb = cfg.nx * cfg.ny * 9 * itemsize / 1024 / 1024
    precision = _PRECISION_NAMES[checkpoint.dtype_name(cfg.dtype)]
    print(f"Lattice Size: {cfg.nx}x{cfg.ny} ({mb:.2f} MB) "
          f"backend={sim.backend} precision={precision} device={sim.device}")

    # under --profile-dir the warmup and each chunk's run are named spans
    # of the trace (lbm_warmup, lbm_run), beside the program's own
    with contextlib.ExitStack() as profiling:
        if args.profile_dir:
            profiling.enter_context(profiler.trace(args.profile_dir))

        if args.warmup:
            # absorb the kernel build and first launches outside the timed
            # run, then restore the state; through sim.run so the timed run
            # takes the warmed path
            f_before = _copy_state(sim.f)
            with profiler.span("lbm_warmup"):
                sim.run(args.warmup)
            sim.f = f_before
            sim.steps_done = 0
            sim.elapsed = 0.0

        probes = None
        probe_rows = []
        if args.probe:
            probes = np.array([[int(v) for v in p.split(",")] for p in args.probe],
                              dtype=np.int64)

        reporter = stats.RunStats(cfg, total_steps=args.steps)
        # chunked run: stats/snapshots/checkpoints/probes between device
        # runs, the loop structure of main() (src/latticeboltzmann.c:148-164).
        # Each event fires at multiples of its own interval: every chunk runs
        # to the earliest upcoming due step, so mixed intervals and resumes
        # from unaligned steps never skip an event.
        intervals = [e for e in (args.print_stats_every, args.save_lattice_every,
                                 args.checkpoint_every,
                                 args.probe_every if probes is not None else 0)
                     if e]
        end = start_step + args.steps
        step = start_step
        t0 = time.perf_counter()
        while step < end:
            due = [((step // e) + 1) * e for e in intervals]
            n = min(due + [end]) - step
            with profiler.span("lbm_run"):
                sim.run(n)
            step += n
            if args.debug_nans and not _finite(sim.f):
                print(f"--debug-nans: the state holds a NaN or inf after step {step}",
                      file=sys.stderr)
                return 1
            if args.print_stats_every and step % args.print_stats_every == 0:
                reporter.report(step - start_step)
            if args.save_lattice_every and step % args.save_lattice_every == 0:
                viz.save_snapshot_field(args.snapshot_dir, step, sim.speed_squared())
            if args.checkpoint_every and step % args.checkpoint_every == 0:
                checkpoint.save(args.checkpoint_dir, step, sim.state(), sim.walls_np, cfg,
                                format=args.checkpoint_format)
            if probes is not None and step % args.probe_every == 0:
                probe_rows.append((step, sim.probe_values(probes)))
        runtime = time.perf_counter() - t0

    stats.final_report(cfg, runtime, sim.reynolds())
    print(f"MLUPS: {sim.mlups:.1f}")

    if probe_rows:
        with open(args.probe_out, "w") as fp:
            fp.write("step,i,j,rho,u_x,u_y\n")
            for s, vals in probe_rows:
                for (pi, pj), (rho, ux, uy) in zip(probes, vals):
                    fp.write(f"{s},{pi},{pj},{float(rho)!r},{float(ux)!r},{float(uy)!r}\n")
        print(f"probe series written to {args.probe_out}")

    if args.movie:
        out = viz.render_movie(args.snapshot_dir, args.movie)
        print(f"movie written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

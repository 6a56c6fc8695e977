"""Command-line runner: `python -m latticeboltzmann_tpu_torch`, the
main-path flags of latticeboltzmann_tpu/cli.py.

Snapshots, checkpoints, probes, the movie, profiling, skew and fast
math are ROADMAP A6/A7.

Usage:
    python -m latticeboltzmann_tpu_torch [--nx 400 --ny 2000 ...]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

PRECISIONS = {"f32": np.float32, "f64": np.float64}


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
                   help="bf16 storage is ROADMAP B3")
    p.add_argument("--backend", default="auto", help="auto|torch|cuda")
    p.add_argument("--geometry", default="barrier",
                   help="empty|channel|barrier|reference|cylinder")
    p.add_argument("--print-stats-every", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=8,
                   help="steps run once before timing starts to absorb the "
                        "kernel build and first-launch costs (state is reset "
                        "afterwards); 0 disables")
    return p


def resolve_backend(name: str) -> str:
    """"auto" is "cuda" when a CUDA card is available, else "torch"."""
    if name != "auto":
        return name
    import torch

    return "cuda" if torch.cuda.is_available() else "torch"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .core import geometry
    from .core.spec import LatticeConfig
    from .models.engine import Simulation
    from .utils import stats

    cfg = LatticeConfig(
        nx=args.nx, ny=args.ny, tau=args.tau, csq=args.csq,
        accel=args.accel, initial_density=args.density,
        dtype=PRECISIONS[args.precision],
    )
    walls = geometry.build(args.geometry, cfg.nx, cfg.ny)
    sim = Simulation(cfg, walls, backend=resolve_backend(args.backend))

    mb = cfg.nx * cfg.ny * 9 * np.dtype(cfg.dtype).itemsize / 1024 / 1024
    print(f"Lattice Size: {cfg.nx}x{cfg.ny} ({mb:.2f} MB) "
          f"backend={sim.backend} precision={args.precision}")

    if args.warmup:
        # absorb the kernel build and first launches outside the timed
        # run, then restore the state
        f_before = sim.f
        sim.run(args.warmup)
        sim.f = f_before
        sim.steps_done = 0
        sim.elapsed = 0.0

    reporter = stats.RunStats(cfg, total_steps=args.steps)
    every = args.print_stats_every
    step = 0
    t0 = time.perf_counter()
    while step < args.steps:
        n = args.steps - step
        if every:
            n = min(n, every - step % every)
        sim.run(n)
        step += n
        if every and step % every == 0:
            reporter.report(step)
    runtime = time.perf_counter() - t0

    stats.final_report(cfg, runtime, sim.reynolds())
    print(f"MLUPS: {sim.mlups:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Headline benchmark of the port: 800x4000 channel flow on the
reference's exact scene, on one CUDA card. Prints ONE JSON line.

--precision f32 (the default) runs the float32 kernel; bf16 runs it with
bf16 storage and float32 arithmetic, ds64 the pair-DP kernel (backend
cuda-ds64 on a float64 config), and f64 the float64 "torch" engine on the
card. --geometry names a scene of core/geometry.build (default
"reference", the reference's exact scene). --temporal T, the root
bench.py's temporal-blocking depth, runs the cuda backend in f32 or bf16
in passes of T steps (Simulation(temporal=T)); the line records it under
"temporal" (null without the flag, where the cuda session runs its
default depth, fused_kernel.default_temporal). Everywhere else it would select
nothing, so it is refused there (exit 2, before any step), as
--skew/--no-skew are everywhere: a line must not record a setting that
did not run. The rows of bench_suite.py run through the same flags.

The method (`defended_timing`, which bench_suite.py shares) is the JAX
package's bench.py (the repository root's, lines 139-187): a slope rate
from runs of 1680 and 5040 steps, which cancels any fixed per-call cost;
at least 3 end-to-end runs, every value kept; the degraded flag when the
best end-to-end rate is under half the slope rate after one retry; and a
guard that the state is finite and non-negative and Re finite.
torch.cuda.synchronize() is the completion barrier (Simulation.run blocks
on it). The line adds the effective bandwidth, bytes per site update x
MLUPS (72 B for f32; 36 B for bf16; 144 B for ds64, two f32 components,
and for f64), and the card's name and power limit.

Usage: python -m latticeboltzmann_tpu_torch.bench [--backend auto|cuda|torch|...]
           [--precision f32|bf16|ds64|f64] [--geometry reference|cylinder|...]
           [--temporal T]
--backend sharded-cuda (f32) and --precision ds64 --backend
sharded-cuda-ds64 are the row-sharded rows of bench_suite.py (:36-37,
:71-73): the rows split over every visible card, on one card the
1-device mesh, the per-chip program of the JAX row (:65-70).
A run that finds no CUDA card fails; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch


def card_info() -> str:
    """`name, power.limit` of the cards, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def defended_timing(sim, steps: int, *, n1: int = 1680, n2: int = 5040,
                    e2e_runs: int = 3) -> dict:
    """The JAX bench.py's two-measurement defense on a warmed Simulation:
    the slope between runs of n1 and n2 steps (best of two each, after one
    run of n1; the two estimates must agree within 1.3x for slope_valid),
    then e2e_runs end-to-end runs of `steps`, every time kept; when the
    best end-to-end rate is under half the slope rate, e2e_runs more, and
    degraded_environment if it still is. "value" is the end-to-end MLUPS,
    or the slope's for a degraded run with a valid slope. Each run ends
    with Simulation.run's completion barrier."""
    sites = sim.cfg.sites

    def timed(n: int) -> float:
        sim.elapsed = 0.0
        sim.steps_done = 0
        sim.run(n)
        return sim.elapsed

    timed(n1)
    t1s = [timed(n1) for _ in range(2)]
    t2s = [timed(n2) for _ in range(2)]
    per_step = (min(t2s) - min(t1s)) / (n2 - n1)
    slope_mlups = sites / per_step / 1e6 if per_step > 0 else 0.0
    slopes = [(t2s[k] - t1s[k]) / (n2 - n1) for k in range(2)]
    slope_valid = bool(
        per_step > 0 and all(s > 0 for s in slopes) and max(slopes) <= 1.3 * min(slopes)
    )

    def e2e_pass() -> list[float]:
        return [timed(steps) for _ in range(e2e_runs)]

    e2e_times = e2e_pass()
    e2e_mlups = sites * steps / min(e2e_times) / 1e6
    degraded = False
    if slope_valid and e2e_mlups < 0.5 * slope_mlups:
        e2e_times += e2e_pass()
        e2e_mlups = sites * steps / min(e2e_times) / 1e6
        degraded = e2e_mlups < 0.5 * slope_mlups
    return {
        "value": slope_mlups if (degraded and slope_valid) else e2e_mlups,
        "runtime_s": min(e2e_times),
        "e2e_runs_s": e2e_times,
        "e2e_mlups": e2e_mlups,
        "slope_mlups": slope_mlups,
        "slope_us_per_step": per_step * 1e6,
        "slope_valid": slope_valid,
        "degraded_environment": degraded,
    }


def precision_setup(precision: str, backend: str) -> tuple[object, str, int]:
    """(LatticeConfig dtype, backend, bytes per site update) of a
    --precision: f32 / bf16 on the kernel ("auto": cli.resolve_backend),
    ds64 on the pair-DP kernel ("auto": cuda-ds64), f64 on the float64
    "torch" engine ("auto": torch)."""
    from .cli import resolve_backend
    from .ops.fused_ds_kernel import BYTES_PER_SITE_DS
    from .utils.interop import bytes_per_site

    if precision == "ds64":
        # pair-DP: the host-side state is float64, the card runs f32 pairs
        return np.float64, "cuda-ds64" if backend == "auto" else backend, BYTES_PER_SITE_DS
    dtype = {"f32": np.float32, "bf16": "bfloat16", "f64": np.float64}[precision]
    return dtype, resolve_backend(backend, dtype), bytes_per_site(dtype)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="latticeboltzmann_tpu_torch.bench")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--precision", choices=("f32", "bf16", "ds64", "f64"), default="f32")
    ap.add_argument("--geometry", default="reference",
                    help="a scene of core/geometry.build: empty|channel|barrier|reference|cylinder")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=4000)
    ap.add_argument("--warmup", type=int, default=96)
    ap.add_argument("--e2e-runs", type=int, default=3)
    ap.add_argument("--skew", dest="skew", action="store_true", default=None,
                    help="the JAX package's wavefront time-skewing knob; refused: it is "
                         "the TPU's sequential-grid carry and selects nothing in the port")
    ap.add_argument("--no-skew", dest="skew", action="store_false")
    ap.add_argument("--temporal", type=int, default=None,
                    help="steps per pass through device memory on the cuda backend "
                         "(f32, bf16); refused on every other backend and precision")
    return ap


def schedule_refusal(args) -> str | None:
    """Why the schedule flags select nothing for these arguments, or None
    when they select what they name: --temporal on the cuda backend ("auto"
    takes it for f32 and bf16) in f32 or bf16, at a depth of at least 1.
    --skew/--no-skew never do."""
    if args.skew is not None:
        return ("--skew/--no-skew select nothing in the port: skew is the TPU kernel's "
                "sequential-grid carry, and the JAX package's tests hold it bitwise equal to "
                "the plain schedule")
    if args.temporal is None:
        return None
    if args.temporal < 1:
        return f"--temporal {args.temporal}: a pass runs at least one step"
    if args.backend not in ("auto", "cuda") or args.precision not in ("f32", "bf16"):
        return (f"--temporal selects nothing on backend {args.backend!r} at precision "
                f"{args.precision}: only the cuda backend runs passes of T steps, in f32 and "
                "bf16")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refusal = schedule_refusal(args)
    if refusal is not None:
        print(f"bench: {refusal}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from .core import geometry
    from .core.spec import LatticeConfig
    from .models.engine import Simulation

    dtype, backend, bytes_per_site = precision_setup(args.precision, args.backend)
    cfg = LatticeConfig(nx=args.nx, ny=args.ny, dtype=dtype)
    walls = geometry.build(args.geometry, cfg.nx, cfg.ny)
    # an experimental backend named outright is opted in to, as in the CLI
    sim = Simulation(cfg, walls, backend=backend, device="cuda", temporal=args.temporal,
                     allow_experimental=backend == args.backend)
    sim.run(args.warmup)  # kernel build and first launches, excluded
    timing = defended_timing(sim, args.steps, e2e_runs=args.e2e_runs)

    re = sim.reynolds()
    f = sim.state()
    ok = bool(np.isfinite(f).all() and (f >= 0).all() and np.isfinite(re))

    mlups = timing.pop("value")
    result = {
        "metric": f"MLUPS_{args.nx}x{args.ny}_{args.precision}_{backend}",
        "value": mlups,
        "unit": "MLUPS",
        "effective_GBps": mlups * 1e6 * bytes_per_site / 1e9,
        "steps": args.steps,
        **timing,
        "geometry": args.geometry,
        "temporal": args.temporal,
        "reynolds": float(re),
        "finite_and_positive": ok,
        "device": torch.cuda.get_device_name(0),
        "card": card_info(),
    }
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

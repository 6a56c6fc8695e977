"""Headline benchmark of the port: 800x4000 channel flow on the
reference's exact scene, on one CUDA card. Prints ONE JSON line.

--precision f32 (the default) runs the float32 kernel; ds64 runs the
pair-DP kernel (backend cuda-ds64 on a float64 config), the JAX
package's bench_suite.py rows (latticeboltzmann_tpu/bench_suite.py:61-64).

The method is the JAX package's bench.py (the repository root's, lines
139-187): a slope rate from runs of 1680 and 5040 steps, which cancels
any fixed per-call cost; at least 3 end-to-end runs, every value kept;
the degraded flag when the best end-to-end rate is under half the slope
rate after one retry; and a guard that the state is finite and
non-negative and Re finite. torch.cuda.synchronize() is the completion
barrier (Simulation.run blocks on it). The line adds the effective
bandwidth, bytes per site update x MLUPS (72 B for f32; 144 B for ds64,
two f32 components), and the card's name and power limit.

Usage: python -m latticeboltzmann_tpu_torch.bench [--backend auto|cuda|torch]
           [--precision f32|ds64]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--precision", choices=("f32", "ds64"), default="f32")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=4000)
    ap.add_argument("--warmup", type=int, default=96)
    ap.add_argument("--e2e-runs", type=int, default=3)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("bench: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from .cli import resolve_backend
    from .core import geometry
    from .core.spec import LatticeConfig, bytes_per_site_update
    from .models.engine import Simulation
    from .ops.fused_ds_kernel import BYTES_PER_SITE_DS

    if args.precision == "ds64":
        # pair-DP: the host-side state is float64, the card runs f32 pairs
        backend = "cuda-ds64" if args.backend == "auto" else args.backend
        dtype, bytes_per_site = np.float64, BYTES_PER_SITE_DS
    else:
        backend = resolve_backend(args.backend)
        dtype, bytes_per_site = np.float32, bytes_per_site_update(np.float32)
    cfg = LatticeConfig(nx=args.nx, ny=args.ny, dtype=dtype)
    walls = geometry.reference_barrier(cfg.nx, cfg.ny)
    sim = Simulation(cfg, walls, backend=backend, device="cuda")
    sim.run(args.warmup)  # kernel build and first launches, excluded

    def timed(n: int) -> float:
        sim.elapsed = 0.0
        sim.steps_done = 0
        sim.run(n)
        return sim.elapsed

    n1, n2 = 1680, 5040
    timed(n1)
    t1s = [timed(n1) for _ in range(2)]
    t2s = [timed(n2) for _ in range(2)]
    per_step = (min(t2s) - min(t1s)) / (n2 - n1)
    slope_mlups = cfg.sites / per_step / 1e6 if per_step > 0 else 0.0
    slopes = [(t2s[k] - t1s[k]) / (n2 - n1) for k in range(2)]
    slope_valid = bool(
        per_step > 0 and all(s > 0 for s in slopes) and max(slopes) <= 1.3 * min(slopes)
    )

    def e2e_pass() -> list[float]:
        return [timed(args.steps) for _ in range(args.e2e_runs)]

    e2e_times = e2e_pass()
    e2e_mlups = cfg.sites * args.steps / min(e2e_times) / 1e6
    degraded = False
    if slope_valid and e2e_mlups < 0.5 * slope_mlups:
        e2e_times += e2e_pass()
        e2e_mlups = cfg.sites * args.steps / min(e2e_times) / 1e6
        degraded = e2e_mlups < 0.5 * slope_mlups
    mlups = slope_mlups if (degraded and slope_valid) else e2e_mlups

    re = sim.reynolds()
    f = sim.state()
    ok = bool(np.isfinite(f).all() and (f >= 0).all() and np.isfinite(re))

    result = {
        "metric": f"MLUPS_{args.nx}x{args.ny}_{args.precision}_{backend}",
        "value": mlups,
        "unit": "MLUPS",
        "effective_GBps": mlups * 1e6 * bytes_per_site / 1e9,
        "runtime_s": min(e2e_times),
        "steps": args.steps,
        "e2e_runs_s": e2e_times,
        "e2e_mlups": e2e_mlups,
        "slope_mlups": slope_mlups,
        "slope_us_per_step": per_step * 1e6,
        "slope_valid": slope_valid,
        "degraded_environment": degraded,
        "reynolds": float(re),
        "finite_and_positive": ok,
        "device": torch.cuda.get_device_name(0),
        "card": card_info(),
    }
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark suite of the port: the JAX package's thirteen rows
(latticeboltzmann_tpu/bench_suite.py), in the same order, at the same
sizes, precisions and geometries, beside the same published baselines
(the upstream C, OpenCL and MPI runtimes of README.md:66-90 and
mpi-runtimes.dat), on one CUDA card. End-to-end runtime for N steps;
MLUPS = NX * NY * steps / runtime / 1e6, the reference's derived metric.

Backends follow the port's names: xla -> torch (the float64 rows, on the
card), pallas -> cuda, sharded-pallas -> sharded-cuda (the rows split
over every visible card; on one card a mesh of one), pallas-ds64 ->
cuda-ds64, sharded-pallas-ds64 -> sharded-cuda-ds64.

Every row is timed by bench.defended_timing, the method bench.py uses: a
slope rate from runs of 240 and 720 steps (the two estimates must agree
within 1.3x for `slope_valid`), two end-to-end runs, every time kept in
`e2e_runs_s`, and `degraded_environment` when the best end-to-end rate
is under half the slope rate after one retry. A row is `sane` when its
macroscopic fields are finite, Re is finite, and the flow has developed
(|Re| > 1e-9, at a column the flow has reached where the central one is
too far for the run: `reynolds_developed`). The float64 rows are capped
at 2,000 steps. Every row line carries the card's name and power limit.

Usage:  python -m latticeboltzmann_tpu_torch.bench_suite [--steps 10000]
        [--quick] [--only 1,2,3] [--out BENCH_RESULTS_TORCH.md] [--append]
--out writes the markdown table there and the rows beside it as .jsonl;
it refuses the JAX package's BENCH_RESULTS.md / .jsonl at the repository
root, which are that package's record. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from .bench import card_info

# (name, nx, ny, precision, geometry, backend, baseline_runtime_s, baseline_hw)
CONFIGS = [
    ("400x2000 f64 (serial C workload)", 400, 2000, "f64", "reference", "torch",
     110.31, "i5-2500K AVX 2T (README.md:70)"),
    ("400x4000 f32 fused kernel", 400, 4000, "f32", "reference", "cuda",
     7.49, "AMD R9 280X OpenCL SP (README.md:80)"),
    ("800x4000 f32 cylinder wake + rho/u extraction", 800, 4000, "f32", "cylinder", "cuda",
     14.38, "AMD R9 280X OpenCL SP (README.md:90)"),
    ("800x4000 f32 row-sharded (MPI-equivalent)", 800, 4000, "f32", "reference", "sharded-cuda",
     14.87, "13x2 Opteron 6128 MPI overlap (README.md:88)"),
    ("4000x16000 f32 large-domain", 4000, 16000, "f32", "reference", "cuda",
     None, "no reference datapoint at this size"),
    ("4000x16000 bf16-storage mixed precision", 4000, 16000, "bf16", "reference", "cuda",
     None, "no reference datapoint at this size"),
    ("800x4000 bf16-storage (headline scene)", 800, 4000, "bf16", "reference", "cuda",
     14.38, "AMD R9 280X OpenCL SP (README.md:90)"),
    ("400x2000 f32 (reference default scene)", 400, 2000, "f32", "reference", "cuda",
     4.21, "AMD R9 280X OpenCL SP (README.md:73)"),
    ("400x4000 f64 (emulated DP)", 400, 4000, "f64", "reference", "torch",
     13.76, "AMD R9 280X OpenCL DP (README.md:80)"),
    ("800x4000 f64 (emulated DP)", 800, 4000, "f64", "reference", "torch",
     27.44, "AMD R9 280X OpenCL DP (README.md:90)"),
    ("400x4000 ds64 pair-DP (fused Pallas)", 400, 4000, "ds64", "reference",
     "cuda-ds64", 13.76, "AMD R9 280X OpenCL DP (README.md:80)"),
    ("800x4000 ds64 pair-DP (fused Pallas)", 800, 4000, "ds64", "reference",
     "cuda-ds64", 27.44, "AMD R9 280X OpenCL DP (README.md:90)"),
    ("800x4000 ds64 pair-DP row-sharded (MPI-DP equiv)", 800, 4000, "ds64",
     "reference", "sharded-cuda-ds64", 26.54,
     "13x2 Opteron 6128 MPI overlap DP (README.md:88, mpi-runtimes.dat:76)"),
]

# the port's backend for each JAX backend name of the rows
BACKEND_NAMES = {"xla": "torch", "pallas": "cuda", "sharded-pallas": "sharded-cuda",
                 "pallas-ds64": "cuda-ds64", "sharded-pallas-ds64": "sharded-cuda-ds64"}

# the default --out; the JAX package's table is BENCH_RESULTS.md
DEFAULT_OUT = "BENCH_RESULTS_TORCH.md"
JAX_RECORDS = ("BENCH_RESULTS.md", "BENCH_RESULTS.jsonl")

# the float64 rows' step cap, and the quick run's steps
F64_MAX_STEPS = 2000
QUICK_STEPS = 1000
# the suite's slope counts and end-to-end runs (the JAX suite's)
SLOPE_STEPS = (240, 720)
E2E_RUNS = 2
WARMUP = 200

# regenerated into the --out table on every run
METHODOLOGY_NOTE = """\
Rows: the JAX package's bench_suite.py rows, one CUDA card, backends
under the port's names (xla -> torch, pallas -> cuda, sharded-pallas ->
sharded-cuda, pallas-ds64 -> cuda-ds64, sharded-pallas-ds64 ->
sharded-cuda-ds64). The float64 rows run the plain "torch" engine on the
card (the port has no float64 kernel) and are capped at 2,000 steps.

Timing: bench.defended_timing, as bench.py: a slope rate from runs of
240 and 720 steps (the two estimates must agree within 1.3x for
`slope_valid`), two end-to-end runs after a 200-step warmup, all kept in
the jsonl as `e2e_runs_s`, and `degraded_environment` when the best
end-to-end rate is under half the slope rate after one retry. The MLUPS
column is the best end-to-end rate; `slope_mlups` in the jsonl is the
sustained rate. Each run ends in torch.cuda.synchronize(). A card may be
set below its 700 W limit: the card column names it; compare rows within
one run.

Physics: every row must show developed flow (`sane`): finite macroscopic
fields and Re, and |Re| > 1e-9 at the central column or, where the flow
cannot reach it within the run (about 0.58 columns a step), at a column
it has reached (`reynolds_developed`)."""


def run_config(name, nx, ny, precision, geo, backend, steps, *, device="cuda") -> dict:
    """One row: `steps` steps of `backend` at nx x ny on scene `geo`,
    timed by bench.defended_timing, with Re, the developed-flow check and
    the macroscopic fields. `device` is "cuda" for the suite; a test runs
    a tiny row of a plain backend on the CPU."""
    from .bench import defended_timing, precision_setup
    from .core import geometry
    from .core.spec import LatticeConfig
    from .models.engine import Simulation

    dtype, backend, _ = precision_setup(precision, backend)
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
    walls = geometry.build(geo, nx, ny)
    sim = Simulation(cfg, walls, backend=backend, device=device)
    sim.run(min(WARMUP, steps))
    timing = defended_timing(sim, steps, n1=SLOPE_STEPS[0], n2=SLOPE_STEPS[1],
                             e2e_runs=E2E_RUNS)
    re = sim.reynolds()
    # where the central column is out of the flow's reach within the run
    # (it spreads at about the lattice sound speed, 0.58 columns a step),
    # probe a column the flow has reached
    re_dev, dev_col = re, None
    if abs(re) < 1e-3 and ny > 2 * steps // 3:
        dev_col = min(1000, ny // 4, max(16, steps // 3))
        re_dev = sim.reynolds(dev_col)
    # the macroscopic extraction is part of the cylinder row's contract
    rho, ux, uy = sim.macroscopic()
    ok = bool(np.isfinite(rho).all() and np.isfinite(ux).all() and np.isfinite(uy).all()
              and np.isfinite(re) and abs(re_dev) > 1e-9)
    out = {
        "config": name,
        "lattice": f"{nx}x{ny}",
        "precision": precision,
        "geometry": geo,
        "backend": backend,
        "steps": steps,
        "mlups": timing.pop("e2e_mlups"),
        **{k: v for k, v in timing.items() if k != "value"},
        "reynolds": float(re),
        "sane": ok,
    }
    if dev_col is not None:
        out["reynolds_developed_col"] = dev_col
        out["reynolds_developed"] = float(re_dev)
    return out


def row_steps(precision: str, steps: int) -> int:
    """A row's steps: the float64 rows are capped at F64_MAX_STEPS."""
    return min(steps, F64_MAX_STEPS) if precision == "f64" else steps


def run_rows(todo, steps: int, card: str, *, device="cuda", emit=print) -> list[dict]:
    """Run the rows `todo` (entries of CONFIGS), each line with the card's
    name and power limit and the published baseline; emit each line as
    it is done."""
    rows = []
    for name, nx, ny, prec, geo, backend, base_rt, base_hw in todo:
        t0 = time.perf_counter()
        r = run_config(name, nx, ny, prec, geo, backend, row_steps(prec, steps), device=device)
        r["wall_total_s"] = time.perf_counter() - t0
        r["card"] = card
        if base_rt is not None:
            base_mlups = nx * ny * 10000 / base_rt / 1e6
            r["baseline_mlups"] = base_mlups
            r["speedup_vs_baseline"] = r["mlups"] / base_mlups
            r["baseline_hw"] = base_hw
        emit(json.dumps(r))
        rows.append(r)
    return rows


def write_table(out: str, rows: list[dict], steps: int, card: str, append: bool) -> None:
    """The markdown table at `out` and the rows at its .jsonl; with
    append, rows of other configs already in the jsonl are kept, in
    CONFIGS order."""
    path = pathlib.Path(out)
    jsonl = path.with_suffix(".jsonl")
    if append and jsonl.exists():
        names = {r["config"] for r in rows}
        prev = [json.loads(line) for line in jsonl.read_text().splitlines() if line.strip()]
        order = {c[0]: k for k, c in enumerate(CONFIGS)}
        rows = sorted([r for r in prev if r["config"] not in names] + rows,
                      key=lambda r: order.get(r["config"], len(CONFIGS)))
    lines = [
        "# Benchmark results (latticeboltzmann_tpu_torch)",
        "",
        f"Card: {card}; steps per config: {steps} (f64 capped at {F64_MAX_STEPS}). "
        "MLUPS = NX*NY*steps/runtime/1e6,",
        "the reference's derived metric (BASELINE.md).",
        "",
        METHODOLOGY_NOTE,
        "",
        "| Config | Backend | Steps | Runtime (s) | MLUPS | Slope MLUPS | Sane | vs baseline "
        "| Baseline HW |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        vs = f'{r["speedup_vs_baseline"]:.2f}x' if "speedup_vs_baseline" in r else "—"
        lines.append(
            f'| {r["config"]} | {r["backend"]} | {r["steps"]} | {r["runtime_s"]:.3f} | '
            f'{r["mlups"]:.1f} | {r["slope_mlups"]:.1f} | {r["sane"]} | {vs} | '
            f'{r.get("baseline_hw", "—")} |')
    lines.append("")
    path.write_text("\n".join(lines))
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="latticeboltzmann_tpu_torch.bench_suite")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--quick", action="store_true", help=f"{QUICK_STEPS} steps per config")
    ap.add_argument("--out", default=None,
                    help=f"write a markdown table here (e.g. {DEFAULT_OUT}) and the rows "
                         "beside it as .jsonl")
    ap.add_argument("--only", default=None,
                    help="comma-separated 1-based config indices, e.g. 1,2,3")
    ap.add_argument("--append", action="store_true",
                    help="keep the jsonl's rows of the configs not run")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = None if args.out is None else pathlib.Path(args.out)
    if out is not None and {out.name, out.with_suffix(".jsonl").name} & set(JAX_RECORDS):
        print(f"bench_suite: {args.out} is the JAX package's record; name another file "
              f"(e.g. {DEFAULT_OUT})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_suite: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    steps = QUICK_STEPS if args.quick else args.steps
    todo = CONFIGS if args.only is None else [CONFIGS[int(i) - 1] for i in args.only.split(",")]
    card = card_info()
    rows = run_rows(todo, steps, card, emit=lambda line: print(line, flush=True))
    if args.out:
        write_table(args.out, rows, steps, card, args.append)
        print(f"wrote {args.out}")
    return 0 if all(r["sane"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

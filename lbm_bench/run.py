"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 -m lbm_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: correct, attempted, failed, metrics, device, (with
--trace 1) breakdown, and last `checks`, each number the check compared
beside its limit; the same numbers are the last lines of standard
error. --trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics, read from a torch.profiler capture of a few chunks.

Exits 2, and prints no result, without a CUDA card, with fewer cards
than the cell asks for, or when jax, jaxlib, flax or the JAX package
is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "latticeboltzmann_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def finite(x):
    """x with every number that is not finite as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("OMP_NUM_THREADS", "2")
    import torch

    from . import harness, manifest

    cell = manifest.cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lbm_bench: the cell asks for {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"lbm_bench: the run loaded {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 2
    readings = result.pop("readings")
    result.pop("window")
    checks = result.pop("checks")
    breakdown = result.pop("breakdown")
    line = dict(result)
    if args.trace and breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    if "first_nonfinite_chunk" in readings:
        print(f"check first_nonfinite_chunk: {readings['first_nonfinite_chunk']}",
              file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

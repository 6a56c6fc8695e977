"""The readings a cell's limits are set from: the program's numbers over
many seeds, the control's, and a planted fault's, in one process, at the
cell's own size.

    python3 -m lbm_bench.control --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--other-control '{"by": ..., "dtype": ...}' ...] \
        [--fault half_rows ... --fault-seeds 7,8,9] [--seconds 2] \
        [--out chiprun_out/readings.jsonl]

The control is the configuration computed one precision lower, as the
configuration file's "control" states it: {"by": "program", "dtype":
<storage>} where the program has that path of its own (a float32
configuration's control is the program with bfloat16 storage; "backend"
may name another of its backends), else {"by": "reference", "dtype":
<storage>, "arithmetic": <dtype>}, the reference (ReferenceProgram) put
in the program's place. --other-control reads another lower precision
on the same seeds. --fault plants one of faults.FAULTS in the program,
on the --fault-seeds. Each line holds every number the check works out,
those the cell compares and the others. The check is
the one every run makes; only the window is shorter (the checked chunks
are the first few), so each line holds what a run of that seed would
compare. Benchmark runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

from . import faults, harness, manifest
from .reference import d2q9


class ReferenceProgram:
    """The reference in the program's place: the entries the traffic
    drives (f, run, run_probed, reynolds), stepped by reference/d2q9 in
    `storage` with `arithmetic`."""

    def __init__(self, config, lattice, walls, device, storage: str, arithmetic: str):
        self.device = torch.device(device)
        self.storage = getattr(torch, storage)
        self.compute = getattr(torch, arithmetic)
        self.params = harness.params_of(config)
        self.walls = d2q9.walls_tensor(walls, self.device)
        self._f = d2q9.rest_state((config.nx, config.ny), config.initial_density, self.params,
                                  self.storage, self.device)

    @property
    def f(self) -> torch.Tensor:
        return self._f.clone()

    @f.setter
    def f(self, value: torch.Tensor) -> None:
        self._f = value.to(self.device).to(self.storage)

    def run(self, n_steps: int, *, block: bool = True):
        self._f, _ = d2q9.run(self._f, self.walls, self.params, n_steps, compute=self.compute)
        return self

    def run_probed(self, n_steps: int, probes, *, every: int = 1, block: bool = True):
        sites = torch.as_tensor(probes, device=self.device)
        self._f, series = d2q9.run(self._f, self.walls, self.params, n_steps,
                                   compute=self.compute, probes=sites, every=every)
        return series.float().cpu().numpy()

    def probe_values(self, probes):
        sites = torch.as_tensor(probes, device=self.device)
        return d2q9.moments(self._f[:, sites[:, 0], sites[:, 1]]).float().cpu().numpy()

    def reynolds(self) -> float:
        return d2q9.reynolds(self._f, self.walls, self.params)


def control_kwargs(config, control: dict | None = None) -> dict:
    """harness.run_cell's program= and storage= for the control that
    `control` states (the configuration's own where None)."""
    c = config.control if control is None else control
    if c["by"] == "program":
        backend = c.get("backend", config.backend)

        def program(config, lattice, walls, device):
            from latticeboltzmann_tpu_torch import Simulation

            return Simulation(lattice, walls, backend=backend, device=device)
    elif c["by"] == "reference":
        arithmetic = c.get("arithmetic", config.arithmetic)

        def program(config, lattice, walls, device):
            return ReferenceProgram(config, lattice, walls, device, c["dtype"], arithmetic)
    else:
        raise ValueError(f"a control is by 'program' or 'reference', not {c['by']!r}")
    return {"program": program, "storage": c["dtype"]}


def readings(cell, groups, seconds: float, device="cuda", emit=print) -> dict:
    """Each seed's numbers for each (kind, seeds, run_cell kwargs) group;
    the lower reading (the program's largest) and the upper (the
    smallest of each other kind) of each number."""
    out: dict = {}
    for kind, seeds, kwargs in groups:
        out[kind] = {}
        for seed in seeds:
            t0 = time.perf_counter()
            r = harness.run_cell(cell, seed, seconds, False, t0, device=device,
                                 emit=lambda s: None, **kwargs)
            nums = r["readings"]
            out[kind][seed] = nums
            emit(json.dumps({"workload": cell.workload["name"], "kind": kind, "seed": seed,
                             "storage": kwargs.get("storage", cell.config.dtype),
                             "correct": r["correct"], "numbers": nums,
                             "seconds": time.perf_counter() - t0}))
    names = sorted({n for group in out.values() for nums in group.values() for n in nums})
    summary = {n: {kind: (max if kind == "program" else min)(
        v.get(n, float("inf")) for v in group.values()) for kind, group in out.items() if group}
        for n in names}
    emit(json.dumps({"workload": cell.workload["name"], "summary": summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--other-control", action="append", default=[],
                    help="another control, as JSON, read on --control-seeds")
    ap.add_argument("--fault", choices=faults.FAULTS, action="append", default=[])
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lbm_bench.control: needs a CUDA card", file=sys.stderr)
        return 2
    lines = []

    def emit(s):
        print(s, flush=True)
        lines.append(s)

    parse = lambda s: [int(x) for x in s.split(",") if x]
    cell = manifest.cell(args.workload)
    controls = parse(args.control_seeds)
    groups = [("program", parse(args.seeds), {}),
              ("control", controls, control_kwargs(cell.config))]
    for other in args.other_control:
        c = json.loads(other)
        groups.append((f"control:{c['dtype']}:{c.get('arithmetic', '')}", controls,
                       control_kwargs(cell.config, c)))
    for fault in args.fault:
        groups.append((f"fault:{fault}", parse(args.fault_seeds),
                       {"program": faults.broken(fault)}))
    readings(cell, groups, args.seconds, emit=emit)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

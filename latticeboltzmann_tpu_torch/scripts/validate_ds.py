"""DP-class validation of the port's pair-DP ("ds64") backends at
reference scale: twin of the JAX package's scripts/validate_ds.py.

Runs the reference's default scene (a 400x2000 channel with its barrier,
geometry.channel_with_barrier) for N steps on a ds backend (cuda-ds64,
the fast tier of the CUDA kernel, by default; torch-ds64, the eager exact
tier, on request) AND on the float64 "torch" engine on the same device,
whose eager float64 steps are bitwise the golden serial-double model on
the CPU (tests/test_torch_engine.py), then compares:

- the Reynolds regression scalar (the reference's own validation metric,
  src/latticeboltzmann.c:522-547): DP-class target <= 1e-9 relative;
- the state's largest relative error;
- the total mass drift (sum of f) of each path against the initial mass.

Usage: python -m latticeboltzmann_tpu_torch.scripts.validate_ds
           [--steps 2000] [--nx 400] [--ny 2000] [--backend cuda-ds64|torch-ds64]
           [--device cuda|cpu]
Prints one JSON line (with the card's name and power limit on a card);
exits 1 if the Reynolds criterion fails, 2 without a card unless
--device cpu is given (the CUDA backends need a card there too).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# the DP-class bar on the Reynolds number (relative)
RE_RTOL = 1e-9


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="latticeboltzmann_tpu_torch.scripts.validate_ds")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=2000)
    ap.add_argument("--backend", default="cuda-ds64", choices=("cuda-ds64", "torch-ds64"),
                    help="the ds backend under test")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def validate(nx: int, ny: int, steps: int, backend: str, device: str) -> dict:
    """The comparison of one run; "reynolds_pass" is the criterion."""
    from ..core import geometry
    from ..core.spec import LatticeConfig
    from ..models.engine import Simulation

    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64)
    walls = geometry.channel_with_barrier(nx, ny)
    ds = Simulation(cfg, walls, backend=backend, device=device)
    mass0 = float(np.sum(ds.state()))
    ds.run(steps)
    st_ds = ds.state()
    re_ds = ds.reynolds()
    ref = Simulation(cfg, walls, backend="torch", device=device).run(steps)
    st_64 = ref.state()
    re_64 = ref.reynolds()
    state_rel = float(np.max(np.abs(st_ds - st_64) / np.maximum(np.abs(st_64), 1e-30)))
    re_rel = abs(re_ds - re_64) / max(abs(re_64), 1e-30)
    return {
        "scene": f"{nx}x{ny} channel_with_barrier",
        "steps": steps,
        "backend": backend,
        "device": str(ds.device),
        "reynolds_ds": re_ds,
        "reynolds_f64": re_64,
        "reynolds_rel_err": float(re_rel),
        "reynolds_pass": bool(re_rel <= RE_RTOL),
        "reynolds_rtol": RE_RTOL,
        "state_max_rel_err": state_rel,
        "mass_drift_ds": float(np.sum(st_ds)) - mass0,
        "mass_drift_f64": float(np.sum(st_64)) - mass0,
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("validate_ds: no CUDA card (torch.cuda.is_available() is False); "
              "--device cpu runs the plain backends on the CPU", file=sys.stderr)
        return 2
    out = validate(args.nx, args.ny, args.steps, args.backend, args.device)
    if on_card:
        from ..bench import card_info

        out["card"] = card_info()
    print(json.dumps(out))
    return 0 if out["reynolds_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Precision-tier accuracy on the headline scene: twin of the JAX
package's scripts/numerics_tiers.py.

Where do the float32 kernel, bf16 storage (float32 arithmetic) and the
pair-DP ("ds64") kernel sit against the float64 anchor, the "torch"
engine in float64 (bitwise the golden serial-double model on the CPU,
tests/test_torch_engine.py)? On the 800x4000 reference scene
(geometry.reference_barrier, bench.py's headline) it measures, for each
tier:

1. short-horizon tracking at steps // 20 and steps // 5 (500 and 2,000
   of the default 10,000, before the wake turns chaotic): the state's
   largest relative error, and Re at a column the flow has reached
   (column 600 at 800x4000, scaled with NY);
2. conservation at `steps`: the total-mass drift relative to the
   initial mass (the physics conserves mass; the forcing injects
   momentum, not mass);
3. a statistical wake observable: the time mean and standard deviation
   of |u|^2 at three wake probes over the last steps // 5 steps, from
   Simulation.run_probed(..., every=4) (instantaneous values are
   chaotic, the developed wake's statistics compare across precisions).
   The JAX script leaves the ds64 tier out of this part, where its
   probes went through the host; here they are gathered on the card, so
   ds64 has them too.

On the card the tiers run backends cuda (f32, bf16), cuda-ds64 and torch
(f64); with --device cpu the plain engines torch and torch-ds64 stand in
for the kernels, at a size the CPU can run (the probe sites and the Re
column scale with the lattice: their 800x4000 places times nx / 800 and
ny / 4000).

Usage: python -m latticeboltzmann_tpu_torch.scripts.numerics_tiers
           [--steps 10000] [--nx 800] [--ny 4000] [--device cuda|cpu]
Prints one JSON document (with the card's name and power limit on a
card); exits 2 without a card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# wake probes at 800x4000: downstream of the barrier (rows [20, 220) x
# columns [100, 105)), at mid-wake heights
PROBES = np.array([[60, 200], [120, 300], [180, 450]])
PROBE_EVERY = 4
# the flow-reached column of the Re comparison at 800x4000
RE_COLUMN = 600
# the lattice those places are given for
NX_REF, NY_REF = 800, 4000


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="latticeboltzmann_tpu_torch.scripts.numerics_tiers")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=4000)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def tier_backends(on_card: bool) -> dict:
    """{tier: (backend, LatticeConfig dtype)}."""
    return {
        "f32": ("cuda" if on_card else "torch", np.float32),
        "bf16": ("cuda" if on_card else "torch", "bfloat16"),
        "ds64": ("cuda-ds64" if on_card else "torch-ds64", np.float64),
        "f64": ("torch", np.float64),
    }


def measure(nx: int, ny: int, steps: int, device: str) -> dict:
    """The tiers' table; raises ValueError unless the horizons divide as
    the probe run needs."""
    from ..core import geometry
    from ..core.spec import LatticeConfig
    from ..models.engine import Simulation

    h1, h2, tail = steps // 20, steps // 5, steps // 5
    if h1 < 1 or (steps - h2) % PROBE_EVERY or tail // PROBE_EVERY < 1:
        raise ValueError(f"--steps {steps}: needs steps // 20 >= 1 and (steps - steps // 5) "
                         f"a multiple of {PROBE_EVERY}")
    col = RE_COLUMN * ny // NY_REF
    probes = PROBES * [nx, ny] // [NX_REF, NY_REF]
    walls = geometry.reference_barrier(nx, ny)

    def run_tier(backend, dtype):
        cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
        sim = Simulation(cfg, walls, backend=backend, device=device)
        mass0 = float(np.sum(np.asarray(sim.state(), np.float64)))
        sim.run(h1)
        st1 = np.asarray(sim.state(), np.float64)
        sim.run(h2 - h1)
        st2 = np.asarray(sim.state(), np.float64)
        re2 = float(sim.reynolds(col))
        series = sim.run_probed(steps - h2, probes, every=PROBE_EVERY)
        u2 = series[:, :, 1] ** 2 + series[:, :, 2] ** 2
        ntail = tail // PROBE_EVERY
        mass = float(np.sum(np.asarray(sim.state(), np.float64)))
        return {"backend": backend, "st1": st1, "st2": st2, "re2": re2,
                "mass_drift_rel": (mass - mass0) / mass0,
                "wake_mean": np.mean(u2[-ntail:], axis=0),
                "wake_std": np.std(u2[-ntail:], axis=0)}

    on_card = torch.device(device).type == "cuda"
    tiers = {name: run_tier(*spec) for name, spec in tier_backends(on_card).items()}
    anchor = tiers["f64"]

    def rel_state(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    out = {"scene": f"{nx}x{ny} reference barrier", "steps": steps, "device": device,
           "probes": probes.tolist(), "probe_every": PROBE_EVERY, "tiers": {}}
    for name, t in tiers.items():
        out["tiers"][name] = {
            "backend": t["backend"],
            f"state_rel_err_{h1}": rel_state(t["st1"], anchor["st1"]),
            f"state_rel_err_{h2}": rel_state(t["st2"], anchor["st2"]),
            f"reynolds_{h2}_col{col}": t["re2"],
            f"reynolds_rel_err_{h2}": abs(t["re2"] - anchor["re2"]) / max(abs(anchor["re2"]),
                                                                          1e-30),
            f"mass_drift_rel_{steps}": t["mass_drift_rel"],
            "wake_u2_mean": [float(x) for x in t["wake_mean"]],
            "wake_u2_std": [float(x) for x in t["wake_std"]],
        }
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("numerics_tiers: no CUDA card (torch.cuda.is_available() is False); "
              "--device cpu runs the plain engines on the CPU", file=sys.stderr)
        return 2
    out = measure(args.nx, args.ny, args.steps, args.device)
    if on_card:
        from ..bench import card_info

        out["card"] = card_info()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

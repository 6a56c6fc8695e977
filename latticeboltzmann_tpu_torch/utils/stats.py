"""Runtime metrics reporter — the reference's PrintRunStats
(src/latticeboltzmann.c:652-662) as a framework component.

Reports progress %, elapsed, ETA, lattice-updates/s (MLUPS), modeled
memory bandwidth, and modeled GFLOPs using the same traffic/FLOP models:
2 full f arrays per step + source column + walls
(src/latticeboltzmann.c:657-658) and 124 FLOP per site update
(src/latticeboltzmann.c:78-80).

A port of latticeboltzmann_tpu/utils/stats.py with the same models and
report lines.
"""

from __future__ import annotations

import dataclasses
import sys
import time

from ..core.spec import FLOP_PER_SITE, NSPEEDS, LatticeConfig
from .interop import storage_dtype


@dataclasses.dataclass
class RunStats:
    cfg: LatticeConfig
    total_steps: int
    start_time: float = dataclasses.field(default_factory=time.perf_counter)
    # sys.stdout when the reporter is made, not when this module is imported
    out: object = dataclasses.field(default_factory=lambda: sys.stdout)

    def __post_init__(self):
        self.itemsize = storage_dtype(self.cfg.dtype).itemsize

    def modeled_bytes(self, n_steps: int) -> float:
        """Reference bandwidth model (src/latticeboltzmann.c:657-658):
        per step, both f arrays touched once each plus the forced source
        column (6 speeds, touched twice per two half-steps ~ NX*6 reals)
        plus one pass over the walls mask."""
        nx, ny = self.cfg.nx, self.cfg.ny
        return (
            2.0 * n_steps * self.itemsize * nx * ny * NSPEEDS
            + 2.0 * n_steps * self.itemsize * nx * 6
            + 4.0 * nx * ny
        )

    def report(self, steps_done: int) -> str:
        elapsed = time.perf_counter() - self.start_time
        frac = steps_done / self.total_steps if self.total_steps else 1.0
        remaining = elapsed / frac * (1.0 - frac) if frac > 0 else float("inf")
        ups = steps_done / elapsed if elapsed > 0 else 0.0
        mlups = ups * self.cfg.sites / 1e6
        gbs = self.modeled_bytes(steps_done) / elapsed / 1024**3 if elapsed > 0 else 0.0
        gflops = FLOP_PER_SITE * self.cfg.sites * steps_done / elapsed / 1e9 if elapsed > 0 else 0.0
        line = (
            f"{frac * 100:5.2f}%--Elapsed: {int(elapsed) // 60:3d}m{int(elapsed) % 60:02d}s, "
            f"Remaining: {int(remaining) // 60:3d}m{int(remaining) % 60:02d}s. "
            f"[Updates/s: {ups:.3e}, MLUPS: {mlups:.1f}, "
            f"Update BW: ~{gbs:.3f} GB/s, GFLOPs: ~{gflops:.3f}]"
        )
        print(line, file=self.out, flush=True)
        return line


def final_report(cfg: LatticeConfig, runtime: float, reynolds: float) -> str:
    """The reference's closing line (src/latticeboltzmann.c:173)."""
    line = f"Runtime: {runtime:f} Re {reynolds:.10e}"
    print(line, flush=True)
    return line

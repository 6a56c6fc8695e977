r"""D2Q9 model constants and run configuration.

A copy of latticeboltzmann_tpu/core/spec.py: that module is numpy-only,
but importing it through its package loads jax. tests/test_torch_core.py
pins the two equal.

The D2Q9 velocity set follows the reference's link numbering
(src/latticeboltzmann.c:7-11, README.md:9-17):

       f6  f2  f5
         \  |  /
    x   f3--f0--f1
    ^     /  |  \
    |   f7  f4  f8
    |
     --- > y

Axis convention (same as the reference): ``x`` is the row index ``i``
(axis 0 of a field plane, size NX), ``y`` is the column index ``j``
(axis 1, size NY, the long contiguous direction). Speed 2 points +x,
speed 1 points +y.

Weights are the reference's OMEGA0/OMEGA14/OMEGA58
(src/latticeboltzmann.c:38-40); the opposite-pair table encodes its
bounce-back swaps (src/latticeboltzmann.c:246-255).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

NSPEEDS = 9

# Integer lattice vectors e_i as (e_x, e_y) rows, indexed by speed.
E = np.array(
    [
        [0, 0],   # f0: rest
        [0, 1],   # f1: +y
        [1, 0],   # f2: +x
        [0, -1],  # f3: -y
        [-1, 0],  # f4: -x
        [1, 1],   # f5: +x +y
        [1, -1],  # f6: +x -y
        [-1, -1], # f7: -x -y
        [-1, 1],  # f8: -x +y
    ],
    dtype=np.int32,
)

# BGK equilibrium weights (src/latticeboltzmann.c:38-40).
W0 = 4.0 / 9.0
W14 = 1.0 / 9.0
W58 = 1.0 / 36.0
W = np.array([W0, W14, W14, W14, W14, W58, W58, W58, W58], dtype=np.float64)

# OPPOSITE[s] is the speed pointing exactly backwards from s; bounce-back
# writes f_s := pulled f_{OPPOSITE[s]} (src/latticeboltzmann.c:246-255).
OPPOSITE = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Specular-reflection ("slip") tables: REFLECT_X[s] is the speed with
# e_x mirrored (wall plane normal to x — the channel walls); REFLECT_Y
# mirrors e_y. The reference names this "reflect" as a concept but never
# implements it (src/latticeboltzmann.c:21); here it is a first-class BC.
# Slip preserves tangential momentum (free-slip wall), unlike bounce-back
# (no-slip).
REFLECT_X = np.array([0, 1, 4, 3, 2, 8, 7, 6, 5], dtype=np.int32)
REFLECT_Y = np.array([0, 3, 2, 1, 4, 6, 5, 8, 7], dtype=np.int32)

# Speed groups entering the velocity moments (src/latticeboltzmann.c:263-266):
# u_x numerator: +(f6+f2+f5) - (f7+f4+f8); u_y: +(f5+f1+f8) - (f6+f3+f7).
POS_X = (6, 2, 5)
NEG_X = (7, 4, 8)
POS_Y = (5, 1, 8)
NEG_Y = (6, 3, 7)


@dataclasses.dataclass(frozen=True)
class LatticeConfig:
    """Runtime equivalent of the reference's compile-time knob block
    (src/latticeboltzmann.c:36-56). Frozen and hashable, so kernels can
    take its fields as launch constants.
    """

    nx: int = 400
    ny: int = 2000
    tau: float = 0.7
    csq: float = 1.0
    accel: float = 0.005
    initial_density: float = 0.1
    wraparound: bool = True  # periodic BCs; the reference hard-codes 1 (:43)
    dtype: Any = np.float32

    def __post_init__(self):
        if not self.wraparound:
            raise NotImplementedError(
                "Only periodic (wraparound) boundaries are implemented, "
                "matching the reference (src/latticeboltzmann.c:43)."
            )
        if self.nx < 2 or self.ny < 2:
            raise ValueError("lattice must be at least 2x2")

    @property
    def itau(self) -> float:
        return 1.0 / self.tau

    @property
    def viscosity(self) -> float:
        # nu = (1/3) (tau - 1/2)  (src/latticeboltzmann.c:544)
        return (1.0 / 3.0) * (self.tau - 0.5)

    @property
    def sites(self) -> int:
        return self.nx * self.ny

    def equilibrium_rest(self) -> np.ndarray:
        """Per-speed distribution of a fluid at rest with the configured
        density — the reference's initial fill (src/latticeboltzmann.c:583-591).
        """
        return (self.initial_density * W).astype(self.dtype)


# ~124 FLOP per lattice-point update, the reference's hand count used in its
# GFLOPs self-report (src/latticeboltzmann.c:78-80).
FLOP_PER_SITE = 124.0


def bytes_per_site_update(dtype) -> int:
    """Minimum HBM traffic per site update for a single-pass fused
    stream+collide: 9 plane reads + 9 plane writes."""
    itemsize = np.dtype(dtype).itemsize
    return 2 * NSPEEDS * itemsize

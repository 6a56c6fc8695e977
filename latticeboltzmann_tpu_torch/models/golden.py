"""Golden NumPy model: the port's float64 test oracle.

The port's own copy of latticeboltzmann_tpu/models/golden.py, function
for function, with the same association order and slip handling; that
module is numpy-only, but importing it through its package loads jax.
It imports numpy and the port's core/spec.py, and no torch: it is a
host oracle. tests/test_torch_golden.py holds every function bitwise to
the original.

A slow, transparent float64 NumPy implementation that reproduces the
semantics of the reference's *serial double-precision* build
(src/latticeboltzmann.c built with prec_double_serial.h) operation for
operation, with the exact floating-point association order of the scalar
StreamCollide kernel (src/latticeboltzmann.c:216-302). The port's eager
float64 engine (ops/stream_collide.py) is bitwise equal to it on the CPU.

Semantics notes (vs. the C code):

* Single functional state. The C code ping-pongs two buffers and, on
  wall sites, never writes speed 0 to the destination
  (src/latticeboltzmann.c:246-255 writes only speeds 1..8), so each
  buffer's wall-site f0 keeps its *initial* value forever. Here a step
  is a pure function f -> f', and wall-site f0 passes through from the
  source. Because wall f0 is time-invariant in both formulations and is
  never read by any physics (neighbors pull only speeds 1..8 from wall
  sites; f0 is pulled from a site's own plane), the state at every
  *even* step is bitwise identical to the C code's fA buffer.

* Association order is pinned to the scalar kernel: density is the
  strict left-to-right sum f0..f8 (:258-261), u numerators group as
  ((a+b)+c) - ((d+e)+g) (:263-266), and feq terms accumulate as
  ((1 + 3u/c^2) + ((4.5*u)*u)/c^2/c^2) - (1.5*u.u)/c^2 (:283-291).

* Relaxation uses 1/tau (:295). In the double build the C quirk of the
  double literal (1.0/TAU) is the native precision, so there is no
  vector/scalar discrepancy to model at float64.
"""

from __future__ import annotations

import numpy as np

from ..core.spec import E, NSPEEDS, OPPOSITE, REFLECT_X, REFLECT_Y, W, LatticeConfig


def initial_state(cfg: LatticeConfig, dtype=np.float64) -> np.ndarray:
    """Uniform rest equilibrium: f_s = initial_density * w_s everywhere
    (src/latticeboltzmann.c:583-591)."""
    f = np.empty((NSPEEDS, cfg.nx, cfg.ny), dtype=dtype)
    rho = np.asarray(cfg.initial_density, dtype=dtype)
    for s in range(NSPEEDS):
        f[s] = rho * np.asarray(W[s], dtype=dtype)
    return f


def apply_source(f: np.ndarray, walls: np.ndarray, cfg: LatticeConfig) -> np.ndarray:
    """Channel forcing on column j=0 (src/latticeboltzmann.c:489-518):
    on non-wall sites, add accel*w to the three +y speeds (5,1,8) and
    subtract from the three -y speeds (6,3,7), but only where all three
    decremented values stay strictly positive (f >= 0 invariant)."""
    dtype = f.dtype.type
    a14 = dtype(cfg.accel) * dtype(W[1])
    a58 = dtype(cfg.accel) * dtype(W[5])
    col = f[:, :, 0]
    ok = (
        (~walls[:, 0])
        & (col[6] - a58 > 0)
        & (col[3] - a14 > 0)
        & (col[7] - a58 > 0)
    )
    out = f.copy()
    out[6, :, 0] = np.where(ok, col[6] - a58, col[6])
    out[3, :, 0] = np.where(ok, col[3] - a14, col[3])
    out[7, :, 0] = np.where(ok, col[7] - a58, col[7])
    out[5, :, 0] = np.where(ok, col[5] + a58, col[5])
    out[1, :, 0] = np.where(ok, col[1] + a14, col[1])
    out[8, :, 0] = np.where(ok, col[8] + a58, col[8])
    return out


def pull(f: np.ndarray) -> np.ndarray:
    """Pull-scheme streaming gather with periodic wrap on both axes
    (src/latticeboltzmann.c:230-243): pulled_s(i,j) = f_s(i-e_x, j-e_y)."""
    pulled = np.empty_like(f)
    for s in range(NSPEEDS):
        ex, ey = int(E[s, 0]), int(E[s, 1])
        pulled[s] = np.roll(f[s], shift=(ex, ey), axis=(0, 1))
    return pulled


def collide(pulled: np.ndarray, cfg: LatticeConfig) -> np.ndarray:
    """BGK collision on pulled distributions, scalar-kernel association
    order (src/latticeboltzmann.c:258-296)."""
    dtype = pulled.dtype.type
    one = dtype(1.0)
    three = dtype(3.0)
    threeotwo = dtype(3.0) / dtype(2.0)
    nineotwo = dtype(9.0) / dtype(2.0)
    csq = dtype(cfg.csq)
    itau = one / dtype(cfg.tau)
    w = [dtype(W[s]) for s in range(NSPEEDS)]

    ft = pulled
    # density: strict left-to-right sum (:258-261)
    density = ft[0]
    for s in range(1, NSPEEDS):
        density = density + ft[s]

    u_x = ((ft[6] + ft[2]) + ft[5] - ((ft[7] + ft[4]) + ft[8])) / density
    u_y = ((ft[5] + ft[1]) + ft[8] - ((ft[6] + ft[3]) + ft[7])) / density
    u_dot_u = u_x * u_x + u_y * u_y

    u = [None] * NSPEEDS
    u[1] = +u_y
    u[2] = +u_x
    u[3] = -u_y
    u[4] = -u_x
    u[5] = u_x + u_y
    u[6] = u_x - u_y
    u[7] = -u_x - u_y
    u[8] = -u_x + u_y

    fequ = [None] * NSPEEDS
    fequ[0] = w[0] * density * (one - threeotwo * u_dot_u / csq)
    for s in range(1, NSPEEDS):
        fequ[s] = (
            w[s]
            * density
            * (one + three * u[s] / csq + nineotwo * u[s] * u[s] / csq / csq
               - threeotwo * u_dot_u / csq)
        )

    out = np.empty_like(ft)
    for s in range(NSPEEDS):
        out[s] = ft[s] + itau * (fequ[s] - ft[s])
    return out


def stream_collide(
    f: np.ndarray,
    walls: np.ndarray,
    cfg: LatticeConfig,
    slip_x: np.ndarray | None = None,
    slip_y: np.ndarray | None = None,
) -> np.ndarray:
    """One fused stream+collide step: pull, then bounce-back on wall
    sites / BGK relax on fluid sites (src/latticeboltzmann.c:216-302).
    Wall-site f0 passes through (see module docstring).

    slip_x / slip_y are optional masks of free-slip (specular-reflection)
    solid sites whose wall plane is normal to x / y — the "reflect" BC the
    reference names but never implements (src/latticeboltzmann.c:21).
    Precedence on overlap: walls > slip_x > slip_y.
    """
    pulled = pull(f)
    relaxed = collide(pulled, cfg)
    out = np.empty_like(f)
    for s in range(NSPEEDS):
        val = relaxed[s]
        if slip_y is not None:
            val = np.where(slip_y, pulled[REFLECT_Y[s]], val)
        if slip_x is not None:
            val = np.where(slip_x, pulled[REFLECT_X[s]], val)
        out[s] = np.where(walls, pulled[OPPOSITE[s]], val)
    # speed 0: pulled[OPPOSITE[0]] == pulled[0] == own f0, i.e. passthrough.
    return out


def step(
    f: np.ndarray,
    walls: np.ndarray,
    cfg: LatticeConfig,
    slip_x: np.ndarray | None = None,
    slip_y: np.ndarray | None = None,
) -> np.ndarray:
    """One full timestep = ApplySource then StreamCollide
    (src/latticeboltzmann.c:192-198). Slip sites are solid for forcing
    purposes too, so the source skips them like walls."""
    solid = walls
    if slip_x is not None:
        solid = solid | slip_x
    if slip_y is not None:
        solid = solid | slip_y
    return stream_collide(apply_source(f, solid, cfg), walls, cfg, slip_x, slip_y)


def run(
    f: np.ndarray,
    walls: np.ndarray,
    cfg: LatticeConfig,
    n_steps: int,
    slip_x: np.ndarray | None = None,
    slip_y: np.ndarray | None = None,
) -> np.ndarray:
    for _ in range(n_steps):
        f = step(f, walls, cfg, slip_x, slip_y)
    return f


def macroscopic(f: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Density and velocity fields, PrintLattice association order
    (src/latticeboltzmann.c:620-631)."""
    density = f[0]
    for s in range(1, NSPEEDS):
        density = density + f[s]
    u_x = ((f[6] + f[2]) + f[5] - ((f[7] + f[4]) + f[8])) / density
    u_y = ((f[5] + f[1]) + f[8] - ((f[6] + f[3]) + f[7])) / density
    return density, u_x, u_y


def reynolds(f: np.ndarray, walls: np.ndarray, cfg: LatticeConfig) -> float:
    """Reynolds number over the central column (src/latticeboltzmann.c:522-547):
    mean u_y of non-wall sites at j=NY/2, times characteristic length 10,
    over nu = (tau - 1/2)/3."""
    j = int(cfg.ny / 2.0)
    col = f[:, :, j]  # (9, NX)
    fluid = ~walls[:, j]
    density = col[0]
    for s in range(1, NSPEEDS):
        density = density + col[s]
    u_y = ((col[5] + col[1]) + col[8] - ((col[6] + col[3]) + col[7])) / density
    # strict sequential accumulation over i, like the C loop
    total = 0.0
    for v in u_y[fluid]:
        total += float(v)
    n = int(fluid.sum())
    return total / n * 10.0 / cfg.viscosity

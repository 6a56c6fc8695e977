"""Fused stream+collide and forcing as plain PyTorch ops: the portable
engine, twin of latticeboltzmann_tpu/ops/stream_collide.py.

Nine `torch.roll` pulls, BGK collision and a branchless masked
bounce-back, device-agnostic. The arithmetic keeps the reference's
scalar-kernel association order (src/latticeboltzmann.c:216-302) and
uses only plain binary ops (no addcmul, lerp or compilation, which
fuse), so eager float64 runs are bitwise-equal to the golden oracle
(latticeboltzmann_tpu/models/golden.py).

Every divisor is a tensor on the state's device, never a Python scalar:
PyTorch's CUDA division by a host scalar multiplies by its reciprocal,
which rounds differently.

bfloat16 is a storage precision, as in the JAX engine
(latticeboltzmann_tpu/ops/stream_collide.py:25-33): the forcing runs in
float32 and rounds the forced column back to bf16 before the pull; the
pulled planes go up to float32, and the step's result is rounded once.

The hand-written CUDA kernel (ops/fused_kernel.py) is the performance
path; this module is the semantics anchor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import E, NSPEEDS, OPPOSITE, REFLECT_X, REFLECT_Y, W, LatticeConfig
from ..utils.interop import compute_dtype


def _np_dtype(cfg: LatticeConfig):
    """Compute precision as a numpy scalar type (float32 for bf16
    storage): the constants below are rounded to it on the host, exactly
    as the JAX engine rounds them. Raises on what the port does not
    take."""
    return np.float64 if compute_dtype(cfg.dtype) == torch.float64 else np.float32


def _full(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=like.dtype, device=like.device)


def apply_source(f: torch.Tensor, walls: torch.Tensor, cfg: LatticeConfig) -> torch.Tensor:
    """Channel forcing on column j=0 (src/latticeboltzmann.c:489-518).

    walls: (NX, NY) bool. Adds accel*w to speeds (5,1,8), subtracts from
    (6,3,7) on fluid sites where all three decrements stay > 0. Guard
    and increments run in the compute dtype; the forced column is
    rounded back to the storage dtype. Returns a new tensor."""
    dt = _np_dtype(cfg)
    a14 = float(dt(cfg.accel) * dt(W[1]))
    a58 = float(dt(cfg.accel) * dt(W[5]))
    col = f[:, :, 0].to(compute_dtype(cfg.dtype))  # (9, NX)
    ok = (
        (~walls[:, 0])
        & (col[6] - a58 > 0)
        & (col[3] - a14 > 0)
        & (col[7] - a58 > 0)
    )
    # per-speed signed increments: +y speeds gain, -y speeds lose
    delta = np.zeros((NSPEEDS,), dtype=dt)
    delta[[5, 8]] = a58
    delta[1] = a14
    delta[[6, 7]] = -a58
    delta[3] = -a14
    delta_t = torch.as_tensor(delta, device=f.device)
    out = f.clone()
    out[:, :, 0] = torch.where(ok[None, :], col + delta_t[:, None], col).to(f.dtype)
    return out


def pull(f: torch.Tensor) -> torch.Tensor:
    """Periodic pull gather: pulled_s(i,j) = f_s(i-e_x, j-e_y)
    (src/latticeboltzmann.c:230-243); the shifts of jnp.roll in the JAX
    engine."""
    planes = [
        torch.roll(f[s], shifts=(int(E[s, 0]), int(E[s, 1])), dims=(0, 1))
        for s in range(NSPEEDS)
    ]
    return torch.stack(planes)


def collide(pulled: torch.Tensor, cfg: LatticeConfig) -> torch.Tensor:
    """BGK collision, scalar-kernel association order
    (src/latticeboltzmann.c:258-296). `pulled` must already be in the
    compute dtype (stream_collide casts bf16 storage up to float32)."""
    dt = _np_dtype(cfg)
    ft = pulled
    one = float(dt(1.0))
    three = float(dt(3.0))
    threeotwo = float(dt(1.5))
    nineotwo = float(dt(4.5))
    csq = _full(float(dt(cfg.csq)), ft)
    itau = float(dt(1.0) / dt(cfg.tau))
    w = [float(dt(W[s])) for s in range(NSPEEDS)]

    density = ft[0]
    for s in range(1, NSPEEDS):
        density = density + ft[s]

    u_x = ((ft[6] + ft[2]) + ft[5] - ((ft[7] + ft[4]) + ft[8])) / density
    u_y = ((ft[5] + ft[1]) + ft[8] - ((ft[6] + ft[3]) + ft[7])) / density
    u_dot_u = u_x * u_x + u_y * u_y

    u = [None, u_y, u_x, -u_y, -u_x, u_x + u_y, u_x - u_y, -u_x - u_y, -u_x + u_y]

    uterm = threeotwo * u_dot_u / csq
    fequ0 = w[0] * density * (one - uterm)
    out = [ft[0] + itau * (fequ0 - ft[0])]
    for s in range(1, NSPEEDS):
        fequ = w[s] * density * (
            one + three * u[s] / csq + nineotwo * u[s] * u[s] / csq / csq - uterm
        )
        out.append(ft[s] + itau * (fequ - ft[s]))
    return torch.stack(out)


def _gather(pulled: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    return pulled[[int(k) for k in table]]


def stream_collide(
    f: torch.Tensor,
    walls: torch.Tensor,
    cfg: LatticeConfig,
    slip_x: torch.Tensor | None = None,
    slip_y: torch.Tensor | None = None,
) -> torch.Tensor:
    """One fused step on the full lattice: pull, BGK relax on fluid,
    bounce-back swap on walls, wall f0 passthrough
    (src/latticeboltzmann.c:216-302).

    slip_x / slip_y: optional masks of free-slip (specular-reflection)
    solid sites with wall plane normal to x / y. Precedence on overlap:
    walls > slip_x > slip_y.

    With bf16 storage the step computes in float32 and rounds once on
    return; the selected pulled values are bf16 values already, so the
    rounding leaves the wall sites exact."""
    pulled = pull(f).to(compute_dtype(cfg.dtype))
    out = collide(pulled, cfg)
    if slip_y is not None:
        out = torch.where(slip_y[None, :, :], _gather(pulled, REFLECT_Y), out)
    if slip_x is not None:
        out = torch.where(slip_x[None, :, :], _gather(pulled, REFLECT_X), out)
    return torch.where(walls[None, :, :], _gather(pulled, OPPOSITE), out).to(f.dtype)


def step(
    f: torch.Tensor,
    walls: torch.Tensor,
    cfg: LatticeConfig,
    slip_x: torch.Tensor | None = None,
    slip_y: torch.Tensor | None = None,
) -> torch.Tensor:
    """One timestep: ApplySource then StreamCollide
    (src/latticeboltzmann.c:192-198). Slip sites are solid for the
    forcing too, so the source skips them like walls."""
    solid = walls
    if slip_x is not None:
        solid = solid | slip_x
    if slip_y is not None:
        solid = solid | slip_y
    return stream_collide(apply_source(f, solid, cfg), walls, cfg, slip_x, slip_y)


def run_steps(
    f: torch.Tensor,
    walls: torch.Tensor,
    cfg: LatticeConfig,
    n_steps: int,
    slip_x: torch.Tensor | None = None,
    slip_y: torch.Tensor | None = None,
) -> torch.Tensor:
    """n_steps timesteps as a Python loop (the JAX engine's jit(scan));
    each step returns a new tensor, so `f` itself is left unchanged."""
    for _ in range(n_steps):
        f = step(f, walls, cfg, slip_x, slip_y)
    return f


def probe_moments(cols: torch.Tensor) -> torch.Tensor:
    """(rho, u_x, u_y) from gathered per-site distribution columns
    (9, P) -> (P, 3), accumulated in at least float32."""
    cols = cols.to(torch.promote_types(cols.dtype, torch.float32))
    density = cols[0]
    for s in range(1, NSPEEDS):
        density = density + cols[s]
    u_x = ((cols[6] + cols[2]) + cols[5] - ((cols[7] + cols[4]) + cols[8])) / density
    u_y = ((cols[5] + cols[1]) + cols[8] - ((cols[6] + cols[3]) + cols[7])) / density
    return torch.stack([density, u_x, u_y], dim=-1)


def probe_values(f: torch.Tensor, probes) -> torch.Tensor:
    """(rho, u_x, u_y) at probe sites. probes: (P, 2) integer (i, j),
    a tensor or an array. Returns (P, 3)."""
    probes = torch.as_tensor(probes, device=f.device).long()
    return probe_moments(f[:, probes[:, 0], probes[:, 1]])


def moment_dtype(storage: torch.dtype) -> torch.dtype:
    """The dtype probe_moments returns for a storage dtype: at least
    float32."""
    return torch.promote_types(storage, torch.float32)


def probe_sites(probes, cfg: LatticeConfig, device) -> torch.Tensor:
    """(P, 2) probe sites (i, j) as an int64 tensor on `device`. Raises
    ValueError unless they are (P, 2) and inside the lattice: a device
    gather out of range is a fault on a card, where the JAX gather
    clamps."""
    sites = np.asarray(probes.cpu() if torch.is_tensor(probes) else probes)
    if sites.ndim != 2 or sites.shape[1] != 2:
        raise ValueError(f"probes must be (P, 2) (i, j) sites, got {sites.shape}")
    if not np.issubdtype(sites.dtype, np.integer):
        raise ValueError(f"probe sites must be integers, got {sites.dtype}")
    inside = (sites >= 0) & (sites < np.array([cfg.nx, cfg.ny]))
    if not inside.all():
        raise ValueError(f"probe sites outside the {cfg.nx}x{cfg.ny} lattice: "
                         f"{sites[~inside.all(axis=1)].tolist()}")
    return torch.as_tensor(sites, dtype=torch.int64, device=device)


def sample_every(n_steps: int, every: int, n_probes: int, dtype: torch.dtype, device,
                 advance, gather) -> torch.Tensor:
    """The loop of every probed run: advance(every), then series[k] =
    gather() (a (P, 3) tensor), n_steps // every times, into a (n_steps //
    every, P, 3) series of `dtype` preallocated on `device`. No host sync.
    Raises ValueError, before any step, unless `every` divides n_steps."""
    if every < 1 or n_steps % every:
        raise ValueError(f"n_steps={n_steps} not divisible by every={every}")
    series = torch.empty((n_steps // every, n_probes, 3), dtype=dtype, device=device)
    for k in range(n_steps // every):
        advance(every)
        series[k] = gather()
    return series


def run_steps_probed(
    f: torch.Tensor,
    walls: torch.Tensor,
    cfg: LatticeConfig,
    n_steps: int,
    probes,
    slip_x: torch.Tensor | None = None,
    slip_y: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """run_steps plus (rho, u_x, u_y) at the probe sites after every
    step: (f, series), series (n_steps, P, 3) of moment_dtype, written
    row by row into a tensor preallocated on f's device, with no host
    sync (the JAX engine's jit(scan) that emits the probe gather)."""
    sites = probe_sites(probes, cfg, f.device)

    def advance(n):
        nonlocal f
        f = run_steps(f, walls, cfg, n, slip_x, slip_y)

    series = sample_every(n_steps, 1, len(sites), moment_dtype(f.dtype), f.device, advance,
                          lambda: probe_values(f, sites))
    return f, series


def macroscopic(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rho, u_x, u_y fields (src/latticeboltzmann.c:620-631)."""
    density = f[0]
    for s in range(1, NSPEEDS):
        density = density + f[s]
    u_x = ((f[6] + f[2]) + f[5] - ((f[7] + f[4]) + f[8])) / density
    u_y = ((f[5] + f[1]) + f[8] - ((f[6] + f[3]) + f[7])) / density
    return density, u_x, u_y


def reynolds(
    f: torch.Tensor, walls: torch.Tensor, cfg: LatticeConfig, col: int | None = None
) -> torch.Tensor:
    """Reynolds number over a column, default the central one
    (src/latticeboltzmann.c:522-547), accumulated in at least float32.
    Returns a 0-dim tensor on f's device."""
    j = int(cfg.ny / 2.0) if col is None else col
    dt = torch.promote_types(f.dtype, torch.float32)
    col_f = f[:, :, j].to(dt)
    fluid = ~walls[:, j]
    density = col_f[0]
    for s in range(1, NSPEEDS):
        density = density + col_f[s]
    u_y = ((col_f[5] + col_f[1]) + col_f[8] - ((col_f[6] + col_f[3]) + col_f[7])) / density
    total = torch.sum(torch.where(fluid, u_y, torch.zeros((), dtype=dt, device=f.device)))
    n = torch.sum(fluid).to(dt)
    return total / n * 10.0 / _full(cfg.viscosity, total)

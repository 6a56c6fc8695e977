"""The plain reference of every configuration: a D2Q9 BGK lattice in
plain PyTorch, written from the upstream C code's semantics
(jodavies/latticeboltzmann src/latticeboltzmann.c: ApplySource :489-518,
StreamCollide :216-302, the Reynolds number :522-547) in its scalar
association order.

It imports torch and numpy only: nothing of the program under test and
nothing of the JAX package. A state is stored in `storage` (the
configuration's storage dtype: float32, bfloat16, or a lower one for the
control) and computed in `compute` (float32 unless said): the planes go
up to `compute` (exactly), the forcing, pull and collision of a step run
in `compute`, and the step's result is rounded once to `storage`. (The
upstream writes the forced column back to its state before the pull; in
its precisions, float32 and float64, storage and arithmetic agree and
that is the same thing. With a narrower storage, rounding the forced
column there would round twice a step, the forcing's increment of a
few bf16 ulps on its own.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NSPEEDS = 9
# lattice vectors (e_x, e_y) by speed; x is the row index i, y the column j
E = ((0, 0), (0, 1), (1, 0), (0, -1), (-1, 0), (1, 1), (1, -1), (-1, -1), (-1, 1))
W = (4.0 / 9.0,) + (1.0 / 9.0,) * 4 + (1.0 / 36.0,) * 4
# bounce-back: the speed pointing back along s
OPPOSITE = (0, 3, 4, 1, 2, 7, 8, 5, 6)


@dataclasses.dataclass(frozen=True)
class Params:
    """The physical constants of a run (src/latticeboltzmann.c:36-56)."""

    tau: float = 0.7
    csq: float = 1.0
    accel: float = 0.005
    initial_density: float = 0.1

    @property
    def viscosity(self) -> float:
        return (self.tau - 0.5) / 3.0


def _scalar(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as a Python float (exact in float64)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def apply_source(f: torch.Tensor, walls: torch.Tensor, p: Params,
                 compute: torch.dtype) -> torch.Tensor:
    """Channel forcing on column 0 (:489-518): on fluid sites where the
    three -y speeds stay positive, +accel*w to speeds 5, 1, 8 and
    -accel*w from 6, 3, 7. Returns the forced column, (9, NX) in
    `compute`."""
    a14 = _scalar(_scalar(p.accel, compute) * _scalar(W[1], compute), compute)
    a58 = _scalar(_scalar(p.accel, compute) * _scalar(W[5], compute), compute)
    col = f[:, :, 0].to(compute)
    ok = (~walls[:, 0]) & (col[6] - a58 > 0) & (col[3] - a14 > 0) & (col[7] - a58 > 0)
    new = col.clone()
    for s, d in ((6, -a58), (3, -a14), (7, -a58), (5, a58), (1, a14), (8, a58)):
        new[s] = torch.where(ok, col[s] + d, col[s])
    return new


def _wrapped(n: int, d: int) -> list[tuple[slice, slice]]:
    """(destination, source) slices of out[k] = x[(k - d) mod n], d in
    -1, 0, 1."""
    if d == 0:
        return [(slice(0, n), slice(0, n))]
    if d == 1:
        return [(slice(1, n), slice(0, n - 1)), (slice(0, 1), slice(n - 1, n))]
    return [(slice(0, n - 1), slice(1, n)), (slice(n - 1, n), slice(0, 1))]


def pull(f: torch.Tensor, column0: torch.Tensor | None = None,
         compute: torch.dtype | None = None) -> torch.Tensor:
    """Periodic pull (:230-243): pulled_s(i, j) = f_s(i - e_x, j - e_y),
    in `compute` (f's dtype unless given), with column0 (9, NX) in place
    of f's column 0 where given."""
    nx, ny = f.shape[1:]
    out = torch.empty(f.shape, dtype=compute or f.dtype, device=f.device)
    for s, (dx, dy) in enumerate(E):
        for di, si in _wrapped(nx, dx):
            for dj, sj in _wrapped(ny, dy):
                out[s, di, dj] = f[s, si, sj]
        if column0 is not None:
            out[s, :, dy % ny] = torch.roll(column0[s].to(out.dtype), dx, 0)
    return out


def collide(ft: torch.Tensor, p: Params) -> torch.Tensor:
    """BGK relaxation of pulled planes in their own dtype, the scalar
    kernel's association order (:258-296). Speeds s and OPPOSITE[s] have
    opposite velocities, so 3u/csq only changes sign between them and
    4.5uu/csq/csq not at all: each is formed once a pair, and w*rho once
    a weight, with the same roundings as the scalar kernel's. A division
    by csq = 1 is left out (exact)."""
    dt = ft.dtype
    one, three = _scalar(1.0, dt), _scalar(3.0, dt)
    threeotwo, nineotwo = _scalar(1.5, dt), _scalar(4.5, dt)
    csq = _scalar(p.csq, dt)
    div = (lambda x: x) if csq == 1.0 else (lambda x: x / csq)
    itau = _scalar(1.0 / _scalar(p.tau, dt), dt)
    density = ft[0]
    for s in range(1, NSPEEDS):
        density = density + ft[s]
    u_x = ((ft[6] + ft[2]) + ft[5] - ((ft[7] + ft[4]) + ft[8])) / density
    u_y = ((ft[5] + ft[1]) + ft[8] - ((ft[6] + ft[3]) + ft[7])) / density
    u_dot_u = u_x * u_x + u_y * u_y
    uterm = div(threeotwo * u_dot_u)
    w_rho = {w: _scalar(w, dt) * density for w in sorted(set(W))}
    out = torch.empty_like(ft)
    out[0] = ft[0] + itau * (w_rho[W[0]] * (one - uterm) - ft[0])
    for s, u in ((1, u_y), (2, u_x), (5, u_x + u_y), (6, u_x - u_y)):
        a = div(three * u)
        b = div(div(nineotwo * u * u))
        for t, one_a in ((s, one + a), (OPPOSITE[s], one - a)):
            fequ = w_rho[W[t]] * ((one_a + b) - uterm)
            out[t] = ft[t] + itau * (fequ - ft[t])
    return out


def step(f: torch.Tensor, walls: torch.Tensor, p: Params,
         compute: torch.dtype = torch.float32, wall_sites=None) -> torch.Tensor:
    """One step (:192-198): forcing, pull, BGK on fluid sites and
    bounce-back on walls (a wall's f0 passes through); the result in
    f's dtype. `wall_sites` is walls.nonzero(as_tuple=True), where the
    caller has it."""
    pulled = pull(f, apply_source(f, walls, p, compute), compute)
    out = collide(pulled, p)
    wi, wj = walls.nonzero(as_tuple=True) if wall_sites is None else wall_sites
    out[:, wi, wj] = pulled[:, wi, wj][list(OPPOSITE)]
    return out.to(f.dtype)


def moments(cols: torch.Tensor) -> torch.Tensor:
    """(rho, u_x, u_y) of (9, P) distribution columns as (P, 3), in
    float64."""
    c = cols.to(torch.float64)
    density = c[0]
    for s in range(1, NSPEEDS):
        density = density + c[s]
    u_x = ((c[6] + c[2]) + c[5] - ((c[7] + c[4]) + c[8])) / density
    u_y = ((c[5] + c[1]) + c[8] - ((c[6] + c[3]) + c[7])) / density
    return torch.stack([density, u_x, u_y], dim=-1)


def run(f: torch.Tensor, walls: torch.Tensor, p: Params, n_steps: int, *,
        compute: torch.dtype = torch.float32, probes: torch.Tensor | None = None,
        every: int = 1) -> tuple[torch.Tensor, torch.Tensor | None]:
    """n_steps steps from f; with (P, 2) probe sites also their moments
    after every `every` steps, as a (n_steps // every, P, 3) float64
    series."""
    series = []
    wall_sites = walls.nonzero(as_tuple=True)
    for k in range(1, n_steps + 1):
        f = step(f, walls, p, compute, wall_sites)
        if probes is not None and k % every == 0:
            series.append(moments(f[:, probes[:, 0], probes[:, 1]]))
    return f, (torch.stack(series) if probes is not None else None)


def reynolds(f: torch.Tensor, walls: torch.Tensor, p: Params) -> float:
    """Re over the central column (:522-547): the mean u_y of its fluid
    sites times 10 over the viscosity, summed in float64."""
    j = int(f.shape[2] / 2.0)
    u_y = moments(f[:, :, j])[:, 2][~walls[:, j]]
    return float(u_y.mean()) * 10.0 / p.viscosity


def speed_scale(f: torch.Tensor, walls: torch.Tensor, p: Params) -> float:
    """Re's scale over the whole lattice: the mean |u_y| of every fluid
    site times 10 over the viscosity (float32 sums, a plane at a time)."""
    c = lambda s: f[s].float()
    u_y = ((c(5) + c(1)) + c(8) - ((c(6) + c(3)) + c(7))) / sum(c(s) for s in range(NSPEEDS))
    return float(u_y.abs()[~walls].double().mean()) * 10.0 / p.viscosity


def rest_state(shape: tuple[int, int], density: torch.Tensor | float, p: Params,
               dtype: torch.dtype, device) -> torch.Tensor:
    """f_s = rho * w_s (the rest equilibrium, :583-591) for a density
    field or a number, in float32 and then rounded to `dtype`."""
    w = torch.tensor(W, dtype=torch.float32, device=device)[:, None, None]
    rho = torch.as_tensor(density, dtype=torch.float32, device=device)
    return (w * rho.expand(shape)[None]).to(dtype)


def flops_per_site() -> int:
    """Additions, subtractions, multiplications and divisions of one
    fluid site's update in `collide` above at csq = 1 (negations not
    counted): density 8; u_x, u_y 6 each; u.u 3; uterm 1; w*rho 3 (one a
    weight); f0's equilibrium 2 and relaxation 3; the diagonal u 2; each
    of the 4 pairs' 3u 1 and 4.5uu 2; each of speeds 1-8 an equilibrium
    of 4 and a relaxation of 3. The least work of a site update, so a
    share of the float32 peak counted with it never overstates.
    tests/test_lbm_bench_roofline.py counts the operations collide runs
    and holds them to this."""
    return 8 + 6 + 6 + 3 + 1 + 3 + 2 + 3 + 2 + 4 * 3 + 8 * (4 + 3)


def walls_tensor(walls: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(walls, dtype=bool), device=device)

"""The plain reference: its step, which saves memory passes, against a
direct transcription of the upstream C code (below), bit for bit; and
the scene the benchmark hands to both sides against the upstream's."""

import numpy as np
import pytest
import torch

from lbm_bench import generator
from lbm_bench.reference import d2q9, scene

# the upstream scene: channel walls and the 200x5 plate
# (src/latticeboltzmann.c:567-578)
UPSTREAM = {"edges": True, "blocks": [[20, 220, 100, 105]]}


def direct_apply_source(f: torch.Tensor, walls: torch.Tensor, p: d2q9.Params,
                 compute: torch.dtype) -> torch.Tensor:
    """Channel forcing on column 0 (:489-518): on fluid sites where the
    three -y speeds stay positive, +accel*w to speeds 5, 1, 8 and
    -accel*w from 6, 3, 7. Returns a new state of f's dtype."""
    a14 = d2q9._scalar(d2q9._scalar(p.accel, compute) * d2q9._scalar(d2q9.W[1], compute), compute)
    a58 = d2q9._scalar(d2q9._scalar(p.accel, compute) * d2q9._scalar(d2q9.W[5], compute), compute)
    col = f[:, :, 0].to(compute)
    ok = (~walls[:, 0]) & (col[6] - a58 > 0) & (col[3] - a14 > 0) & (col[7] - a58 > 0)
    new = col.clone()
    for s, d in ((6, -a58), (3, -a14), (7, -a58), (5, a58), (1, a14), (8, a58)):
        new[s] = torch.where(ok, col[s] + d, col[s])
    out = f.clone()
    out[:, :, 0] = new.to(f.dtype)
    return out


def direct_pull(f: torch.Tensor) -> torch.Tensor:
    """Periodic pull (:230-243): pulled_s(i, j) = f_s(i - e_x, j - e_y)."""
    return torch.stack([torch.roll(f[s], shifts=d2q9.E[s], dims=(0, 1)) for s in range(d2q9.NSPEEDS)])


def direct_collide(ft: torch.Tensor, p: d2q9.Params) -> torch.Tensor:
    """BGK relaxation of pulled planes in their own dtype, the scalar
    kernel's association order (:258-296)."""
    dt = ft.dtype
    one, three = d2q9._scalar(1.0, dt), d2q9._scalar(3.0, dt)
    threeotwo, nineotwo = d2q9._scalar(1.5, dt), d2q9._scalar(4.5, dt)
    csq = torch.full((), p.csq, dtype=dt, device=ft.device)
    itau = d2q9._scalar(1.0 / d2q9._scalar(p.tau, dt), dt)
    density = ft[0]
    for s in range(1, d2q9.NSPEEDS):
        density = density + ft[s]
    u_x = ((ft[6] + ft[2]) + ft[5] - ((ft[7] + ft[4]) + ft[8])) / density
    u_y = ((ft[5] + ft[1]) + ft[8] - ((ft[6] + ft[3]) + ft[7])) / density
    u_dot_u = u_x * u_x + u_y * u_y
    u = (None, u_y, u_x, -u_y, -u_x, u_x + u_y, u_x - u_y, -u_x - u_y, -u_x + u_y)
    uterm = threeotwo * u_dot_u / csq
    out = [ft[0] + itau * (d2q9._scalar(d2q9.W[0], dt) * density * (one - uterm) - ft[0])]
    for s in range(1, d2q9.NSPEEDS):
        fequ = d2q9._scalar(d2q9.W[s], dt) * density * (
            one + three * u[s] / csq + nineotwo * u[s] * u[s] / csq / csq - uterm)
        out.append(ft[s] + itau * (fequ - ft[s]))
    return torch.stack(out)


def direct_step(f: torch.Tensor, walls: torch.Tensor, p: d2q9.Params,
         compute: torch.dtype = torch.float32) -> torch.Tensor:
    """One step (:192-198): forcing, pull, BGK on fluid sites and
    bounce-back on walls (a wall's f0 passes through); the result in
    f's dtype."""
    pulled = direct_pull(direct_apply_source(f.to(compute), walls, p, compute))
    relaxed = direct_collide(pulled, p)
    bounced = pulled[list(d2q9.OPPOSITE)]
    return torch.where(walls[None], bounced, relaxed).to(f.dtype)


@pytest.mark.parametrize("storage, compute", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float64, torch.float64), (torch.bfloat16, torch.bfloat16),
    (torch.float8_e4m3fn, torch.float32)])
@pytest.mark.parametrize("csq", [1.0, 0.9])
def test_the_step_is_the_direct_transcription_bit_for_bit(storage, compute, csq):
    p = d2q9.Params(csq=csq)
    walls = torch.as_tensor(scene.walls({"edges": True, "blocks": [[2, 18, 3, 5]]}, 32, 64))
    f = generator.initial_state(32, 64, p, storage, 5, "cpu")
    g = f
    for _ in range(12):
        f = d2q9.step(f, walls, p, compute)
        g = direct_step(g, walls, p, compute)
        assert torch.equal(f.float(), g.float())
    assert f.dtype == storage


def test_the_upstream_scene():
    w = scene.walls(UPSTREAM, 800, 4000)
    assert w[0].all() and w[-1].all() and not w[1:-1, :100].any()
    assert w[20:220, 100:105].all() and w.sum() == 2 * 4000 + 200 * 5


@pytest.mark.parametrize("nx, ny", [(800, 4000), (4000, 16000)])
def test_the_programs_reference_scene_is_the_same(nx, ny):
    """A witness: the program's own builder of the upstream scene gives
    the same sites, so its wall-spec path runs on the benchmark's walls."""
    from latticeboltzmann_tpu_torch import geometry

    assert np.array_equal(scene.walls(UPSTREAM, nx, ny), geometry.build("reference", nx, ny))


def test_malformed_walls_are_refused():
    with pytest.raises(ValueError, match="unknown"):
        scene.walls({"plates": []}, 32, 64)
    with pytest.raises(ValueError, match="outside"):
        scene.walls({"blocks": [[20, 220, 100, 105]]}, 32, 64)

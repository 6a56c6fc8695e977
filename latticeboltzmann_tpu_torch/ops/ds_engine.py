"""Double-single (f32-pair) DP-class engine in eager PyTorch: twin of
latticeboltzmann_tpu/ops/ds_engine.py, backend 'torch-ds64'.

Every distribution is an unevaluated f32 pair (ops/df64.py), and the
whole step (forcing, pull, BGK collision, bounce-back) runs in
compensated pair arithmetic: ~2^-48 relative precision per op. Semantics
mirror the golden model (src/latticeboltzmann.c:216-302): pull-scheme
streaming, strict moment association order, BGK relaxation through
1/tau, masked bounce-back, j=0 forcing with the all-or-nothing f>0 guard
evaluated at pair precision.

State is a df64.DS of two (9, NX, NY) float32 tensors. Conversions from
float64 happen on the host (df64.from_f64); the diagnostics recombine
the pair to float64 (exact) and use the port's float64 moments.

`collide_planes` (the exact tier) and `collide_planes_fast` (the fast
tier) are shared with ops/fused_ds_kernel.py's plain version, which the
CUDA ds kernel is held against bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import NSPEEDS, OPPOSITE, W, LatticeConfig
from . import df64
from . import stream_collide as torch_ops
from .df64 import DS


def initial_state(cfg: LatticeConfig, device: str | torch.device = "cpu") -> DS:
    """Rest equilibrium split from exact float64 host values
    (src/latticeboltzmann.c:583-591): the lo components carry the part
    of rho*w_s below f32 resolution."""
    f = np.empty((NSPEEDS, cfg.nx, cfg.ny), dtype=np.float64)
    rho = np.float64(cfg.initial_density)
    for s in range(NSPEEDS):
        f[s] = rho * np.float64(W[s])
    return df64.from_f64(f, device)


def _const_values(cfg: LatticeConfig) -> dict:
    """The exact tier's constants as float64 values, derived in f64
    BEFORE splitting, so each pair is a ~2^-48-exact image of the golden
    model's double value."""
    csq = np.float64(cfg.csq)
    return dict(
        one=1.0,
        itau=1.0 / np.float64(cfg.tau),
        c3=3.0 / csq,
        c45=4.5 / (csq * csq),
        c15=1.5 / csq,
        w0=W[0],
        w14=W[1],
        w58=W[5],
        a14=np.float64(cfg.accel) * np.float64(W[1]),
        a58=np.float64(cfg.accel) * np.float64(W[5]),
    )


def _consts(cfg: LatticeConfig, device: str | torch.device = "cpu") -> dict:
    """Physics constants as ds pairs of 0-d tensors on `device`
    (latticeboltzmann_tpu/ops/ds_engine.py:53-77)."""
    return {k: df64.const(v, device) for k, v in _const_values(cfg).items()}


def _fast_const_values(cfg: LatticeConfig) -> dict:
    """The fast tier's constants on the host: relaxation folded into the
    equilibrium weights (c1 = 1-1/tau, iw_s = w_s/tau), presplit by
    df64.split_const into numpy float32 (hi, lo, hh, hl) quads, and the
    pairs one, a14, a58."""
    csq = np.float64(cfg.csq)
    itau = 1.0 / np.float64(cfg.tau)
    c = dict(
        c1=df64.split_const(1.0 - itau),
        iw0=df64.split_const(np.float64(W[0]) * itau),
        iw14=df64.split_const(np.float64(W[1]) * itau),
        iw58=df64.split_const(np.float64(W[5]) * itau),
        c3=df64.split_const(3.0 / csq),
        csixth=df64.split_const(csq / 6.0),
    )
    c.update(
        one=df64.const_literal(1.0),
        a14=df64.const_literal(np.float64(cfg.accel) * np.float64(W[1])),
        a58=df64.const_literal(np.float64(cfg.accel) * np.float64(W[5])),
    )
    return c


def _consts_fast(cfg: LatticeConfig, device: str | torch.device = "cpu") -> dict:
    """_fast_const_values as 0-d tensors on `device`
    (latticeboltzmann_tpu/ops/ds_engine.py:180-213)."""
    out = {}
    for k, v in _fast_const_values(cfg).items():
        t = tuple(torch.tensor(x, device=device) for x in v)
        out[k] = DS(*t) if isinstance(v, DS) else t
    return out


def apply_source(f: DS, walls: torch.Tensor, cfg: LatticeConfig, C: dict | None = None) -> DS:
    """Channel forcing on column j=0 (src/latticeboltzmann.c:489-518)
    at pair precision, including the all-or-nothing f>0 guard.
    walls: (NX, NY) bool. Returns a new pair."""
    C = _consts(cfg, f.hi.device) if C is None else C
    col = DS(f.hi[:, :, 0], f.lo[:, :, 0])  # (9, NX) pairs

    def sp(s):
        return DS(col.hi[s], col.lo[s])

    ok = (
        (~walls[:, 0])
        & df64.gt_zero(df64.sub(sp(6), C["a58"]))
        & df64.gt_zero(df64.sub(sp(3), C["a14"]))
        & df64.gt_zero(df64.sub(sp(7), C["a58"]))
    )
    new = {
        6: df64.sub(sp(6), C["a58"]),
        3: df64.sub(sp(3), C["a14"]),
        7: df64.sub(sp(7), C["a58"]),
        5: df64.add(sp(5), C["a58"]),
        1: df64.add(sp(1), C["a14"]),
        8: df64.add(sp(8), C["a58"]),
    }
    hi, lo = f.hi.clone(), f.lo.clone()
    for s, v in new.items():
        sel = df64.where(ok, v, sp(s))
        hi[s, :, 0] = sel.hi
        lo[s, :, 0] = sel.lo
    return DS(hi, lo)


def pull(f: DS) -> DS:
    """Periodic pull gather (src/latticeboltzmann.c:230-243): pure data
    movement, applied to both pair components."""
    return DS(torch_ops.pull(f.hi), torch_ops.pull(f.lo))


def collide_planes(p: list[DS], C: dict) -> list[DS]:
    """BGK collision on nine pulled ds planes -> nine relaxed ds planes,
    the exact tier. Association order follows the golden model
    (src/latticeboltzmann.c:258-296): strict left-to-right density sum,
    ((a+b)+c) - ((d+e)+g) velocity numerators, feq accumulated as
    ((1 + 3u) + 4.5u^2) - 1.5|u|^2; the +/- speed pairs share their
    common subterms."""
    A, S, M = df64.add, df64.sub, df64.mul

    density = p[0]
    for s in range(1, NSPEEDS):
        density = A(density, p[s])

    num_x = S(A(A(p[6], p[2]), p[5]), A(A(p[7], p[4]), p[8]))
    num_y = S(A(A(p[5], p[1]), p[8]), A(A(p[6], p[3]), p[7]))
    irho = df64.recip(density, one=C["one"])
    u_x = M(num_x, irho)
    u_y = M(num_y, irho)
    uterm = M(C["c15"], A(M(u_x, u_x), M(u_y, u_y)))  # 1.5|u|^2/csq

    itau = C["itau"]
    wd14 = M(C["w14"], density)
    wd58 = M(C["w58"], density)

    out = [None] * NSPEEDS
    # speed 0: feq = w0 * rho * (1 - uterm)
    feq0 = M(M(C["w0"], density), S(C["one"], uterm))
    out[0] = A(p[0], M(itau, S(feq0, p[0])))

    one_f = C["one"].hi  # float32 1.0, the add_f operand
    # +/- pairs (sp pulls along +e, sn along -e): u_sn = -u_sp, so the
    # pair shares t3 = 3u/csq, t45 = 4.5u^2/csq^2 and w*rho
    for sp_, sn, v, wd in (
        (1, 3, u_y, wd14),
        (2, 4, u_x, wd14),
        (5, 7, A(u_x, u_y), wd58),
        (6, 8, S(u_x, u_y), wd58),
    ):
        t3 = M(C["c3"], v)
        t45 = M(C["c45"], M(v, v))
        base = S(A(df64.add_f(t3, one_f), t45), uterm)
        base_n = S(A(df64.add_f(df64.neg(t3), one_f), t45), uterm)
        feq_p = M(wd, base)
        feq_n = M(wd, base_n)
        out[sp_] = A(p[sp_], M(itau, S(feq_p, p[sp_])))
        out[sn] = A(p[sn], M(itau, S(feq_n, p[sn])))
    return out


def collide_planes_fast(p: list[DS], C: dict) -> list[DS]:
    """The fast-tier twin of collide_planes: same physics, reassociated
    for op count (~1.1k f32 flops/site vs ~2.6k): error-free 7/4-term
    accumulations (df64.acc), a one-Newton reciprocal, relaxation folded
    into the weights (out = c1*p + iw*rho*(q +/- eu)), sloppy adds and
    unnormalized muls inside the DAG. Worst-case per-op error ~2^-44.
    C from _consts_fast."""
    A, S = df64.add_s, df64.sub_s

    d56 = A(p[5], p[6])
    d78 = A(p[7], p[8])
    d58 = A(p[5], p[8])
    d67 = A(p[6], p[7])
    density = df64.acc([p[0], p[1], p[2], p[3], p[4], d56, d78])
    num_x = df64.acc([p[2], df64.neg(p[4]), d56, df64.neg(d78)])
    num_y = df64.acc([p[1], df64.neg(p[3]), d58, df64.neg(d67)])
    irho = df64.recip_newton(density, one=C["one"])
    u_x = df64.mul_nr(num_x, irho)
    u_y = df64.mul_nr(num_y, irho)
    ux3 = df64.mul_c(u_x, C["c3"])
    uy3 = df64.mul_c(u_y, C["c3"])
    ssum = A(df64.mul_nr(ux3, ux3), df64.mul_nr(uy3, uy3))
    base = S(C["one"], df64.mul_c(ssum, C["csixth"]))
    r0 = df64.mul_c(density, C["iw0"])
    r14 = df64.mul_c(density, C["iw14"])
    r58 = df64.mul_c(density, C["iw58"])

    out = [None] * NSPEEDS
    out[0] = A(df64.mul_c(p[0], C["c1"]), df64.mul_nr(r0, base))
    for sp_, sn, eu, r_ in (
        (1, 3, uy3, r14),
        (2, 4, ux3, r14),
        (5, 7, A(ux3, uy3), r58),
        (6, 8, S(ux3, uy3), r58),
    ):
        q = A(base, df64.scale_pow2(df64.mul_nr(eu, eu), 0.5))
        out[sp_] = A(df64.mul_c(p[sp_], C["c1"]), df64.mul_nr(r_, A(q, eu)))
        out[sn] = A(df64.mul_c(p[sn], C["c1"]), df64.mul_nr(r_, S(q, eu)))
    return out


def bounce_back(pulled: DS, relaxed: list[DS], walls: torch.Tensor) -> DS:
    """Masked bounce-back on both components: solid sites take the
    pulled opposite speed (wall f0 passes through, like the golden
    model), fluid sites the relaxed value."""
    opp = [int(o) for o in OPPOSITE]
    return DS(
        torch.where(walls[None], pulled.hi[opp], torch.stack([r.hi for r in relaxed])),
        torch.where(walls[None], pulled.lo[opp], torch.stack([r.lo for r in relaxed])),
    )


def stream_collide(f: DS, walls: torch.Tensor, cfg: LatticeConfig, C: dict | None = None) -> DS:
    """One fused step: pull, collide at pair precision (exact tier),
    masked bounce-back."""
    C = _consts(cfg, f.hi.device) if C is None else C
    pulled = pull(f)
    planes = [DS(pulled.hi[s], pulled.lo[s]) for s in range(NSPEEDS)]
    return bounce_back(pulled, collide_planes(planes, C), walls)


def step(f: DS, walls: torch.Tensor, cfg: LatticeConfig, C: dict | None = None) -> DS:
    """ApplySource then StreamCollide (src/latticeboltzmann.c:192-198)."""
    C = _consts(cfg, f.hi.device) if C is None else C
    return stream_collide(apply_source(f, walls, cfg, C), walls, cfg, C)


def run_steps(f: DS, walls: torch.Tensor, cfg: LatticeConfig, n_steps: int) -> DS:
    """n_steps of the exact tier as an eager loop (the JAX engine's
    jit(scan)); `f` is left unchanged. Refuses to run on a device whose
    f32 ops are not one-rounding IEEE (df64.check_backend)."""
    df64.check_backend(f.hi.device, raise_on_fail=True)
    walls = torch.as_tensor(walls, dtype=torch.bool, device=f.hi.device)
    C = _consts(cfg, f.hi.device)
    for _ in range(n_steps):
        f = step(f, walls, cfg, C)
    return f


# --- diagnostics (the pair recombined to float64, exactly) ------------------


def recombine(f: DS) -> torch.Tensor:
    """hi + lo as float64 on the pair's device: exact, the value
    state_f64 gives on the host."""
    return f.hi.double() + f.lo.double()


def probe_values(f: DS, sites: torch.Tensor) -> torch.Tensor:
    """(rho, u_x, u_y) in float64 at (P, 2) sites (an int64 tensor on
    the pair's device): the probe columns recombined, then the moments,
    equal to probe_values of the whole recombined state (the recombination
    is per site) without recombining the rest of it."""
    i, j = sites[:, 0], sites[:, 1]
    return torch_ops.probe_moments(f.hi[:, i, j].double() + f.lo[:, i, j].double())


def state_f64(f: DS) -> np.ndarray:
    return df64.to_f64(f)


def macroscopic(f: DS) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """rho, u_x, u_y of the recombined state, float64 host arrays."""
    return tuple(t.cpu().numpy() for t in torch_ops.macroscopic(recombine(f)))


def reynolds(f: DS, walls, cfg: LatticeConfig, col: int | None = None) -> float:
    walls = torch.as_tensor(walls, dtype=torch.bool, device=f.hi.device)
    return float(torch_ops.reynolds(recombine(f), walls, cfg, col))

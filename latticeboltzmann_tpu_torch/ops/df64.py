"""Double-single ("df64") arithmetic in eager PyTorch: ~49-bit-mantissa
reals as unevaluated sums of two float32 tensors, built from error-free
transforms (Dekker/Knuth TwoSum, TwoProd, Split). Twin of
latticeboltzmann_tpu/ops/df64.py, op for op and in the same order, so the
two give the same bits on the same inputs.

Correctness rests on IEEE-754 round-to-nearest float32 add, sub, mul and
div with exactly ONE rounding per op. Eager PyTorch runs each binary op
as its own kernel, so no mul+add pair is ever contracted into an FMA, and
it has no algebraic simplifier to cancel ``(x + c) - c``. Two rules keep
it so: constants are 0-d tensors on the operand's device (PyTorch's CUDA
division by a host scalar multiplies by its reciprocal, an extra
rounding), and only plain binary ops are used (no addcmul or lerp, which
fuse). `check_backend` probes a device for both failure modes, and
ds_engine.run_steps refuses a device that fails it.

A ds number is a DS(hi, lo) NamedTuple of same-shape float32 tensors with
|lo| <= ulp(hi)/2 (normalized). All ops are elementwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DS(NamedTuple):
    """An unevaluated float32 sum hi + lo (|lo| <= ulp(hi)/2)."""

    hi: torch.Tensor
    lo: torch.Tensor


# --- host-side conversions -------------------------------------------------


def from_f64(x, device: str | torch.device = "cpu") -> DS:
    """Split float64 host values into a normalized (hi, lo) pair on
    `device`: hi = f32(x), lo = f32(x - f64(hi)). Exact when |x - hi| is
    representable (always, for the magnitudes LBM uses)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DS(torch.tensor(hi, device=device), torch.tensor(lo, device=device))


def to_f64(a: DS) -> np.ndarray:
    """Recombine on the host at full float64."""
    hi = a.hi.detach().cpu().numpy().astype(np.float64)
    return hi + a.lo.detach().cpu().numpy().astype(np.float64)


def _split_host(x: float) -> tuple[np.float32, np.float32]:
    v = np.float64(x)
    hi = np.float32(v)
    return hi, np.float32(v - np.float64(hi))


def const(x: float, device: str | torch.device = "cpu") -> DS:
    """A ds scalar constant split on the host from an exact float64
    value: a pair of 0-d float32 tensors on `device`.

    The JAX package wraps its pair in `lax.optimization_barrier`, because
    XLA's HLO simplifier rewrites ``sub(add(x, c), c) -> x`` for a
    compile-time constant c and so zeroes TwoSum's error term. Eager
    PyTorch runs every op as written and has no such pass, so a plain
    tensor is enough; it lives on the operand's device because a CPU
    scalar divisor would be folded into a reciprocal multiply on CUDA."""
    hi, lo = _split_host(x)
    return DS(torch.tensor(hi, device=device), torch.tensor(lo, device=device))


def const_literal(x: float) -> DS:
    """A ds constant as plain numpy float32 scalars, the values the CUDA
    kernel takes as launch parameters (the JAX package's form for
    compiled Pallas bodies). Tensor ops take `const`."""
    return DS(*_split_host(x))


# --- error-free transforms ---------------------------------------------------


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b). 6 flops,
    branch-free, no magnitude precondition."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Dekker FastTwoSum: requires |a| >= |b| (or a == 0). 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


# 2^12 + 1: splits a 24-bit mantissa into two 12-bit halves whose
# products are exact in f32 (Dekker's split constant for single). A
# Python scalar is safe here: it is exact in float32, and PyTorch
# multiplies by a scalar in the tensor's float32.
_SPLIT = np.float32(4097.0)


def _split(a):
    t = a * float(_SPLIT)
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly, p = fl(a * b). 17 flops
    (no FMA dependence: exactness comes from the 12-bit splits)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# --- ds arithmetic -----------------------------------------------------------


def add(a: DS, b: DS) -> DS:
    """Full ds addition (Dekker add2 with both error terms): relative
    error ~2^-47. ~20 flops."""
    sh, se = two_sum(a.hi, b.hi)
    th, te = two_sum(a.lo, b.lo)
    se = se + th
    sh, se = quick_two_sum(sh, se)
    se = se + te
    return DS(*quick_two_sum(sh, se))


def sub(a: DS, b: DS) -> DS:
    return add(a, DS(-b.hi, -b.lo))


def add_f(a: DS, b) -> DS:
    """ds + f32. ~11 flops."""
    sh, se = two_sum(a.hi, b)
    se = se + a.lo
    return DS(*quick_two_sum(sh, se))


def mul(a: DS, b: DS) -> DS:
    """Full ds multiplication: p = a.hi*b.hi exactly (TwoProd) plus the
    cross terms; relative error ~2^-46. ~26 flops."""
    ph, pe = two_prod(a.hi, b.hi)
    pe = pe + (a.hi * b.lo + a.lo * b.hi)
    return DS(*quick_two_sum(ph, pe))


def mul_f(a: DS, b) -> DS:
    """ds * f32 (b exact). ~22 flops."""
    ph, pe = two_prod(a.hi, b)
    pe = pe + a.lo * b
    return DS(*quick_two_sum(ph, pe))


def div(a: DS, b: DS) -> DS:
    """Long-division ds divide (two refinement steps): relative error
    ~2^-46. ~3 f32 divides + ~90 flops."""
    q1 = a.hi / b.hi
    r = sub(a, mul_f(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_f(b, q2))
    q3 = r.hi / b.hi
    qh, ql = quick_two_sum(q1, q2)
    return add_f(DS(qh, ql), q3)


def recip(b: DS, one: DS | None = None) -> DS:
    """1 / b: div with the a=1 residuals simplified away. `one` is the
    pair constant 1 (const(1.0) on b's device when None)."""
    one = const(1.0, b.hi.device) if one is None else one
    q1 = one.hi / b.hi
    r = sub(one, mul_f(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_f(b, q2))
    q3 = r.hi / b.hi
    qh, ql = quick_two_sum(q1, q2)
    return add_f(DS(qh, ql), q3)


def neg(a: DS) -> DS:
    return DS(-a.hi, -a.lo)


# --- relaxed ("fast-tier") variants ------------------------------------------
#
# The ops above keep every error term (~2^-47 worst case per op). The
# variants below trade the last few bits for fewer f32 ops: worst case
# ~2^-44 per op. They are the arithmetic of collide_planes_fast and of
# the CUDA ds kernel's default tier.


def add_s(a: DS, b: DS) -> DS:
    """Sloppy ds add (Dekker add2 without the lo-pair TwoSum): 11 flops
    vs 20. Error ~|a.lo + b.lo| ulp: fine unless the result is dominated
    by the lo parts, which the collision DAG's sums never are."""
    s, e = two_sum(a.hi, b.hi)
    return DS(*quick_two_sum(s, (e + a.lo) + b.lo))


def sub_s(a: DS, b: DS) -> DS:
    return add_s(a, DS(-b.hi, -b.lo))


def acc(terms: list) -> DS:
    """Error-free accumulation of n ds terms: one TwoSum cascade over
    the hi components, error terms and lo components accumulated in
    plain f32. 8(n-1)+3 flops vs 20(n-1) for chained full adds."""
    s = terms[0].hi
    e = terms[0].lo
    for t in terms[1:]:
        s, err = two_sum(s, t.hi)
        e = e + (err + t.lo)
    return DS(*quick_two_sum(s, e))


def mul_nr(a: DS, b: DS) -> DS:
    """Full ds multiply WITHOUT the final renormalization: the returned
    lo may reach ~2 ulp(hi). Safe to feed two_sum-based adds and further
    muls; do not feed quick_two_sum-based code that assumes
    |lo| <= ulp(hi)/2. 23 flops vs 26."""
    ph, pe = two_prod(a.hi, b.hi)
    return DS(ph, pe + (a.hi * b.lo + a.lo * b.hi))


def split_const(x: float) -> tuple:
    """Host-side Dekker split of a ds constant: numpy float32
    (hi, lo, hh, hl) with hh + hl == hi exactly, hh/hl 12-bit-mantissa
    halves. Feeds mul_c's presplit two_prod."""
    hi, lo = _split_host(x)
    t = _SPLIT * hi
    hh = t - (t - hi)
    return hi, lo, np.float32(hh), np.float32(hi - hh)


def mul_c(a: DS, c: tuple) -> DS:
    """a * constant, the constant presplit by split_const (as 0-d
    tensors on a's device). 20 flops (unnormalized lo, see mul_nr)."""
    chi, clo, chh, chl = c
    p = a.hi * chi
    ah, al = _split(a.hi)
    e = ((ah * chh - p) + ah * chl + al * chh) + al * chl
    return DS(p, e + (a.hi * clo + a.lo * chi))


def scale_pow2(a: DS, s) -> DS:
    """a * s for s an exact power of two (both components scale
    exactly): 2 flops."""
    return DS(a.hi * s, a.lo * s)


def recip_newton(b: DS, one: DS | None = None) -> DS:
    """1 / b via one ds Newton step from the f32 divide: q0 = fl32(1/b.hi)
    has ~2^-24 relative error; r = 1 - b*q0 at pair precision, and
    q = q0 + q0*r doubles the bits to ~2^-48."""
    one = const(1.0, b.hi.device) if one is None else one
    q0 = one.hi / b.hi
    r = sub_s(one, mul_f(b, q0))
    return DS(*two_sum(q0, q0 * r.hi))


def where(c, a: DS, b: DS) -> DS:
    return DS(torch.where(c, a.hi, b.hi), torch.where(c, a.lo, b.lo))


def gt_zero(a: DS):
    """a > 0. A normalized pair's sign is carried by hi unless hi == 0,
    where lo decides."""
    return (a.hi > 0) | ((a.hi == 0) & (a.lo > 0))


# --- backend validation ------------------------------------------------------


_BACKEND_OK: dict[str, bool] = {}


def check_backend(device: str | torch.device = "cpu", raise_on_fail: bool = False) -> bool:
    """Probe the eager float32 ops on `device` for strict one-rounding
    semantics, the property every error-free transform here stands on.
    Cached per device type.

    Two probes, each checked against host float64 over 256 inputs:

    1. FMA contraction: ``two_sum(h, a * a)``. A contracting backend
       computes s = fma(a, a, h), one rounding, while TwoSum's error term
       assumes s = fl(h + fl(a*a)). About 28% of random inputs are
       contraction-sensitive, so a miss is ~1e-39.
    2. Constant cancellation: ``sub(const(1.0), u)`` with |u| ~ 1e-3
       must track float64 to 2^-45. A backend that cancels
       ``(x + c) - c`` would zero TwoSum's error term here.

    Returns True if the device is safe; with raise_on_fail, raises
    RuntimeError instead of returning False."""
    device = torch.device(device)
    key = device.type
    if key not in _BACKEND_OK:
        rng = np.random.RandomState(0)
        h = rng.standard_normal(256).astype(np.float32)
        a = rng.standard_normal(256).astype(np.float32)
        ht = torch.tensor(h, device=device)
        at = torch.tensor(a, device=device)
        s, e = two_sum(ht, at * at)
        want = np.float64(h) + np.float64(a * a)  # numpy: one rounding for the mul
        got = s.cpu().numpy().astype(np.float64) + e.cpu().numpy().astype(np.float64)
        fma_ok = bool(np.array_equal(got, want))
        u = np.abs(rng.standard_normal(256)).astype(np.float64) * 1e-3
        diff = to_f64(sub(const(1.0, device), from_f64(u, device))) - (1.0 - u)
        cancel_ok = bool(np.abs(diff).max() < 2.0**-45)
        _BACKEND_OK[key] = fma_ok and cancel_ok
    if raise_on_fail and not _BACKEND_OK[key]:
        raise RuntimeError(
            f"torch device type {key!r} does not preserve one-rounding f32 "
            "semantics (FMA contraction or constant cancellation detected): "
            "the double-single (ds) engine's error-free transforms would "
            "silently degrade to plain f32 accuracy; use the float64 "
            "'torch' backend instead."
        )
    return _BACKEND_OK[key]

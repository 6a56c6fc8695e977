"""The port's double-single arithmetic (latticeboltzmann_tpu_torch/ops/
df64.py) against numpy float64, and op for op against the JAX package's
df64 under jax.jit on the CPU.

The first half mirrors tests/test_ds.py:22-116 with the same seeds and
bars (2^-45 relative for add/sub/mul/div/recip, 2^-44 for the 9-term
chain). The second half holds every port op bitwise equal to its JAX
twin on the same seeded numpy inputs: tests/conftest.py pins XLA:CPU to
one rounding per op (--xla_cpu_max_isa=AVX, no FMA), and eager PyTorch
runs one kernel per op, so both sides round each f32 op exactly once in
the same order.
"""

import jax
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu.ops import df64 as jdf
from latticeboltzmann_tpu_torch import LatticeConfig, geometry
from latticeboltzmann_tpu_torch.ops import df64, ds_engine

torch.set_num_threads(1)


def _rand(rng, n=4096, scale=1.0):
    return (rng.normal(size=n) * scale).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a, b = _rand(rng), _rand(rng, scale=1e-6)
    s, e = df64.two_sum(_t(a), _t(b))
    s, e = _np(s).astype(np.float64), _np(e).astype(np.float64)
    np.testing.assert_array_equal(s + e, a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a, b = _rand(rng), _rand(rng)
    p, e = df64.two_prod(_t(a), _t(b))
    p, e = _np(p).astype(np.float64), _np(e).astype(np.float64)
    np.testing.assert_array_equal(p + e, a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_ds_ops_match_f64(op):
    """tests/test_ds.py:41-60's bar: 2^-45 relative to the operand scale
    for add/sub, to the result for mul/div."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=8192) * np.exp(rng.uniform(-8, 8, size=8192))
    y = rng.normal(size=8192) * np.exp(rng.uniform(-8, 8, size=8192))
    got = df64.to_f64(getattr(df64, op)(df64.from_f64(x), df64.from_f64(y)))
    want = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide}[op](x, y)
    if op in ("add", "sub"):
        scale = np.maximum(np.abs(x), np.abs(y))
    else:
        scale = np.abs(want)
    rel = np.abs(got - want) / np.maximum(scale, 1e-300)
    assert rel.max() < 2.0**-45, f"{op}: max rel {rel.max():.3e}"


def test_ds_recip_matches_f64():
    rng = np.random.default_rng(3)
    x = rng.normal(size=4096) * np.exp(rng.uniform(-6, 6, size=4096))
    got = df64.to_f64(df64.recip(df64.from_f64(x)))
    assert (np.abs(got - 1.0 / x) * np.abs(x)).max() < 2.0**-45


def test_ds_sum_chain_precision():
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=1024) for _ in range(9)]
    acc = df64.from_f64(xs[0])
    for x in xs[1:]:
        acc = df64.add(acc, df64.from_f64(x))
    want = xs[0].copy()
    for x in xs[1:]:
        want = want + x
    err = np.abs(df64.to_f64(acc) - want)
    assert (err / np.max(np.abs(xs), axis=0)).max() < 2.0**-44


def test_gt_zero_pair_sign():
    a = df64.DS(_t(np.float32([1.0, -1.0, 0.0, 0.0, 0.0])),
                _t(np.float32([-2e-8, 2e-8, 1e-12, -1e-12, 0.0])))
    np.testing.assert_array_equal(_np(df64.gt_zero(a)), [True, False, True, False, False])


def test_check_backend_cpu():
    """Eager CPU PyTorch rounds once per f32 op: the probe passes."""
    assert df64.check_backend("cpu")


def test_ds_engine_refuses_failing_backend(monkeypatch):
    monkeypatch.setitem(df64._BACKEND_OK, "cpu", False)
    assert not df64.check_backend("cpu")
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    with pytest.raises(RuntimeError, match="FMA contraction"):
        ds_engine.run_steps(ds_engine.initial_state(cfg), _t(geometry.empty(16, 40)), cfg, 1)


# --- bitwise against the JAX ops under jax.jit on the CPU --------------------


def _pairs(seed, n=4096):
    """Two seeded float64 operand sets split into pairs: wide magnitudes,
    both signs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * np.exp(rng.uniform(-8, 8, size=n))
    y = rng.normal(size=n) * np.exp(rng.uniform(-8, 8, size=n))
    return jdf.from_f64(x), jdf.from_f64(y)


def _c4():
    return df64.split_const(0.7 / 9.0)


# op name -> (jax callable on DS/arrays, port callable on DS/tensors); the
# port's constants are 0-d tensors, the JAX ones numpy scalars or const()
_OPS = {
    "two_sum": (lambda a, b: jdf.two_sum(a.hi, b.hi), lambda a, b: df64.two_sum(a.hi, b.hi)),
    "quick_two_sum": (lambda a, b: jdf.quick_two_sum(a.hi, a.lo),
                      lambda a, b: df64.quick_two_sum(a.hi, a.lo)),
    "two_prod": (lambda a, b: jdf.two_prod(a.hi, b.hi), lambda a, b: df64.two_prod(a.hi, b.hi)),
    "add": (jdf.add, df64.add),
    "sub": (jdf.sub, df64.sub),
    "add_f": (lambda a, b: jdf.add_f(a, b.hi), lambda a, b: df64.add_f(a, b.hi)),
    "mul": (jdf.mul, df64.mul),
    "mul_f": (lambda a, b: jdf.mul_f(a, b.hi), lambda a, b: df64.mul_f(a, b.hi)),
    "div": (jdf.div, df64.div),
    "recip": (lambda a, b: jdf.recip(a), lambda a, b: df64.recip(a)),
    "neg": (lambda a, b: jdf.neg(a), lambda a, b: df64.neg(a)),
    "add_s": (jdf.add_s, df64.add_s),
    "sub_s": (jdf.sub_s, df64.sub_s),
    "acc": (lambda a, b: jdf.acc([a, b, jdf.neg(a), b]),
            lambda a, b: df64.acc([a, b, df64.neg(a), b])),
    "mul_nr": (jdf.mul_nr, df64.mul_nr),
    "mul_c": (lambda a, b: jdf.mul_c(a, _c4()),
              lambda a, b: df64.mul_c(a, tuple(torch.tensor(x) for x in _c4()))),
    "scale_pow2": (lambda a, b: jdf.scale_pow2(a, np.float32(0.5)),
                   lambda a, b: df64.scale_pow2(a, 0.5)),
    "recip_newton": (lambda a, b: jdf.recip_newton(a), lambda a, b: df64.recip_newton(a)),
    "sub_const": (lambda a, b: jdf.sub(jdf.const(1.0), a),
                  lambda a, b: df64.sub(df64.const(1.0), a)),
    "where": (lambda a, b: jdf.where(a.hi > b.hi, a, b),
              lambda a, b: df64.where(a.hi > b.hi, a, b)),
    "gt_zero": (lambda a, b: jdf.gt_zero(jdf.sub(a, b)),
                lambda a, b: df64.gt_zero(df64.sub(a, b))),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_op_bitwise_equals_jax_jit(op):
    jfn, tfn = _OPS[op]
    ja, jb = _pairs(5)
    want = jax.jit(jfn)(ja, jb)
    got = tfn(*(df64.DS(_t(np.asarray(p.hi)), _t(np.asarray(p.lo))) for p in (ja, jb)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_host_splits_equal_jax():
    """from_f64/to_f64, const and split_const split on the host exactly
    as the JAX package does."""
    x = np.random.default_rng(6).normal(size=512) * 0.1
    j, t = jdf.from_f64(x), df64.from_f64(x)
    np.testing.assert_array_equal(t.hi.numpy(), np.asarray(j.hi))
    np.testing.assert_array_equal(t.lo.numpy(), np.asarray(j.lo))
    np.testing.assert_array_equal(df64.to_f64(t), jdf.to_f64(j))
    for v in (1.0, 1.0 / 0.7, 4.0 / 9.0, 0.005 / 36.0):
        assert tuple(float(c) for c in df64.const(v)) == tuple(
            float(c) for c in jdf.const_literal(v))
        assert df64.split_const(v) == jdf.split_const(v)


# --- the CUDA ds kernel's one-FMA products against Dekker's TwoProd ----------
#
# csrc/lbm_ds_step.cu forms the error of a product as fma(a, b, -p), p =
# fl(a * b), where df64.two_prod (the plain version) splits both operands.
# Both are the exact error a * b - p when it is representable, so they are
# the same float wherever that holds; these cases show where.

# Leading-bit exponents (a = +-1.m * 2^ea) of the domain: ea + eb >= EDGE,
# and at most TOP each (Dekker's split multiplies by 4097 and overflows
# above it). From -103 up both errors are exact; from EDGE to -104 only
# Dekker's last partial products round, onto the 2^-149 grid on which the
# rest of its sum lies at even multiples, so they round as the FMA's one
# rounding does, ties included. FIRST_MISS: the first exponent sum under
# the edge at which the two differ, by the kind of operand a.
EDGE, TOP = -113, 114
FIRST_MISS = {"normal": -115, "subnormal": -114}


def _fma_error(a, b):
    """(p, fma(a, b, -p)) for float32 arrays, emulated exactly: the
    float64 product of two float32 values is exact, and so is its
    difference from the float32 product p; one rounding to float32 then
    gives the FMA's result, signed zeros included."""
    p = a * b
    e = (a.astype(np.float64) * b.astype(np.float64) - p.astype(np.float64)).astype(np.float32)
    return p, e


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _draw(rng, e):
    """float32 values of random signs and 24-bit mantissas at leading-bit
    exponents e (rounded to the subnormal grid below -126)."""
    m = (2**23 + rng.integers(0, 2**23, size=len(e))) / 2.0**23
    return (np.ldexp(m, e) * rng.choice([-1.0, 1.0], size=len(e))).astype(np.float32)


def _operands(rng, n, exp_sum, kind="normal"):
    """n float32 pairs (a, b) whose leading-bit exponents add up to
    exp_sum, b normal and at most TOP; a normal, or subnormal."""
    if kind == "normal":
        ea = rng.integers(max(-126, exp_sum - TOP), min(TOP, exp_sum + 126) + 1, size=n)
    else:
        ea = rng.integers(-149, -126, size=n)
    a = _draw(rng, ea)
    eb = exp_sum - (np.frexp(a.astype(np.float64))[1] - 1)
    keep = eb <= TOP
    return a[keep], _draw(rng, eb[keep])


def _differs(a, b):
    """Where df64.two_prod's error differs from the one-FMA error, bitwise."""
    p, e = df64.two_prod(_t(a), _t(b))
    want_p, want_e = _fma_error(a, b)
    assert np.array_equal(_bits(_np(p)), _bits(want_p))
    return _bits(_np(e)) != _bits(want_e)


@pytest.mark.parametrize("kind,sums,n", [
    ("normal", (EDGE, -90), 4096), ("normal", (-89, 0), 256), ("normal", (1, 125), 256),
    ("subnormal", (EDGE, -60), 4096),
])
def test_fma_error_equals_two_prod_in_the_domain(kind, sums, n):
    """Every exponent sum of the domain, n random pairs each: the one-FMA
    error is Dekker's, bit for bit."""
    rng = np.random.default_rng(sums[0] & 0xFFFF)
    for s in range(sums[0], sums[1] + 1):
        a, b = _operands(rng, n, s, kind)
        assert not _differs(a, b).any(), f"exponent sum {s}"


@pytest.mark.parametrize("kind", sorted(FIRST_MISS))
def test_fma_error_first_differs_just_under_the_edge(kind):
    """Under the edge the last partial products of Dekker's sum round at
    odd multiples of 2^-149, or below it, before the sum; the FMA rounds
    once. The first exponent sum under EDGE at which the two differ, over
    4096 random pairs a sum, is FIRST_MISS[kind]: the domain in the
    kernel's source comment is shown, not claimed."""
    rng = np.random.default_rng(7)
    first = None
    for s in range(EDGE - 1, -150, -1):
        a, b = _operands(rng, 4096, s, kind)
        if _differs(a, b).any():
            first = s
            break
    assert first == FIRST_MISS[kind]


def test_fma_error_equals_two_prod_at_zeros():
    """Zeros of both signs against zeros, normal and subnormal operands:
    both errors are +0."""
    z = np.array([0.0, -0.0], np.float32)
    others = np.array([0.0, -0.0, 1.0, -1.0, 3.5e-3, -7.0e20, 1.0e-40, -1.0e-45], np.float32)
    a, b = np.meshgrid(z, others)
    a, b = a.ravel(), b.ravel()
    for x, y in ((a, b), (b, a)):
        assert not _differs(x, y).any()
        p, e = df64.two_prod(_t(x), _t(y))
        assert (_bits(_np(e)) == 0).all()


def _kernel_constants(cfg):
    """The fast tier's split_const quads for cfg (ds_engine's order)."""
    return [v for v in ds_engine._fast_const_values(cfg).values() if len(v) == 4]


@pytest.mark.parametrize("knobs", [{}, {"tau": 0.6, "csq": 0.8, "accel": 0.01}])
def test_mul_c_with_the_whole_constant_equals_the_presplit_one(knobs):
    """mul_c with the product's error by one FMA against c.hi (the
    kernel's form) equals df64.mul_c with split_const's presplit halves,
    bit for bit, for every fast-tier constant; hh and hl are Veltkamp's
    halves of hi, so the presplit product is Dekker's TwoProd."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64, **knobs)
    rng = np.random.default_rng(8)
    x = rng.normal(size=8192) * np.exp(rng.uniform(-40, 4, size=8192))
    a = df64.from_f64(np.concatenate([x, [0.0, -0.0]]))
    for c in _kernel_constants(cfg):
        hi, lo, hh, hl = c
        vh, vl = df64._split(_t(np.array([hi])))
        assert _bits(_np(vh)) == _bits(hh) and _bits(_np(vl)) == _bits(hl)
        got = df64.mul_c(a, tuple(torch.tensor(v) for v in c))
        ah, al = _np(a.hi), _np(a.lo)
        p, e = _fma_error(ah, np.full_like(ah, hi))
        want_lo = e + (ah * lo + al * hi)
        assert np.array_equal(_bits(_np(got.hi)), _bits(p))
        assert np.array_equal(_bits(_np(got.lo)), _bits(want_lo))

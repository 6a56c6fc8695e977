"""The port's pair-DP path on the CPU: the eager engine (ops/ds_engine.py)
against the JAX xla-ds64 engine and the golden oracle, the kernel
module's plain version (ops/fused_ds_kernel.step_reference, which the
CUDA ds kernel is held against bit for bit on the card) against the JAX
fused ds kernel in interpret mode, the Session/wrapper on the CPU, the
facade's ds backends, and the pair's crossing through utils/interop.py.

Scenes are tests/test_ds.py:119-124's _scene(). Bars: bitwise where the
two sides run the same f32 ops in the same order (both round once per op,
see tests/test_torch_df64.py); otherwise the JAX suite's own, 1e-11
relative against golden after 300 steps (tests/test_ds.py:127-145).
"""

import dataclasses

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu import geometry as jgeo
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops import df64 as jdf
from latticeboltzmann_tpu.ops import ds_engine as jds
from latticeboltzmann_tpu.ops import fused_ds_kernel as jfdk
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation
from latticeboltzmann_tpu_torch.ops import df64, ds_engine
from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)


def _scene(nx=16, ny=40):
    """(port cfg, JAX cfg, walls): tests/test_ds.py:119-124."""
    walls = jgeo.channel_with_barrier(nx, ny, barrier_rows=(5, 9), barrier_cols=(10, 13))
    return (LatticeConfig(nx=nx, ny=ny, dtype=np.float64),
            JaxConfig(nx=nx, ny=ny, dtype=np.float64), walls)


def _perturbed(jcfg, seed=0):
    """Rest equilibrium times (1 + 5% seeded uniform noise), float64."""
    rng = np.random.default_rng(seed)
    f = golden.initial_state(jcfg)
    return f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))


def _reference_run(f0, walls, cfg, n, exact):
    """n steps of step_reference from a float64 host state."""
    f = df64.from_f64(f0)
    solid = torch.as_tensor(walls.astype(np.uint8)) if walls.any() else None
    for _ in range(n):
        f = fdk.step_reference(f.hi, f.lo, solid, cfg, exact)
    return f


def test_engine_bitwise_equals_jax_xla_ds64():
    """The exact tier eagerly in PyTorch is the program xla-ds64 compiles
    (tests/test_ds.py:285-300), op for op: bitwise after 60 steps."""
    cfg, jcfg, walls = _scene()
    want = JaxSimulation(jcfg, walls, backend="xla-ds64").run(60).state()
    got = ds_engine.run_steps(ds_engine.initial_state(cfg), torch.as_tensor(walls), cfg, 60)
    np.testing.assert_array_equal(ds_engine.state_f64(got), want)


def test_engine_matches_golden_f64():
    """tests/test_ds.py:127-145's bar after 300 steps: 1e-11 relative on
    the state, 1e-9 on Re."""
    cfg, jcfg, walls = _scene()
    n = 300
    f_gold = golden.run(golden.initial_state(jcfg), walls, jcfg, n)
    f_ds = ds_engine.run_steps(ds_engine.initial_state(cfg), torch.as_tensor(walls), cfg, n)
    err = np.abs(ds_engine.state_f64(f_ds) - f_gold) / np.maximum(np.abs(f_gold), 1e-30)
    assert err.max() < 1e-11, f"max rel {err.max():.3e}"
    re_gold = golden.reynolds(f_gold, walls, jcfg)
    assert abs(ds_engine.reynolds(f_ds, walls, cfg) - re_gold) <= 1e-9 * abs(re_gold)


def test_engine_forcing_guard_matches_golden():
    """tests/test_ds.py:148-164: the pair-precision guard makes golden's
    all-or-nothing decisions, with sites driven near the threshold."""
    cfg, jcfg, walls = _scene()
    f64_state = golden.initial_state(jcfg)
    f64_state[6, :, 0] = np.float64(cfg.accel) * np.float64(golden.W[5]) * np.concatenate(
        [np.linspace(0.5, 2.0, cfg.nx // 2), np.full(cfg.nx - cfg.nx // 2, 10.0)]
    )
    want = golden.apply_source(f64_state, walls, jcfg)
    got = ds_engine.state_f64(
        ds_engine.apply_source(df64.from_f64(f64_state), torch.as_tensor(walls), cfg)
    )
    np.testing.assert_array_equal(np.abs(got - f64_state) > 1e-13, want != f64_state)


def test_step_reference_fast_tier_bitwise_equals_jax_kernel():
    """The kernel module's plain version at the fast tier, 20 steps from
    a perturbed state, against the JAX fused ds kernel in interpret mode
    (tests/test_ds.py:213-229's program: temporal=2, an even step count,
    no tail pass): bitwise."""
    cfg, jcfg, walls = _scene(32, 96)
    f0 = _perturbed(jcfg)
    want = jdf.to_f64(jfdk.run_steps(jdf.from_f64(f0), np.asarray(walls), jcfg, 20,
                                     interpret=True, temporal=2))
    got = _reference_run(f0, walls, cfg, 20, exact=False)
    np.testing.assert_array_equal(df64.to_f64(got), want)


def test_step_reference_exact_tier_bitwise_equals_engine():
    cfg, jcfg, walls = _scene(32, 96)
    f0 = _perturbed(jcfg)
    got = _reference_run(f0, walls, cfg, 20, exact=True)
    want = ds_engine.run_steps(df64.from_f64(f0), torch.as_tensor(walls), cfg, 20)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


def test_kernel_constants_are_the_jax_splits():
    """The launch floats are the JAX package's host splits: the exact
    tier's const pairs and the (hi, lo) of the fast tier's split_const
    quads (the kernel's one-FMA products take no presplit halves)."""
    cfg, jcfg, _ = _scene()
    cfg = dataclasses.replace(cfg, tau=0.6, csq=0.8, accel=0.01)
    jcfg = dataclasses.replace(jcfg, tau=0.6, csq=0.8, accel=0.01)
    exact = [float(x) for v in jds._consts(jcfg, literal=True).values() for x in v]
    assert fdk.kernel_constants_ds(cfg, True) == tuple(exact)
    c = jds._consts_fast(jcfg, literal=True)
    fast = [float(x) for k in ("c1", "iw0", "iw14", "iw58", "c3", "csixth", "one", "a14", "a58")
            for x in c[k][:2]]
    assert fdk.kernel_constants_ds(cfg, False) == tuple(fast)


@pytest.mark.parametrize("exact", [False, True])
def test_session_on_cpu_runs_the_reference(exact):
    """The CPU wrapper path of a Session and of run_steps is
    step_reference, bit for bit, masked and wall-free."""
    for walls in (_scene()[2], np.zeros((16, 40), bool)):
        cfg, jcfg, _ = _scene()
        f0 = _perturbed(jcfg)
        want = _reference_run(f0, walls, cfg, 3, exact)
        sess = fdk.Session(cfg, walls, device="cpu", exact=exact)
        sess.load(df64.from_f64(f0))
        sess.advance(3)
        assert sess.has_walls == bool(walls.any())
        got = sess.state()
        assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
        out = fdk.run_steps(df64.from_f64(f0), torch.as_tensor(walls), cfg, 3, exact=exact,
                            temporal=1)
        assert torch.equal(out.hi, want.hi) and torch.equal(out.lo, want.lo)


def _refusal(case):
    cfg, jcfg, walls = _scene()
    src = df64.from_f64(_perturbed(jcfg))
    dst = df64.DS(torch.empty_like(src.hi), torch.empty_like(src.lo))
    solid = torch.as_tensor(walls.astype(np.uint8))
    if case == "no_card":
        meta = df64.DS(src.hi.to("meta"), src.lo.to("meta"))
        return RuntimeError, lambda: fdk.step(meta, meta, None, cfg, has_walls=False)
    if case == "src_is_dst":
        return ValueError, lambda: fdk.step(src, src, solid, cfg, has_walls=True)
    if case == "shared_component":
        return ValueError, lambda: fdk.step(src, df64.DS(dst.hi, src.lo), solid, cfg,
                                            has_walls=True)
    if case == "hi_is_lo":
        return ValueError, lambda: fdk.step(src, df64.DS(dst.hi, dst.hi), solid, cfg,
                                            has_walls=True)
    if case == "float64_tensor":
        return TypeError, lambda: fdk.step(df64.DS(src.hi.double(), src.lo), dst, solid, cfg,
                                           has_walls=True)
    if case == "f32_config":
        cfg32 = LatticeConfig(nx=16, ny=40, dtype=np.float32)
        return ValueError, lambda: fdk.step(src, dst, solid, cfg32, has_walls=True)
    if case == "shape":
        return ValueError, lambda: fdk.step(df64.DS(src.hi[:, :8].contiguous(), src.lo), dst,
                                            solid, cfg, has_walls=True)
    if case == "strided":
        return ValueError, lambda: fdk.step(df64.DS(src.hi, src.lo.transpose(1, 2)), dst,
                                            solid, cfg, has_walls=True)
    if case == "slip_code":
        solid[3, 3] = 2
        return ValueError, lambda: fdk.step(src, dst, solid, cfg, has_walls=True)
    if case == "no_solid":
        return ValueError, lambda: fdk.step(src, dst, None, cfg, has_walls=True)
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case",
    ["no_card", "src_is_dst", "shared_component", "hi_is_lo", "float64_tensor",
     "f32_config", "shape", "strided", "slip_code", "no_solid"],
)
def test_wrapper_refuses(case):
    exc, call = _refusal(case)
    before = fdk.LAUNCHES
    with pytest.raises(exc):
        call()
    assert fdk.LAUNCHES == before


def test_facade_torch_ds64_vs_jax_xla_ds64():
    """torch-ds64 through the facade: float64 state() bitwise the JAX
    xla-ds64 facade's, Re equal (both sum the column on the host, one site
    after the other), finite moments."""
    cfg, jcfg, walls = _scene()
    sim = Simulation(cfg, walls, backend="torch-ds64").run(60)
    jsim = JaxSimulation(jcfg, walls, backend="xla-ds64").run(60)
    st = sim.state()
    assert st.dtype == np.float64 and sim.device.type == "cpu"
    np.testing.assert_array_equal(st, jsim.state())
    assert sim.reynolds() == jsim.reynolds()
    for a, b in zip(sim.macroscopic(), jsim.macroscopic()):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    probes = np.array([[4, 5], [12, 30]])
    np.testing.assert_allclose(sim.probe_values(probes), jsim.probe_values(probes),
                               rtol=1e-12, atol=1e-15)
    assert sim.steps_done == 60 and sim.mlups > 0


def test_facade_ds_reynolds_is_the_sequential_host_sum(monkeypatch):
    """reynolds() on a ds backend with the default column is the JAX
    facade's (models/engine.py:511-516 there): golden.reynolds on the host
    float64 state, a strict sequential sum, == to it on a lattice tall
    enough (64 rows) that a device reduction adds in another order; no
    device reduction runs. Another column goes through the engine's
    reducer, as there."""
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.ops import stream_collide

    cfg, jcfg, walls = _scene(nx=64, ny=40)
    f0 = _perturbed(jcfg, seed=5)
    sim = Simulation(cfg, walls, backend="torch-ds64", f0=f0).run(12)
    jsim = JaxSimulation(jcfg, walls, backend="xla-ds64", f0=f0).run(12)
    np.testing.assert_array_equal(sim.state(), jsim.state())
    device_sum = stream_collide.reynolds
    monkeypatch.setattr(stream_collide, "reynolds",
                        lambda *a, **k: pytest.fail("a device sum ran for the default column"))
    re = sim.reynolds()
    assert re == jsim.reynolds()
    assert re == golden.reynolds(sim.state(), walls, jcfg)
    assert re == engine.golden.reynolds(sim.state(), walls, cfg)
    monkeypatch.setattr(stream_collide, "reynolds", device_sum)
    assert sim.reynolds(col=7) == pytest.approx(jsim.reynolds(col=7), rel=1e-12)
    # the float64 "torch" backend keeps the engine's reducer, as JAX "xla" does
    plain = Simulation(cfg, walls, backend="torch", f0=f0).run(3)
    jplain = JaxSimulation(jcfg, walls, backend="xla", f0=f0).run(3)
    assert plain.reynolds() == pytest.approx(jplain.reynolds(), rel=1e-12)


def test_facade_ds_refusals():
    cfg, _, walls = _scene()
    with pytest.raises(ValueError, match="float64"):
        Simulation(LatticeConfig(nx=16, ny=40, dtype=np.float32), walls, backend="torch-ds64")
    with pytest.raises(ValueError, match="float64"):
        Simulation(LatticeConfig(nx=16, ny=40, dtype=np.float32), walls, backend="cuda-ds64")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        Simulation(cfg, walls, backend="cuda-ds64")
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        Simulation(cfg, walls, backend="cuda-ds64", device="cpu")


def test_interop_ds_pair_round_trip():
    """A JAX DS crosses into the port and back bit for bit, and the port
    continues it exactly as the JAX engine does."""
    cfg, jcfg, walls = _scene()
    # 60 steps: the program the facade tests compile
    jf = jds.run_steps(jdf.from_f64(_perturbed(jcfg)), np.asarray(walls), jcfg, 60)
    f = interop.from_ds_pair(np.asarray(jf.hi), np.asarray(jf.lo), "cpu")
    hi, lo = interop.to_ds_pair(f)
    np.testing.assert_array_equal(hi, np.asarray(jf.hi))
    np.testing.assert_array_equal(lo, np.asarray(jf.lo))
    back = jdf.DS(hi, lo)
    np.testing.assert_array_equal(jdf.to_f64(back), jdf.to_f64(jf))
    with pytest.raises(ValueError, match="float32"):
        interop.from_ds_pair(hi.astype(np.float64), lo, "cpu")

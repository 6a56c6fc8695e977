"""The port's slice end to end on the CPU: the Simulation facade against
the JAX package's, state carried across by utils/interop.py; the kernel
runner (Session and wrapper, on the CPU through step_reference) against
the JAX fused kernel's runner; the CLI; the cuda backend's refusal
without a card; and float64 on the cuda backend, which runs the torch
engine with no kernel session, as the JAX pallas backend runs float64 on
its XLA engine."""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu import geometry as jgeo
from latticeboltzmann_tpu.models.engine import initial_state as jax_initial_state
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, available_backends, geometry
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_scene(dtype):
    """The JAX suite's small scene (tests/conftest.py small_cfg/walls)."""
    cfg = JaxConfig(nx=24, ny=40, dtype=dtype)
    walls = jgeo.channel(cfg.nx, cfg.ny)
    walls[8:14, 10:13] = True
    return cfg, walls


# float64: the jitted JAX engine differs from eager ops by FMA contraction
# only (tests/test_xla_parity.py:53-60's bar); float32: the accumulation
# bar of tests/test_xla_parity.py:73
@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-13, 1e-18),
                                             (np.float32, 0, 5e-5)])
def test_simulation_torch_vs_jax_xla(dtype, rtol, atol):
    """20 steps in the JAX package, the state carried over through
    interop, 20 more steps in each package: the two states agree, and so
    do Re and the macroscopic fields."""
    jcfg, walls = _jax_scene(dtype)
    jsim = JaxSimulation(jcfg, walls, backend="xla").run(20)
    f, walls_t, cfg = interop.from_numpy_state(
        jsim.state(), jsim.walls_np, dataclasses.asdict(jcfg), "cpu"
    )
    assert cfg == LatticeConfig(**dataclasses.asdict(jcfg))
    assert torch.equal(walls_t, torch.as_tensor(walls))
    np.testing.assert_array_equal(interop.to_numpy(f), jsim.state())
    sim = Simulation(cfg, walls, backend="torch", f0=interop.to_numpy(f)).run(20)
    jsim.run(20)
    assert sim.steps_done == 20 and sim.elapsed > 0 and sim.mlups > 0
    np.testing.assert_allclose(sim.state(), jsim.state(), rtol=rtol, atol=atol)
    assert sim.reynolds() == pytest.approx(jsim.reynolds(), rel=1e-6 if dtype == np.float32 else 1e-12)
    for a, b in zip(sim.macroscopic(), jsim.macroscopic()):
        np.testing.assert_allclose(a, b, rtol=1e-4 if dtype == np.float32 else 1e-10, atol=1e-12)
    probes = np.array([[4, 5], [20, 30]])
    np.testing.assert_allclose(sim.probe_values(probes), jsim.probe_values(probes),
                               rtol=1e-4 if dtype == np.float32 else 1e-10, atol=1e-12)
    np.testing.assert_allclose(sim.speed_squared(), jsim.speed_squared(),
                               rtol=1e-3 if dtype == np.float32 else 1e-9, atol=1e-14)


def test_kernel_runner_vs_jax_pallas_runner():
    """The port's kernel runner (Session + wrapper, step_reference on the
    CPU) against the JAX fused kernel's runner in interpret mode, 3
    steps at tests/test_pallas.py:32-40's scene and bar."""
    jcfg = JaxConfig(nx=16, ny=40, dtype=np.float32)
    walls = jgeo.channel(jcfg.nx, jcfg.ny)
    walls[5:9, 10:13] = True
    ref = np.asarray(jfk.run_steps(
        jnp.asarray(jax_initial_state(jcfg)), jnp.asarray(walls), jcfg, 3, interpret=True
    ))
    f, _, cfg = interop.from_numpy_state(
        jax_initial_state(jcfg), walls, dataclasses.asdict(jcfg), "cpu"
    )
    out = interop.to_numpy(fk.run_steps(f, walls, cfg, 3))
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-7)


def test_interop_refuses_mismatches():
    jcfg, walls = _jax_scene(np.float32)
    st = jax_initial_state(jcfg)
    fields = dataclasses.asdict(jcfg)
    with pytest.raises(TypeError, match="bogus"):
        interop.from_numpy_state(st, walls, {**fields, "bogus": 1}, "cpu")
    with pytest.raises(ValueError, match="state shape"):
        interop.from_numpy_state(st[:, :8], walls, fields, "cpu")
    with pytest.raises(ValueError, match="walls shape"):
        interop.from_numpy_state(st, walls[:8], fields, "cpu")


def test_cli_end_to_end():
    proc = subprocess.run(
        [sys.executable, "-m", "latticeboltzmann_tpu_torch", "--nx", "24", "--ny", "40",
         "--steps", "20", "--backend", "torch", "--print-stats-every", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("Lattice Size: 24x40") and "backend=torch precision=f32" in lines[0]
    assert sum("MLUPS:" in ln and "Elapsed" in ln for ln in lines) == 2
    assert lines[-2].startswith("Runtime: ") and " Re " in lines[-2]
    assert lines[-1].startswith("MLUPS: ")
    re_printed = float(lines[-2].split(" Re ")[1])
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    sim = Simulation(cfg, geometry.build("barrier", 24, 40), backend="torch").run(20)
    assert re_printed == pytest.approx(sim.reynolds(), rel=1e-9)


def test_auto_backend_and_cuda_refusal_without_card():
    from latticeboltzmann_tpu_torch.cli import resolve_backend

    assert available_backends() == ["cuda", "cuda-ds64", "sharded", "sharded-cuda",
                                    "sharded-cuda-ds64", "sharded-cuda-fused", "sharded-cuda-rdma",
                                    "sharded-sync",
                                    "torch", "torch-ds64"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert resolve_backend("auto") == "torch"
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        Simulation(cfg, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        Simulation(cfg, backend="pallas")


def test_blocking_run_ends_with_the_backends_barrier():
    """run(block=True) ends with the session's block(), as the JAX facade
    does (models/engine.py:367-369 there), once per blocking run and never
    with block=False; a backend without a session is asked for its own
    `block` (the eager sharded runners wait for every card of their mesh)."""
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.parallel import sharded

    calls = {"session": 0, "eager": 0}

    class CountingSession(fk.Session):
        def block(self):
            calls["session"] += 1
            super().block()

    def run_steps(*args, **kwargs):
        return fk.run_steps(*args, **kwargs)

    run_steps.session = CountingSession
    eager = sharded.make_backend(sharded.make_mesh(devices=["cpu"] * 2))
    assert callable(eager.block)

    def counted_eager(*args, **kwargs):
        return eager(*args, **kwargs)

    counted_eager.block = lambda: calls.__setitem__("eager", calls["eager"] + 1)
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    walls = geometry.channel(16, 40)
    try:
        engine.register_backend("_counting", run_steps)
        engine.register_backend("_counting_eager", counted_eager)
        for backend, key in (("_counting", "session"), ("_counting_eager", "eager")):
            sim = Simulation(cfg, walls, backend=backend, device="cpu")
            assert calls[key] == 0
            sim.run(3)
            assert calls[key] == 1
            sim.run(3, block=False)
            assert calls[key] == 1
            sim.run(2)
            assert calls[key] == 2 and sim.steps_done == 8
        # the registered kernel sessions all have the barrier
        for name in ("cuda", "cuda-ds64", "sharded-cuda", "sharded-cuda-ds64",
                     "sharded-cuda-rdma"):
            assert hasattr(engine._BACKENDS[name], "session")
        for name in ("sharded", "sharded-sync"):
            assert callable(engine._BACKENDS[name].block)
    finally:
        engine._BACKENDS.pop("_counting", None)
        engine._BACKENDS.pop("_counting_eager", None)


@pytest.mark.parametrize("backend", ["torch", "kernel-session"])
def test_schedule_keywords_construct_and_select_nothing(backend, monkeypatch):
    """Simulation(skew=, temporal=, allow_experimental=) as the JAX facade
    (models/engine.py:195-197 there): kept as given, and the state is the
    same whatever they say, on the plain engine and on a session backend
    (the kernel's session, on the CPU through its plain version)."""
    from latticeboltzmann_tpu_torch.models import engine

    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    walls = geometry.channel(16, 40)
    walls[5:9, 10:13] = True
    if backend == "kernel-session":
        backend = "cuda"
        monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())  # on the CPU, for the test
    states = []
    for kw in ({}, {"skew": True}, {"skew": False}, {"temporal": 4},
               {"skew": True, "temporal": 1, "allow_experimental": True}):
        sim = Simulation(cfg, walls, backend=backend, device="cpu", **kw)
        assert sim.skew is kw.get("skew") and sim.temporal == kw.get("temporal")
        states.append(sim.run(6).state())
    for st in states[1:]:
        np.testing.assert_array_equal(st, states[0])
    # the JAX facade takes the same three keywords
    jcfg, jwalls = _jax_scene(np.float32)
    jsim = JaxSimulation(jcfg, jwalls, backend="xla", skew=False, temporal=None,
                         allow_experimental=False)
    assert jsim.skew is False and jsim.temporal is None


def _f64_scene():
    """24x40 float64, a channel and a block, with slip masks on a copy."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float64)
    walls = geometry.channel(24, 40)
    walls[8:14, 10:13] = True
    return cfg, walls


@pytest.mark.parametrize("slip", [False, True])
def test_cuda_float64_runs_the_torch_engine(slip, monkeypatch):
    """backend="cuda" with a float64 config (the CPU twin of the card's
    path): no kernel session, the "torch" engine, reported as
    fused_kernel.F64_FORM and counted in F64_STEPS; bitwise equal to
    backend="torch" in run(), run_probed() and reynolds(), with the schedule
    and kernel options kept as given and selecting nothing, slip masks
    reaching the engine. Against the JAX fused_kernel.run_steps, which
    takes float64 to its XLA engine, at the JAX test's bar (rtol 1e-13,
    atol 1e-18; tests/test_pallas.py:161-170)."""
    from latticeboltzmann_tpu_torch.models import engine

    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())  # on the CPU, for the test
    cfg, walls = _f64_scene()
    kw = {}
    if slip:
        slip_x, slip_y = np.zeros_like(walls), np.zeros_like(walls)
        slip_x[0] = True
        slip_y[12, 30:33] = True
        walls = walls.copy()
        walls[0] = False
        kw = {"slip_x": slip_x, "slip_y": slip_y}
    steps_before, launches_before = fk.F64_STEPS, fk.LAUNCHES
    sim = Simulation(cfg, walls, backend="cuda", device="cpu", temporal=3, skew=True,
                     fast_math=True, **kw)
    assert sim.form == fk.F64_FORM == "torch-f64" and sim._session is None
    assert (sim.temporal, sim.skew, sim.fast_math) == (3, True, True)
    ref = Simulation(cfg, walls, backend="torch", device="cpu", **kw)
    assert ref.form == "engine"
    sim.run(5).run(2)
    ref.run(7)
    assert fk.F64_STEPS == steps_before + 7 and fk.LAUNCHES == launches_before
    np.testing.assert_array_equal(sim.state(), ref.state())
    assert sim.state().dtype == np.float64
    assert sim.reynolds() == ref.reynolds()
    probes = [(5, 20), (12, 3)]
    series = sim.run_probed(6, probes, every=3)
    np.testing.assert_array_equal(series, ref.run_probed(6, probes, every=3))
    assert series.dtype == np.float64 and fk.F64_STEPS == steps_before + 13
    np.testing.assert_array_equal(sim.state(), ref.state())
    if slip:
        return
    jcfg = JaxConfig(nx=24, ny=40, dtype=np.float64)
    want = np.asarray(jfk.run_steps(jnp.asarray(jax_initial_state(jcfg)), jnp.asarray(walls),
                                    jcfg, 5))
    got = Simulation(cfg, walls, backend="cuda", device="cpu").run(5).state()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-18)


def test_kernel_runner_takes_float64_to_the_engine_and_the_kernels_refuse_it():
    """fused_kernel.run_steps / run_steps_probed with float64: the engine
    on f's device (F64_STEPS counted, no session built), f unchanged, the
    series every `every` steps equal to the engine's per-step series; the
    kernel entry points and Session still raise NotImplementedError naming
    ROADMAP B15."""
    from latticeboltzmann_tpu_torch.ops import stream_collide

    cfg, walls = _f64_scene()
    f = interop.state_tensor(jax_initial_state(JaxConfig(nx=24, ny=40, dtype=np.float64)),
                             cfg.dtype, "cpu")
    f0 = f.clone()
    w = torch.as_tensor(walls)
    before = fk.F64_STEPS
    out = fk.run_steps(f, walls, cfg, 6, wall_spec=geometry.infer_spec(walls), temporal=4)
    assert fk.run_form(cfg) == fk.F64_FORM and fk.F64_STEPS == before + 6
    assert torch.equal(f, f0)
    assert torch.equal(out, stream_collide.run_steps(f, w, cfg, 6))
    fout, series = fk.run_steps_probed(f, w, cfg, 6, [(3, 4), (9, 30)], every=2)
    ref_f, ref_series = stream_collide.run_steps_probed(f, w, cfg, 6, [(3, 4), (9, 30)])
    assert torch.equal(fout, ref_f) and torch.equal(series, ref_series[1::2])
    assert series.dtype == torch.float64 and fk.F64_STEPS == before + 12
    assert fk.run_form(LatticeConfig(nx=24, ny=40, dtype=np.float32)) == fk.KERNEL_FORM
    with pytest.raises(NotImplementedError, match="ROADMAP B15"):
        fk.Session(cfg, walls, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP B15"):
        fk.step(f, torch.empty_like(f), None, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP B15"):
        fk.temporal_step(f, torch.empty_like(f), None, cfg, 2)
    with pytest.raises(TypeError, match="float64"):
        fk.run_steps(f.float(), walls, cfg, 1)
